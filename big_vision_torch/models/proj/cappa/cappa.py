"""CapPa, the image captioner with parallel prediction (arXiv:2306.07915):
port of big_vision_tpu/models/proj/cappa/cappa.py.

A ViT encoder (`models/vit.py`: its attention on the one-shot kernels
under "auto") and a text decoder of pre-norm blocks: causal self-attention,
cross-attention to the encoded image, MLP. The decoder's attentions are
flax's `MultiHeadDotProductAttention` without biases (its [D, H, Dh] and
[H, Dh, D] kernels, q scaled by 1/sqrt(Dh), masked scores at the dtype's
minimum) on the plain path, as in JAX. The decoder's LayerNorms and MLP
have biases only with `decoder_bias`; `EmbedTargets` has one more row, the
[MASK] id (= vocab_size), when `masked_pred_prob` > 0; `LogitsDense` starts
at zero, so the first loss is ln(vocab) on any batch. The `decoder_*`
sizes fall back to the encoder's where 0.

Training: with `masked_pred_prob` p > 0, each example is, with
probability p, trained by parallel prediction: int(masking_ratio * L) of
its positions (drawn uniformly) become [MASK] and its self-attention sees
the whole sequence; otherwise it is teacher-forced (the targets shifted
right, causal attention). The draws come from the `torch.Generator`
passed as `rng` (`parallel_or_ar`): torch cannot draw JAX's numbers, so
the parity tests hold p = 0 and p = 1 with masking_ratio 1, where the draw
decides nothing, and the law of the draw elsewhere.

`scan=True` remats each encoder and decoder block (`common.checkpointed`),
as the JAX model's `nn.remat` under `nn.scan` does whatever
`remat_policy` names; `utils/convert.py` reads both the scanned and the
per-layer param layouts (`convert.cappa`). `decode=True`, the flax cache
for step-by-step decoding, is refused by name: no predict fn of the CapPa
trainer reaches it. The port builds the learned posemb for `image_size`.

`load` reads a whole CapPa checkpoint (merged with the model's params, the
ViT head and [cls] kept from the init) or {"encoder": a ViT checkpoint}
(through `vit.load`), then resamples the encoder's posemb, on nested dicts
of numpy arrays in the JAX layout.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from big_vision_torch.models import common
from big_vision_torch.models import vit
from big_vision_torch.utils import checkpoints
from big_vision_torch.utils import convert


def shift_right(x, axis=1, constant_values=0):
  """Shifts right along `axis`, dropping the last slice (teacher forcing)."""
  first = torch.full_like(x.narrow(axis, 0, 1), constant_values)
  return torch.cat([first, x.narrow(axis, 0, x.shape[axis] - 1)], dim=axis)


def make_causal_mask(targets):
  """flax `nn.make_causal_mask`: [B, 1, L, L] bool, query >= key."""
  length = targets.shape[1]
  causal = torch.tril(torch.ones((length, length), dtype=torch.bool,
                                 device=targets.device))
  return causal.expand(targets.shape[0], 1, length, length)


def parallel_or_ar(tokens, decoder_mask, *, mask_id, masked_pred_prob,
                   masking_ratio, rng):
  """(decoder input, decoder mask) of a training batch: each example is,
  with probability `masked_pred_prob`, `tokens` with int(masking_ratio *
  L) uniformly drawn positions set to `mask_id` under a fully visible mask,
  else `tokens` shifted right under `decoder_mask`. Draws from `rng`."""
  b, length = tokens.shape
  n_mask = int(masking_ratio * length)
  draw = torch.rand((b, length), generator=rng, device=tokens.device)
  ranks = draw.argsort(dim=1).argsort(dim=1)
  masked = torch.where(ranks < n_mask, mask_id, tokens)
  parallel = torch.rand((b,), generator=rng,
                        device=tokens.device) < masked_pred_prob
  return (torch.where(parallel[:, None], masked, shift_right(tokens)),
          decoder_mask | parallel[:, None, None, None])


class MultiHeadAttention(nn.Module):
  """flax `MultiHeadDotProductAttention(use_bias=False)` on the plain path:
  query/key/value [D, H, Dh] and out [H, Dh, D] kernels, stored as [out,
  in] matrices; dropout on the attention weights in training."""

  def __init__(self, width, num_heads, kv_width=None, *, dropout=0.0,
               device="cuda", param_dtype=torch.float32):
    super().__init__()
    if width % num_heads:
      raise ValueError((width, num_heads))
    kw = dict(use_bias=False, device=device, param_dtype=param_dtype)
    self.num_heads = num_heads
    self.dropout = dropout
    self.query = common.Dense(width, width, **kw)
    self.key = common.Dense(kv_width or width, width, **kw)
    self.value = common.Dense(kv_width or width, width, **kw)
    self.out = common.Dense(width, width, **kw)

  def forward(self, xq, xkv, mask=None, rng=None):
    heads = lambda y: y.reshape(*y.shape[:2], self.num_heads, -1)
    q, k, v = heads(self.query(xq)), heads(self.key(xkv)), heads(
        self.value(xkv))
    q = q / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if mask is not None:
      scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    weights = common.dropout(torch.softmax(scores, dim=-1), self.dropout,
                             rng)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
    return self.out(out.reshape(*out.shape[:2], -1))


class EncoderDecoderBlock(nn.Module):
  """Self-attention, cross-attention (skipped without `encoded`) and MLP,
  each a pre-norm residual branch."""

  def __init__(self, width, num_heads, mlp_dim, enc_width=None, *,
               use_bias=True, dropout=0.0, device="cuda",
               param_dtype=torch.float32):
    super().__init__()
    kw = dict(device=device, param_dtype=param_dtype)
    norm = lambda: common.LayerNorm(width, use_bias=use_bias, **kw)
    self.ln1, self.ln2, self.ln3 = norm(), norm(), norm()
    self.self_attn = MultiHeadAttention(width, num_heads, dropout=dropout,
                                        **kw)
    self.cross_attn = MultiHeadAttention(width, num_heads, enc_width,
                                         dropout=dropout, **kw)
    self.mlp = vit.MlpBlock(width, mlp_dim, dropout=dropout,
                            use_bias=use_bias, **kw)
    self.dropout = dropout

  def forward(self, tokens, encoded, mask=None, rng=None):
    drop = lambda y: common.dropout(y, self.dropout, rng)
    y = self.ln1(tokens)
    x = tokens + drop(self.self_attn(y, y, mask, rng))
    if encoded is not None:  # the image-free scoring paths pass None
      x = x + drop(self.cross_attn(self.ln2(x), encoded, None, rng))
    return x + drop(self.mlp(self.ln3(x), rng))


class Decoder(nn.Module):
  """Text decoder; with `masked_pred_prob` > 0 also parallel prediction."""

  def __init__(self, num_layers, num_heads, emb_dim, mlp_dim, enc_width=None,
               *, dropout_rate=0.0, output_vocab_size=32_000,
               masked_pred_prob=0.0, masking_ratio=0.0, use_bias=True,
               remat=False, device="cuda", param_dtype=torch.float32):
    super().__init__()
    kw = dict(device=device, param_dtype=param_dtype)
    self.vocab_size = output_vocab_size
    self.masked_pred_prob = masked_pred_prob
    self.masking_ratio = masking_ratio
    self.remat = remat
    # One extra row serves as [MASK] in parallel prediction.
    rows = output_vocab_size + int(masked_pred_prob > 0.0)
    self.embed = nn.Parameter(torch.empty(rows, emb_dim, device=device,
                                          dtype=param_dtype))
    self.blocks = nn.ModuleList([
        EncoderDecoderBlock(emb_dim, num_heads, mlp_dim, enc_width,
                            use_bias=use_bias, dropout=dropout_rate, **kw)
        for _ in range(num_layers)])
    self.ln = common.LayerNorm(emb_dim, **kw)
    self.logits = common.Dense(emb_dim, output_vocab_size, kernel_init="zeros",
                               **kw)

  def forward(self, encoded, targets, pos_emb, *, train=False,
              decoder_mask=None, rng=None):
    tokens = targets.long()
    if self.masked_pred_prob > 0.0 and train:
      if rng is None:
        raise ValueError("parallel prediction draws its masks: pass rng=")
      tokens, decoder_mask = parallel_or_ar(
          tokens, decoder_mask, mask_id=self.vocab_size,
          masked_pred_prob=self.masked_pred_prob,
          masking_ratio=self.masking_ratio, rng=rng)
    else:
      tokens = shift_right(tokens)
    rng = rng if train else None
    y = self.embed[tokens] + pos_emb[:, :tokens.shape[1]].to(
        self.embed.dtype)
    remat = self.remat and torch.is_grad_enabled()
    for block in self.blocks:
      if remat:
        y = common.checkpointed(block, y, encoded, decoder_mask, rng=rng)
      else:
        y = block(y, encoded, decoder_mask, rng=rng)
    return self.logits(self.ln(y))


class Model(nn.Module):
  """ViT encoder + captioning decoder; `forward(image [N, H, W, C], text
  [N, L])` -> logits [N, L, vocab_size]."""

  def __init__(self, emb_dim=512, mlp_dim=2048, num_layers=6, num_heads=8,
               input_seq_len=768, patches: Sequence[int] = (16, 16),
               posemb_type="learn", enc_dropout_rate=0.0, patch_dropout=0.0,
               vocab_size=32_000, seq_len=256, decoder_num_layers=0,
               decoder_num_heads=0, decoder_emb_dim=0, decoder_mlp_dim=0,
               dec_dropout_rate=0.0, decoder_bias=True, masked_pred_prob=0.0,
               masking_ratio=0.0, scan=False, remat_policy="nothing_saveable",
               *, image_size=224, channels=3, device="cuda",
               param_dtype=torch.float32):
    super().__init__()
    del input_seq_len, patch_dropout  # read by no part of the JAX model
    kw = dict(device=device, param_dtype=param_dtype)
    self.encoder = vit.Model(
        None, posemb=posemb_type, patch_size=tuple(patches), width=emb_dim,
        mlp_dim=mlp_dim, depth=num_layers, num_heads=num_heads,
        dropout=enc_dropout_rate, scan=scan, remat_policy=remat_policy,
        image_size=image_size, channels=channels, **kw)
    fallback = lambda mine, enc: mine or enc
    dec_width = fallback(decoder_emb_dim, emb_dim)
    self.posemb_type = posemb_type
    self.seq_len = seq_len
    if posemb_type == "learn":
      self.pos_embedding_decoder = nn.Parameter(torch.empty(
          1, seq_len, dec_width, device=device, dtype=param_dtype))
    elif posemb_type != "sincos2d":
      raise ValueError(f"Unknown posemb type: {posemb_type}")
    self.decoder = Decoder(
        fallback(decoder_num_layers, num_layers),
        fallback(decoder_num_heads, num_heads), dec_width,
        fallback(decoder_mlp_dim, mlp_dim), emb_dim,
        dropout_rate=dec_dropout_rate, output_vocab_size=vocab_size,
        masked_pred_prob=masked_pred_prob, masking_ratio=masking_ratio,
        use_bias=decoder_bias, remat=bool(scan), **kw)
    self.dec_width = dec_width

  @torch.no_grad()
  def initialize(self, generator, head_bias=None):
    """Draws every parameter as the JAX model's `init` does: the encoder
    by `vit`'s rules; EmbedTargets N(0, 1); the decoder posemb N(0,
    1/width); the attentions lecun_normal; the MLPs xavier_uniform with
    N(0, 1e-6^2) biases; LogitsDense zeros. Returns the module."""
    del head_bias
    self.encoder.initialize(generator)
    for module in self.decoder.modules():
      if hasattr(module, "reset_parameters"):
        module.reset_parameters(generator)
    common.init(self.decoder.embed, ("normal", 1.0), generator)
    if self.posemb_type == "learn":
      common.init(self.pos_embedding_decoder,
                  ("normal", self.dec_width ** -0.5), generator)
    return self

  def pos_emb(self, device):
    if self.posemb_type == "learn":
      return self.pos_embedding_decoder
    return vit.posemb_sincos_2d(1, self.seq_len, self.dec_width,
                                device=device)

  def encode(self, image, train=False, return_enc_features=False, rng=None):
    """The encoded image tokens [N, T, D] (and the encoder's outputs)."""
    _, out = self.encoder(image, train=train, rng=rng)
    if not return_enc_features:
      return out["encoded"]
    return out["encoded"], out

  def decode(self, encoded, targets, decode=False, train=False,
             max_decode_length=None, rng=None):
    """Logits [N, L, vocab] of `targets` given `encoded` (None: no
    cross-attention)."""
    del max_decode_length
    if decode:
      raise NotImplementedError(
          "cappa decode=True (the flax cache for step-by-step decoding) is "
          "not ported: no predict fn of the CapPa trainer reaches it")
    return self.decoder(encoded, targets, self.pos_emb(targets.device),
                        train=train, decoder_mask=make_causal_mask(targets),
                        rng=rng)

  def forward(self, image, text=None, *, decode=False, train=False,
              return_enc_features=False, rng=None):
    if return_enc_features:
      return self.encode(image, train=train, return_enc_features=True,
                         rng=rng)
    memory = self.encode(image, train=train, rng=rng)
    return self.decode(memory, text, decode=decode, train=train, rng=rng)


def load(init_params, init_files, model_params=None,
         dont_load=("head/kernel", "head/bias", "cls")):
  """Loads a whole CapPa checkpoint (a path) or {"encoder": path}; returns
  the merged tree in `init_params`' (per-layer) layout."""
  del model_params
  if isinstance(init_files, str):
    ckpt = convert.cappa_pyloop(vit.convert_pre_linen(
        checkpoints.load_params(init_files)))
    ckpt = common.merge_params(ckpt, init_params, dont_load)
  else:
    if set(init_files) != {"encoder"}:
      raise ValueError(f"only an encoder init is supported: {init_files}")
    ckpt = dict(init_params)
    ckpt["encoder"] = vit.load(ckpt["encoder"], init_files["encoder"],
                               model_cfg={}, dont_load=dont_load)
  enc = ckpt["encoder"]
  enc["pos_embedding"] = vit.resample_posemb(
      old=enc["pos_embedding"], new=init_params["encoder"]["pos_embedding"])
  return ckpt

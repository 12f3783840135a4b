"""JetFormer, one decoder-only transformer over text tokens and soft image
tokens (arXiv:2411.19722): port of
big_vision_tpu/models/proj/jetformer/jetformer.py.

A sequence is [bos, text, boi, image] or [boi, image, bos, text] per
example (`text_first_mask`); text positions get categorical logits (the
text embedding's transpose, or an untied `LogitsText`), image positions the
raw outputs of a zero-init `LogitsImage` head (in `head_dtype`) that
`get_pdf` reads as a Gaussian mixture over the soft tokens (the latents of
the Jet adaptor). `num_vocab_repeats` > 1 repeats a (class) text r times,
each copy in its own slice of the vocabulary; `drop_prefix` replaces a
prefix by the `nolabel` token for classifier-free guidance training.

The backbone is the port's Gemma block (`models/ppp/gemma.py`) with
Gemma v1's settings (queries scaled by 1/sqrt(head_dim), no softcap, no
post-norms), MQA or GQA, a boolean mask on the plain attention path, and
dropout with `dropout_bdims`; its layers are stacked on a leading axis
under "decoder/layers/..." as the JAX model's `scan=True` stacks them
(`common.Scanned`; the port takes no `scan=False`), each under a
non-reentrant checkpoint in training where `remat_policy` is not "none".
`prefill_cache` right-aligns the valid tokens (`right_align`) and fills a
KV cache; `extend_cache` adds one token, which sees the cache's valid
window [cache_begin, cache_end).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from big_vision_torch.models import common
from big_vision_torch.models.ppp import gemma
from big_vision_torch.models.proj.givt import distributions
from big_vision_torch.utils import checkpoints


def right_align(x, attn_mask, input_mask):
  """Moves each example's valid tokens (`input_mask` [B, L], anywhere) to
  the end, in order: x [B, L, ...], attn_mask [B, L, L] and the aligned
  input mask. A stable sort of the mask is that permutation."""
  b, length = input_mask.shape
  if length == 0:
    return x, attn_mask, input_mask
  order = torch.argsort(input_mask.int(), dim=-1, stable=True)
  n_valid = input_mask.sum(-1, keepdim=True)
  aligned = torch.arange(length, device=x.device)[None] >= length - n_valid
  x = x.gather(1, order.reshape(b, length, *(1,) * (x.dim() - 2)).expand(
      x.shape))
  rows = order[:, :, None].expand(b, length, length)
  attn_mask = attn_mask.gather(1, rows).gather(2, rows.transpose(1, 2))
  return x, attn_mask, aligned


@dataclasses.dataclass
class Cache:
  """The decode state: the layers' KV cache and each example's valid
  window [cache_begin, cache_end) of it, and its next position."""
  kv: gemma.KVCache
  seq_len: torch.Tensor
  cache_begin: torch.Tensor
  cache_end: torch.Tensor
  size: int


class Model(nn.Module):
  """JetFormer; `forward(text, image_tokens, text_first_mask, ...)` ->
  (text logits, image logits, pmf, pdf, decoder out)."""

  def __init__(self, width, depth, mlp_dim, num_heads, num_kv_heads,
               head_dim, norm_eps=1e-6, embed_dtype="float32",
               head_dtype="float32", cache_dtype=None, scan=False,
               remat_policy="none", dropout=0.0, dropout_bdims=(),
               vocab_size=1000, bos_id=None, boi_id=None, nolabel_id=None,
               untie_output_vocab=False, num_vocab_repeats=1,
               causal_mask_on_prefix=True, out_dim=32, num_mixtures=4,
               multivariate=False, scale_tol=1e-6,
               per_modality_final_norm=False, drop_labels_probability=0.0,
               *, device="cuda", param_dtype=torch.float32):
    super().__init__()
    del norm_eps  # fixed at 1e-6 in Gemma's RMSNorm, as in JAX
    if not scan:
      raise NotImplementedError(
          "JetFormer with scan=False (per-layer param names) is not ported: "
          "the port stacks the layers as scan=True does")
    if num_mixtures <= 0 or (multivariate and num_mixtures != 1):
      raise ValueError("Multivariate GMM requires num_mixtures == 1.")
    if untie_output_vocab and num_vocab_repeats != 1:
      raise ValueError("untie_output_vocab needs num_vocab_repeats == 1")
    kw = dict(device=device, param_dtype=param_dtype)
    self.embed_dtype = common.resolve_dtype(embed_dtype)
    self.remat_policy = remat_policy
    self.vocab_size, self.num_vocab_repeats = vocab_size, num_vocab_repeats
    self.bos_id, self.boi_id, self.nolabel_id = bos_id, boi_id, nolabel_id
    self.causal_mask_on_prefix = causal_mask_on_prefix
    self.out_dim, self.num_mixtures = out_dim, num_mixtures
    self.multivariate, self.scale_tol = multivariate, scale_tol
    self.drop_labels_probability = drop_labels_probability
    self.text_emb = nn.Parameter(torch.empty(
        vocab_size * num_vocab_repeats, width, device=device,
        dtype=param_dtype))
    self.text_head = (common.Dense(width, vocab_size,
                                   kernel_init=("normal", 1.0), **kw)
                      if untie_output_vocab else None)
    self.img_emb = common.Dense(out_dim, width, **kw)
    self.img_head = common.Dense(width, self.num_logits, dtype=head_dtype,
                                 kernel_init="zeros", **kw)
    self.text_norm = self.img_norm = None
    if per_modality_final_norm:
      self.text_norm = gemma.RMSNorm(width, **kw)
      self.img_norm = gemma.RMSNorm(width, **kw)
    self.layers = common.Scanned(gemma.Block(
        num_heads, num_kv_heads, width, head_dim, mlp_dim,
        query_pre_attn_norm="rsqrt_head_dim", attn_logits_softcap=None,
        post_norms=False, cache_dtype=cache_dtype, dropout=dropout,
        dropout_bdims=dropout_bdims, **kw), depth)
    self.final_norm = gemma.RMSNorm(width, **kw)

  @property
  def num_logits(self) -> int:
    if self.multivariate:
      return round(self.out_dim ** 2) + self.out_dim
    return self.num_mixtures + 2 * self.num_mixtures * self.out_dim

  @torch.no_grad()
  def initialize(self, generator):
    """Draws every parameter with the JAX model's initializers: the text
    embedding (and an untied text head) N(0, 1), the image embedding
    lecun_normal, the image head zeros, the blocks' matmul weights the
    truncated normal of variance 1/fan_in, every RMSNorm scale zero.
    Returns the module."""
    common.init(self.text_emb, ("normal", 1.0), generator)
    for head in (self.text_head, self.img_emb, self.img_head):
      if head is not None:
        head.reset_parameters(generator)
    for name, p in self.layers.named_parameters():
      if p.dim() == 3:  # [depth, out, in]
        common.init(p, "lecun_normal", generator, fan_in=p.shape[-1])
      else:
        common.init(p, "zeros", generator)
    for norm in (self.final_norm, self.text_norm, self.img_norm):
      if norm is not None:
        common.init(norm.scale, "zeros", generator)
    return self

  # The backbone.

  def backbone(self, x, *, mask, positions=None, cache=None, rng=None):
    """[B, T, E] -> (the heads' input, {"encoded", "pre_logits"}); with a
    `Cache`, its KV cache is filled (T > 1) or extended (T == 1)."""
    x = x.to(self.embed_dtype)
    positions, mask = gemma.prep_positions_mask(x, positions, mask,
                                                cache is not None)
    kv = cache.kv if cache is not None else None
    remat = (self.remat_policy != "none" and kv is None
             and torch.is_grad_enabled())
    for i, params in enumerate(self.layers.params()):
      step = lambda *a, rng=None, params=params: self.layers.call(
          params, *a, rng=rng)
      if remat:
        x = common.checkpointed(step, x, positions, mask, None, i, None,
                                rng=rng)
      else:
        x = step(x, positions, mask, kv, i, None, rng=rng)
    if kv is not None:
      kv.idx += x.shape[1]
    out = {"encoded": x, "pre_logits": self.final_norm(x)}
    return (x if self.text_norm is not None else out["pre_logits"]), out

  # The decode cache: prefill, then one token at a time.

  def prefill_cache(self, x, attn_mask, input_mask, *, cache_size):
    """Fills a new cache with right-aligned `x` [B, N, E]; returns (the
    heads' input, right-aligned: [:, -1:] is each example's last valid
    token, and the `Cache`)."""
    prefill_len = x.shape[1]
    x, attn_mask, input_mask = right_align(x, attn_mask, input_mask)
    seq_len = input_mask.sum(-1)
    cache = Cache(gemma.KVCache(), seq_len, prefill_len - seq_len,
                  torch.full_like(seq_len, prefill_len), cache_size)
    mask = torch.nn.functional.pad(attn_mask, (0, cache_size - prefill_len))
    x, _ = self.backbone(x, positions=input_mask.long().cumsum(-1) - 1,
                         mask=mask, cache=cache)
    return x, cache

  def extend_cache(self, x, cache):
    """Extends `cache` by one token `x` [B, 1, E]; returns its heads'
    input. The token sees the window [cache_begin, cache_end] (itself
    included)."""
    if x.shape[1] != 1:
      raise ValueError("extend_cache is one token at a time")
    positions = cache.seq_len
    cache.seq_len = positions + 1
    cache.cache_end = cache.cache_end + 1
    slot = torch.arange(cache.size, device=x.device)[None, None, :]
    mask = ((slot >= cache.cache_begin[:, None, None])
            & (slot < cache.cache_end[:, None, None]))
    x, _ = self.backbone(x, positions=positions[:, None], mask=mask,
                         cache=cache)
    return x

  # The heads.

  def get_pdf(self, logits, temperature_scales=None, temperature_probs=None):
    """The image head's density of the soft tokens."""
    if logits.shape[-1] != self.num_logits:
      raise ValueError(f"{logits.shape[-1]} logits, want {self.num_logits}")
    if self.multivariate:
      return distributions.mvn_tri_from_raw(
          logits, out_dim=self.out_dim, scale_tol=self.scale_tol,
          temp_scales=temperature_scales)
    return distributions.mixture_from_raw(
        logits, num_mixtures=self.num_mixtures, out_dim=self.out_dim,
        scale_tol=self.scale_tol, temp_scales=temperature_scales,
        temp_probs=temperature_probs)

  @staticmethod
  def get_pmf(logits):
    return distributions.Categorical(logits)

  def embed_text(self, tokens):
    return self.text_emb[tokens]

  def text_logits(self, pre_logits):
    if self.text_norm is not None:
      pre_logits = self.text_norm(pre_logits)
    if self.text_head is not None:
      return self.text_head(pre_logits)
    return common.linear(pre_logits, self.text_emb)  # nn.Embed.attend

  def img_logits(self, pre_logits):
    if self.img_norm is not None:
      pre_logits = self.img_norm(pre_logits)
    return self.img_head(pre_logits)

  def lookup_token(self, token_id, batch_size):
    """A special token's embedding, [B, 1, E]."""
    return self.text_emb[token_id][None, None].expand(batch_size, 1, -1)

  def get_drop_labels(self, generator, batch_size):
    """Which examples drop their prefix (CFG training), or None."""
    p = self.drop_labels_probability
    if not p > 0:
      return None
    return torch.rand((batch_size,), generator=generator,
                      device=self.text_emb.device) <= p

  # The teacher-forced forward.

  def forward(self, text_tokens, image_tokens, text_first_mask, *,
              text_input_mask=None, drop_prefix=None, train=False, rng=None):
    """(text logits, image logits, pmf, pdf, decoder out); `rng` draws the
    dropout where `train`."""
    x, attn_mask, input_mask = self.embed_image_and_text(
        text_tokens, image_tokens, text_first_mask=text_first_mask,
        text_input_mask=text_input_mask, drop_prefix=drop_prefix)
    prelogits, out = self.backbone(
        x, mask=attn_mask, positions=input_mask.long().cumsum(-1) - 1,
        rng=rng if train else None)
    text_pre, img_pre = self.split_image_and_text_prelogits(
        prelogits, text_first_mask, text_tokens.shape[1],
        image_tokens.shape[1])
    text_logits = self.text_logits(text_pre)
    image_logits = self.img_logits(img_pre)
    return (text_logits, image_logits, self.get_pmf(text_logits),
            self.get_pdf(image_logits), out)

  def _segment_layout(self, text_len, image_len, device):
    """Index vectors into [bos, (boi,) text, image] of the text-first and
    the image-first order."""
    has_boi = self.boi_id is not None
    t0 = 1 + has_boi
    ar = lambda n, start: torch.arange(n, device=device) + start
    txt, img = ar(text_len, t0), ar(image_len, t0 + text_len)
    bos, boi = ar(1, 0), ar(1, 1)
    if has_boi:
      return (torch.cat([bos, txt, boi, img]),
              torch.cat([boi, img, bos, txt]))
    return torch.cat([bos, txt, img]), torch.cat([bos, img, txt])

  def embed_image_and_text(self, text_tokens, image_tokens, *,
                           text_first_mask, text_input_mask=None,
                           drop_prefix=None, shift=True):
    """(x [B, T, E], attn_mask [B, T, T], input_mask [B, T]) of both
    orders, one per example; `shift` drops the last token (teacher
    forcing)."""
    txt_prefix = text_first_mask
    batch = image_tokens.shape[0]
    dev = image_tokens.device
    if text_input_mask is None:
      text_input_mask = torch.ones(text_tokens.shape, dtype=torch.bool,
                                   device=dev)
    r = self.num_vocab_repeats
    if r > 1:
      # r copies of the text, each in its own slice of the vocabulary.
      offsets = torch.repeat_interleave(
          torch.arange(r, device=dev) * self.vocab_size,
          text_tokens.shape[1])[None]
      widen = lambda t: t.repeat(1, r) + offsets
      nolabel = self.embed_text(widen(torch.full_like(text_tokens,
                                                      self.nolabel_id)))
      text_tokens = widen(text_tokens)
      text_input_mask = text_input_mask.repeat(1, r)
    else:
      nolabel = self.lookup_token(self.nolabel_id, 1)
    x_txt = self.embed_text(text_tokens)
    x_img = self.img_emb(image_tokens)

    img_valid = torch.ones(x_img.shape[:-1], dtype=torch.bool, device=dev)
    txt_valid = text_input_mask.bool()
    if drop_prefix is not None:
      drop_txt = (txt_prefix & drop_prefix)[:, None]
      drop_img = (~txt_prefix & drop_prefix)[:, None]
      x_txt = torch.where(drop_txt[..., None], nolabel, x_txt)
      txt_valid = drop_txt | txt_valid
      x_img = torch.where(drop_img[..., None], nolabel[:, :1, :], x_img)

    segs = [self.lookup_token(self.bos_id, batch)]
    if self.boi_id is not None:
      segs.append(self.lookup_token(self.boi_id, batch))
    seg_valid = [torch.ones(s.shape[:-1], dtype=torch.bool, device=dev)
                 for s in segs] + [txt_valid, img_valid]
    segs += [x_txt, x_img.to(x_txt.dtype)]

    idx_a, idx_b = self._segment_layout(x_txt.shape[1], x_img.shape[1], dev)
    idx = torch.where(txt_prefix[:, None], idx_a[None], idx_b[None])
    if shift:
      idx = idx[:, :-1]
    buf = torch.cat(segs, dim=1)
    x = buf.gather(1, idx[..., None].expand(*idx.shape, buf.shape[-1]))
    input_mask = torch.cat(seg_valid, dim=1).gather(1, idx)

    pos = torch.arange(idx.shape[1], device=dev)
    attn_mask = (pos[:, None] >= pos[None, :])[None]
    if not self.causal_mask_on_prefix:
      prefix_len = torch.where(txt_prefix, x_txt.shape[1] + 1,
                               x_img.shape[1] + 1)
      attn_mask = attn_mask | (pos[None, :] < prefix_len[:, None])[:, None, :]
    return x, attn_mask & input_mask[:, None, :], input_mask

  def split_image_and_text_prelogits(self, prelogits, text_first_mask,
                                     text_len, image_len):
    """Each modality's rows of the (shifted) sequence's outputs."""
    has_boi = int(self.boi_id is not None)
    txt0 = torch.where(text_first_mask, 0, image_len + has_boi)
    img0 = torch.where(text_first_mask,
                       self.num_vocab_repeats * text_len + has_boi, 0)

    def pick(start, n):
      idx = start[:, None] + torch.arange(n, device=prelogits.device)
      return prelogits.gather(1, idx[..., None].expand(
          *idx.shape, prelogits.shape[-1]))
    return pick(txt0, text_len), pick(img0, image_len)


class Joint(nn.Module):
  """The trainer's param tree as one module: JetFormer's params at the top
  and the Jet adaptor's under "params_adaptor/" (where there is one)."""

  def __init__(self, model, adaptor=None):
    super().__init__()
    self.model = model
    self.adaptor = adaptor

  @torch.no_grad()
  def initialize(self, generator, head_bias=None):
    """Draws both models' params (`Model.initialize`, `jet.Model.
    initialize`). Returns the module."""
    del head_bias
    self.model.initialize(generator)
    if self.adaptor is not None:
      self.adaptor.initialize(generator)
    return self


def load(init_params, init_files, model_params=None, dont_load=()):
  """Reads a checkpoint and merges it into `init_params` (nested dicts of
  numpy arrays in the JAX layout)."""
  del model_params
  if not isinstance(init_files, str):
    raise ValueError(f"one checkpoint path, not {init_files!r}")
  return common.merge_params(checkpoints.load_params(init_files),
                             init_params, dont_load)


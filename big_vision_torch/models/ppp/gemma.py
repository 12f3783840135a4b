"""Gemma language model: port of big_vision_tpu/models/ppp/gemma.py.

Same variants, RoPE (halves, not interleaved), RMSNorm with gain 1+scale,
MHA/MQA/GQA, logit softcaps, gated tanh-GELU MLP, and the [B, K, S, H] KV
cache. The activations are `embed_dtype` (f32) whatever the weights' dtype:
JAX promotes an f32 x bf16 product to f32, so every product here casts its
operands to the promoted type first.

The KV cache is a `KVCache` object that the caller passes in and gets back,
in place of Flax's mutable "cache" collection. Its storage is updated in
place (one slot per step), which saves a copy of the whole cache per token.
`decode_impl="flash"` sends a one-token step to the fused decode kernel K6
(ops/decode_attention.py), which reads the cache in its storage dtype,
where the JAX package's gate `decode_attention.fits` holds; elsewhere the
step takes the einsum path, as in the JAX model.

`cache_dtype="int8"` stores k and v as int8 with f32 per-(batch, head,
slot) scales (`_quant_kv`, absmax over head_dim). The scales commute
through both attention products, so they are folded into the logits and
the probabilities, never into the [B, K, S, H] operands: K6 takes them as
they are; the einsum path multiplies the f32 logits by the k-scale before
the softcap and the probabilities by the v-scale after the softmax.

`quant=True` serves int8 weights: every matmul weight is an int8 tensor
[out, in] with an f32 scale per output row [out, 1] (`<name>_scale`), the
JAX model's `_QUANT_LEAVES` carried to the port's layout by
utils/convert.py. `_dequant` converts to the activations' dtype and then
multiplies by the scale, as the JAX `_dequant` does; the embedder
dequantizes the rows it gathers and applies its row scales after the
vocab product. `quantize_params` makes that layout from a float tree in
the JAX layout, and `load` reads the JAX package's `.npz` checkpoints.

Training: `initialize(generator)` draws every parameter from scratch with
the JAX model's initializers (the einsum weights' truncated normal over
their fan-in, the embedding's normal, zero RMSNorm scales). With
`attn_impl="flash"`, a forward that is given the prefix-LM segment ids
`seg` (and no KV cache, and no logits softcap) takes the fused kernels of
ops/flash_attention.py, as the JAX model's training path does: k and v
repeated to the query heads, q multiplied by sqrt(head_dim) to cancel the
kernels' own 1/sqrt(head_dim). A `remat_policy` other than "none" runs each
block under a non-reentrant `torch.utils.checkpoint` while autograd
records: the block keeps only its input and is recomputed in the backward
(the JAX policy "nothing_saveable"; a policy that saves more in JAX
computes the same function). `dropout` is the JAX block's
`nn.Dropout(rate, dropout_bdims)` on the attention and the MLP branch
before each residual add (one mask shared along `dropout_bdims`, kept
entries scaled by 1/(1 - rate)), drawn from the `rng` a training forward
is given; without one there is no dropout, as with JAX's
`deterministic=True`. The context-parallel `attn_impl="ring"` is refused
by name.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from big_vision_torch.models import common
from big_vision_torch.ops import decode_attention as da
from big_vision_torch.ops import flash_attention as fa
from big_vision_torch.utils import checkpoints


def get_config(variant) -> dict:
  """Hyperparameter table for the released Gemma variants."""
  base = dict(variant=variant, norm_eps=1e-6, vocab_size=256_000)
  v2 = dict(final_logits_softcap=30.0, attn_logits_softcap=50.0,
            post_norms=True)
  table = {
      "gemma_2b": dict(width=2048, depth=18, mlp_dim=16_384, num_heads=8,
                       num_kv_heads=1, head_dim=256),
      "gemma_7b": dict(width=3072, depth=28, mlp_dim=24_576, num_heads=16,
                       num_kv_heads=16, head_dim=256),
      "gemma2_2b": dict(width=2304, depth=26, mlp_dim=9_216, num_heads=8,
                        num_kv_heads=4, head_dim=256, **v2),
      "gemma2_9b": dict(width=3584, depth=42, mlp_dim=14_336, num_heads=16,
                        num_kv_heads=8, head_dim=256, **v2),
      "gemma2_27b": dict(width=4608, depth=46, mlp_dim=36_864, num_heads=32,
                         num_kv_heads=16, head_dim=128,
                         query_pre_attn_norm="rsqrt_emb_per_head", **v2),
      "gemma_test": dict(width=32, depth=2, mlp_dim=64, num_heads=2,
                         num_kv_heads=1, head_dim=16, vocab_size=256),
  }
  if variant not in table:
    raise ValueError(f"Unknown gemma variant {variant!r}")
  return {**base, **table[variant]}


def apply_rope(x, *, positions, max_wavelength=10_000):
  """Rotary embedding; x [B, L, H, D], positions [B, L]."""
  d = x.shape[-1]
  freq = torch.arange(d // 2, device=x.device, dtype=torch.float32)
  inv_freq = max_wavelength ** (-2.0 * freq / d)
  angle = positions.float()[:, :, None, None] * inv_freq
  cos, sin = torch.cos(angle), torch.sin(angle)
  lo, hi = x.chunk(2, dim=-1)
  return torch.cat([lo * cos - hi * sin, hi * cos + lo * sin], dim=-1)


def _quant_kv(x):
  """Symmetric int8 per (batch, head, slot) over head_dim: (int8 values,
  f32 scales [..., 1]); the JAX package's `_quant_kv`, bit for bit."""
  x = x.float()
  scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-30) / 127.0
  return torch.round(x / scale).clamp(-127, 127).to(torch.int8), scale


def _dequant(w_q, scale, dtype):
  """int8 weight and its f32 scale -> `dtype`: the int8 values converted to
  `dtype` times the scale converted to `dtype` (the JAX `_dequant`), in one
  elementwise kernel."""
  return torch.mul(w_q, scale.to(dtype))


def _add_weights(module, quant, device, param_dtype, **shapes):
  """Registers each [out, in] matmul weight: float in `param_dtype`, or
  (quant) int8 with an f32 per-output-row scale [out, 1] named
  `<name>_scale`; neither of the two is trained."""
  for name, shape in shapes.items():
    if not quant:
      setattr(module, name, nn.Parameter(torch.empty(
          shape, device=device, dtype=param_dtype)))
      continue
    setattr(module, name, nn.Parameter(torch.empty(
        shape, device=device, dtype=torch.int8), requires_grad=False))
    setattr(module, f"{name}_scale", nn.Parameter(torch.empty(
        (shape[0], 1), device=device, dtype=torch.float32),
        requires_grad=False))


def _matmul(module, name, x):
  """x @ weight.T for the weight `name` of `module`, dequantized to x's
  dtype when it is int8."""
  w = getattr(module, name)
  if w.dtype == torch.int8:
    w = _dequant(w, getattr(module, f"{name}_scale"), x.dtype)
  return common.linear(x, w)


@dataclasses.dataclass
class KVCache:
  """Per-layer key/value storage [B, K, S, H] plus the shared write slot.

  Empty until a prefill fills it; every later step writes one slot. The
  write index is shared across the batch (prompts are right-aligned by the
  caller), as in the JAX model. An int8 cache also holds f32 per-slot
  scales [B, K, S, 1] for k and for v; unwritten slots keep scale 0.
  """
  k: list = dataclasses.field(default_factory=list)
  v: list = dataclasses.field(default_factory=list)
  k_scale: list = dataclasses.field(default_factory=list)
  v_scale: list = dataclasses.field(default_factory=list)
  idx: int = 0

  def update(self, layer, k, v, cache_size, store_dtype):
    """Writes k, v [B, T, K, H], quantized if `store_dtype` is int8.

    Returns the layer's storage tensors and, for an int8 cache, its
    (k_scale, v_scale), else None.
    """
    k, v = k.transpose(1, 2), v.transpose(1, 2)  # -> [B, K, T, H]
    quant = store_dtype == torch.int8
    if quant:
      (k, k_s), (v, v_s) = _quant_kv(k), _quant_kv(v)
      writes = [(self.k, k), (self.v, v), (self.k_scale, k_s),
                (self.v_scale, v_s)]
    else:
      writes = [(self.k, k.to(store_dtype)), (self.v, v.to(store_dtype))]
    t = k.shape[2]
    if layer == len(self.k):  # prefill: allocate and fill slots [0, t)
      for store, x in writes:
        b, kh, _, h = x.shape
        store.append(x.new_zeros((b, kh, cache_size, h)))
        store[layer][:, :, :t] = x
    else:
      if t != 1:
        raise ValueError(f"a filled cache extends one token at a time: {t}")
      for store, x in writes:
        store[layer][:, :, self.idx] = x[:, :, 0]
    scales = (self.k_scale[layer], self.v_scale[layer]) if quant else None
    return self.k[layer], self.v[layer], scales


class RMSNorm(nn.Module):
  """x * rsqrt(mean(x^2) + 1e-6) * (1 + scale)."""

  def __init__(self, width, *, device="cuda", param_dtype=torch.float32):
    super().__init__()
    self.scale = nn.Parameter(torch.empty(width, device=device,
                                          dtype=param_dtype))

  def forward(self, x):
    gain = 1 + self.scale  # in the parameter dtype, as in JAX
    mean_sq = (x * x).mean(-1, keepdim=True)
    return x * torch.rsqrt(mean_sq + 1e-6) * gain


class Embedder(nn.Module):
  """Tied input/output embedding [vocab, width]; int8 with a scale per
  vocab row [vocab, 1] under `quant`."""

  def __init__(self, vocab_size, embed_dim, quant=False, *, device="cuda",
               param_dtype=torch.float32):
    super().__init__()
    self.embed_dim = embed_dim
    self.quant = quant
    _add_weights(self, quant, device, param_dtype,
                 input_embedding=(vocab_size, embed_dim))

  def encode(self, tokens):
    x = self.input_embedding[tokens]
    if self.quant:  # the gathered rows, dequantized
      x = x.float() * self.input_embedding_scale[tokens]
    return x * torch.tensor(math.sqrt(self.embed_dim)).to(x.dtype)

  def decode(self, x):
    if not self.quant:
      return common.linear(x, self.input_embedding)
    # The int8 table converted, then the row scales after the product.
    logits = common.linear(x, self.input_embedding.to(x.dtype))
    return logits * self.input_embedding_scale[:, 0].to(x.dtype)


class Attention(nn.Module):
  """MHA / MQA / GQA with RoPE, optional softcap and a KV cache.

  Projections are stored [out, in]: `qkv` [3*H*hd, D] (MHA) or `q`
  [H*hd, D] and `kv` [2*K*hd, D]; `o` [D, H*hd].
  """

  def __init__(self, num_heads, num_kv_heads, features, head_dim,
               query_pre_attn_norm="rsqrt_head_dim", attn_logits_softcap=None,
               cache_dtype=None, attn_impl="xla", decode_impl="xla",
               quant=False, *, device="cuda", param_dtype=torch.float32):
    super().__init__()
    if decode_impl not in ("xla", "flash"):
      raise ValueError(f"Unknown decode_impl {decode_impl!r}")
    if attn_impl == "ring":
      raise NotImplementedError(
          "attn_impl='ring' (context-parallel ring attention over a device "
          "mesh) is not ported")
    self.num_heads, self.num_kv_heads = num_heads, num_kv_heads
    self.head_dim = head_dim
    self.attn_logits_softcap = attn_logits_softcap
    self.attn_impl = attn_impl
    self.decode_impl = decode_impl
    if cache_dtype == "int8":
      self.cache_dtype = torch.int8  # the quantized (scaled) layout
    else:
      self.cache_dtype = common.resolve_dtype(cache_dtype)
      if self.cache_dtype is not None and not (
          self.cache_dtype.is_floating_point):
        # An integer dtype would store the values cast to it, with no
        # scales: garbage attention. Only the string "int8" selects the
        # quantized cache, as in the JAX model.
        raise ValueError(
            f"Integer cache_dtype {cache_dtype!r} is not a storage format; "
            "pass cache_dtype='int8' to get the quantized KV cache.")
    q_scales = {"rsqrt_head_dim": head_dim,
                "rsqrt_emb_per_head": features // num_heads}
    if query_pre_attn_norm not in q_scales:
      raise ValueError(query_pre_attn_norm)
    self.query_scale = q_scales[query_pre_attn_norm] ** -0.5
    if num_heads == num_kv_heads:
      shapes = dict(qkv=(3 * num_heads * head_dim, features))
    else:
      shapes = dict(q=(num_heads * head_dim, features),
                    kv=(2 * num_kv_heads * head_dim, features))
    _add_weights(self, quant, device, param_dtype, **shapes,
                 o=(features, num_heads * head_dim))

  def forward(self, x, positions, attn_mask, cache=None, layer=0, seg=None):
    b, t, _ = x.shape
    n, kh, h = self.num_heads, self.num_kv_heads, self.head_dim
    if n != kh:
      q = _matmul(self, "q", x).reshape(b, t, n, h)
      k, v = _matmul(self, "kv", x).reshape(b, t, 2, kh, h).unbind(2)
    else:
      q, k, v = _matmul(self, "qkv", x).reshape(b, t, 3, n, h).unbind(2)

    q = apply_rope(q, positions=positions) * self.query_scale
    k = apply_rope(k, positions=positions)
    decode = cache is not None
    scales = None
    if decode:
      store = self.cache_dtype or k.dtype
      k_store, v_store, scales = cache.update(layer, k, v,
                                              attn_mask.shape[-1], store)
      # The JAX model gates its kernel on the itemsize of the cache it
      # hands over: the raw int8 store, or a float cache cast to the
      # compute dtype (k's here).
      itemsize = 1 if scales else k.element_size()
      if (self.decode_impl == "flash" and t == 1
          and da.fits(k_store.shape[2], h, itemsize)):
        # One-token step: kernel K6 reads the cache in its storage dtype.
        # Past the `fits` gate, the einsum path, as in the JAX model.
        grouped = q[:, 0].reshape(b, kh, n // kh, h).contiguous()
        ks, vs = scales or (None, None)
        mixed = da.decode_attention(
            grouped, k_store, v_store, attn_mask[:, 0, 0, :].contiguous(),
            k_scale=ks, v_scale=vs,
            logits_softcap=self.attn_logits_softcap or 0.0)
        return _matmul(self, "o", mixed.reshape(b, 1, n * h))
      # The einsum path computes on the cache cast to the compute dtype
      # (an int8 cache as its raw values; the scales fold in below).
      k, v = k_store.to(k.dtype), v_store.to(v.dtype)

    if (self.attn_impl == "flash" and not decode and seg is not None
        and not self.attn_logits_softcap):
      # The fused training path: `seg` holds the prefix-LM mask that
      # attn_mask holds. The kernels scale by 1/sqrt(head_dim); q is
      # already scaled, so that is cancelled first.
      if kh != n:
        k = k.repeat_interleave(n // kh, dim=2)  # jnp.repeat on axis 2
        v = v.repeat_interleave(n // kh, dim=2)
      qf = (q * h ** 0.5).to(v.dtype)
      mixed = fa.flash_attention(qf.contiguous(), k.contiguous(),
                                 v.contiguous(), seg=seg)
      return _matmul(self, "o", mixed.reshape(b, t, n * h))

    kv = "bksh" if decode else "bskh"
    grouped = q.reshape(b, t, kh, n // kh, h)
    logits = torch.einsum(f"btkgh,{kv}->bkgts", grouped,
                          k.to(grouped.dtype)).float()
    # Per-slot int8 scales [B, K, S, 1] -> [B, K, 1, 1, S] on the logits
    # and the probabilities.
    fold = lambda x: x[..., 0][:, :, None, None, :]
    if scales:
      logits = logits * fold(scales[0])
    if cap := self.attn_logits_softcap:
      logits = cap * torch.tanh(logits / cap)
    s = k.shape[kv.index("s")]
    if tuple(attn_mask.shape) != (b, 1, t, s):
      raise ValueError(f"Bad mask shape {tuple(attn_mask.shape)} for "
                       f"q={tuple(q.shape)} k={tuple(k.shape)}")
    big_neg = -2.3819763e38  # matches the released gemma code
    masked = torch.where(attn_mask[:, :, None], logits,
                         torch.full_like(logits, big_neg))
    probs = torch.softmax(masked, dim=-1)
    if scales:
      probs = probs * fold(scales[1])
    probs = probs.to(k.dtype)
    mixed = torch.einsum(f"bkgts,{kv}->btkgh", probs, v)
    return _matmul(self, "o", mixed.reshape(b, t, n * h))


class FeedForward(nn.Module):
  """Gated tanh-GELU MLP; `gating` [2*F, D] stacks the gate and the up
  projection, `linear` is [D, F]."""

  def __init__(self, features, hidden_dim, quant=False, *, device="cuda",
               param_dtype=torch.float32):
    super().__init__()
    _add_weights(self, quant, device, param_dtype,
                 gating=(2 * hidden_dim, features),
                 linear=(features, hidden_dim))

  def forward(self, x):
    gate, up = _matmul(self, "gating", x).chunk(2, dim=-1)
    return _matmul(self, "linear", common.gelu(gate) * up)


class Block(nn.Module):
  """Pre-norm attention + MLP, optional post-norms (Gemma-2)."""

  def __init__(self, num_heads, num_kv_heads, embed_dim, head_dim,
               hidden_dim, query_pre_attn_norm, attn_logits_softcap,
               post_norms, cache_dtype=None, attn_impl="xla",
               decode_impl="xla", quant=False, dropout=0.0,
               dropout_bdims=(), *, device="cuda",
               param_dtype=torch.float32):
    super().__init__()
    kw = dict(device=device, param_dtype=param_dtype)
    self.dropout, self.dropout_bdims = dropout, tuple(dropout_bdims)
    self.pre_attention_norm = RMSNorm(embed_dim, **kw)
    self.pre_ffw_norm = RMSNorm(embed_dim, **kw)
    self.post_norms = post_norms
    if post_norms:
      self.post_attention_norm = RMSNorm(embed_dim, **kw)
      self.post_ffw_norm = RMSNorm(embed_dim, **kw)
    self.attn = Attention(num_heads, num_kv_heads, embed_dim, head_dim,
                          query_pre_attn_norm, attn_logits_softcap,
                          cache_dtype, attn_impl, decode_impl, quant, **kw)
    self.mlp = FeedForward(embed_dim, hidden_dim, quant, **kw)

  def forward(self, x, positions, attn_mask, cache=None, layer=0, seg=None,
              rng=None):
    drop = lambda y: common.dropout(y, self.dropout, rng, self.dropout_bdims)
    y = self.attn(self.pre_attention_norm(x), positions, attn_mask, cache,
                  layer, seg)
    if self.post_norms:
      y = self.post_attention_norm(y)
    x = x + drop(y)
    y = drop(self.mlp(self.pre_ffw_norm(x)))
    if self.post_norms:
      y = self.post_ffw_norm(y)
    return x + y


def prep_positions_mask(x, positions, mask, decode):
  """Default positions/mask and normalize mask to [B, 1, T, cache]."""
  b, t, _ = x.shape
  if decode and (positions is None or mask is None):
    raise ValueError("decoding requires explicit positions and mask")
  if positions is None:
    positions = torch.arange(t, device=x.device)[None, :]
  if mask is None:
    mask = torch.tril(torch.ones((b, 1, t, t), dtype=torch.bool,
                                 device=x.device))
  elif mask.dim() == 3:
    mask = mask[:, None]
  cache_size = max(t, mask.shape[-1])
  if positions.shape[1] != t or tuple(mask.shape) != (b, 1, t, cache_size):
    raise ValueError(f"positions {tuple(positions.shape)} / mask "
                     f"{tuple(mask.shape)} do not fit x {tuple(x.shape)}")
  return positions, mask


class Model(nn.Module):
  """Gemma decoder-only LM.

  `forward(tokens, ...)` returns (logits, out) like the JAX model; passing
  a `KVCache` as `cache` runs in decode mode and updates it in place.
  `scan` shapes only the JAX param layout (utils/convert.py reads both);
  `remat_policy` and `attn_impl` are described in the module docstring.
  """

  def __init__(self, variant, width, depth, mlp_dim, num_heads,
               num_kv_heads, head_dim, norm_eps, vocab_size,
               query_pre_attn_norm="rsqrt_head_dim",
               final_logits_softcap=0.0, attn_logits_softcap=0.0,
               post_norms=False, dropout=0.0, dropout_bdims=(),
               cache_dtype=None, embed_dtype="float32", scan=False,
               remat_policy="none", attn_impl="xla", decode_impl="xla",
               quant=False, *, device="cuda", param_dtype=torch.float32):
    super().__init__()
    del variant, norm_eps, scan  # norm eps is fixed at 1e-6, as in JAX
    kw = dict(device=device, param_dtype=param_dtype)
    self.embed_dtype = common.resolve_dtype(embed_dtype)
    self.final_logits_softcap = final_logits_softcap
    self.remat_policy = remat_policy
    self.embedder = Embedder(vocab_size, width, quant, **kw)
    self.layers = nn.ModuleList([
        Block(num_heads, num_kv_heads, width, head_dim, mlp_dim,
              query_pre_attn_norm, attn_logits_softcap, post_norms,
              cache_dtype, attn_impl, decode_impl, quant, dropout,
              dropout_bdims, **kw)
        for _ in range(depth)])
    self.final_norm = RMSNorm(width, **kw)

  @torch.no_grad()
  def initialize(self, generator):
    """Draws every parameter as the JAX model's `init` does: the embedding
    N(0, 1/width) (flax's variance_scaling "fan_in" "normal"), every
    matmul weight flax's truncated normal of variance 1/fan_in (its
    [out, in] matrix's `in`: the JAX einsum's contracted axes), the
    RMSNorm scales zero. Returns the module."""
    if self.embedder.quant:
      raise ValueError("int8 weights are not drawn: quantize or load them")
    for name, p in self.named_parameters():
      if name == "embedder.input_embedding":
        common.init(p, ("normal", p.shape[1] ** -0.5), generator)
      elif p.dim() == 2:
        common.init(p, "lecun_normal", generator, fan_in=p.shape[1])
      else:
        common.init(p, "zeros", generator)
    return self

  def embed(self, tokens=None, embedded_prefix=None):
    """Concatenates prefix embeddings and token embeddings, as embed_dtype."""
    parts = []
    if embedded_prefix is not None:
      parts.append(embedded_prefix)
    if tokens is not None:
      parts.append(self.embedder.encode(tokens))
    return torch.cat([p.to(self.embed_dtype) for p in parts], dim=-2)

  def trunk(self, tokens=None, *, embedded_prefix=None, positions=None,
            mask=None, cache=None, seg=None, rng=None):
    """Runs the blocks and the final norm; returns the `out` dict with
    "encoded" and "pre_logits" (no vocab projection). `seg` [B, T] (the
    prefix-LM segment ids) sends attention to the fused kernels where
    `attn_impl` is "flash"; `rng` draws the dropout masks in training."""
    x = self.embed(tokens, embedded_prefix)
    positions, mask = prep_positions_mask(x, positions, mask,
                                          cache is not None)
    remat = (self.remat_policy != "none" and cache is None
             and torch.is_grad_enabled())
    for i, block in enumerate(self.layers):
      if remat:
        x = common.checkpointed(block, x, positions, mask, None, i, seg,
                                rng=rng)
      else:
        x = block(x, positions, mask, cache, i, seg, rng)
    if cache is not None:
      cache.idx += x.shape[1]
    out = {"encoded": x}
    out["pre_logits"] = self.final_norm(x)
    return out

  def logits(self, pre_logits):
    x = self.embedder.decode(pre_logits)
    if cap := self.final_logits_softcap:
      x = cap * torch.tanh(x / cap)
    return x

  def forward(self, tokens=None, *, embedded_prefix=None, embed_only=False,
              pre_logits=None, positions=None, mask=None, cache=None,
              seg=None, rng=None):
    """Embed-only, logits-from-pre-logits, or the full forward.

    As in JAX, logits from `pre_logits` skip the final softcap.
    """
    if pre_logits is not None:
      logits = self.embedder.decode(pre_logits)
      return logits, {"pre_logits": pre_logits, "logits": logits}
    if embed_only:
      return self.embed(tokens, embedded_prefix)
    out = self.trunk(tokens, embedded_prefix=embedded_prefix,
                     positions=positions, mask=mask, cache=cache, seg=seg,
                     rng=rng)
    out["logits"] = self.logits(out["pre_logits"])
    return out["logits"], out


# (parent module, leaf) of the JAX layout -> (the einsum's contracted axes,
# the scale's leaf name): the JAX package's `_QUANT_LEAVES`. The axes are
# negative, so one rule covers the pyloop and the scan layout.
_QUANT_LEAVES = {
    ("qkv_einsum", "w"): ((-2,), "w_scale"),
    ("q_einsum", "w"): ((-2,), "w_scale"),
    ("kv_einsum", "w"): ((-2,), "w_scale"),
    ("attn_vec_einsum", "w"): ((-3, -2), "w_scale"),
    ("mlp", "gating_einsum"): ((-2,), "gating_einsum_scale"),
    ("mlp", "linear"): ((-2,), "linear_scale"),
    ("embedder", "input_embedding"): ((-1,), "input_embedding_scale"),
}


def _flatten_in_order(tree, prefix=()):
  """[(path, leaf)] in the dicts' insertion order, as flax's flatten_dict."""
  out = []
  for k, v in tree.items():
    if isinstance(v, dict):
      out += _flatten_in_order(v, prefix + (k,))
    else:
      out.append((prefix + (k,), v))
  return out


def _unflatten(items):
  out = {}
  for path, v in items:
    node = out
    for k in path[:-1]:
      node = node.setdefault(k, {})
    node[path[-1]] = v
  return out


def _quantize(w, axes):
  """Symmetric absmax int8 over `axes`: (int8 values, f32 scales with the
  axes kept as 1), for a numpy array or a tensor, with the JAX recipe."""
  if isinstance(w, torch.Tensor):
    w = w.float()
    scale = w.abs().amax(dim=axes, keepdim=True).clamp_min(1e-30) / 127.0
    return torch.round(w / scale).clamp(-127, 127).to(torch.int8), scale
  w = np.asarray(w, np.float32)
  scale = np.maximum(np.abs(w).max(axis=axes, keepdims=True),
                     np.float32(1e-30)) / np.float32(127.0)
  return np.clip(np.round(w / scale), -127, 127).astype(np.int8), scale


def quantize_params(params):
  """Float Gemma params (the JAX layout, either layer layout; numpy arrays
  or tensors) -> the int8 + per-output-channel-scale layout of
  `Model(quant=True)`, bit for bit the JAX package's `quantize_params`.

  Absmax over the contracted axes, scale max(absmax, 1e-30) / 127, values
  rounded half to even and clipped to +-127. Leaves are visited in the
  tree's insertion order, as JAX visits them, so an already-quantized tree
  is treated as it is there.
  """
  out, n_quant = [], 0
  for path, w in _flatten_in_order(params):
    rule = _QUANT_LEAVES.get((path[-2] if len(path) > 1 else "", path[-1]))
    if rule is None:
      out.append((path, w))
      continue
    contract, scale_name = rule
    axes = tuple(a % w.ndim for a in contract)
    q, scale = _quantize(w, axes)
    out += [(path, q), (path[:-1] + (scale_name,), scale)]
    n_quant += 1
  if not n_quant:
    raise ValueError("quantize_params: no quantizable gemma weights found")
  # A later entry of a path overwrites an earlier one, as in a dict.
  return _unflatten(out)


def _is_pyloop(p):
  return isinstance(p.get("layers"), dict) and "0" in p["layers"]


def _map(fn, tree):
  return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
          for k, v in tree.items()}


def _stack(xs):
  return torch.stack(xs) if isinstance(xs[0], torch.Tensor) else np.stack(xs)


def scan_to_pyloop(params):
  """Stacked scan layout (`layers/...` with a leading depth axis) ->
  per-layer `layers/{i}/...`."""
  params = dict(params)
  stacked = params.pop("layers")
  depth = len(next(iter(_flatten_in_order(stacked)))[1])
  params["layers"] = {str(i): _map(lambda x, i=i: x[i], stacked)
                      for i in range(depth)}
  return params


def pyloop_to_scan(params):
  """Inverse of `scan_to_pyloop`."""
  params = dict(params)
  per_layer = params.pop("layers")
  depth = 1 + max(int(k) for k in per_layer)
  layers = [_flatten_in_order(per_layer[str(i)]) for i in range(depth)]
  params["layers"] = _unflatten(
      (path, _stack([layer[j][1] for layer in layers]))
      for j, (path, _) in enumerate(layers[0]))
  return params


def _any_int8(tree):
  return any(str(x.dtype) in ("int8", "torch.int8")
             for _, x in _flatten_in_order(tree))


def load(init_params, init_file, model_cfg=None, dont_load=()):
  """Loads a Gemma `.npz` checkpoint (`file.npz` or `file.npz:subtree`) in
  the JAX layout, as the JAX package's `load` does.

  The vocab is extended to `model_cfg["vocab_size"]` with new rows drawn
  from numpy's global RNG (refused for int8 rows); the layer layout is
  converted to the target's (per-layer unless `init_params` has the
  stacked form, or `model_cfg["scan"]` without `init_params`); a float
  checkpoint is quantized into an int8 target (`init_params` with int8
  leaves, e.g. `utils.convert.gemma_params` of a `quant=True` model), and
  an int8 checkpoint is refused for a float target. Orbax directories
  (the published Gemma releases) are refused: the port reads `.npz` only.
  """
  model_cfg = dict(model_cfg or {})
  if not (isinstance(init_file, str)
          and (init_file.endswith(".npz") or ".npz:" in init_file)):
    raise ValueError(
        f"{init_file!r} is not an .npz file: the port reads Gemma "
        "checkpoints in the JAX package's .npz layout only (orbax "
        "directories are not supported).")
  params = checkpoints.load_params(init_file)

  def extend_rows(emb, target_rows):
    missing = target_rows - emb.shape[0]
    if missing == 0:
      return emb
    if missing < 0:
      raise ValueError("Can't shrink the vocab")
    if not np.issubdtype(np.asarray(emb).dtype, np.floating):
      raise ValueError(
          "vocab_size extension needs a float checkpoint; extend rows "
          "BEFORE quantization (tools/quantize_ckpt.py), not after.")
    new = (np.random.randn(missing, emb.shape[1]) * 0.02).astype(emb.dtype)
    return np.concatenate([np.asarray(emb), new])

  if "vocab_size" in model_cfg:
    params["embedder"]["input_embedding"] = extend_rows(
        params["embedder"]["input_embedding"], model_cfg["vocab_size"])

  if init_params is not None and "layers" in init_params:
    target_pyloop = _is_pyloop(init_params)
  else:
    target_pyloop = not model_cfg.get("scan", False)
  if _is_pyloop(params) != target_pyloop:
    params = (scan_to_pyloop(params) if target_pyloop
              else pyloop_to_scan(params))

  if init_params is not None and _any_int8(init_params) \
      and not _any_int8(params):
    params = quantize_params(params)
  if init_params is not None and _any_int8(params) \
      and not _any_int8(init_params):
    raise ValueError(
        "Loading an int8-quantized checkpoint into a float (quant=False) "
        "model; build the model with quant=True, or re-export the "
        "checkpoint in float.")
  return common.merge_params(params, init_params, dont_load)

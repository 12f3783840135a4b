"""Attention ops: one call site, selectable implementation.

Port of big_vision_tpu/ops/attention.py. `dot_product_attention(q, k, v)`
takes [B, T, H, D] tensors. Implementations:
  * "xla"   - the plain math path, with the exact semantics of the JAX
              package's `_xla_attention` (the name is kept so configs carry
              over unchanged).
  * "flash" - the fused kernels (ops/flash_attention.py): K1/K2 where
              `oneshot_fits`, the blocked K3-K5 elsewhere; their plain
              versions on a CPU tensor.
  * "auto"  - the JAX package's decision, copied: "flash" only where
              `_kernel_ok` holds (`supports`, then `oneshot_fits` or scores
              over `XLA_SCORES_BYTES_LIMIT`) and there is no boolean mask,
              "xla" otherwise. So FlexiViT-B at batch 32 runs the plain
              path at seqhw 30 and 40 unless a config asks for "flash".

The gate's numbers were sized for a TPU; the port keeps them so that both
packages compute the same function for the same config. Ring attention is
not ported yet.
"""

from __future__ import annotations

import math

import torch
from torch.utils import checkpoint

from big_vision_torch.ops import flash_attention

# Past this many bytes of bf16 scores [B, H, T, T] on one device, "auto"
# takes the O(T)-memory blocked kernels (the JAX package's limit).
XLA_SCORES_BYTES_LIMIT = 2 * 1024**3


def _kernel_ok(t, d, b, h):
  """The JAX package's auto-dispatch policy with a batch-shard factor of 1
  (one GPU, no mesh): the one-shot kernels wherever `oneshot_fits`, the
  blocked ones only where the plain path's scores would pass the limit."""
  if not flash_attention.supports(t, d):
    return False
  return (flash_attention.oneshot_fits(t, t, d)
          or max(b, 1) * h * t * t * 2 > XLA_SCORES_BYTES_LIMIT)


def _xla_core(q, k, v, mask=None):
  """Plain attention; q,k,v: [B, T, H, D] -> [B, T, H, D].

  q is pre-scaled in its own dtype, logits are f32, masked logits -1e30,
  softmax in f32, weights cast to v's dtype before the second product.
  """
  q = q * torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype)
  logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
  if mask is not None:
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
  weights = torch.softmax(logits, dim=-1).to(v.dtype)
  # Low-precision products accumulate in f32 and round once, as in JAX.
  return torch.einsum("bhqk,bkhd->bqhd", weights.float(),
                      v.float()).to(v.dtype)


def _xla_attention(q, k, v, mask=None):
  """`_xla_core`; where autograd records, under a non-reentrant checkpoint,
  which keeps q, k, v (and the mask) for the backward in place of the f32
  [B, H, Tq, Tkv] probabilities and recomputes them there: the same
  numbers, and 44 GiB less memory over FlexiViT-B's 12 layers at seqhw 40
  and batch 32 in f32."""
  if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
    return checkpoint.checkpoint(_xla_core, q, k, v, mask,
                                 use_reentrant=False,
                                 preserve_rng_state=False)
  return _xla_core(q, k, v, mask)


def dot_product_attention(q, k, v, mask=None, impl="auto", seg=None):
  """Multi-head attention core; shapes [B, T, H, D] (Tq may differ).

  `mask` is broadcastable to [B, H, Tq, Tkv], True = attend. `seg` is a
  [B, T] int encoding of the same (0 = padding; j attendable from i iff
  0 < seg[j] <= seg[i]) that the fused kernel consumes directly; pass one
  or the other, not both.
  """
  if impl not in ("auto", "flash", "xla"):
    raise ValueError(f"Unknown attention impl {impl!r}")
  b, t, h, d = q.shape
  if seg is not None:
    if mask is not None:
      raise ValueError("pass mask or seg, not both")
    if impl == "auto" and t == k.shape[1] and _kernel_ok(t, d, b, h):
      impl = "flash"
    if impl == "flash":
      return flash_attention.flash_attention(q, k, v, seg=seg)
    mask = ((seg[:, None, None, :] > 0)
            & (seg[:, None, None, :] <= seg[:, None, :, None]))
    return _xla_attention(q, k, v, mask)
  if impl == "auto":
    impl = "flash" if mask is None and _kernel_ok(t, d, b, h) else "xla"
  if impl == "flash" and mask is None:
    return flash_attention.flash_attention(q, k, v)
  # A boolean mask is not a kernel input (use `seg` for padding and
  # prefix-LM structure): it takes the math path, never dropped.
  return _xla_attention(q, k, v, mask)

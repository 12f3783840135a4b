"""Attention ops: one call site, selectable implementation.

Port of big_vision_tpu/ops/attention.py. `dot_product_attention(q, k, v)`
takes [B, T, H, D] tensors. Implementations:
  * "xla"   - the plain math path, with the exact semantics of the JAX
              package's `_xla_attention` (the name is kept so configs carry
              over unchanged).
  * "flash" - the fused kernel K1 (ops/flash_attention.py); its plain
              version on a CPU tensor.
  * "auto"  - "flash" whenever there is no boolean mask.

The TPU package gates "auto" on VMEM budgets (`_kernel_ok`, `oneshot_fits`,
`XLA_SCORES_BYTES_LIMIT`). Those gates are not ported: the Hopper kernel
takes any T and any D <= 256. Ring attention is not ported yet.
"""

from __future__ import annotations

import math

import torch

from big_vision_torch.ops import flash_attention


def _xla_attention(q, k, v, mask=None):
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


def dot_product_attention(q, k, v, mask=None, impl="auto", seg=None):
  """Multi-head attention core; shapes [B, T, H, D] (Tq may differ).

  `mask` is broadcastable to [B, H, Tq, Tkv], True = attend. `seg` is a
  [B, T] int encoding of the same (0 = padding; j attendable from i iff
  0 < seg[j] <= seg[i]) that the fused kernel consumes directly; pass one
  or the other, not both.
  """
  if impl not in ("auto", "flash", "xla"):
    raise ValueError(f"Unknown attention impl {impl!r}")
  if seg is not None:
    if mask is not None:
      raise ValueError("pass mask or seg, not both")
    if impl == "auto" and q.shape[1] == k.shape[1]:
      impl = "flash"
    if impl == "flash":
      return flash_attention.flash_attention(q, k, v, seg=seg)
    mask = ((seg[:, None, None, :] > 0)
            & (seg[:, None, None, :] <= seg[:, None, :, None]))
    return _xla_attention(q, k, v, mask)
  if impl in ("auto", "flash") and mask is None:
    return flash_attention.flash_attention(q, k, v)
  # A boolean mask is not a kernel input (use `seg` for padding and
  # prefix-LM structure): it takes the math path, never dropped.
  return _xla_attention(q, k, v, mask)

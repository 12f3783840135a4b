"""Fused attention forward: kernel K1 of the port, and its plain version.

Replaces the TPU kernel `_oneshot_fwd_kernel` with `_oneshot_softmax`
(big_vision_tpu/ops/flash_attention.py, launched by `_oneshot_fwd`). The
CUDA source is `csrc/flash_fwd.cu`; its header says how it tiles.

Bound on the card: the bytes of q, k, v and o. At the image tower's shapes
(So400m/14, batch 8: B*H=128, T=256, D=72, bf16) that is 18.9 MB, about
5.6 us at 3.35 TB/s, against 2.4 GFLOP (2.4 us on the bf16 tensor cores).
The TPU kernel held whole [T, T] f32 matrices in 16 MB of VMEM; a Hopper
block has 227 KB of shared memory, so the kernel tiles 64 query rows per
block and streams K/V through an online softmax instead. It reads q, k, v
in their [B, T, H, D] layout, so no transposes surround it.

`flash_attention` launches the kernel for a CUDA tensor (or raises) and
runs `flash_attention_reference` for a CPU tensor. Forward only: the
backward kernels (K2-K5) are not ported yet.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from big_vision_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -1e30


@functools.cache
def _lib():
  """The kernel's C entry point, built and typed once per process."""
  lib = _build.load("flash_fwd")
  fn = lib.bvt_flash_fwd
  fn.restype = ctypes.c_int
  fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
      ctypes.c_float, ctypes.c_void_p]
  return fn


def _check_inputs(q, k, v, seg):
  if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
    raise ValueError(f"want q [B,Tq,H,D], k=v [B,Tkv,H,D]; got "
                     f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
  b, tq, h, d = q.shape
  if k.shape[0] != b or k.shape[2:] != (h, d):
    raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
  if not q.dtype == k.dtype == v.dtype:
    raise ValueError(f"dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
  if seg is not None and (tq != k.shape[1] or tuple(seg.shape) != (b, tq)):
    raise ValueError(f"seg {tuple(seg.shape)} needs Tq == Tkv and [B, T]")


def flash_attention_reference(q, k, v, *, causal=False, seg=None):
  """Plain PyTorch version with the exact one-shot semantics.

  s = (q . k^T) * (1/sqrt(D)) in f32; causal keeps col <= row; `seg`
  [B, T] keeps j for i iff 0 < seg[j] <= seg[i]; masked logits are -1e30
  and masked probabilities exactly 0, so a fully masked row emits zeros;
  softmax in f32; p is cast to v's dtype before p.v; o = (p.v)/l in q's
  dtype.
  """
  _check_inputs(q, k, v, seg)
  d = q.shape[-1]
  tq, tkv = q.shape[1], k.shape[1]
  s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
      1.0 / math.sqrt(d))
  mask = None
  if causal:
    rows = torch.arange(tq, device=q.device)[:, None]
    cols = torch.arange(tkv, device=q.device)[None, :]
    mask = (cols <= rows)[None, None]
  if seg is not None:
    seg = seg.to(torch.int32)
    sm = ((seg[:, None, None, :] > 0)
          & (seg[:, None, None, :] <= seg[:, None, :, None]))
    mask = sm if mask is None else mask & sm
  if mask is not None:
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
  m = s.amax(dim=-1, keepdim=True)
  p = torch.exp(s - m)
  if mask is not None:
    p = torch.where(mask, p, torch.zeros_like(p))
  l = p.sum(dim=-1, keepdim=True)
  l = torch.where(l == 0, torch.ones_like(l), l)
  o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
  return (o / l.permute(0, 2, 1, 3)).to(q.dtype)


def flash_attention(q, k, v, *, causal=False, seg=None):
  """Fused attention; q [B, Tq, H, D], k and v [B, Tkv, H, D], D <= 256.

  `seg`: optional [B, T] int segment ids (needs Tq == Tkv): position j is
  attendable from i iff 0 < seg[j] <= seg[i]; padding is seg=0. Scales by
  1/sqrt(D). On a CUDA tensor this launches the K1 kernel and counts the
  launch in `flash_attention.launches`; on a CPU tensor it runs
  `flash_attention_reference`.
  """
  if q.device.type == "cpu":
    return flash_attention_reference(q, k, v, causal=causal, seg=seg)
  if q.device.type != "cuda":
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
  _check_inputs(q, k, v, seg)
  b, tq, h, d = q.shape
  tkv = k.shape[1]
  if q.dtype not in _DTYPES:
    raise ValueError(f"unsupported dtype {q.dtype}")
  if d > 256:
    raise ValueError(f"head dim {d} > 256")
  for name, x in (("q", q), ("k", k), ("v", v)):
    if x.device != q.device or not x.is_contiguous():
      raise ValueError(f"{name} must be contiguous on {q.device}")
  if seg is not None:
    if seg.device != q.device:
      raise ValueError(f"seg must be on {q.device}, not {seg.device}")
    seg = seg.to(torch.int32).contiguous()
  out = torch.empty_like(q)
  fn = _lib()
  err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           None if seg is None else seg.data_ptr(), _DTYPES[q.dtype], b, tq,
           tkv, h, d, int(bool(causal)), 1.0 / math.sqrt(d),
           _build.stream_ptr(q.device))
  _build.check(err, "flash_fwd")
  flash_attention.launches += 1
  return out


flash_attention.launches = 0

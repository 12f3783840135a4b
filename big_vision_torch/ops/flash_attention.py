"""Fused attention: kernels K1-K5 of the port, and the dispatch between them.

`flash_attention` computes one of two functions, as the JAX package's does
(big_vision_tpu/ops/flash_attention.py, `flash_attention`):

* one-shot, where `oneshot_fits(Tq, Tkv, D)` holds and no block size was
  passed: bf16 products with f32 sums, p rounded to v's dtype before p.v.
  K1 replaces `_oneshot_fwd_kernel` with `_oneshot_softmax` (launched by
  `_oneshot_fwd`), K2 `_oneshot_bwd_kernel` (launched by `_oneshot_bwd`);
  each is two kernels, for bf16 inputs on the tensor cores in bf16
  (`csrc/flash_fwd_tc.cu`, `csrc/flash_bwd_tc.cu`, which share
  `csrc/flash_tc_common.cuh`), for f32 inputs on the tensor cores with
  3xTF32 products (`csrc/flash_fwd.cu`, the forward template of
  `csrc/flash_tf32_fwd.cuh`; `csrc/flash_bwd.cu`; both on
  `csrc/flash_tf32_common.cuh`). On the card K1 also emits each row's
  log-sum-exp, which K2 takes instead of recomputing the row max (it sums
  each row of exp(s - lse) again, so that p sums to 1 as the plain
  version's does).
* blocked, elsewhere: q, k and v cast to f32, q scaled before q.k, every
  product in f32, the output rounded once; the backward takes
  delta = rowsum(do.o), computed outside the kernels. K3
  (`csrc/flash_blocked_fwd.cu`, the same forward template as K1's f32
  kernel with q scaled first, 3xTF32 products) replaces `_fwd_kernel`
  (launched by `_fwd`), K4a and K4b (`csrc/flash_blocked_bwd.cu`, 3xTF32
  products on `csrc/flash_tf32_common.cuh`) replace `_bwd_dq_kernel` and
  `_bwd_dkv_kernel` (launched by `_bwd`). With
  `FUSED_BLOCKED_BWD` set (off by default, as in the JAX package) and
  `fused_bwd_fits` holding, the backward is K5
  (`csrc/flash_blocked_bwd_fused.cu`, 3xTF32 products on
  `csrc/flash_tf32_common.cuh`) instead, which replaces
  `_bwd_fused_kernel` (launched by `_bwd_fused`): one recompute of the
  scores per pair of tiles, dq summed in f32 per chunk of key tiles in
  order, and the chunks' parts in key order.

Each path is one autograd Function whose forward and backward launch the
kernels on CUDA tensors and run the plain versions
(`flash_attention_reference`, `flash_attention_bwd_reference`,
`flash_attention_blocked_reference`, `flash_attention_blocked_bwd_reference`,
`flash_attention_blocked_bwd_fused_reference`) on CPU tensors. Each kernel's source says how it tiles and what bounds it
on the card; each wrapper counts its launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from big_vision_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -1e30
MAX_ONESHOT = 1024
DEFAULT_BLOCK_Q = DEFAULT_BLOCK_KV = 128
# The blocked backward: K5 where this is set and `fused_bwd_fits` holds,
# K4a + K4b otherwise (the JAX package's `FUSED_BLOCKED_BWD`, off there too).
FUSED_BLOCKED_BWD = False


def supports(t, d):
  """The JAX package's shape gate of its auto dispatch (`ops.attention`)."""
  return d <= 256 and t >= 16


# The one-shot/blocked boundary, copied from the JAX package (`_r`,
# `_oneshot_bytes`, `oneshot_fits`). It is where that package switches
# numerics, sized for a TPU core's 16 MB of VMEM, not a memory limit of
# this card: the port follows it so that both packages compute the same
# function at every shape. Retuning it for Hopper is later work.
def _r(x, m):
  return -(-x // m) * m


def _oneshot_bytes(tq, tkv, d, bwd):
  """VMEM bytes per problem at Mosaic's internal tile granularity."""
  nmats = 3 if bwd else 2
  mats = nmats * _r(tq, 8) * _r(tkv, 128) * 4
  io = (6 if bwd else 4) * (_r(tq, 16) + _r(tkv, 16)) * _r(d, 128) * 2
  return mats + io


def oneshot_fits(tq, tkv, d):
  """True where the JAX package takes the one-shot path."""
  per = _oneshot_bytes(tq, tkv, d, bwd=True)
  return max(tq, tkv) <= MAX_ONESHOT and per <= 12 * 1024 * 1024


def fused_bwd_fits(tq, tkv, d, block_q, block_kv):
  """The JAX package's gate of K5 (a VMEM budget), on the lengths padded to
  the blocks as the JAX `_bwd` receives them."""
  del tkv
  per = (2 * _r(tq, 16) * _r(d, 128) * 2     # q, do (bf16)
         + _r(tq, 8) * _r(d, 128) * 4        # dq accumulator (f32)
         + 2 * _r(tq, 128) * 4               # lse, delta
         + 2 * _r(block_kv, 16) * _r(d, 128) * 4
         + 3 * _r(block_q, 8) * _r(block_kv, 128) * 4)
  return per <= 10 * 1024 * 1024


def block_sizes(tq, tkv, block_q=None, block_kv=None):
  """The JAX `flash_attention`'s blocked-path block sizes for the given
  (or default) `block_q`, `block_kv`."""
  return (block_q or min(DEFAULT_BLOCK_Q, max(16, tq)),
          block_kv or min(DEFAULT_BLOCK_KV, max(16, tkv)))


def takes_fused_bwd(tq, tkv, d, block_q, block_kv):
  """Whether the blocked backward of this call is K5, as the JAX `_bwd`
  decides it: the flag, and the gate on T padded to the blocks."""
  return FUSED_BLOCKED_BWD and fused_bwd_fits(
      _r(tq, block_q), _r(tkv, block_kv), d, block_q, block_kv)


# K1's two kernels, by input dtype: bf16 on the tensor cores in bf16, f32 on
# the tensor cores with 3xTF32 products (f32 to about 2^-20 per product).
FWD_KERNELS = {torch.bfloat16: "flash_fwd_tc", torch.float32: "flash_fwd"}


def fwd_kernel(dtype):
  """The name of the K1 kernel (its source in csrc/) that takes `dtype`."""
  if dtype not in FWD_KERNELS:
    raise ValueError(f"K1 takes {sorted(map(str, FWD_KERNELS))}, not {dtype}")
  return FWD_KERNELS[dtype]


@functools.cache
def _fwd_lib(name):
  """The C entry point of K1's kernel `name`, built and typed once per
  process."""
  fn = getattr(_build.load(name), f"bvt_{name}")
  fn.restype = ctypes.c_int
  fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
      ctypes.c_float, ctypes.c_void_p]
  return fn


# K2's two kernels, by input dtype: bf16 on the tensor cores in bf16, f32 on
# the tensor cores with 3xTF32 products (f32 to about 2^-20 per product).
BWD_KERNELS = {torch.bfloat16: "flash_bwd_tc", torch.float32: "flash_bwd"}


def bwd_kernel(dtype):
  """The name of the K2 kernel (its source in csrc/) that takes `dtype`."""
  if dtype not in BWD_KERNELS:
    raise ValueError(f"K2 takes {sorted(map(str, BWD_KERNELS))}, not {dtype}")
  return BWD_KERNELS[dtype]


@functools.cache
def _bwd_lib(name):
  """The C entry point of K2's kernel `name`, built and typed once per
  process. The f32 kernel also takes its key tiles per block and D padded."""
  fn = getattr(_build.load(name), f"bvt_{name}")
  fn.restype = ctypes.c_int
  tail = [ctypes.c_int] * 2 if name == "flash_bwd" else []
  fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
      ctypes.c_float] + tail + [ctypes.c_void_p]
  return fn


@functools.cache
def _tc_scratch():
  """The tensor-core K2's dq scratch size, in floats per (batch, head)."""
  fn = _build.load("flash_bwd_tc").bvt_flash_bwd_tc_scratch
  fn.restype = ctypes.c_longlong
  fn.argtypes = [ctypes.c_int, ctypes.c_int]
  return fn


@functools.cache
def _blocked_fwd_lib():
  """K3's C entry point, built and typed once per process."""
  fn = _build.load("flash_blocked_fwd").bvt_flash_blocked_fwd
  fn.restype = ctypes.c_int
  fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
      ctypes.c_float, ctypes.c_void_p]
  return fn


@functools.cache
def _blocked_bwd_lib(which):
  """K4a's (`which`="dq") or K4b's ("dkv") C entry point."""
  fn = getattr(_build.load("flash_blocked_bwd"), f"bvt_flash_blocked_{which}")
  fn.restype = ctypes.c_int
  fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
      ctypes.c_float, ctypes.c_void_p]
  return fn


@functools.cache
def _blocked_bwd_fused_lib():
  """K5's C entry point, built and typed once per process."""
  fn = _build.load("flash_blocked_bwd_fused").bvt_flash_blocked_bwd_fused
  fn.restype = ctypes.c_int
  fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
      ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
  return fn


# The 3xTF32 backward kernels (K2 for f32, K5; csrc/flash_tf32_common.cuh)
# walk key tiles of TF32_KEY_TILE keys, with D zero-padded (`tf32_dpad`). A
# block takes a chunk of `key_tiles_per_block` key tiles of one (batch,
# head) and sums its chunk's dq in its own f32 part; a second kernel sums
# the parts in key order. One key tile per block measured fastest at
# FlexiViT-B's shapes on the H100 (tools/kernel_timing.py times them), but
# the parts, [chunks, B*H, Tq, D] f32, then take as much memory as the f32
# scores that a fused kernel exists to avoid. So chunks are capped at
# TF32_PARTS_BYTES of parts: the 2 GiB that the JAX package's attention
# gate allows a score matrix (`XLA_SCORES_BYTES_LIMIT`).
TF32_KEY_TILE, TF32_PARTS_BYTES = 64, 2 * 1024**3


def tf32_dpad(d):
  """D zero-padded as the 3xTF32 kernels pad it."""
  return 32 if d <= 32 else 64 if d <= 64 else 128 if d <= 128 else 256


def key_tiles_per_block(bh, tq, tkv, d):
  """Key tiles per block of the 3xTF32 backward kernels for B*H = `bh`
  heads of `tq` queries and `tkv` keys: one, unless the dq parts would
  pass TF32_PARTS_BYTES."""
  nk = -(-tkv // TF32_KEY_TILE)
  chunks = min(nk, max(1, TF32_PARTS_BYTES // (bh * tq * tf32_dpad(d) * 4)))
  return -(-nk // chunks)


def tf32_dq_parts_shape(bh, tq, tkv, d, key_tiles):
  """The f32 dq scratch of the 3xTF32 backward kernels: one part per chunk
  of `key_tiles` key tiles, [chunks, B*H, Tq, tf32_dpad(D)]."""
  if not isinstance(key_tiles, int) or key_tiles < 1:
    raise ValueError(f"key_tiles must be a positive int, not {key_tiles!r}")
  nk = -(-tkv // TF32_KEY_TILE)
  return -(-nk // key_tiles), bh, tq, tf32_dpad(d)


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


def _check_cuda(named, seg):
  """Device, dtype, head dim and layout checks before a kernel launch."""
  q = named[0][1]
  if q.dtype not in _DTYPES:
    raise ValueError(f"unsupported dtype {q.dtype}")
  if q.shape[-1] > 256:
    raise ValueError(f"head dim {q.shape[-1]} > 256")
  for name, x in named:
    if x.device != q.device or not x.is_contiguous():
      raise ValueError(f"{name} must be contiguous on {q.device}")
  if seg is None:
    return None
  if seg.device != q.device:
    raise ValueError(f"seg must be on {q.device}, not {seg.device}")
  return seg.to(torch.int32).contiguous()


def _mask(tq, tkv, causal, seg, device):
  """Bool [B or 1, 1, Tq, Tkv] (True = visible), or None for no mask.

  causal keeps col <= row; `seg` keeps j for i iff 0 < seg[j] <= seg[i].
  """
  mask = None
  if causal:
    rows = torch.arange(tq, device=device)[:, None]
    cols = torch.arange(tkv, device=device)[None, :]
    mask = (cols <= rows)[None, None]
  if seg is not None:
    seg = seg.to(torch.int32)
    sm = ((seg[:, None, None, :] > 0)
          & (seg[:, None, None, :] <= seg[:, None, :, None]))
    mask = sm if mask is None else mask & sm
  return mask


def _masked_probs(q, k, causal, seg):
  """[B, H, Tq, Tkv] f32 probabilities p = exp(s - m) / l and the mask.

  s = (q . k^T) / sqrt(D) in f32; causal keeps col <= row; `seg` keeps j
  for i iff 0 < seg[j] <= seg[i]; masked logits are -1e30 and masked
  probabilities exactly 0, so a fully masked row is all zeros.
  """
  s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
      1.0 / math.sqrt(q.shape[-1]))
  mask = _mask(q.shape[1], k.shape[1], causal, seg, q.device)
  if mask is not None:
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
  m = s.amax(dim=-1, keepdim=True)
  p = torch.exp(s - m)
  if mask is not None:
    p = torch.where(mask, p, torch.zeros_like(p))
  l = p.sum(dim=-1, keepdim=True)
  return p, m, torch.where(l == 0, torch.ones_like(l), l)


def flash_attention_reference(q, k, v, *, causal=False, seg=None):
  """Plain PyTorch forward with the exact one-shot semantics.

  Probabilities as `_masked_probs`; the unnormalized p is cast to v's dtype
  before p.v; o = (p.v)/l in q's dtype.
  """
  _check_inputs(q, k, v, seg)
  p, _, l = _masked_probs(q, k, causal, seg)
  o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
  return (o / l.permute(0, 2, 1, 3)).to(q.dtype)


def flash_attention_lse_reference(q, k, v, *, causal=False, seg=None):
  """Plain PyTorch row log-sum-exp [B*H, Tq] f32 that K1 emits beside o
  (and K2 takes): m + log(l) of `_masked_probs`, -1e30 for a row with no
  visible key."""
  _check_inputs(q, k, v, seg)
  _, m, l = _masked_probs(q, k, causal, seg)
  return _lse_rows(m + torch.log(l))


def flash_attention_bwd_reference(q, k, v, do, *, causal=False, seg=None):
  """Plain PyTorch backward with the exact semantics of `_oneshot_bwd_kernel`.

  p normalized by l (f32) and cast to v's dtype for dv = p^T.do; dp =
  do.v^T in f32; delta = rowsum(p.dp); ds = p (dp - delta) cast to q's
  dtype; dq = ds.k * scale and dk = ds^T.q * scale. Products accumulate in
  f32; outputs are in the inputs' dtypes. Masked entries are exact zeros.
  """
  _check_inputs(q, k, v, seg)
  scale = 1.0 / math.sqrt(q.shape[-1])
  p, _, l = _masked_probs(q, k, causal, seg)
  p = p / l
  dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), do.float())
  dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
  delta = (p * dp).sum(dim=-1, keepdim=True)
  ds = (p * (dp - delta)).to(q.dtype).float()
  dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
  dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
  return ((dq * scale).to(q.dtype), (dk * scale).to(k.dtype),
          dv.to(v.dtype))


def _blocked_scores(q, k, causal, seg):
  """(q * scale in f32, s = (q * scale) . k^T [B, H, Tq, Tkv] f32, mask)."""
  qs = q.float() * (1.0 / math.sqrt(q.shape[-1]))
  s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
  return qs, s, _mask(q.shape[1], k.shape[1], causal, seg, q.device)


def _lse_rows(x):
  """[B, H, Tq, 1] -> the kernels' [B*H, Tq] layout."""
  return x[..., 0].reshape(-1, x.shape[2])


def flash_attention_blocked_reference(q, k, v, *, causal=False, seg=None):
  """Plain PyTorch forward with the exact semantics of `_fwd_kernel`.

  q, k and v cast to f32 and q scaled by 1/sqrt(D) before s = q.k^T; the
  masks as `_mask`, masked logits -1e30 and masked probabilities exactly
  0; o = (p.v) / l in f32, rounded once to q's dtype; the row log-sum-exp
  m + log(l) ([B*H, Tq] f32; -1e30 for a row with no visible key, whose
  o is 0). The blocked kernel's online softmax computes the same sums in
  another order. Returns (o, lse).
  """
  _check_inputs(q, k, v, seg)
  _, s, mask = _blocked_scores(q, k, causal, seg)
  if mask is not None:
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
  m = s.amax(dim=-1, keepdim=True)
  p = torch.exp(s - m)
  if mask is not None:
    p = torch.where(mask, p, torch.zeros_like(p))
  l = p.sum(dim=-1, keepdim=True)
  l = torch.where(l == 0, torch.ones_like(l), l)
  o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
  o = (o / l.permute(0, 2, 1, 3)).to(q.dtype)
  return o, _lse_rows(m + torch.log(l))


def blocked_delta(o, do):
  """delta = rowsum(do . o) in f32 from o in its stored dtype, as the JAX
  `_bwd` computes it outside its kernels; [B*H, Tq]."""
  b, tq, h, _ = o.shape
  delta = (do.float() * o.float()).sum(-1)  # [B, Tq, H]
  return delta.permute(0, 2, 1).reshape(b * h, tq).contiguous()


def _blocked_probs(q, k, v, lse, delta, do, causal, seg):
  """(q * scale, p, ds) [B, H, Tq, Tkv] f32 of the blocked backward."""
  b, tq, h, _ = q.shape
  qs, s, mask = _blocked_scores(q, k, causal, seg)
  p = torch.exp(s - lse.reshape(b, h, tq, 1))
  if mask is not None:  # a masked row's lse is -1e30: exp overflows there
    p = torch.where(mask, p, torch.zeros_like(p))
  dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
  return qs, p, p * (dp - delta.reshape(b, h, tq, 1))


def flash_attention_blocked_dq_reference(q, k, v, do, lse, delta, *,
                                         causal=False, seg=None):
  """Plain PyTorch dq with the exact semantics of `_bwd_dq_kernel` (K4a);
  arguments as `flash_attention_blocked_dq`. See
  `flash_attention_blocked_bwd_reference`."""
  _check_inputs(q, k, v, seg)
  _, _, ds = _blocked_probs(q, k, v, lse, delta, do, causal, seg)
  dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
  return (dq * (1.0 / math.sqrt(q.shape[-1]))).to(q.dtype)


def flash_attention_blocked_dkv_reference(q, k, v, do, lse, delta, *,
                                          causal=False, seg=None):
  """Plain PyTorch (dk, dv) with the exact semantics of `_bwd_dkv_kernel`
  (K4b); arguments as `flash_attention_blocked_dkv`."""
  _check_inputs(q, k, v, seg)
  qs, p, ds = _blocked_probs(q, k, v, lse, delta, do, causal, seg)
  dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
  dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
  return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_blocked_bwd_reference(q, k, v, o, lse, do, *,
                                          causal=False, seg=None):
  """Plain PyTorch backward with the exact semantics of `_bwd_dq_kernel`
  and `_bwd_dkv_kernel`; returns (dq, dk, dv).

  `o` and `lse` are the forward's. In f32: delta as `blocked_delta`;
  p = exp(s - lse) where visible, exactly 0 where masked (a masked row's
  lse is -1e30, so the mask must be applied, not only the exponential);
  dp = do.v^T; ds = p (dp - delta); dq = ds.k * scale in q's dtype;
  dk = ds^T.(q * scale) in k's dtype; dv = p^T.do in v's dtype.
  """
  delta = blocked_delta(o, do)
  kw = dict(causal=causal, seg=seg)
  dq = flash_attention_blocked_dq_reference(q, k, v, do, lse, delta, **kw)
  return (dq, *flash_attention_blocked_dkv_reference(q, k, v, do, lse, delta,
                                                     **kw))


def flash_attention_blocked_bwd_fused_reference(q, k, v, o, lse, do, *,
                                                causal=False, seg=None,
                                                block_kv=None, chunk_keys=None):
  """Plain PyTorch backward with the semantics of `_bwd_fused_kernel` (K5);
  returns (dq, dk, dv).

  As `flash_attention_blocked_bwd_reference`, but dq is summed in f32 as
  the K5 kernel groups it: each key tile's ds.k (tiles of `block_kv` keys,
  default TF32_KEY_TILE) multiplied by scale, summed in key order within
  each chunk of `chunk_keys` keys (default: the kernel's chunk at this
  shape, `key_tiles_per_block`), the chunks' parts summed in key order, and
  rounded to q's dtype once. The JAX kernel sums over its `block_kv` grid
  blocks in one sequence instead, which is this grouping with one chunk (a
  difference of rounding only).
  """
  _check_inputs(q, k, v, seg)
  b, _, h, d = q.shape
  tkv = k.shape[1]
  block_kv = block_kv or TF32_KEY_TILE
  chunk_keys = chunk_keys or TF32_KEY_TILE * key_tiles_per_block(
      b * h, q.shape[1], tkv, d)
  scale = 1.0 / math.sqrt(d)
  delta = blocked_delta(o, do)
  qs, p, ds = _blocked_probs(q, k, v, lse, delta, do, causal, seg)
  dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
  dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
  dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
  kf = k.float()
  for c0 in range(0, tkv, chunk_keys):
    c1 = min(c0 + chunk_keys, tkv)
    part = torch.zeros_like(dq)
    for j in range(c0, c1, block_kv):
      j1 = min(j + block_kv, c1)
      part = part + torch.einsum("bhqk,bkhd->bqhd", ds[..., j:j1],
                                 kf[:, j:j1]) * scale
    dq = dq + part
  return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_forward(q, k, v, *, causal=False, seg=None):
  """K1 on CUDA tensors: (o, row log-sum-exp [B*H, Tq] f32).

  Launches the kernel `fwd_kernel(q.dtype)` (bf16: the bf16 tensor-core
  kernel, csrc/flash_fwd_tc.cu; f32: the 3xTF32 one, csrc/flash_fwd.cu) and
  counts the launch in `flash_attention_forward.launches`, and a launch of
  the bf16 tensor-core kernel also in `flash_attention_forward.tc_launches`.
  """
  if q.device.type != "cuda":
    raise ValueError(f"the K1 kernel runs on cuda, not {q.device}")
  _check_inputs(q, k, v, seg)
  name = fwd_kernel(q.dtype)
  seg = _check_cuda((("q", q), ("k", k), ("v", v)), seg)
  b, tq, h, d = q.shape
  out = torch.empty_like(q)
  row_lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
  err = _fwd_lib(name)(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
      None if seg is None else seg.data_ptr(), row_lse.data_ptr(), b, tq,
      k.shape[1], h, d, int(bool(causal)), 1.0 / math.sqrt(d),
      _build.stream_ptr(q.device))
  _build.check(err, name)
  flash_attention_forward.launches += 1
  if name == "flash_fwd_tc":
    flash_attention_forward.tc_launches += 1
  return out, row_lse


def flash_attention_bwd(q, k, v, lse, do, *, causal=False, seg=None,
                        key_tiles=None):
  """K2 on CUDA tensors: (dq, dk, dv) of `flash_attention`.

  `lse` is the row log-sum-exp `flash_attention_forward` returned for q,
  k, v. Launches the kernel `bwd_kernel(q.dtype)` (bf16: the bf16
  tensor-core kernel, csrc/flash_bwd_tc.cu; f32: the 3xTF32 one,
  csrc/flash_bwd.cu, with `key_tiles` key tiles per block, by default
  `key_tiles_per_block`) and counts the launch in
  `flash_attention_bwd.launches`, and a launch of the bf16 tensor-core
  kernel also in `flash_attention_bwd.tc_launches`.
  """
  if q.device.type != "cuda":
    raise ValueError(f"the K2 kernel runs on cuda, not {q.device}")
  _check_inputs(q, k, v, seg)
  name = bwd_kernel(q.dtype)
  if do.shape != q.shape or do.dtype != q.dtype:
    raise ValueError(f"do {tuple(do.shape)} {do.dtype} must match q")
  b, tq, h, d = q.shape
  if lse is None or lse.dtype != torch.float32 \
      or tuple(lse.shape) != (b * h, tq):
    raise ValueError(f"lse must be [B*H, Tq] = {(b * h, tq)} float32")
  seg = _check_cuda((("q", q), ("k", k), ("v", v), ("do", do),
                     ("lse", lse)), seg)
  dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
  f32 = dict(dtype=torch.float32, device=q.device)
  if name == "flash_bwd_tc":
    dq_acc = torch.empty(b * h * _tc_scratch()(tq, d), **f32)
    tail = ()
  else:
    kt = key_tiles or key_tiles_per_block(b * h, tq, k.shape[1], d)
    dq_acc = torch.empty(tf32_dq_parts_shape(b * h, tq, k.shape[1], d, kt),
                         **f32)
    tail = (kt, dq_acc.shape[-1])
  # Row statistics: delta and the row sum of exp(s - lse) per query row.
  delta = torch.empty((2, b * h, tq), **f32)
  err = _bwd_lib(name)(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
      None if seg is None else seg.data_ptr(), dq.data_ptr(), dk.data_ptr(),
      dv.data_ptr(), dq_acc.data_ptr(), delta.data_ptr(), b, tq, k.shape[1],
      h, d, int(bool(causal)), 1.0 / math.sqrt(d), *tail,
      _build.stream_ptr(q.device))
  _build.check(err, name)
  flash_attention_bwd.launches += 1
  if name == "flash_bwd_tc":
    flash_attention_bwd.tc_launches += 1
  return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
  """K1 forward, K2 backward (their plain versions on CPU tensors)."""

  @staticmethod
  def forward(ctx, q, k, v, seg, causal):
    ctx.causal = causal
    if q.device.type == "cpu":
      o, lse = flash_attention_reference(q, k, v, causal=causal, seg=seg), None
    else:
      o, lse = flash_attention_forward(q, k, v, causal=causal, seg=seg)
    ctx.save_for_backward(q, k, v, seg, lse)
    return o

  @staticmethod
  def backward(ctx, do):
    q, k, v, seg, lse = ctx.saved_tensors
    if q.device.type == "cpu":
      dq, dk, dv = flash_attention_bwd_reference(q, k, v, do,
                                                 causal=ctx.causal, seg=seg)
    else:
      dq, dk, dv = flash_attention_bwd(q, k, v, lse, do.contiguous(),
                                       causal=ctx.causal, seg=seg)
    return dq, dk, dv, None, None


def _launch_args(q, k, v, seg, named):
  """Checks before a blocked-kernel launch; returns (seg int32 or None,
  the kernel's shape arguments)."""
  if q.device.type != "cuda":
    raise ValueError(f"the blocked kernels run on cuda, not {q.device}")
  _check_inputs(q, k, v, seg)
  seg = _check_cuda((("q", q), ("k", k), ("v", v), *named), seg)
  b, tq, h, d = q.shape
  return seg, (_DTYPES[q.dtype], b, tq, k.shape[1], h, d)


def flash_attention_blocked_forward(q, k, v, *, causal=False, seg=None):
  """K3 on CUDA tensors: (o, row log-sum-exp [B*H, Tq] f32) with the
  semantics of `flash_attention_blocked_reference`.

  Counts the launch in `flash_attention_blocked_forward.launches`.
  """
  seg, shape = _launch_args(q, k, v, seg, ())
  b, tq, h, _ = q.shape
  out = torch.empty_like(q)
  lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
  err = _blocked_fwd_lib()(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
      None if seg is None else seg.data_ptr(), lse.data_ptr(), *shape,
      int(bool(causal)), 1.0 / math.sqrt(q.shape[-1]),
      _build.stream_ptr(q.device))
  _build.check(err, "flash_blocked_fwd")
  flash_attention_blocked_forward.launches += 1
  return out, lse


def _launch_blocked_bwd(which, q, k, v, do, lse, delta, outs, causal, seg):
  """Checks and launches K4a (`which`="dq", outs (dq,)) or K4b ("dkv",
  outs (dk, dv))."""
  b, tq, h, _ = q.shape
  for name, x in (("lse", lse), ("delta", delta)):
    if x.dtype != torch.float32 or tuple(x.shape) != (b * h, tq):
      raise ValueError(f"{name} must be [B*H, Tq] = {(b * h, tq)} float32")
  if do.shape != q.shape or do.dtype != q.dtype:
    raise ValueError(f"do {tuple(do.shape)} {do.dtype} must match q")
  seg, shape = _launch_args(q, k, v, seg, (("do", do), ("lse", lse),
                                           ("delta", delta)))
  ptrs = [x.data_ptr() for x in outs] + [None] * (2 - len(outs))
  err = _blocked_bwd_lib(which)(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
      lse.data_ptr(), delta.data_ptr(),
      None if seg is None else seg.data_ptr(), *ptrs, *shape,
      int(bool(causal)), 1.0 / math.sqrt(q.shape[-1]),
      _build.stream_ptr(q.device))
  _build.check(err, f"flash_blocked_{which}")


def flash_attention_blocked_dq(q, k, v, do, lse, delta, *, causal=False,
                               seg=None):
  """K4a on CUDA tensors: dq of the blocked attention in q's dtype.

  `lse` is K3's row log-sum-exp, `delta` is `blocked_delta(o, do)`.
  Counts the launch in `flash_attention_blocked_dq.launches`.
  """
  dq = torch.empty_like(q)
  _launch_blocked_bwd("dq", q, k, v, do, lse, delta, (dq,), causal, seg)
  flash_attention_blocked_dq.launches += 1
  return dq


def flash_attention_blocked_dkv(q, k, v, do, lse, delta, *, causal=False,
                                seg=None):
  """K4b on CUDA tensors: (dk, dv) of the blocked attention in k's and v's
  dtypes. Arguments as `flash_attention_blocked_dq`.

  Counts the launch in `flash_attention_blocked_dkv.launches`.
  """
  dk, dv = torch.empty_like(k), torch.empty_like(v)
  _launch_blocked_bwd("dkv", q, k, v, do, lse, delta, (dk, dv), causal, seg)
  flash_attention_blocked_dkv.launches += 1
  return dk, dv


def flash_attention_blocked_bwd(q, k, v, o, lse, do, *, causal=False,
                                seg=None):
  """The blocked backward on CUDA tensors: delta (a plain torch op, as the
  JAX package computes it outside Pallas), then K4a for dq and K4b for dk
  and dv. Returns (dq, dk, dv)."""
  if q.device.type != "cuda":
    raise ValueError(f"the blocked kernels run on cuda, not {q.device}")
  delta = blocked_delta(o, do)
  dq = flash_attention_blocked_dq(q, k, v, do, lse, delta, causal=causal,
                                  seg=seg)
  dk, dv = flash_attention_blocked_dkv(q, k, v, do, lse, delta,
                                       causal=causal, seg=seg)
  return dq, dk, dv


def flash_attention_blocked_bwd_fused(q, k, v, o, lse, do, *, causal=False,
                                      seg=None, key_tiles=None):
  """K5 on CUDA tensors: delta (a plain torch op, as the JAX package
  computes it outside Pallas), then one launch for (dq, dk, dv), with the
  semantics of `flash_attention_blocked_bwd_fused_reference`.

  `o` and `lse` are K3's; `key_tiles` key tiles per block, by default
  `key_tiles_per_block`. Counts the launch in
  `flash_attention_blocked_bwd_fused.launches`.
  """
  if q.device.type != "cuda":
    raise ValueError(f"the K5 kernel runs on cuda, not {q.device}")
  b, tq, h, d = q.shape
  if lse.dtype != torch.float32 or tuple(lse.shape) != (b * h, tq):
    raise ValueError(f"lse must be [B*H, Tq] = {(b * h, tq)} float32")
  if do.shape != q.shape or do.dtype != q.dtype or o.shape != q.shape:
    raise ValueError(f"do {tuple(do.shape)} {do.dtype} and o "
                     f"{tuple(o.shape)} must match q")
  delta = blocked_delta(o, do)
  seg, shape = _launch_args(q, k, v, seg, (("do", do), ("lse", lse)))
  dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
  kt = key_tiles or key_tiles_per_block(b * h, tq, k.shape[1], d)
  dq_parts = torch.empty(tf32_dq_parts_shape(b * h, tq, k.shape[1], d, kt),
                         dtype=torch.float32, device=q.device)
  err = _blocked_bwd_fused_lib()(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
      lse.data_ptr(), delta.data_ptr(),
      None if seg is None else seg.data_ptr(), dq.data_ptr(), dk.data_ptr(),
      dv.data_ptr(), dq_parts.data_ptr(), *shape, int(bool(causal)),
      1.0 / math.sqrt(d), kt, dq_parts.shape[-1],
      _build.stream_ptr(q.device))
  _build.check(err, "flash_blocked_bwd_fused")
  flash_attention_blocked_bwd_fused.launches += 1
  return dq, dk, dv


class _FlashAttentionBlocked(torch.autograd.Function):
  """K3 forward; delta and K4a + K4b, or K5, backward (plain versions on
  the CPU)."""

  @staticmethod
  def forward(ctx, q, k, v, seg, causal, block_q, block_kv):
    ctx.causal, ctx.block_q, ctx.block_kv = causal, block_q, block_kv
    if q.device.type == "cpu":
      o, lse = flash_attention_blocked_reference(q, k, v, causal=causal,
                                                 seg=seg)
    else:
      o, lse = flash_attention_blocked_forward(q, k, v, causal=causal,
                                               seg=seg)
    ctx.save_for_backward(q, k, v, o, lse, seg)
    return o

  @staticmethod
  def backward(ctx, do):
    q, k, v, o, lse, seg = ctx.saved_tensors
    cpu = q.device.type == "cpu"
    if takes_fused_bwd(q.shape[1], k.shape[1], q.shape[-1], ctx.block_q,
                       ctx.block_kv):
      fn = (flash_attention_blocked_bwd_fused_reference if cpu
            else flash_attention_blocked_bwd_fused)
    else:
      fn = (flash_attention_blocked_bwd_reference if cpu
            else flash_attention_blocked_bwd)
    dq, dk, dv = fn(q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
                    seg=seg)
    return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal=False, seg=None, block_q=None,
                    block_kv=None):
  """Fused attention; q [B, Tq, H, D], k and v [B, Tkv, H, D], D <= 256.

  `seg`: optional [B, T] int segment ids (needs Tq == Tkv): position j is
  attendable from i iff 0 < seg[j] <= seg[i]; padding is seg=0. Scales by
  1/sqrt(D). A row with no visible key gives 0.

  Dispatch, as in the JAX package: the one-shot semantics (K1 forward, K2
  backward) where `oneshot_fits(Tq, Tkv, D)` and no block size was given,
  the blocked semantics (K3 forward; K4a and K4b backward, or K5 where
  `takes_fused_bwd`) otherwise. The JAX package pads T to a multiple of its
  blocks (`block_sizes`: default min(128, max(16, T)) rows) and masks the pad;
  the port's kernels mask the ragged edge of their own 64-row tiles
  instead, so the unpadded rows are the same and `block_q`/`block_kv` only
  choose the blocked path and the backward. On CPU tensors the plain
  versions run instead of the kernels.
  """
  if q.device.type not in ("cpu", "cuda"):
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
  _check_inputs(q, k, v, seg)
  for name, blk in (("block_q", block_q), ("block_kv", block_kv)):
    if blk is not None and (not isinstance(blk, int) or blk < 1):
      raise ValueError(f"{name} must be a positive int, not {blk!r}")
  if (block_q is None and block_kv is None
      and oneshot_fits(q.shape[1], k.shape[1], q.shape[-1])):
    return _FlashAttention.apply(q, k, v, seg, causal)
  return _FlashAttentionBlocked.apply(
      q, k, v, seg, causal, *block_sizes(q.shape[1], k.shape[1], block_q,
                                    block_kv))


flash_attention_forward.launches = 0
flash_attention_forward.tc_launches = 0
flash_attention_bwd.launches = 0
flash_attention_bwd.tc_launches = 0
flash_attention_blocked_forward.launches = 0
flash_attention_blocked_dq.launches = 0
flash_attention_blocked_dkv.launches = 0
flash_attention_blocked_bwd_fused.launches = 0

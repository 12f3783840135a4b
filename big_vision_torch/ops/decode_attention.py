"""Single-token decode attention over the stored KV cache: kernel K6.

Replaces the TPU kernel `_kernel` / `decode_attention`
(big_vision_tpu/ops/decode_attention.py). The CUDA source is
`csrc/decode_attention.cu`; its header says how it works.

Bound on the card: the bytes of the K and V cache. At gemma_2b serving
shapes (B=8, K=1, S=352, H=256, bf16) that is 2.9 MB, about 0.9 us at
3.35 TB/s. The kernel reads the cache in its storage dtype (int8, bf16 or
f32) and splits it over the SMs (`plan`); a second small kernel combines
the splits.

The JAX decode path hands the Pallas kernel f32 copies of a bf16 cache
(`_update_kv_cache` returns the cache cast up to the compute dtype). The
bf16 -> f32 -> bf16 round trip is exact, so the port passes the bf16
storage itself: the same numbers, half the bytes.

`decode_attention` launches the kernel for a CUDA tensor (or raises) and
runs `decode_attention_reference` for a CPU tensor. The model reaches it
only where `fits` holds, the JAX package's gate.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from big_vision_torch.ops import _build

NEG_INF = -1e30
_GP = 8  # the TPU kernel's query rows per program
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CACHE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _r(x, m):
  return -(-x // m) * m


def fits(s, h, store_bytes):
  """The JAX package's gate of its decode kernel, copied: whether one
  (batch, kv_head) cache plane of S slots and head dim h, stored in
  `store_bytes`-byte elements, fits that kernel's VMEM budget
  (double-buffered k and v blocks, the bf16 copies of an int8 cache, three
  [GP, S] f32 mats, against 12 MB). Where it fails, the model takes its
  einsum path, as the JAX model does, so both compute the same function."""
  s, h = _r(s, 128), _r(h, 128)
  blocks = 2 * 2 * s * h * store_bytes
  copies = 2 * s * h * 2 if store_bytes == 1 else 0
  mats = 3 * _GP * s * 4
  return blocks + copies + mats <= 12 * 1024 * 1024


# The kernel's grid (csrc/decode_attention.cu): a cache plane is cut into
# splits of whole tiles, each tile at most TILE slots in shared memory, and
# at most MAX_SPLITS splits, the combine's table.
TILE, MAX_SPLITS = 64, 64


@functools.lru_cache(maxsize=256)
def plan(bk, s, num_sms):
  """(slots per tile, slots per split, splits) of K6's grid for `bk` =
  B * K cache planes of `s` slots on a card of `num_sms` SMs.

  The rule: the tile is the largest of 64, 32 and 16 slots for which one
  split per tile (ceil(s / tile) * bk blocks) fills the SMs at least once,
  else 16; a split is one tile, or, past MAX_SPLITS splits, as many slots as
  keep the splits to MAX_SPLITS, in tiles of up to 64. At the serving shape
  (bk = 8, s = 352) that is 22 splits of 16 slots; at bk = 64, s = 1120, 18
  of 64.
  """
  for tile in (64, 32, 16):
    if -(-s // tile) * bk >= num_sms:
      break
  per_split = max(tile, -(-s // MAX_SPLITS))
  if per_split > tile:
    tile = min(TILE, per_split)
    per_split = -(-per_split // tile) * tile
  return tile, per_split, -(-s // per_split)


def scratch_floats(bk, g, h, splits):
  """f32 scratch of one launch: each split's o [G, round_up(H, 4)] and its
  (m, l) per query row; none for a single split."""
  return 0 if splits == 1 else bk * splits * g * (-(-h // 4) * 4 + 2)


@functools.cache
def _lib():
  """The kernel's C entry point, built and typed once per process."""
  lib = _build.load("decode_attention")
  fn = lib.bvt_decode_attention
  fn.restype = ctypes.c_int
  fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
      ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
  return fn


@functools.cache
def _num_sms(index):
  return torch.cuda.get_device_properties(index).multi_processor_count


def _check_inputs(q, k, v, mask, k_scale, v_scale):
  if q.dim() != 4:
    raise ValueError(f"q must be [B, K, G, H], got {tuple(q.shape)}")
  b, kh, _, h = q.shape
  s = k.shape[2] if k.dim() == 4 else -1
  if tuple(k.shape) != (b, kh, s, h) or k.shape != v.shape:
    raise ValueError(f"cache must be [B, K, S, H] = ({b}, {kh}, S, {h}); "
                     f"got {tuple(k.shape)} {tuple(v.shape)}")
  if tuple(mask.shape) != (b, s):
    raise ValueError(f"mask must be [B, S] = ({b}, {s}), got "
                     f"{tuple(mask.shape)}")
  if (k_scale is None) != (v_scale is None):
    raise ValueError("pass both k_scale and v_scale, or neither")
  if (k.dtype == torch.int8) != (k_scale is not None):
    raise ValueError("an int8 cache needs scales; a float cache takes none")
  if k_scale is not None:
    for x in (k_scale, v_scale):
      if tuple(x.shape) != (b, kh, s, 1):
        raise ValueError(f"scales must be [B, K, S, 1], got {tuple(x.shape)}")


def decode_attention_reference(q, k, v, mask, *, k_scale=None, v_scale=None,
                               logits_softcap=0.0):
  """Plain PyTorch version with the TPU kernel's exact semantics.

  bf16 operands (int8 values are exact in bf16), f32 scores; the k-scale
  multiplies the logits before the softcap; masked logits are -1e30 and
  masked probabilities exactly 0; l is summed before the v-scale
  multiplies p; p.v with p cast to bf16; o = (p.v)/l in q's dtype.
  """
  _check_inputs(q, k, v, mask, k_scale, v_scale)
  cd = torch.bfloat16
  s = torch.einsum("bkgh,bksh->bkgs", q.to(cd).float(), k.to(cd).float())
  if k_scale is not None:
    s = s * k_scale[:, :, None, :, 0]
  if logits_softcap:
    s = logits_softcap * torch.tanh(s / logits_softcap)
  valid = mask.bool()[:, None, None, :]
  s = torch.where(valid, s, torch.full_like(s, NEG_INF))
  m = s.amax(dim=-1, keepdim=True)
  p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
  l = p.sum(dim=-1, keepdim=True)
  l = torch.where(l == 0, torch.ones_like(l), l)
  if v_scale is not None:
    p = p * v_scale[:, :, None, :, 0]
  o = torch.einsum("bkgs,bksh->bkgh", p.to(cd).float(), v.to(cd).float())
  return (o / l).to(q.dtype)


def decode_attention(q, k, v, mask, *, k_scale=None, v_scale=None,
                     logits_softcap=0.0):
  """One AR attention step over the stored cache.

  Args:
    q: [B, K, G, H] grouped single-token queries, already scaled (no
      1/sqrt(H) here), f32 or bf16; on the card G <= 8 and H <= 256.
    k, v: [B, K, S, H] cache in its storage dtype: int8 (pass the scales),
      bf16 or f32.
    mask: [B, S] bool, True on attendable slots.
    k_scale, v_scale: [B, K, S, 1] f32 per-slot dequant scales, or None.
    logits_softcap: cap*tanh(logits/cap) when non-zero.

  Returns [B, K, G, H] in q's dtype. On a CUDA tensor this launches the K6
  kernel and counts it in `decode_attention.launches`.
  """
  dev = q.device
  if dev.type == "cpu":
    return decode_attention_reference(q, k, v, mask, k_scale=k_scale,
                                      v_scale=v_scale,
                                      logits_softcap=logits_softcap)
  if dev.type != "cuda":
    raise ValueError(f"decode_attention runs on cuda or cpu, not {dev}")
  _check_inputs(q, k, v, mask, k_scale, v_scale)
  b, kh, g, h = q.shape
  if q.dtype not in _Q_DTYPES or k.dtype not in _CACHE_DTYPES:
    raise ValueError(f"unsupported dtypes q={q.dtype} cache={k.dtype}")
  if g > _GP or h > 256 or v.dtype != k.dtype:
    raise ValueError(f"kernel takes G <= 8, H <= 256, one cache dtype; got "
                     f"G={g} H={h} {k.dtype}/{v.dtype}")
  if mask.dtype != torch.bool:
    raise ValueError(f"mask must be bool, got {mask.dtype}")
  scales = () if k_scale is None else (k_scale, v_scale)
  for x in (q, k, v, mask, *scales):
    if x.device != dev or not x.is_contiguous():
      raise ValueError(f"inputs must be contiguous on {dev}")
  if scales and not k_scale.dtype == v_scale.dtype == torch.float32:
    raise ValueError("scales must be float32")
  return _launch(q, k, v, mask, k_scale, v_scale, logits_softcap,
                 plan(b * kh, k.shape[2], _num_sms(dev.index)))


def _launch(q, k, v, mask, k_scale, v_scale, softcap, grid):
  """Launches K6 on inputs `decode_attention` has checked, with the grid
  (slots per tile, slots per split, splits); counts the launch."""
  b, kh, g, h = q.shape
  tile, per_split, splits = grid
  out = torch.empty_like(q)
  n = scratch_floats(b * kh, g, h, splits)
  scratch = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
  ptr = lambda x: None if x is None else x.data_ptr()
  err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(k_scale),
               ptr(v_scale), mask.data_ptr(), out.data_ptr(), ptr(scratch),
               _Q_DTYPES[q.dtype], _CACHE_DTYPES[k.dtype], b, kh, g,
               k.shape[2], h, float(softcap or 0.0), tile, per_split, splits,
               _build.stream_ptr(q.device))
  _build.check(err, "decode_attention")
  decode_attention.launches += 1
  return out


decode_attention.launches = 0

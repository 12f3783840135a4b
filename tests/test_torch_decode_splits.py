"""K6's split-and-combine arithmetic, emulated in torch, vs the JAX kernel.

K6 (csrc/decode_attention.cu) runs only on the card, where chip_smoke.py
holds it against its plain version. Here its arithmetic is repeated in
torch on the CPU with the grid `plan` gives it: q and the cache rounded to
bf16, per split a running max over its tiles, p rounded to bf16 against
the split's max after the v-scale, l summed before it, the splits'
(m, l, o) combined in split order with weight 0 for a split with no
visible slot. It is held against the JAX package's `decode_attention` (in
interpret mode) within K6_BAR = 1e-2 of max|o|, at the serving shape
(B=8, K=1, G=8, S=352, H=256: 22 splits of 16 slots) with live lengths
that end mid-split, leading and trailing splits wholly masked and an
example with no visible slot (exact zeros), in bf16 and int8 (with the
softcap), and on a grid of several tiles per split. Also the rule of
`plan`, the scratch size and the wrapper's refusal of other devices.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch.models.ppp import gemma as t_gemma
from big_vision_torch.ops import decode_attention as t_da
from big_vision_tpu.ops import decode_attention as j_da

K6_BAR = 1e-2
H100_SMS = 132


def emulate(q, k, v, mask, k_scale=None, v_scale=None, softcap=0.0,
            grid=None):
  """K6's arithmetic on the grid (slots per tile, slots per split, splits)."""
  b, kh, g, h = q.shape
  s = k.shape[2]
  tile, per_split, splits = grid or t_da.plan(b * kh, s, H100_SMS)
  bf = lambda x: x.to(torch.bfloat16).float()
  qb, kb, vb = bf(q), bf(k), bf(v)
  parts = []
  for i in range(splits):
    m = torch.full((b, kh, g), -torch.inf)
    l = torch.zeros((b, kh, g))
    o = torch.zeros((b, kh, g, h))
    end = min(s, (i + 1) * per_split)
    for t0 in range(i * per_split, end, tile):
      t1 = min(t0 + tile, end)
      sc = torch.einsum("bkgh,bksh->bkgs", qb, kb[:, :, t0:t1])
      if k_scale is not None:
        sc = sc * k_scale[:, :, None, t0:t1, 0]
      if softcap:
        sc = softcap * torch.tanh(sc / softcap)
      vis = mask[:, None, None, t0:t1]
      sc = torch.where(vis, sc, -torch.inf)
      m_new = torch.maximum(m, sc.amax(-1))
      p = torch.where(vis, torch.exp(sc - m_new[..., None]), 0.0)
      alpha = torch.where(m == -torch.inf, 0.0, torch.exp(m - m_new))
      l = l * alpha + p.sum(-1)
      if v_scale is not None:
        p = p * v_scale[:, :, None, t0:t1, 0]
      o = o * alpha[..., None] + torch.einsum("bkgs,bksh->bkgh", bf(p),
                                              vb[:, :, t0:t1])
      m = m_new
    parts.append((m, l, o))
  if splits == 1:
    m, l, o = parts[0]
  else:
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    l = torch.zeros((b, kh, g))
    o = torch.zeros((b, kh, g, h))
    for m_i, l_i, o_i in parts:  # in split order
      w = torch.where(m_i == -torch.inf, 0.0, torch.exp(m_i - top))
      l = l + w * l_i
      o = o + w[..., None] * o_i
  return (o / torch.where(l == 0, 1.0, l)[..., None]).to(q.dtype)


def _inputs(b, kh, g, s, h, spans, quant, seed=0):
  """numpy q, k, v, mask and the scales; example i sees [lo_i, hi_i)."""
  rs = np.random.RandomState(seed)
  q = (rs.randn(b, kh, g, h) / np.sqrt(h)).astype(np.float32)
  kf, vf = (rs.randn(b, kh, s, h).astype(np.float32) for _ in range(2))
  slots = np.arange(s)[None, :]
  lo, hi = (np.array(x)[:, None] for x in zip(*spans))
  mask = (slots >= lo) & (slots < hi)
  if quant:
    (kq, ks), (vq, vs) = (t_gemma._quant_kv(torch.from_numpy(x))
                          for x in (kf, vf))
    return q, kq.numpy(), vq.numpy(), mask, ks.numpy(), vs.numpy()
  bf = lambda x: torch.from_numpy(x).to(torch.bfloat16).float().numpy()
  return q, bf(kf), bf(vf), mask, None, None


def _both(args, softcap=0.0, grid=None):
  q, k, v, mask, ks, vs = args
  jx = lambda x: None if x is None else jnp.asarray(x)
  want = np.asarray(j_da.decode_attention(
      jx(q), jx(k), jx(v), jx(mask), k_scale=jx(ks), v_scale=jx(vs),
      logits_softcap=softcap))
  tt = lambda x: None if x is None else torch.from_numpy(np.asarray(x))
  got = emulate(tt(q), tt(k), tt(v), tt(mask), tt(ks), tt(vs), softcap,
                grid).numpy()
  return got, want


# The serving shape's 22 splits of 16 slots: spans that end mid-split, leave
# leading and trailing splits wholly masked, one slot, and none.
SERVING_SPANS = [(0, 352), (0, 343), (3, 300), (40, 291), (96, 200),
                 (17, 18), (336, 352), (0, 0)]


@pytest.mark.parametrize("cache,softcap", [("bf16", 0.0), ("int8", 0.0),
                                           ("int8", 50.0)])
def test_split_combine_matches_jax_at_the_serving_shape(cache, softcap):
  args = _inputs(8, 1, 8, 352, 256, SERVING_SPANS, cache == "int8")
  assert t_da.plan(8, 352, H100_SMS) == (16, 16, 22)
  got, want = _both(args, softcap)
  err = np.abs(got - want).max() / np.abs(want).max()
  assert err <= K6_BAR, err
  assert np.abs(got[-1]).max() == 0.0  # no visible slot: exact zeros
  assert np.isfinite(got).all()


def test_split_combine_over_several_tiles_a_split():
  """One plane of 5000 slots: 40 splits of two 64-slot tiles each."""
  grid = t_da.plan(1, 5000, H100_SMS)
  assert grid == (64, 128, 40)
  args = _inputs(2, 1, 8, 5000, 64, [(100, 4321), (4200, 4262)], True,
                 seed=1)
  got, want = _both(args, grid=grid)
  err = np.abs(got - want).max() / np.abs(want).max()
  assert err <= K6_BAR, err


# (B * K, S) -> (slots per tile, slots per split, splits) on 132 SMs.
PLANS = {(8, 352): (16, 16, 22), (64, 1120): (64, 64, 18),
         (64, 352): (64, 64, 6), (132, 64): (64, 64, 1), (1, 1): (16, 16, 1),
         (3, 129): (16, 16, 9), (2, 2000): (32, 32, 63),
         (1, 5000): (64, 128, 40), (16, 6016): (64, 128, 47),
         (4, 17): (16, 16, 2), (1, 100_000): (64, 1600, 63)}


@pytest.mark.parametrize("bk,s", sorted(PLANS))
def test_plan(bk, s):
  tile, per_split, splits = t_da.plan(bk, s, H100_SMS)
  assert (tile, per_split, splits) == PLANS[bk, s]
  assert 16 <= tile <= t_da.TILE and per_split % tile == 0
  assert (splits - 1) * per_split < s <= splits * per_split
  assert splits <= t_da.MAX_SPLITS
  if -(-s // 16) * bk >= H100_SMS and -(-s // 16) <= t_da.MAX_SPLITS:
    assert splits * bk >= H100_SMS  # the grid fills the SMs


def test_scratch_floats():
  assert t_da.scratch_floats(8, 8, 256, 1) == 0
  assert t_da.scratch_floats(8, 8, 256, 22) == 8 * 22 * 8 * 258
  assert t_da.scratch_floats(2, 3, 70, 5) == 2 * 5 * 3 * (72 + 2)


def test_wrapper_refuses_other_devices():
  """A tensor neither on the CPU nor on the card is refused, not run."""
  q = torch.empty((2, 1, 8, 72), device="meta")
  k = torch.empty((2, 1, 40, 72), device="meta", dtype=torch.bfloat16)
  mask = torch.empty((2, 40), device="meta", dtype=torch.bool)
  with pytest.raises(ValueError, match="cuda or cpu"):
    t_da.decode_attention(q, k, k, mask)

"""The 3xTF32 products of the f32 attention kernels, and their scratch.

K2's f32 kernel, K5 and K4a + K4b (csrc/flash_bwd.cu,
csrc/flash_blocked_bwd_fused.cu, csrc/flash_blocked_bwd.cu), and the
forwards K3 and K1's f32 kernel (csrc/flash_blocked_fwd.cu,
csrc/flash_fwd.cu, through csrc/flash_tf32_fwd.cuh) run every f32 product
on the tensor cores as three TF32 products, split and issued by
csrc/flash_tf32_common.cuh, and run only on the card (chip_smoke.py holds
them against their plain versions at 1e-4). Here: the sources use that
header, and no header of csrc/ is left unused; TF32 rounding emulated in
torch (the 13 low mantissa bits, round to nearest, ties away from zero, as
`cvt.rna.tf32.f32` rounds and the kernels round hi; lo truncated, as the
tensor cores read it) shows on numpy inputs at FlexiViT-B's scales that
three products hold each of K2's five products, K4a's and K4b's sums over
1601 keys or queries tile by tile, and the forward's online softmax over
64-key tiles, within 1e-6 of f64 while one TF32 product each misses 1e-4;
the forward's rows with no visible key; the wrappers' scratch shapes,
chunking and refusals; and that the design variants of
tools/tf32_variants.py still apply to the sources.
"""

import shutil

import numpy as np
import pytest
import torch

from big_vision_torch.ops import _build
from big_vision_torch.ops import flash_attention as t_flash
from big_vision_torch.tools import tf32_variants

HEADER, FWD_HEADER = "flash_tf32_common.cuh", "flash_tf32_fwd.cuh"


def _included(text):
  """The headers of csrc/ that `text` includes, directly or through them."""
  found, todo = set(), [text]
  while todo:
    for line in todo.pop().splitlines():
      if line.startswith('#include "'):
        name = line.split('"')[1]
        if name not in found:
          found.add(name)
          todo.append((_build._CSRC / name).read_text())
  return found


@pytest.mark.parametrize("name", ["flash_bwd", "flash_blocked_bwd_fused",
                                  "flash_blocked_bwd", "flash_fwd",
                                  "flash_blocked_fwd"])
def test_kernels_use_the_tf32_header(name):
  src = (_build._CSRC / f"{name}.cu").read_text()
  assert HEADER in _included(src)
  if name.endswith("fwd"):
    # The forwards are one template on the header's mma3, with no
    # products of their own and no atomics.
    assert _included(src) == {FWD_HEADER, HEADER}
    fwd = (_build._CSRC / FWD_HEADER).read_text()
    code = "\n".join(line.split("//")[0] for line in (src + fwd).splitlines())
    assert "mma3(" in code and "fmaf(" not in src.split("#include")[-1]
    assert "atomic" not in code
  header = (_build._CSRC / HEADER).read_text()
  assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in header
  # The split rounds hi as cvt.rna.tf32.f32 does, with an integer add and
  # mask (0x1000, then the 13 low bits cleared), as `tf32` below emulates.
  assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in header
  assert "mma3(" in header and "split_tf32(" in header


def test_every_header_is_included():
  sources = "".join(f.read_text() for f in _build._CSRC.glob("*.cu"))
  headers = sorted(_build._CSRC.glob("*.cuh"))
  assert headers
  for header in headers:
    assert f'#include "{header.name}"' in sources, header.name


def tf32(x):
  """x rounded to TF32 (10 mantissa bits kept, ties away from zero), as
  f32: the sign-magnitude bits plus half of the dropped range, truncated,
  as the kernels' `split_tf32` rounds hi."""
  bits = x.contiguous().view(torch.int32)
  return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x):
  """x as the tensor cores read a TF32 operand: the 13 low mantissa bits
  dropped (the kernels pass lo so)."""
  return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def test_tf32_rounding():
  ulp = 2.0 ** -10  # of TF32 at 1
  x = torch.tensor([1.0, 1 + ulp / 4, 1 + ulp / 2, 1 + 3 * ulp / 2,
                    -(1 + ulp / 2), 1 + ulp, 0.0, -2.5, 3e-39],
                   dtype=torch.float32)
  want = [1.0, 1.0, 1 + ulp, 1 + 2 * ulp, -(1 + ulp), 1 + ulp, 0.0, -2.5]
  got = tf32(x)
  assert got[:8].tolist() == want  # ties (1/2 ulp) go away from zero
  assert (got.view(torch.int32) & 0x1FFF).eq(0).all()


def _products(seed=0, t=226, d=64):
  """K2's five products at FlexiViT-B's seqhw 15 (T=226, D=64) for one
  head, from numpy N(0, 1) inputs: {name: (a, b)} in f32."""
  rs = np.random.RandomState(seed)
  q, k, v, do = (torch.from_numpy(rs.randn(t, d).astype(np.float32))
                 for _ in range(4))
  s = (q.double() @ k.double().T) * d ** -0.5
  p = torch.softmax(s, -1)
  dp = do.double() @ v.double().T
  ds = (p * (dp - (p * dp).sum(-1, keepdim=True))).float()
  p = p.float()
  return {"s": (q, k.T), "dp": (do, v.T), "dv": (p.T, do), "dk": (ds.T, q),
          "dq": (ds, k)}


def _rel(got, a, b):
  exact = a.double() @ b.double()
  return ((got - exact).abs().max() / exact.abs().max()).item()


@pytest.mark.parametrize("name", ["s", "dp", "dv", "dk", "dq"])
def test_three_tf32_products_hold_the_f32_bar(name):
  a, b = _products()[name]
  a_hi, b_hi = tf32(a), tf32(b)
  a_lo, b_lo = tf32_trunc(a - a_hi), tf32_trunc(b - b_hi)
  f64 = lambda x: x.double()
  # Products of TF32 values are exact in f64; the tensor cores sum in f32.
  three = (f64(a_lo) @ f64(b_hi) + f64(a_hi) @ f64(b_lo)
           + f64(a_hi) @ f64(b_hi))
  one = f64(a_hi) @ f64(b_hi)
  assert _rel(three, a, b) <= 1e-6
  assert _rel(one, a, b) > 1e-4  # one TF32 product misses the f32 bar


def _blocked_sums(seed=1, t=40 * 40 + 1, d=64):
  """K4a's and K4b's sums at FlexiViT-B's seqhw 40 (T=1601, D=64) for one
  head, from numpy N(0, 1) inputs: {name: (a, b, tile)} in f32, where the
  kernel sums a @ b over a's columns in tiles of `tile`: dq = ds.k over key
  tiles of 64 (K4a), dk = ds^T.(q * scale) and dv = p^T.do over query
  tiles of 32 (K4b)."""
  rs = np.random.RandomState(seed)
  q, k, v, do = (torch.from_numpy(rs.randn(t, d).astype(np.float32))
                 for _ in range(4))
  qs = q * np.float32(d ** -0.5)
  p = torch.softmax(qs.double() @ k.double().T, -1)
  dp = do.double() @ v.double().T
  ds = (p * (dp - (p * dp).sum(-1, keepdim=True))).float()
  p = p.float()
  return {"dq": (ds, k, 64), "dk": (ds.T.contiguous(), qs, 32),
          "dv": (p.T.contiguous(), do, 32)}


@pytest.mark.parametrize("name", ["dq", "dk", "dv"])
def test_blocked_sums_hold_the_f32_bar(name):
  """Each tile's three TF32 products (exact in f64), the tiles summed in
  f32 in order, dq scaled once at the end: within 1e-6 of f64 over 1601
  keys or queries; one TF32 product per tile misses 1e-4."""
  a, b, tile = _blocked_sums()[name]
  mul = np.float32(64 ** -0.5 if name == "dq" else 1)  # K4a scales once
  a_hi, b_hi = tf32(a), tf32(b)
  a_lo, b_lo = tf32_trunc(a - a_hi), tf32_trunc(b - b_hi)
  three = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
  one = torch.zeros_like(three)
  for j in range(0, a.shape[1], tile):
    f64 = lambda x, y: x[:, j:j + tile].double() @ y[j:j + tile].double()
    three = three + (f64(a_lo, b_hi) + f64(a_hi, b_lo)
                     + f64(a_hi, b_hi)).float()
    one = one + f64(a_hi, b_hi).float()
  exact = (a.double() @ b.double()) * float(mul)
  rel = lambda got: ((got - exact).abs().max() / exact.abs().max()).item()
  assert rel(three * mul) <= 1e-6
  assert rel(one * mul) > 1e-4  # one TF32 product misses the f32 bar


def _fwd_emulated(q, k, v, mask, scale_first, products=3, tile=64):
  """The arithmetic of the forward kernel (csrc/flash_tf32_fwd.cuh) for one
  head in torch: per 64-key tile, S from `products` TF32 products (exact
  in f64, summed in f32), scaled first (q * scale, K3) or after (K1);
  masked scores -inf; the running max m (from -1e30) and sum l rescaled by
  alpha = exp(m_old - m_new); p = exp(s - m_new); o = o * alpha + the
  tile's p . v from `products` TF32 products. Returns (o = o / l,
  lse = m + log l), with l = 0 taken as 1."""
  scale = np.float32(q.shape[1] ** -0.5)
  qs = q * scale if scale_first else q

  def product(a, b):
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32_trunc(a - a_hi), tf32_trunc(b - b_hi)
    f64 = lambda x, y: x.double() @ y.double()
    terms = [f64(a_lo, b_hi), f64(a_hi, b_lo)][:products - 1]
    return (sum(terms) + f64(a_hi, b_hi)).float()

  f32 = torch.float32
  m = torch.full((q.shape[0], 1), -1e30, dtype=f32)
  l = torch.zeros((q.shape[0], 1), dtype=f32)
  o = torch.zeros(q.shape, dtype=f32)
  for j in range(0, k.shape[0], tile):
    s = product(qs, k[j:j + tile].T)
    s = s if scale_first else s * scale
    s = torch.where(mask[:, j:j + tile], s, -torch.inf)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l = l * alpha + p.sum(-1, keepdim=True)
    o = o * alpha + product(p, v[j:j + tile])
    m = m_new
  l = torch.where(l == 0, torch.ones_like(l), l)
  return o / l, (m + torch.log(l))[:, 0]


def _fwd_f64(q, k, v, mask):
  """(o, lse) in f64 with every visible row's softmax exact."""
  s = (q.double() @ k.double().T) * q.shape[1] ** -0.5
  s = torch.where(mask, s, -torch.inf)
  lse = torch.logsumexp(s, -1)
  return torch.exp(s - lse[:, None]) @ v.double(), lse


@pytest.mark.parametrize("kernel,seqhw", [("K3", 40), ("K1", 15)])
def test_forward_holds_the_f32_bar(kernel, seqhw):
  """K3 at FlexiViT-B's seqhw 40 (T=1601, D=64, q scaled first) and K1's
  f32 kernel at seqhw 15 (T=226, scaled after), one head from numpy N(0, 1)
  inputs: three TF32 products per tile with the online rescaling are within
  1e-6 of f64 in o and the LSE; one product per tile misses 1e-4 in o."""
  t, d = seqhw * seqhw + 1, 64
  rs = np.random.RandomState(seqhw)
  q, k, v = (torch.from_numpy(rs.randn(t, d).astype(np.float32))
             for _ in range(3))
  mask = torch.ones((t, t), dtype=torch.bool)
  want_o, want_lse = _fwd_f64(q, k, v, mask)
  rel = lambda got, want: ((got.double() - want).abs().max()
                           / want.abs().max()).item()
  o, lse = _fwd_emulated(q, k, v, mask, scale_first=kernel == "K3")
  assert rel(o, want_o) <= 1e-6 and rel(lse, want_lse) <= 1e-6
  o1, _ = _fwd_emulated(q, k, v, mask, scale_first=kernel == "K3",
                        products=1)
  assert rel(o1, want_o) > 1e-4  # one TF32 product misses the f32 bar


@pytest.mark.parametrize("scale_first", [True, False])
def test_forward_rows_with_no_visible_key(scale_first):
  """A row with no visible key (a padding row: seg 0) gives o = 0 and
  lse = -1e30 exactly; a row whose keys are all in its second tile (the
  first tile all masked: alpha = 0 once the first key shows) is exact."""
  t, d = 150, 64
  rs = np.random.RandomState(5)
  q, k, v = (torch.from_numpy(rs.randn(t, d).astype(np.float32))
             for _ in range(3))
  seg = torch.ones(t, dtype=torch.int32)
  seg[:70] = 2
  seg[100:] = 0  # padding: no row sees keys 100.., rows 100.. see nothing
  mask = (seg[None, :] > 0) & (seg[None, :] <= seg[:, None])
  mask[5] = False
  mask[5, 80:90] = True  # row 5 sees keys 80..89 only (the second tile)
  o, lse = _fwd_emulated(q, k, v, mask, scale_first)
  empty = ~mask.any(-1)
  assert empty.sum().item() == 50
  assert torch.equal(o[empty], torch.zeros_like(o[empty]))
  assert (lse[empty] == torch.tensor(-1e30)).all()
  want_o, want_lse = _fwd_f64(q[~empty], k, v, mask[~empty])
  assert torch.allclose(o[~empty].double(), want_o, rtol=0, atol=1e-6)
  assert torch.allclose(lse[~empty].double(), want_lse, rtol=1e-6, atol=0)


@pytest.mark.parametrize("seqhw,key_tiles,chunks", [
    (5, 1, 1), (15, 1, 4), (24, 1, 10), (30, 1, 15), (40, 2, 13)])
def test_flexivit_chunks(seqhw, key_tiles, chunks):
  """At FlexiViT-B's shapes (B=32, H=12, D=64) a block takes one key tile
  of 64 keys, and its own dq part, except at seqhw 40, where 26 parts of
  157 MB would pass 2 GiB: two tiles there."""
  t = seqhw * seqhw + 1
  assert t_flash.key_tiles_per_block(32 * 12, t, t, 64) == key_tiles
  assert t_flash.tf32_dq_parts_shape(32 * 12, t, t, 64, key_tiles) == (
      chunks, 384, t, 64)


@pytest.mark.parametrize("d,dp", [(18, 32), (32, 32), (64, 64), (72, 128),
                                  (128, 128), (200, 256), (256, 256)])
def test_dq_parts_pad_d(d, dp):
  # A few heads: one block per key tile (300 keys, 5 tiles).
  assert t_flash.key_tiles_per_block(8, 100, 300, d) == 1
  assert t_flash.tf32_dq_parts_shape(8, 100, 300, d, 1) == (5, 8, 100, dp)
  assert t_flash.tf32_dq_parts_shape(8, 100, 300, d, 2) == (3, 8, 100, dp)


def test_dq_parts_stay_under_the_cap():
  # ViT-B at T=4097 and batch 64: one key tile per block would take
  # 65 parts of 805 MB.
  bh, t = 64 * 12, 4097
  kt = t_flash.key_tiles_per_block(bh, t, t, 64)
  shape = t_flash.tf32_dq_parts_shape(bh, t, t, 64, kt)
  assert (kt, shape[0]) == (33, 2)
  assert 4 * np.prod(shape) <= t_flash.TF32_PARTS_BYTES
  # One part alone may pass it: never fewer than one chunk.
  assert t_flash.key_tiles_per_block(4096, 4097, 4097, 256) == 65


@pytest.mark.parametrize("key_tiles", [0, -1, 1.5])
def test_dq_parts_refuse_bad_key_tiles(key_tiles):
  with pytest.raises(ValueError, match="key_tiles"):
    t_flash.tf32_dq_parts_shape(8, 100, 300, 64, key_tiles)


def _inputs(seed=0, b=2, t=40, h=2, d=16):
  rs = np.random.RandomState(seed)
  return [torch.from_numpy(rs.randn(b, t, h, d).astype(np.float32))
          for _ in range(4)]


@pytest.mark.parametrize("key_tiles", [None, 2])
def test_wrappers_refuse_cpu_tensors(key_tiles):
  """Neither wrapper runs a plain version on a CPU tensor, and neither
  counts a launch."""
  q, k, v, do = _inputs()
  o, lse = t_flash.flash_attention_blocked_reference(q, k, v)
  before = (t_flash.flash_attention_bwd.launches,
            t_flash.flash_attention_blocked_bwd_fused.launches)
  with pytest.raises(ValueError, match="cuda"):
    t_flash.flash_attention_bwd(q, k, v, lse, do, key_tiles=key_tiles)
  with pytest.raises(ValueError, match="cuda"):
    t_flash.flash_attention_blocked_bwd_fused(q, k, v, o, lse, do,
                                              key_tiles=key_tiles)
  assert before == (t_flash.flash_attention_bwd.launches,
                    t_flash.flash_attention_blocked_bwd_fused.launches)


@pytest.mark.parametrize("causal", [False, True])
def test_fused_plain_version_groups_dq_by_chunk(causal):
  """K5's plain version sums dq per chunk of key tiles, then the chunks in
  key order, as the kernel does: bit for bit what a hand-written loop over
  chunks gives, and within f32 rounding of one chunk."""
  q, k, v, do = _inputs(seed=3, t=150)
  o, lse = t_flash.flash_attention_blocked_reference(q, k, v, causal=causal)
  ref = t_flash.flash_attention_blocked_bwd_fused_reference
  got = ref(q, k, v, o, lse, do, causal=causal, block_kv=32, chunk_keys=64)
  one = ref(q, k, v, o, lse, do, causal=causal, block_kv=32, chunk_keys=150)
  # By hand: tiles of 32 keys, chunks of 64 (two tiles each, the last one
  # 22 keys).
  delta = t_flash.blocked_delta(o, do)
  _, _, ds = t_flash._blocked_probs(q, k, v, lse, delta, do, causal, None)
  term = lambda j0, j1: torch.einsum("bhqk,bkhd->bqhd", ds[..., j0:j1],
                                     k[:, j0:j1]) * 16 ** -0.5
  dq = torch.zeros_like(q)
  for c0 in (0, 64, 128):
    part = torch.zeros_like(q)
    for j in range(c0, min(c0 + 64, 150), 32):
      part = part + term(j, min(j + 32, c0 + 64, 150))
    dq = dq + part
  assert torch.equal(got[0], dq)
  torch.testing.assert_close(got[0], one[0], rtol=1e-5, atol=1e-6)
  for x, y in zip(got[1:], one[1:]):
    assert torch.equal(x, y)  # dk and dv do not depend on the chunks


@pytest.mark.parametrize("name", sorted(tf32_variants.VARIANTS))
def test_timing_variants_apply_to_the_sources(name):
  """tools/tf32_variants.py undoes one design choice per variant by a text
  replacement; each replacement must still find its text."""
  src = tf32_variants.variant_sources(name)
  try:
    changed = [f.name for f in src.iterdir()
               if f.read_text() != (_build._CSRC / f.name).read_text()]
    assert sorted(changed) == sorted({f for f, _, _ in
                                      tf32_variants.VARIANTS[name]})
  finally:
    shutil.rmtree(src)

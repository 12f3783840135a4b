"""Port's blocked attention path (K3, K4a, K4b plain versions) vs the JAX one.

The JAX side is `flash_attention(..., block_q=16, block_kv=16)` and
`jax.vjp` of it, whose blocked Pallas kernels run in interpret mode on the
CPU, as tests/test_flash_attention.py runs them. The port side is its
`flash_attention` with the same block sizes, which on CPU tensors runs the
plain versions inside the blocked autograd Function. Inputs and the
output cotangent are drawn with numpy from a seed. Both sides compute in
f32 from the same inputs: in f32 they differ only in the order of sums
(bar 1e-5 of max|x|); in bf16 each rounds its outputs once, from f32 sums
taken in another order (bar 1e-2 of max|x|, docs/flash_parity.md).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch.ops import flash_attention as t_flash
from big_vision_tpu.ops import flash_attention as j_flash

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_BAR = {"float32": 1e-5, "bfloat16": 1e-2}


def _inputs(b, t, h, d, tkv=None, seed=0):
  rs = np.random.RandomState(seed)
  tkv = tkv or t
  return [rs.randn(*shape).astype(np.float32)
          for shape in ((b, t, h, d), (b, tkv, h, d), (b, tkv, h, d),
                        (b, t, h, d))]


def _seg(b, t):
  """Prefix-LM segments with trailing padding; the last row is all zero."""
  rs = np.random.RandomState(1)
  seg = np.zeros((b, t), np.int32)
  for i in range(b - 1):
    n = rs.randint(t // 2, t + 1)
    seg[i, :n] = 1 + np.cumsum(rs.rand(n) < 0.3)
  return seg


def _close(got, want, bar):
  got = got.detach().float().numpy()
  scale = max(1e-30, float(np.abs(want).max()))
  assert np.abs(got - want).max() <= bar * scale, (
      np.abs(got - want).max() / scale, bar)


CASES = [  # (dtype, t, d, causal, tkv, with_seg); each JAX call compiles
    ("float32", 16, 16, False, None, False),
    ("float32", 48, 72, False, None, True),
    ("float32", 40, 16, True, 24, False),
    ("bfloat16", 48, 16, True, None, True),
    ("bfloat16", 16, 72, False, 40, False),
]


@pytest.mark.parametrize("dtype,t,d,causal,tkv,with_seg", CASES)
def test_blocked_path_matches_jax(dtype, t, d, causal, tkv, with_seg):
  q, k, v, do = _inputs(3, t, 2, d, tkv)
  seg = _seg(3, t) if with_seg else None
  cast = lambda x: jnp.asarray(x).astype(_JNP[dtype])
  fn = lambda q, k, v: j_flash.flash_attention(
      q, k, v, causal=causal, block_q=16, block_kv=16,
      seg=None if seg is None else jnp.asarray(seg))
  want_o, vjp = jax.vjp(fn, cast(q), cast(k), cast(v))
  want = [np.asarray(x.astype(jnp.float32))
          for x in (want_o, *vjp(cast(do)))]

  leaves = [torch.from_numpy(x).to(_TORCH[dtype]).requires_grad_()
            for x in (q, k, v)]
  out = t_flash.flash_attention(
      *leaves, causal=causal, block_q=16, block_kv=16,
      seg=None if seg is None else torch.from_numpy(seg))
  out.backward(torch.from_numpy(do).to(_TORCH[dtype]))
  got = [out] + [x.grad for x in leaves]
  for g, w, x in zip(got, want, (q, q, k, v)):
    assert g.dtype == _TORCH[dtype] and g.shape == x.shape
    _close(g, w, _BAR[dtype])
  if with_seg:  # the all-zero seg row and its keys: exact zeros
    for g in got:
      assert g[-1].abs().max().item() == 0.0
    for g in got[2:]:  # dk and dv of every seg=0 key
      assert g[torch.from_numpy(seg) == 0].abs().max().item() == 0.0


def test_reference_lse_and_masked_rows():
  """The plain forward's LSE equals log(sum(exp(s))) per row; a row with no
  visible key has o = 0 and LSE = -1e30, as `_fwd_kernel` writes them."""
  q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2, 24, 2, 16))
  seg = torch.from_numpy(_seg(2, 24))
  o, lse = t_flash.flash_attention_blocked_reference(q, k, v)
  s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 4.0
  torch.testing.assert_close(lse, torch.logsumexp(s, -1).reshape(4, 24))
  o, lse = t_flash.flash_attention_blocked_reference(q, k, v, seg=seg)
  assert o[1].abs().max().item() == 0.0
  assert (lse[2:] == t_flash.NEG_INF).all()


def test_dispatch_follows_oneshot_fits():
  """D=64: one-shot at T=864, blocked at T=901, as in the JAX package."""
  assert t_flash.oneshot_fits(864, 864, 64)
  assert not t_flash.oneshot_fits(901, 901, 64)
  q, k, v, _ = (torch.from_numpy(x).to(torch.bfloat16)
                for x in _inputs(1, 901, 1, 64, seed=2))
  got = t_flash.flash_attention(q, k, v)
  want, _ = t_flash.flash_attention_blocked_reference(q, k, v)
  torch.testing.assert_close(got, want, rtol=0, atol=0)
  got = t_flash.flash_attention(q[:, :864], k[:, :864], v[:, :864])
  want = t_flash.flash_attention_reference(q[:, :864], k[:, :864],
                                           v[:, :864])
  torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_oneshot_fits_equals_jax():
  ts = (16, 100, 197, 257, 577, 640, 768, 864, 900, 901, 1024, 1025, 1601)
  for tq in ts:
    for tkv in ts:
      for d in (16, 64, 72, 128, 256):
        assert (t_flash.oneshot_fits(tq, tkv, d)
                == j_flash.oneshot_fits(tq, tkv, d)), (tq, tkv, d)


@pytest.mark.parametrize("block_q", [0, -16, 16.0, "16"])
def test_bad_block_sizes_are_refused(block_q):
  q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 16, 1, 16))
  with pytest.raises(ValueError, match="block_q"):
    t_flash.flash_attention(q, k, v, block_q=block_q)


def test_kernels_need_cuda():
  """Each blocked wrapper launches its kernel or raises: only the autograd
  Function picks a plain version, and only for a CPU tensor. A tensor on
  another device (here `meta`, which a machine without a card has) goes to
  the kernels' wrappers and raises."""
  q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 16, 2, 16))
  lse = delta = torch.zeros((2, 16))
  for fn, args in (
      (t_flash.flash_attention_blocked_forward, (q, k, v)),
      (t_flash.flash_attention_blocked_dq, (q, k, v, do, lse, delta)),
      (t_flash.flash_attention_blocked_dkv, (q, k, v, do, lse, delta)),
      (t_flash.flash_attention_blocked_bwd, (q, k, v, q, lse, do))):
    with pytest.raises(ValueError, match="cuda"):
      fn(*args)
  meta = [x.to("meta") for x in (q, k, v, q, lse)] + [None]
  ctx = types.SimpleNamespace(saved_tensors=meta, causal=False, block_q=16,
                              block_kv=16)
  with pytest.raises(ValueError, match="cuda, not meta"):
    t_flash._FlashAttentionBlocked.backward(ctx, do.to("meta"))

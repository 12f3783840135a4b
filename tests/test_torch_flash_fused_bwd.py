"""Port's fused blocked backward (K5's plain version) vs the JAX one.

The JAX side is `_bwd_fused` in interpret mode on the CPU, called on the
padded inputs that `_attend_bwd` passes it (the residuals of `_attend_fwd`
and the padded output cotangent), and `jax.grad` of the blocked
`flash_attention` with the package's `FUSED_BLOCKED_BWD` set, as
tests/test_flash_attention.py sets it. The port side is
`flash_attention_blocked_bwd_fused_reference` on the same (unpadded) inputs,
and its `flash_attention` with the port's flag set, which on CPU tensors
runs that plain version inside the blocked autograd Function. Inputs are
drawn with numpy from a seed; T <= 64 with blocks of 16 keeps the
interpret-mode kernels fast. Both sides compute in f32 and differ only in
the order of sums (atol 1e-5, rtol 1e-4), also where the plain version
groups its dq sums in chunks of key tiles as the K5 kernel does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch.ops import flash_attention as t_flash
from big_vision_tpu.ops import flash_attention as j_flash

B, H, BLOCK = 2, 2, 16


def _inputs(t, d, tkv=None, seed=0):
  rs = np.random.RandomState(seed)
  tkv = tkv or t
  return [0.5 * rs.randn(*shape).astype(np.float32)
          for shape in ((B, t, H, d), (B, tkv, H, d), (B, tkv, H, d),
                        (B, t, H, d))]


def _seg(t):
  """Row 0: two prefix-LM segments and trailing padding; row 1: all
  padding (seg = 0), whose gradients must be exact zeros."""
  seg = np.zeros((B, t), np.int32)
  seg[0, : t - 5] = 1 + (np.arange(t - 5) >= t // 3)
  return seg


def _bh(x):
  """[B, T, H, D] numpy -> [B*H, T, D] jnp, the JAX kernels' layout."""
  return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, x.shape[1], -1))


def _bthd(x, t):
  """[B*H, T_pad, D] -> [B, T, H, D] numpy (the unpadded rows)."""
  x = np.array(x[:, :t])
  return np.ascontiguousarray(x.reshape(B, H, t, -1).transpose(0, 2, 1, 3))


@pytest.fixture
def jax_fused():
  old = j_flash.FUSED_BLOCKED_BWD
  try:
    j_flash.FUSED_BLOCKED_BWD = True
    jax.clear_caches()
    yield
  finally:
    j_flash.FUSED_BLOCKED_BWD = old
    jax.clear_caches()


@pytest.fixture
def port_fused(monkeypatch):
  monkeypatch.setattr(t_flash, "FUSED_BLOCKED_BWD", True)


CASES = [  # (t, d, causal, tkv, with_seg)
    (32, 16, False, None, False),
    (48, 32, True, None, False),
    (40, 16, False, None, True),   # ragged T with an all-padding row
    (24, 16, True, 56, False),     # Tq != Tkv, ragged both
]


@functools.cache
def _jax_bwd_fused(t, d, causal, tkv, with_seg):
  """(inputs, seg, o, lse, JAX `_bwd_fused`'s dq, dk, dv) of a case."""
  q, k, v, do = _inputs(t, d, tkv)
  seg = _seg(t) if with_seg else None
  seg_bh = None if seg is None else jnp.repeat(jnp.asarray(seg), H, axis=0)
  res = j_flash._attend_fwd(_bh(q), _bh(k), _bh(v), seg_bh, seg_bh, causal,
                            BLOCK, BLOCK)[1]
  qp, kp, vp, sq, sk, o, lse, seq_q, seq_kv, scale = res
  dop = j_flash._pad_to(_bh(do), qp.shape[1])
  want = j_flash._bwd_fused(qp, kp, vp, o, lse, dop, sq, sk, scale=scale,
                            causal=causal, block_q=BLOCK, block_kv=BLOCK,
                            seq_q=seq_q, seq_kv=seq_kv)
  want = [_bthd(x, n) for x, n in zip(want, (t, tkv or t, tkv or t))]
  return (q, k, v, do), seg, _bthd(o, t), np.array(lse[:, 0, :t]), want


def _check_plain_version(case, **kw):
  (q, k, v, do), seg, o, lse, want = _jax_bwd_fused(*case)
  got = t_flash.flash_attention_blocked_bwd_fused_reference(
      *map(torch.from_numpy, (q, k, v, o, lse, do)), causal=case[2],
      seg=None if seg is None else torch.from_numpy(seg), block_kv=BLOCK,
      **kw)
  for name, g, w in zip(("dq", "dk", "dv"), got, want):
    assert np.abs(w).max() > 0, name
    np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-4,
                               err_msg=name)
  if seg is not None:
    zero = seg == 0
    for g in got:
      assert g.numpy()[zero].max() == g.numpy()[zero].min() == 0.0


@pytest.mark.parametrize("t,d,causal,tkv,with_seg", CASES)
def test_plain_version_matches_jax_bwd_fused(t, d, causal, tkv, with_seg):
  _check_plain_version((t, d, causal, tkv, with_seg))


@pytest.mark.parametrize("t,d,causal,tkv,with_seg", CASES)
def test_chunked_plain_version_matches_jax_bwd_fused(t, d, causal, tkv,
                                                     with_seg):
  """The K5 kernel sums dq per chunk of key tiles and then the chunks in
  key order; its plain version, grouped alike (chunks of two 16-key
  tiles), still agrees with the JAX kernel's single sequence."""
  _check_plain_version((t, d, causal, tkv, with_seg), chunk_keys=2 * BLOCK)


def test_fused_bwd_fits_matches_jax():
  for tq in (16, 197, 1056, 1664, 4128, 8192, 10_000, 16_384):
    for d in (16, 64, 72, 128, 256):
      for bq, bkv in ((16, 16), (128, 128), (128, 64)):
        assert (t_flash.fused_bwd_fits(tq, tq, d, bq, bkv)
                == j_flash.fused_bwd_fits(tq, tq, d, bq, bkv)), (tq, d, bq)


def test_the_gate_sees_padded_lengths(port_fused):
  # A length that fits unpadded but not padded to its 128-row blocks: the
  # JAX `_bwd` sees the padded one, so the port must refuse K5 there too.
  t = next(t for t in range(8000, 12000)
           if t_flash.fused_bwd_fits(t, t, 64, 128, 128)
           and not t_flash.fused_bwd_fits(t_flash._r(t, 128), t, 64, 128,
                                          128))
  assert not t_flash.takes_fused_bwd(t, t, 64, 128, 128)
  assert t_flash.takes_fused_bwd(t - 128, t - 128, 64, 128, 128)
  assert t_flash.block_sizes(1601, 1601) == (128, 128)
  assert t_flash.block_sizes(20, 40) == (20, 40)
  assert t_flash.takes_fused_bwd(1601, 1601, 64, 128, 128)


def _port_grads(q, k, v, do, causal, seg):
  leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
  out = t_flash.flash_attention(
      *leaves, causal=causal, block_q=BLOCK, block_kv=BLOCK,
      seg=None if seg is None else torch.from_numpy(seg))
  out.backward(torch.from_numpy(do))
  return [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("t,d,causal,tkv,with_seg", CASES[1:3])
def test_flag_selects_the_fused_backward(t, d, causal, tkv, with_seg,
                                         monkeypatch, jax_fused):
  q, k, v, do = _inputs(t, d, tkv, seed=1)
  seg = _seg(t) if with_seg else None
  calls = []
  real = t_flash.flash_attention_blocked_bwd_fused_reference
  monkeypatch.setattr(t_flash, "flash_attention_blocked_bwd_fused_reference",
                      lambda *a, **kw: calls.append(kw) or real(*a, **kw))
  two = _port_grads(q, k, v, do, causal, seg)
  assert not calls
  monkeypatch.setattr(t_flash, "FUSED_BLOCKED_BWD", True)
  fused = _port_grads(q, k, v, do, causal, seg)
  # On the CPU the plain version runs at the kernel's own key tiles, not
  # at the blocks given to flash_attention.
  assert len(calls) == 1 and calls[0].get("block_kv") is None

  jseg = None if seg is None else jnp.asarray(seg)
  fn = lambda q, k, v: jnp.vdot(j_flash.flash_attention(
      q, k, v, causal=causal, seg=jseg, block_q=BLOCK, block_kv=BLOCK),
                                jnp.asarray(do))
  want = jax.grad(fn, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
  for f, g, w in zip(fused, two, want):
    np.testing.assert_allclose(f, g, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(f, np.asarray(w), atol=1e-5, rtol=1e-4)


def test_wrapper_refuses_cpu_tensors():
  q, k, v, do = (torch.from_numpy(x) for x in _inputs(16, 16))
  o, lse = t_flash.flash_attention_blocked_reference(q, k, v)
  with pytest.raises(ValueError, match="cuda"):
    t_flash.flash_attention_blocked_bwd_fused(q, k, v, o, lse, do)

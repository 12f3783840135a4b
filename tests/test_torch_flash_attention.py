"""Port's K1 plain version vs the JAX one-shot flash kernel (interpret mode).

Both sides get the same f32 inputs, drawn with numpy from a seed. They
differ only in summation order, so the bar is atol 1e-5 x max|output|.
TF32 is off so that f32 products stay f32 (only matters on a GPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch.ops import attention as t_attention
from big_vision_torch.ops import flash_attention as t_flash
from big_vision_tpu.ops import attention as j_attention
from big_vision_tpu.ops import flash_attention as j_flash

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _qkv(b, t, h, d, tkv=None, seed=0):
  rs = np.random.RandomState(seed)
  tkv = tkv or t
  return (rs.randn(b, t, h, d).astype(np.float32),
          rs.randn(b, tkv, h, d).astype(np.float32),
          rs.randn(b, tkv, h, d).astype(np.float32))


def _seg(b, t, seed=0):
  """Prefix-LM segments with trailing padding; the last row is all zero."""
  rs = np.random.RandomState(seed)
  seg = np.zeros((b, t), np.int32)
  for i in range(b - 1):
    n = rs.randint(t // 2, t + 1)
    seg[i, :n] = 1 + np.cumsum(rs.rand(n) < 0.3)
  return seg


def _close(got, want):
  want = np.asarray(want)
  scale = max(1.0, float(np.abs(want).max()))
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("t,d,causal,tkv,with_seg", [
    (16, 16, False, None, False),
    (48, 72, False, None, False),
    (197, 16, False, None, False),
    (48, 16, True, None, False),
    (48, 16, False, None, True),
    (16, 72, False, 40, False),
])
def test_reference_matches_jax_kernel(t, d, causal, tkv, with_seg):
  q, k, v = _qkv(2 if t > 100 else 3, t, 2, d, tkv)
  seg = _seg(q.shape[0], t) if with_seg else None
  want = j_flash.flash_attention(
      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
      seg=None if seg is None else jnp.asarray(seg))
  got = t_flash.flash_attention(
      torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
      causal=causal, seg=None if seg is None else torch.from_numpy(seg))
  _close(got, want)
  if with_seg:  # an all-zero seg row attends nothing and emits exact zeros
    assert got[-1].abs().max().item() == 0.0


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_dispatch_matches_jax(impl):
  q, k, v = _qkv(2, 16, 2, 16, seed=1)
  seg = _seg(2, 16, seed=1)
  for kw in ({}, {"seg": seg}):
    want = j_attention.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl=impl,
        **{n: jnp.asarray(x) for n, x in kw.items()})
    got = t_attention.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        impl=impl, **{n: torch.from_numpy(x) for n, x in kw.items()})
    _close(got, want)


def test_bool_mask_takes_math_path():
  q, k, v = _qkv(2, 16, 2, 16, seed=2)
  mask = np.tril(np.ones((16, 16), bool))[None, None]
  want = j_attention.dot_product_attention(
      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask))
  got = t_attention.dot_product_attention(
      torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
      mask=torch.from_numpy(mask))
  _close(got, want)


def test_wrapper_checks_shapes():
  q, k, v = (torch.from_numpy(x) for x in _qkv(1, 16, 2, 16))
  with pytest.raises(ValueError):
    t_flash.flash_attention(q, k[..., :8], v)
  with pytest.raises(ValueError):
    t_flash.flash_attention(q, k, v, seg=torch.ones(1, 8, dtype=torch.int32))

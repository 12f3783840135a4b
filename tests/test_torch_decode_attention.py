"""Port's K6 plain version vs the JAX decode kernel (interpret mode).

Mirrors tests/test_decode_attention.py: the grid quant x (K, G), softcap,
and fully masked rows. Both sides round operands to bf16 the same way and
accumulate in f32, so the bar is atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch.ops import decode_attention as t_da
from big_vision_tpu.models.ppp import gemma as j_gemma
from big_vision_tpu.ops import decode_attention as j_da

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _inputs(b, kh, g, s, h, quant, seed=0):
  """numpy q, k, v, mask, k_scale, v_scale; the last example is masked out."""
  rs = np.random.RandomState(seed)
  q = rs.randn(b, kh, g, h).astype(np.float32)
  kf = rs.randn(b, kh, s, h).astype(np.float32)
  vf = rs.randn(b, kh, s, h).astype(np.float32)
  lengths = [max(1, s - 1 - 3 * i) for i in range(b)]
  lengths[-1] = 0 if b > 2 else lengths[-1]
  mask = np.arange(s)[None, :] < np.array(lengths)[:, None]
  if not quant:
    bf = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16))
    return q, bf(kf), bf(vf), mask, None, None
  (kq, ks), (vq, vs) = j_gemma._quant_kv(kf), j_gemma._quant_kv(vf)
  return q, *(np.asarray(x) for x in (kq, vq)), mask, *(
      np.asarray(x) for x in (ks, vs))


def _torch(x):
  if x is None:
    return None
  if x.dtype.name == "bfloat16":
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
  return torch.from_numpy(np.array(x))


def _run_both(args, softcap=0.0):
  q, k, v, mask, ks, vs = args
  jx = lambda x: None if x is None else jnp.asarray(x)
  want = j_da.decode_attention(jx(q), jx(k), jx(v), jx(mask), k_scale=jx(ks),
                               v_scale=jx(vs), logits_softcap=softcap)
  got = t_da.decode_attention(*(_torch(x) for x in (q, k, v, mask)),
                              k_scale=_torch(ks), v_scale=_torch(vs),
                              logits_softcap=softcap)
  return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("kh,g", [(1, 8), (4, 2), (2, 3)])
def test_reference_matches_jax_kernel(quant, kh, g):
  got, want = _run_both(_inputs(3, kh, g, 140, 64, quant))
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
  assert np.abs(got[-1]).max() == 0.0  # the fully masked example


def test_softcap():
  args = _inputs(2, 2, 4, 64, 32, True, seed=1)
  got, want = _run_both(args, softcap=50.0)
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
  uncapped, _ = _run_both(args)
  assert np.abs(got - uncapped).max() > 1e-4


def test_wrapper_checks_inputs():
  q, k, v, mask, ks, vs = (_torch(x) for x in _inputs(2, 1, 8, 32, 16, True))
  with pytest.raises(ValueError):  # an int8 cache needs its scales
    t_da.decode_attention(q, k, v, mask)
  with pytest.raises(ValueError):
    t_da.decode_attention(q, k, v, mask[:, :8], k_scale=ks, v_scale=vs)

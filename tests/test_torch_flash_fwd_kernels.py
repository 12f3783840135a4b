"""K1's wrapper picks its kernel by dtype alone, and refuses what neither takes.

bf16 inputs go to the tensor-core kernel (csrc/flash_fwd_tc.cu), f32 inputs
to the scalar one (csrc/flash_fwd.cu); there is no switch between them and
no fallback. The kernels themselves run only on the card (chip_smoke.py
holds both against the plain version); on the CPU the wrapper refuses, and
the autograd Function runs the plain forward. The plain version's bf16
semantics (p rounded to bf16 before p.v, which the tensor-core kernel
keeps) are held against the JAX kernel in interpret mode, at the bar of
docs/flash_parity.md: 1e-2 of max|JAX|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch.ops import _build
from big_vision_torch.ops import flash_attention as t_flash
from big_vision_tpu.ops import flash_attention as j_flash


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "flash_fwd_tc"),
                                        (torch.float32, "flash_fwd")])
def test_each_dtype_has_its_kernel(dtype, name):
  assert t_flash.fwd_kernel(dtype) == name
  src = (_build._CSRC / f"{name}.cu").read_text()
  assert f'extern "C" int bvt_{name}(' in src
  assert "_oneshot_fwd_kernel" in src  # the TPU kernel it replaces


def test_tensor_core_kernel_uses_the_tensor_cores():
  src = (_build._CSRC / "flash_fwd_tc.cu").read_text()
  assert '#include "flash_tc_common.cuh"' in src
  src += (_build._CSRC / "flash_tc_common.cuh").read_text()
  for instr in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                "ldmatrix.sync.aligned.m8n8.x4.shared.b16",
                "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16",
                "cp.async.cg.shared.global", "cp.async.wait_group"):
    assert instr in src, instr
  # The scalar kernel keeps no bf16 instantiation.
  assert "bfloat16" not in (_build._CSRC / "flash_fwd.cu").read_text()


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int32])
def test_other_dtypes_are_refused(dtype):
  with pytest.raises(ValueError, match="K1 takes"):
    t_flash.fwd_kernel(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrapper_launches_or_raises(dtype):
  """A CPU tensor is refused (the wrapper never runs the plain version);
  no launch is counted."""
  rs = np.random.RandomState(0)
  q, k, v = (torch.from_numpy(rs.randn(1, 16, 2, 16).astype(np.float32))
             .to(dtype) for _ in range(3))
  before = (t_flash.flash_attention_forward.launches,
            t_flash.flash_attention_forward.tc_launches)
  with pytest.raises(ValueError, match="cuda"):
    t_flash.flash_attention_forward(q, k, v)
  assert (t_flash.flash_attention_forward.launches,
          t_flash.flash_attention_forward.tc_launches) == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,with_seg", [(False, False), (True, False),
                                             (False, True)])
def test_cpu_autograd_takes_the_plain_forward(dtype, causal, with_seg):
  rs = np.random.RandomState(1)
  q, k, v = (torch.from_numpy(rs.randn(3, 40, 2, 24).astype(np.float32))
             .to(dtype) for _ in range(3))
  seg = (torch.from_numpy(_seg(3, 40)) if with_seg else None)
  got = t_flash.flash_attention(q, k, v, causal=causal, seg=seg)
  want = t_flash.flash_attention_reference(q, k, v, causal=causal, seg=seg)
  assert got.dtype == dtype
  torch.testing.assert_close(got, want, rtol=0, atol=0)


def _seg(b, t, seed=0):
  """Prefix-LM segments with trailing padding; the last row is all zero."""
  rs = np.random.RandomState(seed)
  seg = np.zeros((b, t), np.int32)
  for i in range(b - 1):
    n = rs.randint(t // 2, t + 1)
    seg[i, :n] = 1 + np.cumsum(rs.rand(n) < 0.3)
  return seg


@pytest.mark.parametrize("t,d,causal,with_seg", [(48, 72, False, True),
                                                 (196, 64, True, False)])
def test_bf16_reference_matches_jax_kernel(t, d, causal, with_seg):
  """The plain version in bf16 against the JAX one-shot kernel on the same
  bf16 inputs: both round p to bf16 before p.v; only the order of f32 sums
  and the exponentials' last bits differ."""
  b = 3 if with_seg else 2
  rs = np.random.RandomState(7)
  q, k, v = (rs.randn(b, t, 2, d).astype(np.float32) for _ in range(3))
  seg = _seg(b, t, seed=2) if with_seg else None
  jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
  assert j_flash.oneshot_fits(t, t, d)  # the JAX call takes the one-shot path
  want = np.asarray(j_flash.flash_attention(
      jq, jk, jv, causal=causal,
      seg=None if seg is None else jnp.asarray(seg)).astype(jnp.float32))
  tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
  got = t_flash.flash_attention(
      tq, tk, tv, causal=causal,
      seg=None if seg is None else torch.from_numpy(seg))
  assert got.dtype == torch.bfloat16
  err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
  assert err <= 1e-2, err
  if with_seg:  # an all-zero seg row attends nothing and emits exact zeros
    assert got[-1].abs().max().item() == 0.0

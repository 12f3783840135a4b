"""K2's wrapper picks its kernel by dtype alone, and refuses what neither takes.

bf16 inputs go to the bf16 tensor-core kernel (csrc/flash_bwd_tc.cu), f32
inputs to the 3xTF32 one (csrc/flash_bwd.cu, tested further in
tests/test_torch_tf32_products.py); there is no switch between them and no
fallback. The kernels themselves run only on the card (chip_smoke.py
holds both against the plain version); on the CPU the wrapper refuses, and
the autograd Function runs the plain backward.
"""

import numpy as np
import pytest
import torch

from big_vision_torch.ops import _build
from big_vision_torch.ops import flash_attention as t_flash


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "flash_bwd_tc"),
                                        (torch.float32, "flash_bwd")])
def test_each_dtype_has_its_kernel(dtype, name):
  assert t_flash.bwd_kernel(dtype) == name
  src = (_build._CSRC / f"{name}.cu").read_text()
  assert f'extern "C" int bvt_{name}(' in src
  assert "_oneshot_bwd_kernel" in src  # the TPU kernel it replaces


def test_tensor_core_kernel_uses_the_tensor_cores():
  # The instructions sit in the header the kernel shares with K1's
  # tensor-core kernel.
  src = (_build._CSRC / "flash_bwd_tc.cu").read_text()
  assert '#include "flash_tc_common.cuh"' in src
  src += (_build._CSRC / "flash_tc_common.cuh").read_text()
  for instr in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                "ldmatrix.sync.aligned.m8n8.x4.shared.b16",
                "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16",
                "cp.async.cg.shared.global", "cp.async.wait_group"):
    assert instr in src, instr
  # The f32 kernel keeps no bf16 instantiation.
  assert "bfloat16" not in (_build._CSRC / "flash_bwd.cu").read_text()


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int32])
def test_other_dtypes_are_refused(dtype):
  with pytest.raises(ValueError, match="K2 takes"):
    t_flash.bwd_kernel(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrapper_launches_or_raises(dtype):
  """A CPU tensor is refused (the wrapper never runs the plain version);
  no launch is counted."""
  rs = np.random.RandomState(0)
  q, k, v, do = (torch.from_numpy(rs.randn(1, 16, 2, 16).astype(np.float32))
                 .to(dtype) for _ in range(4))
  before = (t_flash.flash_attention_bwd.launches,
            t_flash.flash_attention_bwd.tc_launches)
  with pytest.raises(ValueError, match="cuda"):
    t_flash.flash_attention_bwd(q, k, v, torch.zeros((2, 16)), do)
  assert (t_flash.flash_attention_bwd.launches,
          t_flash.flash_attention_bwd.tc_launches) == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_autograd_takes_the_plain_backward(dtype):
  rs = np.random.RandomState(1)
  q, k, v, do = (torch.from_numpy(rs.randn(2, 40, 2, 24).astype(np.float32))
                 .to(dtype) for _ in range(4))
  leaves = [x.clone().requires_grad_() for x in (q, k, v)]
  t_flash.flash_attention(*leaves).backward(do)
  want = t_flash.flash_attention_bwd_reference(q, k, v, do)
  for leaf, w in zip(leaves, want):
    assert leaf.grad.dtype == dtype
    torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)

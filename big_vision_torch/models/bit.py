"""BiT ResNet-V1 (post-activation bottlenecks, GroupNorm + weight
standardisation): port of big_vision_tpu/models/bit.py.

The same stage table (`STAGE_PLAN`, depths 26-200, or a list of block
counts), the width multiplier (`int(64 * width)` root channels), the
module names (`conv_root`, `gn_root`, `block{i}/unit{j}/conv{1,2,3}`,
`gn{1,2,3}`, `conv_proj`, `gn_proj`, `head`) and the taps `stem`,
`stage1..4`, `pre_logits_2d`, `pre_logits`, `logits_2d`, `logits`. Every
conv is `convnets.WSConv` ("std" flavour, eps 1e-5, JAX's SAME padding)
followed by `convnets.GroupNorm` (32 groups, eps 1e-6, (C,) params); the
projection shortcut sees the unit's raw input; each unit's last GN scale
and the head's kernel start at zero. The root max-pool is 3x3/2 SAME with
-inf padding, after the root GN and relu.

`load` reads a checkpoint through `fix_old_checkpoints` (flax's
`convert_pre_linen` renumbering, `vit.convert_pre_linen`, and the GN
params squeezed from (1, 1, 1, C) to (C,)), on nested dicts of numpy
arrays in the JAX layout; `utils/convert.py` maps the result onto the
module. Nothing is fetched: a `gs://` name is refused.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from big_vision_torch.models import common
from big_vision_torch.models import convnets as cn
from big_vision_torch.models import vit
from big_vision_torch.utils import checkpoints
from big_vision_torch.utils import trees

# Bottleneck-block counts per named depth.
STAGE_PLAN = {
    26: [2, 2, 2, 2],
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
    200: [3, 24, 36, 3],
}


def get_block_desc(depth):
  if isinstance(depth, list):
    depth = tuple(depth)
  return STAGE_PLAN.get(depth, depth)


def _conv_gn(parent, conv, gn, features_in, features, ksize, strides=1,
             zero_scale=False, device="cuda"):
  """Adds `conv_gn`'s WSConv `conv` and GroupNorm `gn` to `parent`."""
  parent.add_module(conv, cn.WSConv(features_in, features, ksize, strides,
                                    device=device))
  parent.add_module(gn, cn.GroupNorm(features, zero_scale=zero_scale,
                                     device=device))


class ResidualUnit(nn.Module):
  """1x1 -> 3x3(stride) -> 1x1 bottleneck; GN after each conv, relu after
  the sum; a projection (conv + GN on the raw input) where the shape
  changes."""

  def __init__(self, features_in, nmid=None, strides=(1, 1), *,
               device="cuda"):
    super().__init__()
    mid = nmid or features_in // 4
    wide = 4 * mid
    strides = tuple(strides)
    self.has_proj = strides != (1, 1) or features_in != wide
    if self.has_proj:
      _conv_gn(self, "conv_proj", "gn_proj", features_in, wide, 1, strides,
               device=device)
    _conv_gn(self, "conv1", "gn1", features_in, mid, 1, device=device)
    _conv_gn(self, "conv2", "gn2", mid, mid, 3, strides, device=device)
    _conv_gn(self, "conv3", "gn3", mid, wide, 1, zero_scale=True,
             device=device)

  def forward(self, x):
    shortcut = self.gn_proj(self.conv_proj(x)) if self.has_proj else x
    y = torch.relu(self.gn1(self.conv1(x)))
    y = torch.relu(self.gn2(self.conv2(y)))
    y = self.gn3(self.conv3(y))
    return torch.relu(shortcut + y)


class ResNetStage(nn.Module):
  """`block_size` units named unit1, unit2, ...; the first strided."""

  def __init__(self, features_in, block_size, first_stride=(1, 1),
               nmid=None, *, device="cuda"):
    super().__init__()
    self.block_size = block_size
    for i in range(block_size):
      unit = ResidualUnit(features_in, nmid,
                          first_stride if i == 0 else (1, 1), device=device)
      self.add_module(f"unit{i + 1}", unit)
      features_in = 4 * (nmid or features_in // 4)

  def forward(self, x):
    for i in range(self.block_size):
      x = getattr(self, f"unit{i + 1}")(x)
    return x


class Model(nn.Module):
  """ResNetV1 with GN+WS (the BiT recipe); `forward(image [N, H, W, C])`
  -> (logits or pre-logits, {tap name: tensor})."""

  def __init__(self, num_classes: Optional[int] = None, width: float = 1,
               depth: Union[int, Sequence[int]] = 50, *, channels=3,
               device="cuda"):
    super().__init__()
    plan = get_block_desc(depth)
    base = int(64 * width)
    _conv_gn(self, "conv_root", "gn_root", channels, base, 7, (2, 2),
             device=device)
    self.num_stages = len(plan)
    features = base
    for i, nblocks in enumerate(plan):
      self.add_module(f"block{i + 1}", ResNetStage(
          features, nblocks, (1, 1) if i == 0 else (2, 2),
          nmid=base * 2 ** i, device=device))
      features = 4 * base * 2 ** i
    self.head = (common.Dense(features, num_classes, kernel_init="zeros",
                              device=device) if num_classes else None)

  @torch.no_grad()
  def initialize(self, generator, head_bias=None):
    """Draws every parameter from scratch with the JAX model's
    initializers (lecun_normal kernels, GN scales 1 but each unit's gn3 at
    0, the head's kernel 0) and, when given, sets the trainer's
    `init_head_bias`. Returns the module."""
    for module in self.modules():
      if module is not self and hasattr(module, "reset_parameters"):
        module.reset_parameters(generator)
    if head_bias is not None:
      common.init(self.head.bias, ("constant", head_bias), generator)
    return self

  def forward(self, image, *, train=False, rng=None):
    del train, rng  # no dropout or other draws
    out = {}
    x = torch.relu(self.gn_root(self.conv_root(image)))
    x = out["stem"] = cn.max_pool(x, (3, 3), (2, 2), "SAME")
    for i in range(self.num_stages):
      x = out[f"stage{i + 1}"] = getattr(self, f"block{i + 1}")(x)
    out["pre_logits_2d"] = x
    x = out["pre_logits"] = x.mean(dim=(1, 2))
    if self.head is not None:
      out["logits_2d"] = self.head(out["pre_logits_2d"])
      x = out["logits"] = self.head(x)
    return x, out


_GN_NAMES = {"gn_root", "gn_proj", "gn1", "gn2", "gn3"}


def fix_old_checkpoints(params):
  """flax's `convert_pre_linen` renumbering, then every GroupNorm param
  squeezed to (C,) (pre-linen checkpoints held them as (1, 1, 1, C))."""
  flat = trees.flatten(vit.convert_pre_linen(params))
  flat = {k: np.squeeze(v) if _GN_NAMES & set(k.split("/")) else v
          for k, v in flat.items()}
  return trees.unflatten(flat)


def refuse_remote(name, fname):
  """Raises for a `gs://` file name: nothing is fetched."""
  if isinstance(fname, str) and fname.startswith("gs://"):
    raise ValueError(
        f"{name!r} names the published checkpoint {fname}, which is not "
        f"fetched: pass the path of a local .npz as the config's `init` "
        f"arg (transfer.py) or `teacher_init` arg (the distill configs)")


def load(init_params, init_file, model_cfg, dont_load=()):
  """Loads a BiT checkpoint; `init_params` is the model's own tree (numpy,
  JAX layout; `utils/convert.params`). Returns the merged tree."""
  del model_cfg
  refuse_remote(init_file, init_file)
  restored = common.merge_params(checkpoints.load_params(init_file),
                                 init_params, dont_load)
  return fix_old_checkpoints(restored)

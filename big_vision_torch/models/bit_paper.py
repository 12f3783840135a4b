"""BiT ResNet-V2 (pre-activation), as in the Big Transfer paper: port of
big_vision_tpu/models/bit_paper.py.

The paper's numerics: RMS-standardised convs (`convnets.WSConv` "rms",
eps 1e-10 inside the sqrt, no bias) and mean-of-squares GroupNorm (`msq`,
eps 1e-5; (1, 1, 1, C) params in the JAX tree, (C,) here). The root block
is a 7x7/2 conv padded (3, 3) and a 3x3/2 max-pool padded (1, 1) with
-inf: no norm or relu comes between them, so the pool's padding shows.
Each unit is GN+relu before each of its convs (the 3x3 padded (1, 1));
its projection sees the normalised input `preact(1, x)`. Units are named
`unit01`, `unit02`, ... and each stage's tap is {unit name: output}; then
`norm-pre-head` (named `norm_pre_head` here), `pre_logits_2d`,
`pre_logits` and the head (zero kernel with `head_zeroinit`).

`load` maps the JAX package's names of the published checkpoints (`L`,
`M`, `S` upstreams, the distilled `FunMatch` students) to their file
names and refuses them (nothing is fetched: the config's `init` or
`teacher_init` arg names a local `.npz`); a local file in the TF release
layout (`resnet/block1/unit01/a/standardized_conv2d/kernel`,
`.../group_norm/gamma`, ...) is converted by
`maybe_convert_big_transfer_format` (`to_big_transfer_format` writes
one).
"""

from __future__ import annotations

import re
from typing import Optional, Sequence, Union

import torch
from torch import nn

from big_vision_torch.models import bit
from big_vision_torch.models import common
from big_vision_torch.models import convnets as cn
from big_vision_torch.utils import checkpoints
from big_vision_torch.utils import trees

# The paper flavour of the convs and GroupNorms.
_CONV = dict(ws="rms", eps=1e-10, use_bias=False)
_GN = dict(msq=True, eps=1e-5)


def _gn(channels, device):
  return cn.GroupNorm(channels, **_GN, device=device)


class RootBlock(nn.Module):
  """7x7/2 conv padded (3, 3), then a 3x3/2 max-pool padded (1, 1)."""

  def __init__(self, channels, width, *, device="cuda"):
    super().__init__()
    self.conv_root = cn.WSConv(channels, width, 7, 2,
                               padding=[(3, 3), (3, 3)], **_CONV,
                               device=device)

  def forward(self, x):
    return cn.max_pool(self.conv_root(x), (3, 3), (2, 2),
                       [(1, 1), (1, 1)])


class ResidualUnit(nn.Module):
  """Pre-activation bottleneck: GN+relu precede each conv."""

  def __init__(self, features_in, nmid=None, strides=(1, 1), *,
               device="cuda"):
    super().__init__()
    mid = nmid or features_in // 4
    wide = 4 * mid
    strides = tuple(strides)
    self.gn1 = _gn(features_in, device)
    self.has_proj = strides != (1, 1) or features_in != wide
    if self.has_proj:
      self.conv_proj = cn.WSConv(features_in, wide, 1, strides, **_CONV,
                                 device=device)
    self.conv1 = cn.WSConv(features_in, mid, 1, **_CONV, device=device)
    self.gn2 = _gn(mid, device)
    self.conv2 = cn.WSConv(mid, mid, 3, strides, padding=[(1, 1), (1, 1)],
                           **_CONV, device=device)
    self.gn3 = _gn(mid, device)
    self.conv3 = cn.WSConv(mid, wide, 1, **_CONV, device=device)

  def forward(self, x):
    y = torch.relu(self.gn1(x))
    # The projection sees the normalised input, unlike models/bit.py's.
    shortcut = self.conv_proj(y) if self.has_proj else x
    y = self.conv1(y)
    y = self.conv2(torch.relu(self.gn2(y)))
    y = self.conv3(torch.relu(self.gn3(y)))
    return y + shortcut


class ResNetStage(nn.Module):
  """`block_size` units named unit01, unit02, ...; the first strided."""

  def __init__(self, features_in, block_size, nmid=None,
               first_stride=(1, 1), *, device="cuda"):
    super().__init__()
    self.names = [f"unit{i + 1:02d}" for i in range(block_size)]
    for i, name in enumerate(self.names):
      self.add_module(name, ResidualUnit(
          features_in, nmid, first_stride if i == 0 else (1, 1),
          device=device))
      features_in = 4 * (nmid or features_in // 4)

  def forward(self, x):
    taps = {}
    for name in self.names:
      x = taps[name] = getattr(self, name)(x)
    return x, taps


class Model(nn.Module):
  """ResNetV2 with GN+WS (BiT paper flavour); `forward(image [N, H, W,
  C])` -> (logits or pre-logits, {tap name: tensor or {unit: tensor}})."""

  def __init__(self, num_classes: Optional[int] = None,
               depth: Union[int, Sequence[int]] = 50, width: float = 1,
               head_zeroinit: bool = True, *, channels=3, device="cuda"):
    super().__init__()
    plan = bit.get_block_desc(depth)
    base = int(64 * width)
    self.root_block = RootBlock(channels, base, device=device)
    self.num_stages = len(plan)
    features = base
    for i, nblocks in enumerate(plan):
      self.add_module(f"block{i + 1}", ResNetStage(
          features, nblocks, base * 2 ** i,
          first_stride=(1, 1) if i == 0 else (2, 2), device=device))
      features = 4 * base * 2 ** i
    self.norm_pre_head = _gn(features, device)
    self.head = (common.Dense(
        features, num_classes, device=device,
        kernel_init="zeros" if head_zeroinit else "lecun_normal")
                 if num_classes else None)

  @torch.no_grad()
  def initialize(self, generator, head_bias=None):
    """Draws every parameter from scratch with the JAX model's
    initializers (lecun_normal kernels, GN scales 1, the head's kernel 0
    with `head_zeroinit`) and, when given, sets the trainer's
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
    x = out["stem"] = self.root_block(image)
    for i in range(self.num_stages):
      x, out[f"stage{i + 1}"] = getattr(self, f"block{i + 1}")(x)
    x = out["norm_pre_head"] = self.norm_pre_head(x)
    x = out["pre_logits_2d"] = torch.relu(x)
    x = out["pre_logits"] = x.mean(dim=(1, 2))
    if self.head is None:
      return x, out
    out["logits_2d"] = self.head(out["pre_logits_2d"])
    x = out["logits"] = self.head(x)
    return x, out


# The JAX package's names of the distilled students' checkpoints.
VANITY = {
    "FunMatch-224px-i1k82.8": "gs://bit_models/distill/R50x1_224.npz",
    "FunMatch-160px-i1k80.5": "gs://bit_models/distill/R50x1_160.npz",
}


def checkpoint_name(init_file, model_cfg):
  """The file the JAX `load` reads for `init_file`: an upstream name `L`,
  `M` or `S` (with "-<dataset>" for a downstream one) becomes
  gs://bit_models/BiT-<up>-R<depth>x<width>[-<down>].npz, a `VANITY` name
  its file; anything else is a path."""
  if init_file and init_file[0] in ("L", "M", "S"):
    upstream, downstream = ((init_file.split("-", 1) + [""])[:2]
                            if "-" in init_file else (init_file, ""))
    if downstream:
      downstream = "-" + {"imagenet2012": "ILSVRC2012"}.get(downstream,
                                                            downstream)
    cfg = dict(model_cfg)
    return (f"gs://bit_models/BiT-{upstream}-"
            f"R{cfg['depth']}x{cfg['width']}{downstream}.npz")
  return VANITY.get(init_file, init_file)


def load(init_params, init_file, model_cfg, dont_load=()):
  """Loads a BiT-{L,M,S} checkpoint (the TF release layout converted) and
  merges it with `init_params`, the model's own tree (numpy, JAX layout;
  `utils/convert.params`). A published name is refused, naming the
  config args that take a local path in its place."""
  fname = checkpoint_name(init_file, model_cfg)
  bit.refuse_remote(init_file, fname)
  params = maybe_convert_big_transfer_format(checkpoints.load_params(fname))
  return common.merge_params(params, init_params, dont_load)


def maybe_convert_big_transfer_format(params_tf):
  """Converts the original TF BiT release layout to this module's tree;
  any other tree is returned as it is."""
  if "resnet" not in params_tf:
    return params_tf

  flat = trees.flatten(params_tf)
  # The TF export numbers repeated conv layers; collapse the suffix.
  flat = {re.sub(r"/standardized_conv2d_\d+/", "/standardized_conv2d/", k): v
          for k, v in flat.items()}

  def gn_of(prefix):
    return {"bias": flat[f"{prefix}/beta"][None, None, None],
            "scale": flat[f"{prefix}/gamma"][None, None, None]}

  params = {
      "root_block": {"conv_root": {
          "kernel": flat["resnet/root_block/standardized_conv2d/kernel"]}},
      "norm-pre-head": gn_of("resnet/group_norm"),
      "head": {"kernel": flat["resnet/head/conv2d/kernel"][0, 0],
               "bias": flat["resnet/head/conv2d/bias"]},
  }
  for block in ("block1", "block2", "block3", "block4"):
    units = {m.group(0) for k in flat if block in k
             for m in [re.search(r"unit\d+", k)] if m}
    params[block] = {}
    for unit in sorted(units):
      tf_base = f"resnet/{block}/{unit}"
      tree = {}
      for i, branch in enumerate("abc", 1):
        tree[f"conv{i}"] = {"kernel": flat[
            f"{tf_base}/{branch}/standardized_conv2d/kernel"]}
        tree[f"gn{i}"] = gn_of(f"{tf_base}/{branch}/group_norm")
      projs = [k for k in flat if f"{block}/{unit}/a/proj" in k]
      if len(projs) > 1:
        raise ValueError(f"more than one projection in {unit}: {projs}")
      if projs:
        tree["conv_proj"] = {"kernel": flat[projs[0]]}
      params[block][unit] = tree
  return params


def to_big_transfer_format(params):
  """A tree of this module (JAX layout) in the TF BiT release layout, the
  inverse of `maybe_convert_big_transfer_format`: what a published BiT
  file holds, each unit's convs numbered standardized_conv2d, _1, _2 as
  the TF export numbers them. Stand-ins for the published files are
  written with it."""
  flat = {}

  def gn(prefix, tree):
    flat[f"{prefix}/gamma"] = tree["scale"].reshape(-1)
    flat[f"{prefix}/beta"] = tree["bias"].reshape(-1)

  flat["resnet/root_block/standardized_conv2d/kernel"] = params[
      "root_block"]["conv_root"]["kernel"]
  gn("resnet/group_norm", params["norm-pre-head"])
  flat["resnet/head/conv2d/kernel"] = params["head"]["kernel"][None, None]
  flat["resnet/head/conv2d/bias"] = params["head"]["bias"]
  for block in ("block1", "block2", "block3", "block4"):
    for unit, tree in params[block].items():
      base = f"resnet/{block}/{unit}"
      for i, branch in enumerate("abc", 1):
        suffix = "" if i == 1 else f"_{i - 1}"
        flat[f"{base}/{branch}/standardized_conv2d{suffix}/kernel"] = tree[
            f"conv{i}"]["kernel"]
        gn(f"{base}/{branch}/group_norm", tree[f"gn{i}"])
      if "conv_proj" in tree:
        flat[f"{base}/a/proj/standardized_conv2d/kernel"] = tree[
            "conv_proj"]["kernel"]
  return trees.unflatten(flat)

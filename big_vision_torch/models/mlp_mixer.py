"""MLP-Mixer (arxiv.org/abs/2105.01601): port of
big_vision_tpu/models/mlp_mixer.py.

The same variant table, blocks and param names as the JAX model: a SAME
patch-embedding stem (`vit.PatchEmbed`), `num_blocks` MixerBlocks (a
token-mixing MLP over the transposed token and channel axes, then a
channel-mixing MLP, each a pre-LayerNorm residual branch), a LayerNorm,
the mean over the tokens (`pre_logits`) and a zero-initialized head.
`dtype_mm` sets the dtype of the stem's and the MLPs' matmuls; the
LayerNorms (eps 1e-6) and the head compute in the promoted type of their
input and parameters, as flax does with `dtype=None`.

Stochastic depth (`_keep_branch`): in training, each residual branch of
block i is multiplied by a per-example 0/1, drawn from the `rng`
generator, that is 0 with probability `stoch_depth * i / (num_blocks -
1)`; the kept branches are not rescaled by 1 / (1 - p), unlike
torchvision's StochasticDepth.

`load` reads a Mixer checkpoint, also in the original paper's layout
(blocks nested under "Mixer" with fused MLP names), as the JAX `load`
does; `utils/convert.mixer` maps the tree onto the module.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from big_vision_torch.models import common
from big_vision_torch.models import vit
from big_vision_torch.utils import checkpoints


def _keep_branch(x, drop_p, rng):
  """The stochastic-depth multiplier of a branch: 1.0, or in training a
  per-example f32 0/1 of shape [N, 1, ...] (0 with probability drop_p)."""
  if rng is None or not drop_p:
    return 1.0
  shape = (x.shape[0],) + (1,) * (x.dim() - 1)
  return (torch.rand(shape, generator=rng, device=x.device)
          >= drop_p).float()


class MlpBlock(nn.Module):
  """Dense -> tanh GELU -> Dense back to the input width."""

  def __init__(self, width, mlp_dim, *, dtype_mm="float32", device="cuda",
               param_dtype=torch.float32):
    super().__init__()
    kw = dict(dtype=dtype_mm, device=device, param_dtype=param_dtype)
    self.fc1 = common.Dense(width, mlp_dim, **kw)
    self.fc2 = common.Dense(mlp_dim, width, **kw)

  def forward(self, x):
    return self.fc2(common.gelu(self.fc1(x)))


class MixerBlock(nn.Module):
  """Token mixing, then channel mixing, each a pre-LN residual branch."""

  def __init__(self, width, tokens, tokens_mlp_dim, channels_mlp_dim,
               drop_p, *, dtype_mm="float32", device="cuda",
               param_dtype=torch.float32):
    super().__init__()
    kw = dict(device=device, param_dtype=param_dtype)
    self.ln0 = common.LayerNorm(width, **kw)
    self.token_mixing = MlpBlock(tokens, tokens_mlp_dim, dtype_mm=dtype_mm,
                                 **kw)
    self.ln1 = common.LayerNorm(width, **kw)
    self.channel_mixing = MlpBlock(width, channels_mlp_dim,
                                   dtype_mm=dtype_mm, **kw)
    self.drop_p = drop_p

  def forward(self, x, rng=None):
    y = self.token_mixing(self.ln0(x).transpose(-1, -2)).transpose(-1, -2)
    x = x + y * _keep_branch(x, self.drop_p, rng)
    y = self.channel_mixing(self.ln1(x))
    return x + y * _keep_branch(x, self.drop_p, rng)


class MlpMixer(nn.Module):
  """Mixer backbone + mean-pool + linear head; `forward(image [N, H, W,
  C])` -> (logits or pre-logits, {intermediate name: tensor})."""

  def __init__(self, patch_size: Sequence[int], hidden_dim, num_blocks,
               tokens_mlp_dim, channels_mlp_dim,
               num_classes: Optional[int] = None, stoch_depth=0.0,
               dtype_mm="float32", *, image_size=224, channels=3,
               device="cuda", param_dtype=torch.float32):
    super().__init__()
    kw = dict(device=device, param_dtype=param_dtype)
    self.dtype_mm = common.resolve_dtype(dtype_mm)
    self.stoch_depth = stoch_depth
    self.stem = vit.PatchEmbed(hidden_dim, patch_size, channels,
                               dtype_mm=dtype_mm, padding="SAME", **kw)
    grid = [-(-image_size // p) for p in patch_size]  # SAME: ceil
    # Stochastic depth ramps linearly: 0 at the first block, `stoch_depth`
    # at the last.
    denom = max(num_blocks - 1, 1)
    self.blocks = nn.ModuleList([
        MixerBlock(hidden_dim, grid[0] * grid[1], tokens_mlp_dim,
                   channels_mlp_dim, stoch_depth * i / denom,
                   dtype_mm=dtype_mm, **kw)
        for i in range(num_blocks)])
    self.pre_head_layer_norm = common.LayerNorm(hidden_dim, **kw)
    self.head = (common.Dense(hidden_dim, num_classes, kernel_init="zeros",
                              **kw) if num_classes else None)

  @torch.no_grad()
  def initialize(self, generator, head_bias=None):
    """Draws every parameter from scratch with the JAX model's
    initializers (flax's defaults; the head's kernel zero) and, when
    given, sets the trainer's `init_head_bias`. Returns the module."""
    for module in self.modules():
      if module is not self and hasattr(module, "reset_parameters"):
        module.reset_parameters(generator)
    if head_bias is not None:
      common.init(self.head.bias, ("constant", head_bias), generator)
    return self

  def forward(self, image, *, train=False, rng=None):
    """With `train` and a stochastic depth, `rng` (a torch.Generator on the
    image's device) draws the per-example branch masks."""
    if train and self.stoch_depth and rng is None:
      raise ValueError("stochastic depth needs a generator: pass rng=")
    rng = rng if train else None
    out = {}
    tokens = out["stem"] = self.stem(image.to(self.dtype_mm))
    x = out["input_tokens"] = tokens.flatten(1, 2)
    for i, block in enumerate(self.blocks):
      x = out[f"block_{i}"] = block(x, rng)
    pooled = out["pre_logits"] = self.pre_head_layer_norm(x).mean(1)
    if self.head is None:
      return pooled, out
    out["logits"] = self.head(pooled)
    return out["logits"], out


# (hidden_dim, num_blocks, tokens_mlp_dim, channels_mlp_dim) per size.
_VARIANTS = {
    "S": (512, 8, 256, 2048),
    "B": (768, 12, 384, 3072),
    "L": (1024, 24, 512, 4096),
    "H": (1280, 32, 640, 5120),
}

_GEOM_KEYS = ("hidden_dim", "num_blocks", "tokens_mlp_dim",
              "channels_mlp_dim")


def Model(num_classes=None, *, variant=None, **kw):  # pylint: disable=invalid-name
  """Builds a Mixer from a variant string like "B/16" (or from explicit
  geometry without one)."""
  if variant is None:
    return MlpMixer(num_classes=num_classes, **kw)
  size, _, patch = variant.partition("/")
  geom = dict(zip(_GEOM_KEYS, _VARIANTS[size]),
              patch_size=(int(patch),) * 2)
  return MlpMixer(num_classes=num_classes, **{**geom, **kw})


# The JAX package's names of the paper's checkpoints; nothing is fetched:
# a checkpoint is read from a local path.
_PAPER_CKPTS = {
    "B-i1k/16": "gs://mixer_models/imagenet1k/Mixer-B_16.npz",
    "L-i1k/16": "gs://mixer_models/imagenet1k/Mixer-L_16.npz",
    "B-i21k/16": "gs://mixer_models/imagenet21k/Mixer-B_16.npz",
    "L-i21k/16": "gs://mixer_models/imagenet21k/Mixer-L_16.npz",
}


def load(init_params, init_file, model_cfg, dont_load=()):
  """Loads a Mixer checkpoint, also in the original paper's layout.

  `init_params` is the model's own tree (numpy, JAX layout; see
  `utils/convert.mixer_params`); returns the merged tree in that layout.
  """
  del model_cfg
  restored = vit.convert_pre_linen(checkpoints.load_params(
      _PAPER_CKPTS.get(init_file, init_file)))

  if "Mixer" in restored:
    # The original paper's layout: blocks nested under "Mixer" with
    # fused-phase MLP names. Unfold them into this model's tree.
    restored["pre_head_layer_norm"] = restored["Mixer"].pop("encoder_norm")
    restored["stem"] = restored.pop("embedding")

    def unfuse(phase):
      return {f"Dense_{j}": {"bias": phase[f"bias{j + 1}"].squeeze(),
                             "kernel": phase[f"kernel{j + 1}"].squeeze()}
              for j in range(2)}

    for key, block in restored.pop("Mixer").items():
      idx = key.removeprefix("encoderblock_")
      if idx == key:
        raise ValueError(f"unexpected Mixer entry {key}")
      block["token_mixing"] = unfuse(block.pop("token_mixing_phase_0"))
      block["channel_mixing"] = unfuse(block.pop("channel_mixing_phase_0"))
      restored[f"MixerBlock_{idx}"] = block

  return common.merge_params(restored, init_params, dont_load)

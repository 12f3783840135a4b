"""FlexiViT: port of big_vision_tpu/models/proj/flexi/vit.py.

A ViT whose token grid is chosen per call (`seqhw`): the stored patch
kernel is PI-resized to the patch size that tiles the image into a
seqhw x seqhw grid (`resample_patchemb`), and the learned position
embedding is resized from its stored `posemb_size` grid to that grid as
`jax.image.resize(..., "linear")` resizes it (antialiased when
downsampling). The trunk, readout and head are `models/vit.py`'s, and the
parameters carry the same names, so `utils/convert.vit` and
`convert.vit_names` serve this model too.

Both resize operators are constants built in numpy from the 1-D matrices
of `_linear_resize_mat_1d`, cached per (stored, new) size and device, and
applied as products, so autograd flows into the stored kernel and posemb.

Differences from the JAX model: the output dict holds no `logits_2d` (a
head over every token: at seqhw 40 and 21843 classes that is 4.5 GB per
32 images, which XLA drops under jit as unused and an eager forward would
compute) and no per-block `encoder` outputs; `attn_impl` selects the
attention implementation as in `models/vit.py` (the JAX model always
takes "auto").

`load` reads a (Flexi)ViT checkpoint as `vit.load` does and resizes its
posemb (`vit.resample_posemb`) and patch kernel (`resample_patchemb`) to
this model's, on numpy trees in the JAX layout.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from big_vision_torch.models import common
from big_vision_torch.models import vit
from big_vision_torch.utils import checkpoints

# Published FlexiViT checkpoints, keyed by vanity name.
_CKPT_DIR = "gs://big_vision/flexivit"
VANITY_NAMES = {
    vanity: f"{_CKPT_DIR}/{fname}.npz" for vanity, fname in (
        ("FlexiViT-L i1k", "flexivit_l_i1k"),
        ("FlexiViT-B i1k", "flexivit_b_i1k"),
        ("FlexiViT-S i1k", "flexivit_s_i1k"),
        ("FlexiViT-B i21k 90ep", "flexivit_b_i21k_90ep"),
        ("FlexiViT-B i21k 300ep", "flexivit_b_i21k_300ep"),
        ("FlexiViT-B i21k 1000ep", "flexivit_b_i21k_1000ep"),
        ("ViT-B/16 i21k", "vit_b16_i21k_300ep"),
        ("ViT-B/30 i21k", "vit_b30_i21k_300ep"),
    )
}


def _linear_resize_mat_1d(n_in, n_out):
  """[n_out, n_in] matrix of jax.image.resize(method="linear").

  Triangle kernel over half-pixel-centered coordinates, widened by the
  scale factor when downsampling (antialias), weights normalized.
  """
  scale = n_out / n_in
  # Input-space sample position of each output pixel.
  x = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
  s = max(1.0, 1.0 / scale)  # kernel width (antialias on downsample)
  j = np.arange(n_in, dtype=np.float64)
  w = np.maximum(0.0, 1.0 - np.abs(x[:, None] - j[None, :]) / s)
  return (w / w.sum(axis=1, keepdims=True)).astype(np.float32)


@functools.cache
def _patch_pinv(old_hw, new_hw, device):
  """[prod(new_hw), prod(old_hw)] f32 on `device`: the pseudo-inverse of
  the transposed 2-D patch-resize operator (the Kronecker product of the
  two 1-D ones), computed once in numpy as the JAX package computes it."""
  op = np.kron(_linear_resize_mat_1d(old_hw[0], new_hw[0]),
               _linear_resize_mat_1d(old_hw[1], new_hw[1]))
  return torch.from_numpy(np.linalg.pinv(op.T)).to(device, torch.float32)


@functools.cache
def _resize_mats(old_hw, new_hw, device):
  """The two 1-D linear-resize matrices on `device`."""
  return tuple(torch.from_numpy(_linear_resize_mat_1d(o, n)).to(device)
               for o, n in zip(old_hw, new_hw))


def resample_patchemb(weight, old_hw, new_hw):
  """PI-resize of a patch kernel stored [width, old_h*old_w*c] in
  (h, w, c) order to one of patch size `new_hw`, in the same layout.

  Chosen so that `resampled . resized_patch ~= kernel . patch` (the JAX
  package's `resample_patchemb` on the [h, w, c, width] kernel).
  """
  old_hw, new_hw = tuple(old_hw), tuple(new_hw)
  if len(new_hw) != 2:
    raise ValueError(f"target must be (h, w), got {new_hw}")
  if new_hw == old_hw:
    return weight
  width = weight.shape[0]
  pinv = _patch_pinv(old_hw, new_hw, weight.device)
  planes = weight.reshape(width, old_hw[0] * old_hw[1], -1)
  new = torch.einsum("nm,wmc->wnc", pinv.to(weight.dtype), planes)
  return new.reshape(width, -1)


def resize_posemb(pos, old_hw, new_hw):
  """[1, old_h*old_w, c] -> [1, new_h*new_w, c], as
  `jax.image.resize(pos.reshape(1, *old_hw, c), (1, *new_hw, c), "linear")`
  resizes it."""
  if tuple(old_hw) == tuple(new_hw):
    return pos
  mh, mw = _resize_mats(tuple(old_hw), tuple(new_hw), pos.device)
  grid = pos.reshape(*old_hw, pos.shape[-1])
  out = torch.einsum("ai,bj,ijc->abc", mh.to(pos.dtype), mw.to(pos.dtype),
                     grid)
  return out.reshape(1, -1, pos.shape[-1])


class Patchify(nn.Module):
  """Patch embedding whose stored kernel is PI-resized per requested grid.

  The kernel is stored [width, ph*pw*c] as in `vit.PatchEmbed`; the product
  runs in the promoted type of the image and the kernel, as the JAX
  model's convolution does.
  """

  def __init__(self, width, patch_size=(32, 32), channels=3, *,
               device="cuda", param_dtype=torch.float32):
    super().__init__()
    self.patch_size = tuple(patch_size)
    ph, pw = self.patch_size
    kw = dict(device=device, dtype=param_dtype)
    self.weight = nn.Parameter(torch.empty(width, ph * pw * channels, **kw))
    self.bias = nn.Parameter(torch.empty(width, **kw))

  def reset_parameters(self, generator):
    """N(0, width^-1/2) kernel and zero bias, as the JAX Patchify."""
    common.init(self.weight, ("normal", self.weight.shape[0] ** -0.5),
                generator)
    common.init(self.bias, "zeros", generator)

  def forward(self, image, seqhw):
    patch = tuple(side // seqhw for side in image.shape[1:3])
    weight = resample_patchemb(self.weight, self.patch_size, patch)
    return vit.patchify(image, weight, self.bias, patch)


class _Model(nn.Module):
  """FlexiViT; `forward(image [N, H, W, C], seqhw=...)` -> (reps, out)."""

  def __init__(self, num_classes, *, depth=12, width=768, num_heads=12,
               mlp_dim=None, pool_type="gap", head_zeroinit=True,
               dtype_mm="float32", posemb="learn",
               patch_size: Sequence[int] = (32, 32),
               posemb_size: Sequence[int] = (7, 7),
               seqhw: Optional[int] = None, attn_impl="auto", channels=3,
               device="cuda", param_dtype=torch.float32):
    super().__init__()
    if pool_type not in ("map", "gap", "tok"):
      raise ValueError(f"Unknown pool type {pool_type!r}")
    if posemb not in ("learn", "sincos2d"):
      raise ValueError(f"Unknown posemb type: {posemb}")
    kw = dict(device=device, param_dtype=param_dtype)
    self.pool_type, self.posemb = pool_type, posemb
    self.posemb_size = tuple(posemb_size)
    self.seqhw = seqhw
    self.embedding = Patchify(width, patch_size, channels, **kw)
    if posemb == "learn":
      self.pos_embedding = nn.Parameter(torch.empty(
          1, int(np.prod(self.posemb_size)), width, device=device,
          dtype=param_dtype))
    if pool_type == "tok":
      self.cls = nn.Parameter(torch.empty(1, 1, width, device=device,
                                          dtype=param_dtype))
    self.encoder = vit.Encoder(width, depth, num_heads, mlp_dim,
                               dtype_mm=dtype_mm, attn_impl=attn_impl, **kw)
    self.map_head = (vit.MAPHead(width, num_heads, mlp_dim, **kw)
                     if pool_type == "map" else None)
    self.head = (common.Dense(
        width, num_classes,
        kernel_init="zeros" if head_zeroinit else "lecun_normal", **kw)
                 if num_classes else None)

  @torch.no_grad()
  def initialize(self, generator, head_bias=None):
    """Draws every parameter from scratch, as the JAX model's `init` does
    (see `vit._Model.initialize`); `head_bias` fills the head's bias."""
    for module in self.modules():
      if module is not self and hasattr(module, "reset_parameters"):
        module.reset_parameters(generator)
    width = self.embedding.weight.shape[0]
    if self.posemb == "learn":
      common.init(self.pos_embedding, ("normal", width ** -0.5), generator)
    if self.pool_type == "tok":
      common.init(self.cls, "zeros", generator)
    if self.map_head is not None:
      common.init(self.map_head.probe, "xavier_uniform", generator,
                  fan_in=1, fan_out=width)
    if head_bias is not None:
      common.init(self.head.bias, ("constant", head_bias), generator)
    return self

  def forward(self, image, *, seqhw=None, train=False):
    """(logits or pre-logits, {intermediate name: tensor}) at a token grid
    of `seqhw` x `seqhw` (default: the model's `seqhw`). The model has no
    dropout, so `train` changes nothing."""
    del train
    seqhw = seqhw or self.seqhw
    if seqhw is None:
      raise ValueError("pass seqhw= (the model has no default seqhw)")
    out = {}
    x = out["stem"] = self.embedding(image, seqhw)
    n, h, w, c = x.shape
    if self.posemb == "learn":
      pos = self.pos_embedding.to(x.dtype)
    else:
      pos = vit.posemb_sincos_2d(*self.posemb_size, c, dtype=x.dtype,
                                 device=x.device)
    pos = resize_posemb(pos, self.posemb_size, (h, w))
    x = out["with_posemb"] = x.reshape(n, h * w, c) + pos
    if self.pool_type == "tok":
      x = torch.cat([self.cls.to(x.dtype).expand(n, -1, -1), x], dim=1)

    x = out["encoded"] = self.encoder(x)
    x, spatial = vit.readout(x, self.pool_type, self.map_head)
    out["head_input"] = out["pre_logits"] = x
    out["pre_logits_2d"] = spatial.reshape(n, h, w, -1)
    if self.head is not None:
      x = out["logits"] = self.head(x)
    return x, out


def Model(num_classes, *, variant=None, **kw):  # pylint: disable=invalid-name
  """Factory taking the JAX model's config keys ("B" etc. in `variant`)."""
  return _Model(num_classes, **{**vit.decode_variant(variant), **kw})


def load(init_params, init_file, model_cfg, dont_load=()):
  """Loads (Flexi)ViT checkpoints, resizing pos+patch embeddings.

  `init_params` is the model's own tree (numpy, JAX layout; see
  `utils/convert.vit_params`); returns the merged tree in the same layout.
  """
  vanity = {**vit.VANITY_NAMES, **VANITY_NAMES}
  restored = vit.fix_old_checkpoints(
      checkpoints.load_params(vanity.get(init_file, init_file)))
  kernel = restored["embedding"]["kernel"]  # [h, w, c, width]
  new_hw = tuple(dict(model_cfg)["patch_size"])
  weight = resample_patchemb(
      torch.from_numpy(np.ascontiguousarray(
          kernel.reshape(-1, kernel.shape[-1]).T)), kernel.shape[:2], new_hw)
  resized = {
      "pos_embedding": vit.resample_posemb(
          old=restored["pos_embedding"],
          new=init_params["pos_embedding"]),
      "embedding": {**restored["embedding"],
                    "kernel": weight.numpy().T.reshape(
                        *new_hw, *kernel.shape[2:])},
  }
  return common.merge_params({**restored, **resized}, init_params, dont_load)

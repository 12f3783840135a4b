"""NaFlex ViT (SigLIP 2's native-aspect tower): port of
big_vision_tpu/models/proj/image_text/naflex_vit.py.

The input is the tuple (patches [B, N, p*p*c], type [B, N], yidx [B, N],
xidx [B, N]) of the NaFlex pp ops (pp/proj/image_text/ops_naflex.py); a
token is an image patch where type == 1 and padding elsewhere. The stem is
a linear patch embedding (optional LayerNorms before and after); the
learned 2D posemb table [n, n, width] is resized per example to that
example's patch grid and read at each patch's (y, x) (`pos_emb_resize`);
the trunk is `models/vit.py`'s Encoder and MAPHead, with padding masked:
`attn_impl="flash"` at N <= MAX_ONESHOT sends the padding as segment ids
(1 valid, 0 padding) to the fused kernels K1/K2, whose padded query rows
come out as exact zeros; elsewhere a [B, N, N] boolean mask takes the
plain path. `gap` and `max` pool over the valid tokens only.

`pos_emb_resize` computes what the JAX model's
`jax.image.scale_and_translate(bilinear, antialias=True)` to an l x l grid
followed by `lax.gather(mode="fill")` computes, but only at the gathered
coordinates: each output coordinate's triangle-kernel weights over the
table's rows (the kernel widened by 1/scale where the grid shrinks, the
weights normalized, zero weight for a sample outside the scaled extent),
and NaN for a coordinate at or past `l`, the gather's fill.
`F.interpolate(antialias=True)` places its samples otherwise and is not
this function.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from big_vision_torch.models import common
from big_vision_torch.models import vit
from big_vision_torch.ops import flash_attention as fa

_EPS_F32 = float(np.finfo(np.float32).eps)


def _decode_posemb(posemb):
  m = re.fullmatch(r"learn_2d\((\d+)\)", posemb)
  if m is None:
    return posemb, None
  return "learn_2d", int(m.group(1))


def _resize_weights(in_size, scale, coords):
  """[..., in_size] weights of the output samples `coords` (int, [...])
  of `jax.image.scale_and_translate`'s triangle kernel with antialias and
  no translation, at `scale` ([...] f32, output size / input size)."""
  inv_scale = 1.0 / scale
  kernel_scale = torch.clamp(inv_scale, min=1.0)
  sample_f = (coords.float() + 0.5) * inv_scale - 0.5
  src = torch.arange(in_size, dtype=torch.float32, device=coords.device)
  x = (sample_f[..., None] - src).abs() / kernel_scale[..., None]
  w = torch.clamp(1 - x.abs(), min=0.0)
  total = w.sum(-1, keepdim=True)
  w = torch.where(total.abs() > 1000.0 * _EPS_F32,
                  w / torch.where(total != 0, total, torch.ones_like(total)),
                  torch.zeros_like(w))
  inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
  return torch.where(inside[..., None], w, torch.zeros_like(w))


def pos_emb_resize(table, grids_hw, coords, l):
  """Per-example bilinear resize of the posemb `table` [n, m, width] to
  each example's grid `grids_hw` [B, 2], read at `coords` [B, T, 2];
  [B, T, width]. A coordinate at or past `l` (the JAX model's static
  grid bound) reads NaN, as the JAX gather's fill."""
  n, m, _ = table.shape
  canon = torch.tensor([n, m], dtype=torch.float32, device=table.device)
  scale = grids_hw.float() / canon  # [B, 2]
  y, x = coords[..., 0], coords[..., 1]
  wy = _resize_weights(n, scale[:, None, 0].expand_as(y), y)  # [B, T, n]
  wx = _resize_weights(m, scale[:, None, 1].expand_as(x), x)  # [B, T, m]
  t = table.float()
  out = torch.einsum("bti,btj,ijc->btc", wy, wx, t).to(table.dtype)
  outside = ((y < 0) | (y >= l) | (x < 0) | (x >= l))[..., None]
  return torch.where(outside, torch.full_like(out, float("nan")), out)


def masked_pool(x, keep, pool_type):
  """Pools [B, T, D] over the valid (keep) tokens only."""
  keep = keep[..., None].to(x.dtype)
  if pool_type == "gap":
    return (x * keep).sum(1) / keep.sum(1)
  if pool_type == "max":
    neg = torch.where(keep > 0, torch.zeros_like(keep),
                      torch.full_like(keep, torch.finfo(x.dtype).min))
    return (x * keep + neg).amax(1)
  raise ValueError(f"Unknown pool type {pool_type!r}")


class _Model(nn.Module):
  """NaFlex ViT; `forward((patches, type, yidx, xidx))` -> (reps, out)."""

  def __init__(self, num_classes=None, *, width=768, depth=12, mlp_dim=None,
               num_heads=12, pool_type="gap", rep_size=False,
               head_zeroinit=True, posemb="learn_2d(64)", nposemb=None,
               patchln_pre=False, patchln_post=False, dtype_mm="float32",
               attn_impl="xla", remat=False, patch_dim=768, device="cuda",
               param_dtype=torch.float32):
    super().__init__()
    kind, grid = _decode_posemb(posemb)
    if kind != "learn_2d":
      raise ValueError(f"Unknown posemb {posemb!r}")
    if pool_type not in ("map", "gap", "max", "none"):
      raise ValueError(f"Unknown pool type {pool_type!r}")
    kw = dict(device=device, param_dtype=param_dtype)
    self.grid = grid or 64
    self.pool_type = pool_type
    self.attn_impl = attn_impl
    self.dtype_mm = common.resolve_dtype(dtype_mm)
    self.patchln_pre = (common.LayerNorm(patch_dim, **kw)
                        if patchln_pre else None)
    self.embedding = common.Dense(patch_dim, width, dtype=dtype_mm, **kw)
    self.patchln_post = (common.LayerNorm(width, **kw)
                         if patchln_post else None)
    self.pos_embedding = nn.Parameter(torch.empty(
        nposemb, nposemb, width, device=device,
        dtype=self.dtype_mm or param_dtype))
    self.encoder = vit.Encoder(width, depth, num_heads, mlp_dim,
                               dtype_mm=dtype_mm, attn_impl=attn_impl,
                               remat=remat, **kw)
    self.map_head = (vit.MAPHead(width, num_heads, mlp_dim,
                                 dtype_mm=dtype_mm, **kw)
                     if pool_type == "map" else None)
    self.rep_size = rep_size
    hid = width if rep_size is True else rep_size
    if rep_size:
      self.pre_logits = common.Dense(width, hid, **kw)
    self.head = (common.Dense(
        hid if rep_size else width, num_classes,
        kernel_init="zeros" if head_zeroinit else "lecun_normal", **kw)
                 if num_classes else None)

  @torch.no_grad()
  def initialize(self, generator, head_bias=None):
    """Draws every parameter as the JAX model's `init`: each layer's
    `reset_parameters`, the posemb table N(0, 1/width), the MAP probe
    xavier_uniform. Returns the module."""
    del head_bias
    for module in self.modules():
      if module is not self and hasattr(module, "reset_parameters"):
        module.reset_parameters(generator)
    width = self.pos_embedding.shape[-1]
    common.init(self.pos_embedding, ("normal", width ** -0.5), generator)
    if self.map_head is not None:
      common.init(self.map_head.probe, "xavier_uniform", generator,
                  fan_in=1, fan_out=width)
    return self

  def forward(self, image, *, train=False, rng=None):
    del train, rng  # no dropout in this tower, as in JAX
    out = {}
    patches, ptype, yabs, xabs = image
    valid = ptype == 1
    patches = patches.to(self.dtype_mm or torch.float32)
    if self.patchln_pre is not None:
      patches = self.patchln_pre(patches)
    x = out["stem"] = self.embedding(patches)
    if self.patchln_post is not None:
      x = self.patchln_post(x)

    coords = torch.stack([yabs, xabs], dim=-1).long()
    grids_hw = coords.amax(dim=1) + 1
    x = x + pos_emb_resize(self.pos_embedding, grids_hw, coords, self.grid)
    out["with_posemb"] = x

    # Padding only: segment ids (1 valid, 0 padding) for the fused
    # kernels, the [B, T, T] boolean mask otherwise.
    if self.attn_impl == "flash" and patches.shape[1] <= fa.MAX_ONESHOT:
      mask, seg = None, valid.to(torch.int32)
    else:
      mask, seg = valid[:, :, None] & valid[:, None, :], None
    x = out["encoded"] = self.encoder(x, mask=mask, seg=seg)

    if self.pool_type == "map":
      x = self.map_head(x, mask=valid)
    elif self.pool_type != "none":
      x = masked_pool(x, valid, self.pool_type)
    out["head_input"] = x
    if self.rep_size:
      x = torch.tanh(self.pre_logits(x))
    out["pre_logits"] = x
    if self.head is not None:
      x = out["logits"] = self.head(x)
    return x, out


def Model(num_classes=None, *, variant=None, scan=None, remat_policy=None,
          image_size=None, channels=3, patch_size=16, **kw):  # pylint: disable=invalid-name
  """Factory taking the JAX model's config keys. `scan` remats every block,
  as the JAX Encoder under scan does. Patching happens in pp; the stem's
  input length is ph x pw x `channels`, of the variant's patch size (else
  `patch_size`), which the port needs to build the weight (the JAX Dense
  reads it from its input)."""
  del remat_policy, image_size
  cfg = dict(vit.decode_variant(variant))
  ph, pw = cfg.pop("patch_size", (patch_size, patch_size))
  cfg.update(kw)
  cfg.setdefault("patch_dim", ph * pw * channels)
  return _Model(num_classes, remat=bool(scan), **cfg)


load = vit.load

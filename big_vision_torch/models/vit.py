"""Vision Transformer: port of big_vision_tpu/models/vit.py.

Same variant table, posembs, readouts and dtype rules as the JAX model:
`dtype_mm` sets the matmul dtype and the block LayerNorm output dtype (the
residual stream stays in it; LayerNorm statistics are f32), while
`encoder_norm`, `pre_logits` and `head` compute in the promoted type of
their input and parameters, as flax does with `dtype=None`. Attention goes
through `ops.attention`, whose "auto" takes the JAX package's gate (the
fused kernel K1 wherever `oneshot_fits`).

Scan-over-layers is a JAX compile-time device, not a model: the port has a
plain list of blocks, and `utils/convert.py` reads both param layouts. What
`scan=True` also brings in the JAX model is kept: remat, each block run
under a checkpoint that keeps only its input while autograd records
(`common.checkpointed`; the JAX model applies it under scan whatever
`remat_policy` names, and a policy that saves more computes the same
function). The learned posemb needs its length when the module is built, so
the port takes `image_size`.

Training: `forward(image, train=True, rng=generator)` applies dropout where
the JAX model does (after the posemb, inside the MLP, on each residual
branch), drawing from the given `torch.Generator`. `initialize(generator)`
draws every parameter from scratch with the JAX model's initializers (see
`models/common.init`).

Checkpoints: `load` reads a ViT checkpoint of any historical layout
(`fix_old_checkpoints`), in either layer layout (`pyloop_to_scan`,
`scan_to_pyloop`), merges it with the model's own params
(`common.merge_params`) and resamples the learned posemb
(`resample_posemb`), all on nested dicts of numpy arrays in the JAX layout,
as the JAX package's `load` does; `utils/convert.vit` maps the result onto
the module. `VANITY_NAMES` are the JAX package's names of the published
checkpoints; nothing is fetched.
"""

from __future__ import annotations

import re
from typing import Sequence, Union

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from big_vision_torch.models import common
from big_vision_torch.ops import attention as attn_ops
from big_vision_torch.utils import checkpoints
from big_vision_torch.utils import trees


def posemb_sincos_2d(h, w, width, temperature=10_000., dtype=torch.float32,
                     device=None):
  """2D sin-cos position embedding [1, h*w, width]: [sin x, cos x, sin y,
  cos y], each a width/4-band geometric sweep from 1 to 1/temperature."""
  if width % 4:
    raise ValueError("Width must be a multiple of 4 for sincos posemb")
  bands = width // 4
  freqs = temperature ** (-torch.arange(bands, device=device,
                                        dtype=torch.float32) / (bands - 1))
  grid_y, grid_x = torch.meshgrid(
      torch.arange(h, device=device), torch.arange(w, device=device),
      indexing="ij")
  phase = [grid_x.reshape(-1, 1) * freqs, grid_y.reshape(-1, 1) * freqs]
  pe = torch.cat([trig(p) for p in phase for trig in (torch.sin, torch.cos)],
                 dim=-1)
  return pe[None].to(dtype)


class PatchEmbed(nn.Module):
  """Non-overlapping patchify as a reshape + matmul (`padding` "VALID":
  remainder rows and columns are cropped; "SAME": zero-padded up to the
  next patch multiple, as the Mixer's stem). The weight is the JAX kernel
  [p, p, c, width] flattened in (ph, pw, c) order and stored
  [width, p*p*c]."""

  def __init__(self, width, patch_size, channels=3, *, dtype_mm="float32",
               padding="VALID", device="cuda", param_dtype=torch.float32):
    super().__init__()
    self.patch_size = tuple(patch_size)
    self.padding = padding
    ph, pw = self.patch_size
    kw = dict(device=device, dtype=param_dtype)
    self.weight = nn.Parameter(torch.empty(width, ph * pw * channels, **kw))
    self.bias = nn.Parameter(torch.empty(width, **kw))
    self.dtype_mm = common.resolve_dtype(dtype_mm)

  def reset_parameters(self, generator):
    """lecun_normal on the [p, p, c, width] kernel: fan_in = p * p * c."""
    common.init(self.weight, "lecun_normal", generator,
                fan_in=self.weight.shape[1])
    common.init(self.bias, "zeros", generator)

  def forward(self, image):
    return patchify(image, self.weight, self.bias, self.patch_size,
                    self.dtype_mm, self.padding)


def patchify(image, weight, bias, patch_size, dtype=None, padding="VALID"):
  """[N, H, W, C] -> [N, gh, gw, width]: the stride-p conv of a [p, p, c,
  width] kernel (stored [width, p*p*c] in (ph, pw, c) order) as a reshape +
  matmul in `dtype` (None: the promoted type). VALID crops the remainder
  rows and columns (gh = H // ph); SAME pads them with zeros at the bottom
  and right (gh = ceil(H / ph))."""
  ph, pw = patch_size
  if padding == "SAME":
    image = F.pad(image, (0, 0, 0, -image.shape[2] % pw,
                          0, -image.shape[1] % ph))
  elif padding != "VALID":
    raise ValueError(f"Unknown padding {padding!r}")
  n, h, w, c = image.shape
  image = image[:, :h - h % ph, :w - w % pw]
  gh, gw = h // ph, w // pw
  x = image.reshape(n, gh, ph, gw, pw, c).permute(0, 1, 3, 2, 4, 5)
  x = x.reshape(n, gh * gw, ph * pw * c)
  y = common.linear(x, weight, None, dtype)
  y = y + bias.to(y.dtype)
  return y.reshape(n, gh, gw, -1)


class MultiHeadAttention(nn.Module):
  """query/key/value/out projections (flax DenseGeneral layouts, stored as
  [out, in] matrices) around `ops.attention.dot_product_attention`."""

  def __init__(self, width, num_heads, *, dtype_mm="float32",
               attn_impl="auto", device="cuda", param_dtype=torch.float32):
    super().__init__()
    if width % num_heads:
      raise ValueError((width, num_heads))
    self.num_heads = num_heads
    self.attn_impl = attn_impl
    kw = dict(dtype=dtype_mm, device=device, param_dtype=param_dtype,
              kernel_init="xavier_uniform")
    self.query = common.Dense(width, width, **kw)
    self.key = common.Dense(width, width, **kw)
    self.value = common.Dense(width, width, **kw)
    self.out = common.Dense(width, width, **kw)

  def forward(self, xq, xkv, mask=None, seg=None):
    heads = lambda y: y.reshape(*y.shape[:2], self.num_heads, -1)
    q, k, v = heads(self.query(xq)), heads(self.key(xkv)), heads(
        self.value(xkv))
    out = attn_ops.dot_product_attention(q, k, v, mask=mask,
                                         impl=self.attn_impl, seg=seg)
    return self.out(out.reshape(*out.shape[:2], -1))


class MlpBlock(nn.Module):
  """Dense -> tanh GELU -> dropout -> Dense."""

  def __init__(self, width, mlp_dim=None, *, dtype_mm="float32",
               dropout=0.0, use_bias=True, device="cuda",
               param_dtype=torch.float32):
    super().__init__()
    kw = dict(dtype=dtype_mm, device=device, param_dtype=param_dtype,
              kernel_init="xavier_uniform", bias_init=("normal", 1e-6),
              use_bias=use_bias)
    self.fc1 = common.Dense(width, mlp_dim or 4 * width, **kw)
    self.fc2 = common.Dense(mlp_dim or 4 * width, width, **kw)
    self.dropout = dropout

  def forward(self, x, rng=None):
    h = common.dropout(common.gelu(self.fc1(x)), self.dropout, rng)
    return self.fc2(h)


class Encoder1DBlock(nn.Module):
  """Pre-norm block; the LayerNorms emit `dtype_mm`."""

  def __init__(self, width, num_heads, mlp_dim=None, *, dtype_mm="float32",
               attn_impl="auto", dropout=0.0, device="cuda",
               param_dtype=torch.float32):
    super().__init__()
    kw = dict(device=device, param_dtype=param_dtype)
    self.ln1 = common.LayerNorm(width, dtype=dtype_mm, **kw)
    self.attn = MultiHeadAttention(width, num_heads, dtype_mm=dtype_mm,
                                   attn_impl=attn_impl, **kw)
    self.ln2 = common.LayerNorm(width, dtype=dtype_mm, **kw)
    self.mlp = MlpBlock(width, mlp_dim, dtype_mm=dtype_mm, dropout=dropout,
                        **kw)
    self.dropout = dropout

  def forward(self, x, mask=None, seg=None, rng=None):
    if mask is not None and mask.dim() == 3:
      mask = mask[:, None]  # the (broadcast) head axis
    y = self.ln1(x)
    y = self.attn(y, y, mask=mask, seg=seg)
    x = x + common.dropout(y, self.dropout, rng)
    y = self.mlp(self.ln2(x), rng)
    return x + common.dropout(y, self.dropout, rng)


class Encoder(nn.Module):
  """Blocks then `encoder_norm` (flax default dtype: promoted); with
  `remat`, each block under `common.checkpointed` while autograd records."""

  def __init__(self, width, depth, num_heads, mlp_dim=None, *,
               dtype_mm="float32", attn_impl="auto", dropout=0.0,
               remat=False, device="cuda", param_dtype=torch.float32):
    super().__init__()
    kw = dict(device=device, param_dtype=param_dtype)
    self.remat = remat
    self.blocks = nn.ModuleList([
        Encoder1DBlock(width, num_heads, mlp_dim, dtype_mm=dtype_mm,
                       attn_impl=attn_impl, dropout=dropout, **kw)
        for _ in range(depth)])
    self.encoder_norm = common.LayerNorm(width, **kw)

  def forward(self, x, mask=None, seg=None, rng=None):
    remat = self.remat and torch.is_grad_enabled()
    for block in self.blocks:
      if remat:
        x = common.checkpointed(block, x, mask, seg, rng=rng)
      else:
        x = block(x, mask=mask, seg=seg, rng=rng)
    return self.encoder_norm(x)


class MAPHead(nn.Module):
  """Multihead attention pooling with a learned probe (math attention)."""

  def __init__(self, width, num_heads, mlp_dim=None, *, dtype_mm="float32",
               device="cuda", param_dtype=torch.float32):
    super().__init__()
    kw = dict(device=device, param_dtype=param_dtype)
    self.probe = nn.Parameter(torch.empty(1, 1, width, device=device,
                                          dtype=param_dtype))
    self.attn = MultiHeadAttention(width, num_heads, dtype_mm=dtype_mm,
                                   attn_impl="xla", **kw)
    self.ln = common.LayerNorm(width, **kw)
    self.mlp = MlpBlock(width, mlp_dim, dtype_mm=dtype_mm, **kw)

  def forward(self, x, mask=None):
    q = self.probe.to(x.dtype).expand(x.shape[0], -1, -1)
    if mask is not None:  # [B, T] validity -> [B, 1(head), 1(q), T]
      mask = mask[:, None, None, :]
    pooled = self.attn(q, x, mask=mask)
    pooled = pooled + self.mlp(self.ln(pooled))
    return pooled[:, 0]


def readout(x, pool_type, map_head=None):
  """Pools encoded tokens -> (pooled, spatial_tokens)."""
  if pool_type == "map":
    return map_head(x), x
  if pool_type == "gap":
    return x.mean(dim=1), x
  if pool_type == "0":
    return x[:, 0], x
  if pool_type == "tok":
    return x[:, 0], x[:, 1:]
  if pool_type == "none":
    return x, x
  raise ValueError(f"Unknown pool type: {pool_type!r}")


class _Model(nn.Module):
  """ViT; `forward(image [N, H, W, C])` -> (reps, out) as the JAX model."""

  def __init__(self, num_classes=None, *, width=768, depth=12, mlp_dim=None,
               num_heads=12, patch_size: Sequence[int] = (16, 16),
               posemb="learn", pool_type="gap",
               rep_size: Union[int, bool] = False, head_zeroinit: bool = True,
               dropout: float = 0.0, dtype_mm="float32", attn_impl="auto",
               remat: bool = False, image_size: int = 224, channels: int = 3,
               device="cuda", param_dtype=torch.float32):
    super().__init__()
    kw = dict(device=device, param_dtype=param_dtype)
    self.pool_type = pool_type
    self.posemb = posemb
    self.dropout = dropout
    self.dtype_mm = common.resolve_dtype(dtype_mm)
    self.embedding = PatchEmbed(width, patch_size, channels,
                                dtype_mm=dtype_mm, **kw)
    if posemb == "learn":
      tokens = (image_size // patch_size[0]) * (image_size // patch_size[1])
      self.pos_embedding = nn.Parameter(torch.empty(
          1, tokens, width, device=device, dtype=param_dtype))
    elif posemb != "sincos2d":
      raise ValueError(f"Unknown posemb type: {posemb}")
    if pool_type == "tok":
      self.cls = nn.Parameter(torch.empty(1, 1, width, device=device,
                                          dtype=param_dtype))
    self.encoder = Encoder(width, depth, num_heads, mlp_dim,
                           dtype_mm=dtype_mm, attn_impl=attn_impl,
                           dropout=dropout, remat=remat, **kw)
    self.map_head = (MAPHead(width, num_heads, mlp_dim, dtype_mm=dtype_mm,
                             **kw) if pool_type == "map" else None)
    self.rep_size = rep_size
    if rep_size:
      hid = width if rep_size is True else rep_size
      self.pre_logits = common.Dense(width, hid, **kw)
    self.head = (common.Dense(
        hid if rep_size else width, num_classes,
        kernel_init="zeros" if head_zeroinit else "lecun_normal", **kw)
                 if num_classes else None)

  @torch.no_grad()
  def initialize(self, generator, head_bias=None):
    """Draws every parameter from scratch, as the JAX model's `init` does.

    Per layer: `reset_parameters` (Dense, LayerNorm, PatchEmbed); then the
    learned posemb N(0, 1/width), the zero [cls] token, the MAP probe
    (xavier_uniform over its (1, width) fans) and, when given, the trainer's
    `init_head_bias` as the head's bias. Returns the module.
    """
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

  def forward(self, image, *, train=False, rng=None):
    """(logits or pre-logits, {intermediate name: tensor}).

    With `train` and a dropout rate, `rng` (a torch.Generator on the
    image's device) draws the dropout masks.
    """
    if train and self.dropout and rng is None:
      raise ValueError("dropout needs a generator: pass rng=")
    rng = rng if train else None
    out = {}
    x = out["stem"] = self.embedding(image.to(self.dtype_mm))
    n, h, w, c = x.shape
    if self.posemb == "learn":
      pos = self.pos_embedding.to(x.dtype)
    else:
      pos = posemb_sincos_2d(h, w, c, dtype=x.dtype, device=x.device)
    x = out["with_posemb"] = x.reshape(n, h * w, c) + pos
    if self.pool_type == "tok":
      x = torch.cat([self.cls.to(x.dtype).expand(n, -1, -1), x], dim=1)
    x = common.dropout(x, self.dropout, rng)

    x = out["encoded"] = self.encoder(x, rng=rng)

    x, encoded = readout(x, self.pool_type, self.map_head)
    if self.pool_type != "none":
      out["head_input"] = x
    grid = (n, h, w, -1)

    def each(fn, reps):
      if self.pool_type == "none":  # both reps hold the same tokens
        y = fn(reps[""])
        return {"": y, "_2d": y.reshape(grid)}
      return {k: fn(v) for k, v in reps.items()}

    reps = {"": x, "_2d": encoded.reshape(grid)}
    if self.rep_size:
      reps = each(lambda v: torch.tanh(self.pre_logits(v)), reps)
    out.update({f"pre_logits{k}": v for k, v in reps.items()})
    if self.head is not None:
      reps = each(self.head, reps)
      out.update({f"logits{k}": v for k, v in reps.items()})
    return reps[""], out


def Model(num_classes=None, *, variant=None, scan=None, remat_policy=None,
          **kw):  # pylint: disable=invalid-name
  """Factory taking the JAX model's config keys.

  `scan` shapes the JAX param layout (which `utils/convert.py` reads either
  way) and, as in the JAX model, remats every block (`remat`) whatever
  `remat_policy` names; without `scan` the JAX model has no remat.
  """
  del remat_policy
  cfg = decode_variant(variant)
  cfg.update(kw)
  return _Model(num_classes, remat=bool(scan), **cfg)


# (width, depth, mlp_dim, num_heads) per size letter, as in the JAX model.
VARIANT_TABLE = {
    "mu": (32, 1, 128, 2),
    "Ti": (192, 12, 768, 3),
    "S": (384, 12, 1536, 6),
    "M": (512, 12, 2048, 8),
    "B": (768, 12, 3072, 12),
    "L": (1024, 24, 4096, 16),
    "So400m": (1152, 27, 4304, 16),
    "H": (1280, 32, 5120, 16),
    "g": (1408, 40, 6144, 16),
    "g-opt": (1536, 40, 6144, 16),
    "G": (1664, 48, 8192, 16),
    "G-opt": (1536, 48, 8192, 16),
    "e": (1792, 56, 15360, 16),
}


def decode_variant(variant):
  """"B/16" -> {width, depth, mlp_dim, num_heads, patch_size}."""
  if variant is None:
    return {}
  size, _, patch = variant.partition("/")
  width, depth, mlp_dim, num_heads = VARIANT_TABLE[size]
  cfg = dict(width=width, depth=depth, mlp_dim=mlp_dim, num_heads=num_heads)
  if patch:
    cfg["patch_size"] = (int(patch),) * 2
  return cfg


def resample_posemb(old, new):
  """Bilinear-resizes a learned posemb grid [1, N, C] to `new`'s length."""
  if old.shape == new.shape:
    return old
  import scipy.ndimage  # pylint: disable=g-import-not-at-top
  side_old, side_new = (int(np.sqrt(p.shape[1])) for p in (old, new))
  zoom = (side_new / side_old, side_new / side_old, 1)
  grid = scipy.ndimage.zoom(old.reshape(side_old, side_old, -1), zoom,
                            order=1)
  return grid.reshape(1, side_new * side_new, -1)


_FLOAT = re.compile(r"([-+]?(?:\d+(?:\.\d*)?|\.\d+)(?:[eE][-+]?\d+)?)")
_MODULE_NUM = re.compile(r"(.*)_\d+$")


def _natural_sort(names):
  """Sorts names with their numbers compared as numbers (flax's
  `natural_sort`: module_2 before module_10)."""
  def key(name):
    return [float(c) if _FLOAT.match(c) else c for c in _FLOAT.split(name)]
  return sorted(names, key=key)


def convert_pre_linen(params):
  """flax's `convert_pre_linen` on a nested dict: pre-Linen checkpoints
  numbered submodules across classes (Conv_0, Dense_1); Linen numbers each
  class on its own (Conv_0, Dense_0). A tree in Linen naming is unchanged."""
  if not isinstance(params, dict):
    return params
  renamed, counts = {}, {}
  for name in _natural_sort(params):
    value = params[name]
    if m := _MODULE_NUM.match(name):
      num = counts.get(m.group(1), 0)
      counts[m.group(1)] = num + 1
      name = f"{m.group(1)}_{num}"
    renamed[name] = convert_pre_linen(value)
  return renamed


def fix_old_checkpoints(params):
  """Upgrades historical ViT checkpoint layouts to the current tree."""
  params = convert_pre_linen(params)

  # The posemb has lived in two places inside the encoder over the years:
  # its own "posembed_input" module (very old) or directly in "Transformer"
  # (pre-2022). Hoist either to the top level.
  trunk = params.get("Transformer", {})
  if "posembed_input" in trunk:
    params["pos_embedding"] = trunk.pop("posembed_input")["pos_embedding"]
  if "pos_embedding" in trunk:
    params["pos_embedding"] = trunk.pop("pos_embedding")

  # Oldest layout concatenated [cls] before adding posemb, giving N+1
  # posembs; fold the extra slot's posemb into the cls token itself.
  pe = params.get("pos_embedding")
  if pe is not None and int(np.sqrt(pe.shape[1])) ** 2 + 1 == pe.shape[1]:
    params["pos_embedding"] = pe[:, 1:]
    if "cls" in params:
      params["cls"] = params["cls"] + pe[:, :1]

  # ViT-G-era checkpoints had the MAP head's submodules inlined at the top.
  if "probe" in params:
    inlined = ("probe", "MlpBlock_0", "MultiHeadDotProductAttention_0",
               "LayerNorm_0")
    params["MAPHead_0"] = {k: params.pop(k) for k in inlined}
  return params


def _map_leaves(fn, *trees_):
  """fn over the leaves of nested dicts of the same structure."""
  if isinstance(trees_[0], dict):
    return {k: _map_leaves(fn, *(t[k] for t in trees_)) for k in trees_[0]}
  return fn(*trees_)


def pyloop_to_scan(params_pyloop):
  """Stacks per-layer encoderblock_{i} subtrees for the scan encoder."""
  params = _map_leaves(lambda x: x, params_pyloop)
  t = params["Transformer"]
  depth = 1 + max(int(k.split("_")[-1]) for k in t
                  if k.startswith("encoderblock_"))
  t["encoderblock"] = _map_leaves(
      lambda *xs: np.stack(xs), *[t[f"encoderblock_{i}"] for i in range(depth)])
  for i in range(depth):
    del t[f"encoderblock_{i}"]
  return params


def scan_to_pyloop(params_scan):
  """Inverse of pyloop_to_scan."""
  params = _map_leaves(lambda x: x, params_scan)
  t = params["Transformer"]
  depth = len(next(iter(trees.flatten(t["encoderblock"]).values())))
  for i in range(depth):
    t[f"encoderblock_{i}"] = _map_leaves(lambda x, i=i: x[i],
                                         t["encoderblock"])
  del t["encoderblock"]
  return params


def load(init_params, init_file, model_cfg, dont_load=()):
  """Loads a ViT checkpoint (any historical layout), with posemb resample.

  `init_params` is the model's own tree (numpy, JAX layout; see
  `utils/convert.vit_params`); returns the merged tree in the same layout.
  """
  restored = fix_old_checkpoints(
      checkpoints.load_params(VANITY_NAMES.get(init_file, init_file)))
  model_cfg = dict(model_cfg or {})
  if model_cfg.get("scan") and "encoderblock" not in restored["Transformer"]:
    restored = pyloop_to_scan(restored)
  if not model_cfg.get("scan") and "encoderblock" in restored["Transformer"]:
    restored = scan_to_pyloop(restored)

  restored = common.merge_params(restored, init_params, dont_load)

  if init_params and "pos_embedding" in init_params:
    restored["pos_embedding"] = resample_posemb(
        old=restored["pos_embedding"], new=init_params["pos_embedding"])
  return restored


# Canonical public checkpoints, by the JAX package's names (which configs
# use); nothing is fetched: a checkpoint is read from a local path.
VANITY_NAMES = {
    "howto-i21k-Ti/16": "gs://vit_models/augreg/Ti_16-i21k-300ep-lr_0.001-aug_none-wd_0.03-do_0.0-sd_0.0.npz",
    "howto-i21k-S/32": "gs://vit_models/augreg/S_32-i21k-300ep-lr_0.001-aug_none-wd_0.1-do_0.0-sd_0.0.npz",
    "howto-i21k-S/16": "gs://vit_models/augreg/S_16-i21k-300ep-lr_0.001-aug_light1-wd_0.03-do_0.0-sd_0.0.npz",
    "howto-i21k-B/32": "gs://vit_models/augreg/B_32-i21k-300ep-lr_0.001-aug_light1-wd_0.1-do_0.0-sd_0.0.npz",
    "howto-i21k-B/16": "gs://vit_models/augreg/B_16-i21k-300ep-lr_0.001-aug_medium1-wd_0.1-do_0.0-sd_0.0.npz",
    "howto-i21k-B/8": "gs://vit_models/augreg/B_8-i21k-300ep-lr_0.001-aug_medium2-wd_0.1-do_0.0-sd_0.0.npz",
    "howto-i21k-L/16": "gs://vit_models/augreg/L_16-i21k-300ep-lr_0.001-aug_strong1-wd_0.1-do_0.0-sd_0.0.npz",
    "i1k-s16-90ep": "gs://big_vision/vit_s16_i1k_90ep.npz",
    "i1k-s16-150ep": "gs://big_vision/vit_s16_i1k_150ep.npz",
    "i1k-s16-300ep": "gs://big_vision/vit_s16_i1k_300ep.npz",
    "SigLIP B/16 224": "gs://big_vision/siglip/webli_en_b16_224_63724782.npz:img",
    "SigLIP B/16 256": "gs://big_vision/siglip/webli_en_b16_256_60500360.npz:img",
    "SigLIP B/16 384": "gs://big_vision/siglip/webli_en_b16_384_68578854.npz:img",
    "SigLIP L/16 256": "gs://big_vision/siglip/webli_en_l16_256_60552751.npz:img",
    "SigLIP L/16 384": "gs://big_vision/siglip/webli_en_l16_384_63634585.npz:img",
    "SigLIP So400m/14 224": "gs://big_vision/siglip/webli_en_so400m_224_57633886.npz:img",
    "SigLIP So400m/14 384": "gs://big_vision/siglip/webli_en_so400m_384_58765454.npz:img",
    "SigLIP2 B/16 224": "gs://big_vision/siglip2/siglip2_b16_224.npz:img",
    "SigLIP2 B/16 256": "gs://big_vision/siglip2/siglip2_b16_256.npz:img",
    "SigLIP2 L/16 256": "gs://big_vision/siglip2/siglip2_l16_256.npz:img",
    "SigLIP2 So400m/14 224": "gs://big_vision/siglip2/siglip2_so400m14_224.npz:img",
}

"""Jet, a normalizing flow of ViT-conditioned affine couplings
(arXiv:2412.15129): port of big_vision_tpu/models/proj/jet/jet.py.

An image [B, H, W, C] is cut into ps x ps patches (tokens [B, N, K], K =
ps*ps*C) and run through `depth` couplings. Each splits the tokens in two
halves, by channels (a random permutation) or by space (checkerboard,
stripes; "-inv" swaps the halves), runs a conditioner `DNN` (a dense
projection, a learned posemb, an optional cross-attention to a context, a
`models/vit.py` Encoder at `attn_impl="auto"`, a zero-init projection to a
bias and a raw scale) on the first half, and maps the second:
y2 = (x2 + bias) * scale, scale = sigmoid(raw) * scale_factor, log|det| =
sum(log scale); the inverse runs the couplings in reverse. A spatial half
of N/2 tokens of width K is carried as N tokens of width K/2 (a reshape),
so every conditioner sees [B, N, K/2] and both kinds share one parameter
shape: at imagenet64's ps 4 that is T = 256 tokens of D = 64 per head,
where the attention gate takes the fused kernels K1 and K2 (f32).

The couplings' parameters are stacked on a leading depth axis, as the JAX
model's `nn.scan` stacks them (`common.Scanned`), under the JAX names
("couplings/dnn/vit/encoderblock_0/..."); each coupling runs under a
non-reentrant checkpoint while autograd records (the JAX model's
`nn.remat` with `nothing_saveable`), so a training step runs each
conditioner's forward twice. The one-hot masks [depth, n, n] are
parameters named `*-FREEZE_ME` in JAX (the trainers freeze them); each
layer reads them back into gather indices (`mask_to_perm`). The port
draws a fresh init's channel permutations from a `torch.Generator`, which
cannot reproduce `jax.random.permutation`: parity carries JAX's masks.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from big_vision_torch.models import common
from big_vision_torch.models import vit
from big_vision_torch.ops import attention as attn_ops
from big_vision_torch.utils import checkpoints


def load(init_params, init_file, model_params=None, dont_load=()):
  """Reads a Jet checkpoint and merges it into `init_params` (nested dicts
  of numpy arrays in the JAX layout)."""
  del model_params
  ckpt = checkpoints.load_params(init_file)
  if init_params is None:
    return ckpt
  return common.merge_params(ckpt, init_params, dont_load)


def _grid_halves(kind, nh, nw):
  """Boolean partition-A membership of each token for a spatial kind."""
  tok = np.arange(nh * nw)
  patterns = {
      "vstripes": tok % 2,
      "hstripes": (tok // nw) % 2,
      "checkerboard": (tok + tok // nw) % 2,
  }
  base = kind.removesuffix("-inv")
  if base not in patterns:
    raise ValueError(f"Unknown coupling kind {kind!r}")
  in_a = patterns[base] == 0
  return ~in_a if kind.endswith("-inv") else in_a


def spatial_masks(kinds, nh, nw):
  """[depth, N, N] one-hot masks (float32 numpy): output slots [0, N/2)
  hold partition A's tokens, the rest partition B's; "zero" layers are
  all zeros."""
  n = nh * nw
  w = np.zeros((len(kinds), n, n), np.float32)
  for i, kind in enumerate(kinds):
    if kind == "zero":
      continue
    in_a = _grid_halves(kind, nh, nw)
    tok = np.arange(n)
    w[i, tok[in_a], np.arange(n // 2)] = 1.0
    w[i, tok[~in_a], np.arange(n // 2, n)] = 1.0
  return w


def channel_masks(kinds, c, generator, device=None):
  """[depth, C, C] one-hot masks: "random" is a permutation drawn from
  `generator` (mask[p[j], j] = 1), "zero" all zeros."""
  w = torch.zeros((len(kinds), c, c), device=device)
  for i, kind in enumerate(kinds):
    if kind == "zero":
      continue
    if kind != "random":
      raise ValueError(f"Unknown coupling kind {kind!r}")
    perm = torch.randperm(c, generator=generator, device=generator.device)
    w[i, perm.to(w.device), torch.arange(c, device=w.device)] = 1.0
  return w


def mask_to_perm(mask):
  """(fwd, inv) gather indices of a one-hot mask: mask[k, m] = 1 means
  output slot m reads input slot k, so x[..., fwd] == x @ mask and
  x[..., inv] == x @ mask.T (the first maximum wins, as jnp.argmax)."""
  return mask.argmax(0), mask.argmax(1)


class CrossAttention(nn.Module):
  """flax `nn.MultiHeadDotProductAttention` of queries [B, T, D] over a
  context [B, S, Dc]: query/key/value/out with biases (lecun_normal
  kernels, the output kernel zero-init), q scaled by 1/sqrt(head dim),
  softmax in f32."""

  def __init__(self, width, context_dim, num_heads, *, device="cuda",
               param_dtype=torch.float32):
    super().__init__()
    kw = dict(device=device, param_dtype=param_dtype)
    self.num_heads = num_heads
    self.query = common.Dense(width, width, **kw)
    self.key = common.Dense(context_dim, width, **kw)
    self.value = common.Dense(context_dim, width, **kw)
    self.out = common.Dense(width, width, kernel_init="zeros", **kw)

  def forward(self, x, context):
    heads = lambda y: y.reshape(*y.shape[:2], self.num_heads, -1)
    q, k, v = (heads(self.query(x)), heads(self.key(context)),
               heads(self.value(context)))
    out = attn_ops.dot_product_attention(q, k, v, impl="xla")
    return self.out(out.reshape(*out.shape[:2], -1))


class DNN(nn.Module):
  """Conditioner: [B, N, K/2] -> (bias, raw scale), each [B, N, K/2]."""

  def __init__(self, in_dim, tokens, *, emb_dim=256, depth=1, num_heads=4,
               context_dim=None, attn_impl="auto", device="cuda",
               param_dtype=torch.float32):
    super().__init__()
    kw = dict(device=device, param_dtype=param_dtype)
    self.init_proj = common.Dense(in_dim, emb_dim, **kw)
    self.posemb = nn.Parameter(torch.empty(1, tokens, emb_dim, device=device,
                                           dtype=torch.float32))
    self.xattn = (CrossAttention(emb_dim, context_dim, num_heads, **kw)
                  if context_dim else None)
    self.encoder = vit.Encoder(emb_dim, depth, num_heads,
                               attn_impl=attn_impl, **kw)
    self.final_proj = common.Dense(emb_dim, 2 * in_dim, kernel_init="zeros",
                                   **kw)

  def reset_parameters(self, generator):
    common.init(self.posemb, ("normal", self.posemb.shape[-1] ** -0.5),
                generator)

  def forward(self, x, context=None):
    out_dim = x.shape[-1]
    h = self.init_proj(x) + self.posemb
    if self.xattn is not None and context is not None:
      h = h + self.xattn(h, context)
    h = self.encoder(h)
    raw = self.final_proj(h)
    return raw[..., :out_dim], raw[..., out_dim:]


class Coupling(nn.Module):
  """One affine coupling (the template of the stack): `forward(x, kind,
  channel_mask, spatial_mask, invert, context)` -> (y, log|det| [B]);
  kind 1 splits by channels, 0 by space."""

  def __init__(self, channels, tokens, *, scale_factor=2.0, **dnn_kw):
    super().__init__()
    self.scale_factor = scale_factor
    self.dnn = DNN(channels // 2, tokens, **dnn_kw)

  @staticmethod
  def _partition(x, kind, cmask, smask):
    if kind:
      fwd, _ = mask_to_perm(cmask)
      permuted = x.index_select(-1, fwd)
      half = permuted.shape[-1] // 2
      return permuted[..., :half], permuted[..., half:]
    fwd, _ = mask_to_perm(smask)
    a, b = x.index_select(-2, fwd).chunk(2, dim=-2)
    thin = lambda t: t.reshape(*t.shape[:-2], 2 * t.shape[-2],
                               t.shape[-1] // 2)
    return thin(a), thin(b)

  @staticmethod
  def _combine(x1, x2, kind, cmask, smask):
    if kind:
      _, inv = mask_to_perm(cmask)
      return torch.cat([x1, x2], dim=-1).index_select(-1, inv)
    _, inv = mask_to_perm(smask)
    fat = lambda t: t.reshape(*t.shape[:-2], t.shape[-2] // 2,
                              2 * t.shape[-1])
    return torch.cat([fat(x1), fat(x2)], dim=-2).index_select(-2, inv)

  def forward(self, x, kind, cmask, smask, invert, context=None):
    x1, x2 = self._partition(x, kind, cmask, smask)
    bias, raw_scale = self.dnn(x1, context)
    scale = torch.sigmoid(raw_scale) * self.scale_factor
    x2 = (x2 / scale - bias) if invert else (x2 + bias) * scale
    logdet = math.log(self.scale_factor) + F.logsigmoid(raw_scale)
    logdet = logdet.sum(dim=tuple(range(1, logdet.dim())))
    y = self._combine(x1, x2, kind, cmask, smask)
    return y, (-logdet if invert else logdet)


class Model(nn.Module):
  """Jet flow; `forward(x, context=None)` images -> (latents, sum of the
  log-determinants [B]), `inverse(z, context=None)` back. The port builds
  the parameters for `image_shape` (H, W, C) (and `context_dim`, the width
  of a class-conditional flow's context token), which the JAX model reads
  from its input. `attn_impl` is the conditioners' attention: "auto", the
  JAX model's, or "xla" to hold the kernels against the plain path."""

  def __init__(self, depth=2, ps=4, kinds=("channels", "channels", "spatial"),
               channels_coupling_projs=("random",),
               spatial_coupling_projs=("checkerboard", "checkerboard-inv"),
               block_depth=1, emb_dim=256, num_heads=4, scale_factor=2.0, *,
               image_shape=(16, 16, 3), context_dim=None, attn_impl="auto",
               device="cuda", param_dtype=torch.float32):
    super().__init__()
    h, w, c = image_shape
    if h % ps or w % ps:
      raise ValueError(f"image {image_shape} is not a multiple of ps {ps}")
    self.ps = ps
    self.grid = (h // ps, w // ps)
    self.channels = c * ps * ps
    tokens = self.grid[0] * self.grid[1]
    kind_flags, self.c_kinds, self.s_kinds = self._layer_plan(
        depth, kinds, channels_coupling_projs, spatial_coupling_projs)
    self.kind_flags = list(kind_flags)
    self.channel_masks = nn.Parameter(
        torch.zeros(depth, self.channels, self.channels, device=device),
        requires_grad=False)
    self.spatial_masks = nn.Parameter(
        torch.from_numpy(spatial_masks(self.s_kinds, *self.grid)).to(device),
        requires_grad=False)
    self.couplings = common.Scanned(
        Coupling(self.channels, tokens, scale_factor=scale_factor,
                 emb_dim=emb_dim, depth=block_depth, num_heads=num_heads,
                 context_dim=context_dim, attn_impl=attn_impl,
                 device=device, param_dtype=param_dtype), depth)

  @staticmethod
  def _layer_plan(depth, kinds, c_projs, s_projs):
    """Per-layer (kind flag, channel proj kind, spatial proj kind)."""
    pools = {"channels": itertools.cycle(c_projs),
             "spatial": itertools.cycle(s_projs)}
    plan = []
    for k in itertools.islice(itertools.cycle(kinds), depth):
      if k not in pools:
        raise ValueError(f"Unknown coupling kind {k!r}")
      proj = next(pools[k])
      plan.append((1, proj, "zero") if k == "channels" else (0, "zero", proj))
    return zip(*plan)

  @torch.no_grad()
  def initialize(self, generator, head_bias=None):
    """Draws the couplings' parameters with the JAX model's initializers
    and the channel permutations from `generator`. Returns the module."""
    del head_bias
    self.couplings.reset_parameters(generator)
    self.channel_masks.copy_(channel_masks(
        self.c_kinds, self.channels, generator, self.channel_masks.device))
    self.spatial_masks.copy_(torch.from_numpy(
        spatial_masks(self.s_kinds, *self.grid)))
    return self

  def _tokens(self, x):
    b, h, w, c = x.shape
    p = self.ps
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)

  def _image(self, tokens, c):
    b, n, _ = tokens.shape
    p = self.ps
    gh = int(np.round(n ** 0.5))
    x = tokens.reshape(b, gh, n // gh, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * p, (n // gh) * p, c)

  def _run(self, x, invert, context=None):
    tokens = self._tokens(x)
    layers = self.couplings.params()
    remat = torch.is_grad_enabled()
    order = range(len(layers))
    logdets = [None] * len(layers)
    for i in (reversed(order) if invert else order):
      args = (tokens, self.kind_flags[i], self.channel_masks[i],
              self.spatial_masks[i], invert, context)
      step = lambda *a, i=i: self.couplings.call(layers[i], *a)
      if remat:
        tokens, logdets[i] = common.checkpointed(
            lambda *a, rng=None, step=step: step(*a), *args)
      else:
        tokens, logdets[i] = step(*args)
    return self._image(tokens, x.shape[-1]), torch.stack(logdets).sum(0)

  def forward(self, x, context=None):
    """Images -> latents, with the sum of the layers' log-determinants."""
    return self._run(x, False, context)

  def inverse(self, x, context=None):
    """Latents -> images (the exact inverse; layers in reverse order)."""
    return self._run(x, True, context)

"""Weight-standardised convolutions and GroupNorm: port of
big_vision_tpu/models/convnets.py, the layers of the BiT family
(`models/bit.py`, `models/bit_paper.py`).

Feature maps enter and leave every layer as NHWC, as in the JAX package,
so the models' taps have the JAX shapes. A conv hands cuDNN the NHWC tensor
as a `channels_last` view of NCHW (no copy) and takes its output back the
same way. Kernels are stored OIHW (`weight`); `utils/convert.py` carries
them to and from the JAX HWIO layout.

The traps of the JAX layers, kept here:

* Weight standardisation per output channel over (kh, kw, in), in two
  flavours: "std", `(w - mean) / (std + eps)` with the population std
  (ddof 0) and eps outside the sqrt; "rms", `(w - mean) / sqrt(mean((w -
  mean)^2) + eps)` with eps inside.
* `"SAME"` padding is JAX's, which is asymmetric: the total `max((out - 1)
  * s + k - in, 0)` is split `total // 2` before and the rest after (the
  7x7/2 conv at 224 px pads (2, 3)). Explicit paddings are kept as given.
* The convolutions compute in IEEE f32: cuDNN's TF32, which PyTorch leaves
  on for convolutions by default, is turned off around the forward and the
  backward of every conv (`_Conv2d`), whatever the caller's flags say.
* GroupNorm over H, W and the channels of a group, in two flavours:
  `msq=False`, `E[x^2] - E[x]^2` with eps 1e-6 (flax's form, written out);
  `msq=True`, centred first, then the mean of squares with eps 1e-5. The
  port holds the scale and bias as (C,); the JAX `msq` layer's (1, 1, 1, C)
  is the converter's business.
"""

from __future__ import annotations

import contextlib
from typing import Sequence, Union

import torch
from torch import nn
import torch.nn.functional as F

from big_vision_torch.models import common

Padding = Union[str, Sequence[Sequence[int]]]


def _pair(v):
  return (v, v) if isinstance(v, int) else tuple(v)


def same_padding(size, k, s):
  """JAX's `"SAME"` padding (before, after) of one spatial axis."""
  out = -(-size // s)
  total = max((out - 1) * s + k - size, 0)
  return total // 2, total - total // 2


def paddings(padding: Padding, hw, ksize, strides):
  """[(before, after)] per spatial axis: JAX's "SAME" or "VALID", or the
  explicit pairs given."""
  if padding == "SAME":
    return [same_padding(n, k, s) for n, k, s in zip(hw, ksize, strides)]
  if padding == "VALID":
    return [(0, 0), (0, 0)]
  return [tuple(p) for p in padding]


@contextlib.contextmanager
def _ieee_f32():
  """While open, cuDNN convolutions compute in IEEE f32 (TF32 off)."""
  prev = torch.backends.cudnn.allow_tf32
  torch.backends.cudnn.allow_tf32 = False
  try:
    yield
  finally:
    torch.backends.cudnn.allow_tf32 = prev


class _Conv2d(torch.autograd.Function):
  """F.conv2d (NCHW views, no bias) whose forward and backward both run
  under `_ieee_f32`: the backward of a plain conv reads the global TF32
  flag when it runs, outside any context the forward was called in."""

  @staticmethod
  def forward(ctx, x, w, stride, padding):
    ctx.save_for_backward(x, w)
    ctx.stride, ctx.padding = stride, padding
    with _ieee_f32():
      return F.conv2d(x, w, stride=stride, padding=padding)

  @staticmethod
  def backward(ctx, grad):
    x, w = ctx.saved_tensors
    with _ieee_f32():
      gx, gw, _ = torch.ops.aten.convolution_backward(
          grad, x, w, None, list(ctx.stride), list(ctx.padding), [1, 1],
          False, [0, 0], 1,
          [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
    return gx, gw, None, None


def conv2d(x, w, strides, pads):
  """NHWC `x` convolved with the OIHW kernel `w` at `strides`, padded by
  `pads` [(before, after)] per axis; NHWC out. Symmetric pads go to the
  conv itself, asymmetric ones to an explicit zero pad first."""
  xc = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC memory
  if any(lo != hi for lo, hi in pads):
    (top, bottom), (left, right) = pads
    xc = F.pad(xc, (left, right, top, bottom))
    pads = [(0, 0), (0, 0)]
  y = _Conv2d.apply(xc, w, tuple(strides), (pads[0][0], pads[1][0]))
  return y.permute(0, 2, 3, 1)


def max_pool(x, window, strides, padding: Padding):
  """flax `nn.max_pool` on NHWC: the padding is -inf, never 0."""
  pads = paddings(padding, x.shape[1:3], window, strides)
  xc = x.permute(0, 3, 1, 2)
  (top, bottom), (left, right) = pads
  xc = F.pad(xc, (left, right, top, bottom), value=float("-inf"))
  return F.max_pool2d(xc, window, strides).permute(0, 2, 3, 1)


def standardize(w, ws, eps):
  """Weight standardisation of an OIHW kernel per output channel (over
  the kh, kw and in axes)."""
  dims = (1, 2, 3)
  centered = w - w.mean(dim=dims, keepdim=True)
  if ws == "std":
    denom = w.std(dim=dims, keepdim=True, correction=0) + eps
  else:
    denom = torch.sqrt((centered * centered).mean(dim=dims, keepdim=True)
                       + eps)
  return centered / denom


class WSConv(nn.Module):
  """2D conv with weight standardisation applied to the kernel at each
  call; `ws` "std", "rms" or None (a plain conv). The weight is the raw
  kernel, OIHW, drawn lecun_normal over its kh * kw * in fan-in."""

  def __init__(self, features_in, features, ksize=3, strides=1,
               padding: Padding = "SAME", ws="std", eps=1e-5,
               use_bias=False, *, device="cuda"):
    super().__init__()
    self.ksize, self.strides = _pair(ksize), _pair(strides)
    self.padding, self.ws, self.eps = padding, ws, eps
    self.weight = nn.Parameter(torch.empty(features, features_in,
                                           *self.ksize, device=device))
    self.bias = (nn.Parameter(torch.empty(features, device=device))
                 if use_bias else None)

  def reset_parameters(self, generator):
    fan_in = self.weight[0].numel()
    common.init(self.weight, "lecun_normal", generator, fan_in=fan_in)
    if self.bias is not None:
      common.init(self.bias, "zeros", generator)

  def forward(self, x):
    w = standardize(self.weight, self.ws, self.eps) if self.ws else (
        self.weight)
    pads = paddings(self.padding, x.shape[1:3], self.ksize, self.strides)
    y = conv2d(x, w, self.strides, pads)
    return y if self.bias is None else y + self.bias


class GroupNorm(nn.Module):
  """GroupNorm over the channels (last axis) of an NHWC tensor; `msq`
  selects the BiT-paper flavour (see the module docstring). The scale
  starts at 0 with `zero_scale`, else at 1."""

  def __init__(self, channels, groups=32, msq=False, eps=1e-6,
               zero_scale=False, *, device="cuda"):
    super().__init__()
    self.groups, self.msq, self.eps = groups, msq, eps
    self.zero_scale = zero_scale
    self.weight = nn.Parameter(torch.empty(channels, device=device))
    self.bias = nn.Parameter(torch.empty(channels, device=device))

  def reset_parameters(self, generator):
    del generator
    common.init(self.weight, "zeros" if self.zero_scale else "ones", None)
    common.init(self.bias, "zeros", None)

  def forward(self, x):
    shape = x.shape
    g = x.reshape(*shape[:-1], self.groups, shape[-1] // self.groups)
    red = (1, 2, 4)
    mu = g.mean(dim=red, keepdim=True)
    if self.msq:
      g = g - mu
      g = g * torch.rsqrt((g * g).mean(dim=red, keepdim=True) + self.eps)
    else:
      var = (g * g).mean(dim=red, keepdim=True) - mu * mu
      g = (g - mu) * torch.rsqrt(var + self.eps)
    return g.reshape(shape) * self.weight + self.bias


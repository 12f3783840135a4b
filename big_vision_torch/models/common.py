"""Layers shared by the port's models, with flax's dtype rules.

flax computes `nn.Dense(dtype=None)` in the promoted type of its input and
parameters, and in `dtype` when one is given; torch refuses a product of
two dtypes. So `Dense` and `LayerNorm` cast explicitly to the type JAX
computes in.
"""

from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F


def resolve_dtype(dtype) -> torch.dtype | None:
  """"bfloat16" / "float32" / torch.dtype / None -> torch.dtype or None."""
  if dtype is None or isinstance(dtype, torch.dtype):
    return dtype
  return getattr(torch, dtype)


def linear(x, weight, bias=None, dtype=None):
  """x @ weight.T (+ bias) in `dtype`, or in the promoted type of x and the
  weight when `dtype` is None (jnp's promotion: f32 x bf16 -> f32)."""
  dtype = dtype or torch.promote_types(x.dtype, weight.dtype)
  b = None if bias is None else bias.to(dtype)
  return F.linear(x.to(dtype), weight.to(dtype), b)


class Dense(nn.Module):
  """flax `nn.Dense`; weight stored [out, in] as in `nn.Linear`."""

  def __init__(self, features_in, features_out, *, use_bias=True, dtype=None,
               device="cuda", param_dtype=torch.float32):
    super().__init__()
    kw = dict(device=device, dtype=param_dtype)
    self.weight = nn.Parameter(torch.empty(features_out, features_in, **kw))
    self.bias = (nn.Parameter(torch.empty(features_out, **kw))
                 if use_bias else None)
    self.dtype = resolve_dtype(dtype)

  def forward(self, x):
    return linear(x, self.weight, self.bias, self.dtype)


class LayerNorm(nn.Module):
  """flax `nn.LayerNorm`: eps 1e-6, statistics in f32 as E[x^2] - E[x]^2.

  The output is in `dtype`, or in the promoted type of x and the
  parameters when `dtype` is None.
  """

  def __init__(self, width, *, dtype=None, device="cuda",
               param_dtype=torch.float32, eps=1e-6):
    super().__init__()
    kw = dict(device=device, dtype=param_dtype)
    self.weight = nn.Parameter(torch.empty(width, **kw))
    self.bias = nn.Parameter(torch.empty(width, **kw))
    self.dtype = resolve_dtype(dtype)
    self.eps = eps

  def forward(self, x):
    out_dtype = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + self.eps) * self.weight.float()
    return ((xf - mean) * mul + self.bias.float()).to(out_dtype)


def gelu(x):
  """flax `nn.gelu`: the tanh approximation."""
  return F.gelu(x, approximate="tanh")


@torch.no_grad()
def init_random_(module: nn.Module, seed: int) -> nn.Module:
  """Fills every parameter with random values from `seed`, in place.

  Matrices get N(0, 1/fan_in) with fan_in their last axis; 1-D `weight`s
  (LayerNorm gains) 1 + N(0, 0.02^2); other vectors N(0, 0.02^2). Used
  where no checkpoint exists, e.g. the serving benchmark.
  """
  params = dict(module.named_parameters())
  device = next(iter(params.values())).device
  gen = torch.Generator(device=device).manual_seed(seed)
  for name in sorted(params):
    p = params[name]
    r = torch.randn(p.shape, generator=gen, device=device,
                    dtype=torch.float32)
    if p.dim() >= 2:
      r = r / math.sqrt(p.shape[-1])
    elif name.endswith("weight"):
      r = 1.0 + 0.02 * r
    else:
      r = 0.02 * r
    p.copy_(r)
  return module

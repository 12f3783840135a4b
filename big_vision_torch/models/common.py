"""Layers shared by the port's models, with flax's dtype rules and inits.

flax computes `nn.Dense(dtype=None)` in the promoted type of its input and
parameters, and in `dtype` when one is given; torch refuses a product of
two dtypes. So `Dense` and `LayerNorm` cast explicitly to the type JAX
computes in.

From-scratch init follows flax's initializers and fans (`init`): each layer
names its initializers as the JAX model does, and `reset_parameters`
draws them from an explicit `torch.Generator`. A weight stored [out, in]
has fan_in = in and fan_out = out, which are the fans flax takes of the
flattened DenseGeneral kernels too.

`merge_params` reconciles a loaded param tree with an inited one, as the
JAX package's does, on nested dicts of numpy arrays in the JAX layout.
"""

from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils import checkpoint

from big_vision_torch.utils import trees


def merge_params(loaded, inited, dont_load=(), match_dtype=False):
  """Reconciles a loaded checkpoint tree with a model-inited tree.

  Keys matched by a `dont_load` regex keep their init value (or are dropped
  if only in the checkpoint). Any other structural mismatch is an error that
  lists the offending keys.
  """
  if inited is None:
    return loaded
  patterns = trees.compile_patterns(dont_load)

  def keep_init(name):
    return any(p.fullmatch(name) for p in patterns)

  have, want = trees.flatten(loaded), trees.flatten(inited)
  merged, problems = {}, []
  for name in sorted(set(have) | set(want)):
    if name not in want:
      # Checkpoint-only entry: silently dropped when dont_load'ed.
      if not keep_init(name):
        problems.append(f" + {name}  (in checkpoint, not in model)")
    elif name in have and not keep_init(name):
      val = have[name]
      merged[name] = val.astype(want[name].dtype) if match_dtype else val
    else:
      merged[name] = want[name]
      if name not in have and not keep_init(name):
        problems.append(f" - {name}  (in model, not in checkpoint)")
  if problems:
    raise ValueError(
        "Checkpoint/model structure mismatch not covered by dont_load:\n"
        + "\n".join(problems))
  return trees.unflatten(merged)


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


def init(tensor, kind, generator, fan_in=1, fan_out=1):
  """Fills `tensor` in place as flax's initializer `kind` would.

  kind: "zeros", "ones", ("normal", stddev), ("constant", value),
  "xavier_uniform" (U(+-sqrt(6 / (fan_in + fan_out)))) or "lecun_normal"
  (a normal truncated at two of its stddevs, scaled so that its variance is
  1 / fan_in).
  """
  with torch.no_grad():
    if kind == "zeros":
      return tensor.zero_()
    if kind == "ones":
      return tensor.fill_(1.0)
    if kind == "xavier_uniform":
      limit = math.sqrt(6.0 / (fan_in + fan_out))
      return tensor.uniform_(-limit, limit, generator=generator)
    if kind == "lecun_normal":
      # flax divides by the stddev of a unit normal truncated to [-2, 2].
      std = math.sqrt(1.0 / fan_in) / .87962566103423978
      return nn.init.trunc_normal_(tensor, 0.0, std, -2 * std, 2 * std,
                                   generator=generator)
    name, arg = kind
    if name == "normal":
      return tensor.normal_(0.0, arg, generator=generator)
    if name == "constant":
      return tensor.fill_(arg)
  raise ValueError(f"Unknown initializer {kind!r}")


def checkpointed(fn, *args, rng=None):
  """fn(*args, rng=rng) under a non-reentrant `torch.utils.checkpoint`:
  only the inputs are kept, and the backward recomputes fn (a remat policy
  that saves nothing). The recompute draws its dropout masks from `rng`'s
  state as it was at the forward, so they are the forward's, and the
  gradients are those of the plain call, bit for bit."""
  if rng is None:
    return checkpoint.checkpoint(fn, *args, use_reentrant=False)
  state = rng.get_state()

  def run(*a):
    rng.set_state(state)  # a no-op in the forward; rewinds the recompute
    return fn(*a, rng=rng)

  return checkpoint.checkpoint(run, *args, use_reentrant=False)


def dropout(x, rate, generator, broadcast_dims=()):
  """flax `nn.Dropout(rate, broadcast_dims)`: keeps each entry with
  probability 1 - rate and scales it by 1 / (1 - rate); one draw is shared
  along each axis of `broadcast_dims`. A no-op without a generator or at
  rate 0."""
  if generator is None or rate == 0:
    return x
  shape = list(x.shape)
  for d in broadcast_dims:
    shape[d] = 1
  keep = torch.rand(shape, generator=generator, device=x.device) >= rate
  return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Scanned(nn.Module):
  """`depth` layers of one module whose parameters are stacked on a
  leading axis, as flax's `nn.scan` stacks them: the JAX param names and
  shapes (with the depth axis first) of a scanned stack, so that config
  regexes written against them ("^decoder/layers/attn/.*") match as in
  JAX. `layer` is the template; its parameters are replaced by stacked
  ones ([depth, *shape]), and `params()` gives each layer's views of them
  (one `unbind` per call, whose backward stacks the layers' gradients
  once), which `call` runs the template on (`torch.func.functional_call`).
  `reset_parameters` runs each submodule's own, whose initializers take
  their fans from the trailing axes."""

  def __init__(self, layer, depth):
    super().__init__()
    self.depth = depth
    self.layer = layer
    for mod in layer.modules():
      for name, p in list(mod._parameters.items()):  # pylint: disable=protected-access
        if p is not None:
          mod._parameters[name] = nn.Parameter(  # pylint: disable=protected-access
              p.detach().new_empty((depth, *p.shape)),
              requires_grad=p.requires_grad)

  def reset_parameters(self, generator):
    for mod in self.layer.modules():
      if hasattr(mod, "reset_parameters"):
        mod.reset_parameters(generator)

  def params(self):
    """[{template parameter name: layer i's view}] for i < depth."""
    views = {n: p.unbind(0) for n, p in self.layer.named_parameters()}
    return [{n: v[i] for n, v in views.items()} for i in range(self.depth)]

  def call(self, params, *args, **kw):
    """The template's forward with one layer's `params`."""
    return torch.func.functional_call(self.layer, params, args, kw)


class Dense(nn.Module):
  """flax `nn.Dense`; weight stored [out, in] as in `nn.Linear`.

  `kernel_init` and `bias_init` name the flax initializers (`init`); the
  defaults are flax's.
  """

  def __init__(self, features_in, features_out, *, use_bias=True, dtype=None,
               device="cuda", param_dtype=torch.float32,
               kernel_init="lecun_normal", bias_init="zeros"):
    super().__init__()
    kw = dict(device=device, dtype=param_dtype)
    self.weight = nn.Parameter(torch.empty(features_out, features_in, **kw))
    self.bias = (nn.Parameter(torch.empty(features_out, **kw))
                 if use_bias else None)
    self.dtype = resolve_dtype(dtype)
    self.kernel_init, self.bias_init = kernel_init, bias_init

  def forward(self, x):
    return linear(x, self.weight, self.bias, self.dtype)

  def reset_parameters(self, generator):
    out, inp = self.weight.shape[-2:]  # a stacked [depth, out, in] too
    init(self.weight, self.kernel_init, generator, fan_in=inp, fan_out=out)
    if self.bias is not None:
      init(self.bias, self.bias_init, generator)


class LayerNorm(nn.Module):
  """flax `nn.LayerNorm`: eps 1e-6, statistics in f32 as E[x^2] - E[x]^2;
  without a bias where `use_bias` is False.

  The output is in `dtype`, or in the promoted type of x and the
  parameters when `dtype` is None.
  """

  def __init__(self, width, *, dtype=None, device="cuda",
               param_dtype=torch.float32, eps=1e-6, use_bias=True):
    super().__init__()
    kw = dict(device=device, dtype=param_dtype)
    self.weight = nn.Parameter(torch.empty(width, **kw))
    self.bias = nn.Parameter(torch.empty(width, **kw)) if use_bias else None
    self.dtype = resolve_dtype(dtype)
    self.eps = eps

  def forward(self, x):
    out_dtype = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + self.eps) * self.weight.float()
    y = (xf - mean) * mul
    if self.bias is not None:
      y = y + self.bias.float()
    return y.to(out_dtype)

  def reset_parameters(self, generator):
    del generator
    init(self.weight, "ones", None)
    if self.bias is not None:
      init(self.bias, "zeros", None)


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

"""Optimizer factory: port of `make` and `get_count` in big_vision_tpu/optim.py.

The config language is the JAX package's:

  config["optax_name"] = "scale_by_adam", "big_vision.momentum_hp",
                         "big_vision.scale_by_adafactor" or "big_vision.sgd"
  config["optax"]      = its arguments
  config["lr"]         = base learning rate
  config["schedule"]   = sched-dict or [(regex, sched-dict-or-None), ...]
                         (None freezes the matching params)
  config["lr_mults"]   = [(regex, mult), ...]
  config["wd"]         = decoupled weight decay; config["wd_mults"] masks it
  config["grad_clip_norm"] (+ config["grad_clip_per_example"])

Params, gradients and updates are {JAX name: tensor} dicts (see
`utils/convert.names`), so the configs' regexes apply unchanged. The
chain and its arithmetic are optax's, in the order `make` builds it:
clip (global norm, or per example) -> the named rule (masked to the
non-frozen params) -> lr -> lr_mults -> weight decay -> schedules and
zeroing of frozen params -> -1. The rules' states live on the params'
device, under the names of their optax states:

  * `scale_by_adam`: "mu" (in `mu_dtype`: a bf16 first moment is updated
    in f32 from the stored value and bias-corrected before it is rounded,
    as `optax.scale_by_adam` does) and "nu";
  * `big_vision.momentum_hp`: "trace" (`optax.trace` with a bf16
    accumulator by default, and `nesterov`);
  * `big_vision.scale_by_adafactor`: "v_row" and "v_col" for a factored
    param, "v" for the others (`optax.scale_by_factored_rms` with the
    capped `_decay_rate_pow`), then `clip_by_block_rms` where a threshold
    is given, and "ema" (`optax.ema` without debias, bf16 by default);
  * `big_vision.sgd`: none (`optax.identity`).

Where optax meets a bf16 state with a Python float, the float is a bf16
number there (jnp's weak types), so the port multiplies by a bf16 tensor.
Adafactor factors the two largest axes of a param's JAX shape: `make`
takes `jax_shapes` ({name: JAX shape}) for params stored in another
layout, the port's [out, in] matrix of a "/kernel" leaf being the JAX
kernel reshaped to [in, out] and transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from big_vision_torch.models import common
from big_vision_torch.utils import schedules
from big_vision_torch.utils import trees

__all__ = ["make", "get_count", "Chain", "RULES"]


def get_count(opt_state) -> int:
  """The schedule step count of an optimizer state."""
  return int(opt_state["count"])


class _Weak(dict):
  """`weak(value, like)`: `value` as jnp's weak typing makes it beside
  `like`, a 0-d tensor of like's dtype on like's device. Each is made once
  and kept: making one on the card copies from the host and waits for the
  stream, which a step must not do for every param."""

  def __call__(self, value, like):
    key = (value, like.dtype, like.device)
    if key not in self:
      self[key] = torch.tensor(value, dtype=like.dtype, device=like.device)
    return self[key]


def _scale_groups(tensors, factors):
  """[t * f] for t, f in zip(tensors, factors), one foreach call per
  distinct factor (factors of 1 leave their tensors as they are)."""
  out = list(tensors)
  for f in set(factors) - {1.0}:
    idx = [i for i, g in enumerate(factors) if g == f]
    for i, x in zip(idx, torch._foreach_mul([out[i] for i in idx], f)):
      out[i] = x
  return out


def _split_frozen(names, schedule):
  """(frozen {name: bool}, [(mask, sched-dict)] of the live schedules)."""
  patterns, scheds = zip(*schedule)
  masks = trees.make_mask_trees(dict.fromkeys(names), list(patterns))
  not_covered = [n for n in names if not any(m[n] for m in masks)]
  if not_covered:
    raise ValueError("config.schedule must cover all params (None = "
                     f"frozen): {not_covered}")
  frozen = {n: any(m[n] for m, s in zip(masks, scheds) if s is None)
            for n in names}
  return frozen, [(m, s) for m, s in zip(masks, scheds) if s is not None]


class ScaleByAdam:
  """optax.scale_by_adam: state "mu", "nu"."""

  def __init__(self, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
               mu_dtype=None, nesterov=False):
    if nesterov:
      raise ValueError("scale_by_adam(nesterov=True) is not ported")
    self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
    self.mu_dtype = common.resolve_dtype(mu_dtype)
    self.weak = _Weak()

  def init(self, live):
    return {"mu": {n: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                   for n, p in live.items()},
            "nu": {n: torch.zeros_like(p) for n, p in live.items()}}

  def update(self, names, g, state, params, count):
    del params
    # The moments from the stored mu (in its dtype), the bias correction
    # in f32 before mu is rounded to mu_dtype.
    mu_old = [state["mu"][n] for n in names]
    b1 = [self.weak(self.b1, m) for m in mu_old]
    mu = torch._foreach_add(torch._foreach_mul(g, 1 - self.b1),
                            torch._foreach_mul(mu_old, b1))
    nu = torch._foreach_add(
        torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.b2),
        torch._foreach_mul([state["nu"][n] for n in names], self.b2))
    f32 = np.float32
    bc1 = float(f32(1) - f32(self.b1) ** f32(count + 1))
    bc2 = float(f32(1) - f32(self.b2) ** f32(count + 1))
    den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_add(
        torch._foreach_div(nu, bc2), self.eps_root)), self.eps)
    u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
    new_mu = [m.to(o.dtype) for m, o in zip(mu, mu_old)]
    return u, {"mu": dict(zip(names, new_mu)), "nu": dict(zip(names, nu))}


class Trace:
  """big_vision.momentum_hp, optax.trace: state "trace" in `dtype`."""

  def __init__(self, momentum=0.9, dtype="bfloat16", nesterov=False):
    self.decay, self.nesterov = momentum, nesterov
    self.dtype = common.resolve_dtype(dtype)
    self.weak = _Weak()

  def init(self, live):
    return {"trace": {n: torch.zeros_like(p, dtype=self.dtype or p.dtype)
                      for n, p in live.items()}}

  def update(self, names, g, state, params, count):
    del params, count
    old = [state["trace"][n] for n in names]
    new = torch._foreach_add(g, torch._foreach_mul(
        old, [self.weak(self.decay, t) for t in old]))
    u = (torch._foreach_add(g, torch._foreach_mul(new, self.decay))
         if self.nesterov else new)
    return u, {"trace": {n: t.to(o.dtype)
                         for n, t, o in zip(names, new, old)}}


def _factored_dims(shape, min_dim_size_to_factor):
  """optax's `_factored_dims`: (second largest, largest) axis, or None."""
  if len(shape) < 2:
    return None
  sorted_dims = np.argsort(shape)
  if shape[sorted_dims[-2]] < min_dim_size_to_factor:
    return None
  return int(sorted_dims[-2]), int(sorted_dims[-1])


class ScaleByAdafactor:
  """big_vision.scale_by_adafactor: a factored second moment ("v_row",
  "v_col"; "v" where a param is not factored), a block-RMS clip, and an
  undebiased momentum "ema" in `dtype_momentum`."""

  def __init__(self, min_dim_size_to_factor=32, decay_rate=0.8,
               decay_offset=0, beta2_cap=0.999, clipping_threshold=None,
               momentum=0.9, dtype_momentum="bfloat16", eps=1e-30,
               jax_shapes=None):
    self.min_dim = min_dim_size_to_factor
    self.decay_rate, self.decay_offset = decay_rate, decay_offset
    self.beta2_cap, self.clip = beta2_cap, clipping_threshold
    self.momentum = momentum
    self.dtype = common.resolve_dtype(dtype_momentum)
    self.eps = eps
    self.jax_shapes = jax_shapes or {}
    self.weak = _Weak()

  def _jax(self, name, x):
    """x in the JAX layout of param `name` (a view)."""
    shape = self.jax_shapes.get(name)
    if shape is None:
      return x
    if name.endswith("/kernel") and x.dim() == 2:
      x = x.T
    return x.reshape(shape)

  def _port(self, name, u, like):
    """u, in the JAX layout of `name`, in `like`'s layout."""
    if name not in self.jax_shapes:
      return u
    if name.endswith("/kernel") and like.dim() == 2:
      return u.reshape(like.shape[::-1]).T
    return u.reshape(like.shape)

  def init(self, live):
    state = {"v_row": {}, "v_col": {}, "v": {}}
    for n, p in live.items():
      shape = tuple(self._jax(n, p).shape)
      dims = _factored_dims(shape, self.min_dim)
      if dims is None:
        state["v"][n] = torch.zeros(shape, dtype=p.dtype, device=p.device)
        continue
      d1, d0 = dims
      state["v_row"][n] = torch.zeros(np.delete(shape, d0).tolist(),
                                      dtype=p.dtype, device=p.device)
      state["v_col"][n] = torch.zeros(np.delete(shape, d1).tolist(),
                                      dtype=p.dtype, device=p.device)
    if self.momentum:
      state["ema"] = {n: torch.zeros_like(p, dtype=self.dtype or p.dtype)
                      for n, p in live.items()}
    return state

  def update(self, names, g, state, params, count):
    f32 = np.float32
    t = f32(count - self.decay_offset) + f32(1.0)
    decay = np.minimum(f32(self.beta2_cap), f32(1.0) - t ** f32(
        -self.decay_rate))
    decay, rest = float(decay), float(f32(1.0) - decay)
    new = {"v_row": {}, "v_col": {}, "v": {}}
    u = []
    for n, grad in zip(names, g):
      grad = self._jax(n, grad)
      grad_sqr = grad * grad + self.eps
      if n in state["v"]:
        v = state["v"][n] * decay + grad_sqr * rest
        new["v"][n] = v
        upd = grad * v ** -0.5
      else:
        d1, d0 = _factored_dims(tuple(grad.shape), self.min_dim)
        v_row = state["v_row"][n] * decay + grad_sqr.mean(d0) * rest
        v_col = state["v_col"][n] * decay + grad_sqr.mean(d1) * rest
        new["v_row"][n], new["v_col"][n] = v_row, v_col
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_col_mean = v_row.mean(reduced_d1, keepdim=True)
        row_factor = (v_row / row_col_mean) ** -0.5
        col_factor = v_col ** -0.5
        upd = grad * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
      if self.clip:  # optax.clip_by_block_rms
        rms = torch.sqrt((upd * upd).mean())
        upd = upd / torch.clamp_min(rms / self.clip, 1.0)
      u.append(self._port(n, upd, params[n]))
    if self.momentum:  # optax.ema(debias=False)
      old = [state["ema"][n] for n in names]
      decay = [self.weak(self.momentum, e) for e in old]
      u = torch._foreach_add(torch._foreach_mul(u, 1 - self.momentum),
                             torch._foreach_mul(old, decay))
      new["ema"] = {n: e.to(o.dtype) for n, e, o in zip(names, u, old)}
    return u, new


class Identity:
  """big_vision.sgd: optax.identity, no state."""

  def init(self, live):
    del live
    return {}

  def update(self, names, g, state, params, count):
    del names, state, params, count
    return g, {}


# config["optax_name"] -> the rule it names.
RULES = {"scale_by_adam": ScaleByAdam,
         "big_vision.momentum_hp": Trace,
         "big_vision.scale_by_adafactor": ScaleByAdafactor,
         "big_vision.sgd": Identity}


def _clip_per_example(g, max_norm):
  """JAX `clip_by_per_example_global_norm`: axis 0 of every gradient is
  the example axis; each example's gradient is scaled to a global norm of
  at most `max_norm`, and the mean over the examples is returned."""
  n = g[0].shape[0] if g and g[0].dim() else None
  if n is None or any(x.dim() < 1 or x.shape[0] != n for x in g):
    raise ValueError("grad_clip_per_example expects every gradient to "
                     "have the batch dimension on its axis 0")
  norms = torch.sqrt(sum(torch.sum(x.reshape(n, -1) ** 2, 1) for x in g))
  mult = torch.nan_to_num(torch.clamp_max(max_norm / norms, 1.0), nan=1.0)
  return [torch.tensordot(mult, x, dims=1) / n for x in g]


def _global_norm(g):
  """optax.global_norm of a list of tensors: sqrt of the sum, in list order,
  of each tensor's sum of squares (one tensor's square at a time)."""
  return torch.sqrt(sum(torch.sum(x * x) for x in g))


class Chain:
  """The optax chain `make` builds, over {name: tensor} dicts.

  `init(params)` returns the state; `update(grads, state, params)` returns
  (updates, new state) without touching params, as optax does;
  `apply_(params, grads, state)` adds the updates to the params in place
  and returns (updates, new state). `apply_(..., chunk_numel=n)` runs the
  same arithmetic over chunks of about n elements of params at a time, so
  that its temporaries are the size of a chunk and not of the whole tree:
  the clip's global norm first (the same sums in the same order), then
  for each chunk the rule, lr, mults, weight decay and schedules, its
  params updated and its state tensors replaced in `state` itself. Its
  params and state are bit-equal to the unchunked chain's; it returns
  (None, state).
  """

  def __init__(self, names, rule, *, frozen, clip_norm, clip_per_example,
               lr, mult, wd, sched_of, sched_fns):
    self.names = list(names)
    self.rule = rule
    self.live = [n for n in self.names if not frozen[n]]
    self.frozen = [n for n in self.names if frozen[n]]
    self.clip_norm, self.clip_per_example = clip_norm, clip_per_example
    self.lr, self.mult, self.wd = lr, mult, wd
    self.sched_of, self.sched_fns = sched_of, sched_fns

  def init(self, params):
    return {"count": 0, **self.rule.init({n: params[n] for n in self.live})}

  def _live_updates(self, live, grads, state, params, norm=None):
    """(updates [tensor] of the params `live`, the rule's state of them),
    with the clip's global `norm` over every live param when given."""
    g = [grads[n] for n in live]
    if self.clip_norm and self.clip_per_example:
      g = _clip_per_example(g, self.clip_norm)
    elif self.clip_norm:  # optax.clip_by_global_norm, masked to live params
      norm = _global_norm(g) if norm is None else norm
      small = norm < self.clip_norm
      norms = {x.dtype: norm.to(x.dtype) for x in g}
      g = [torch.where(small, x, (x / norms[x.dtype]) * self.clip_norm)
           for x in g]
    count = state["count"]
    u, rule_state = self.rule.update(live, g, state, params, count)
    u = torch._foreach_mul(u, self.lr)
    u = _scale_groups(u, [self.mult[n] for n in live])
    for w in set(self.wd[n] for n in live) - {0.0}:
      idx = [i for i, n in enumerate(live) if self.wd[n] == w]
      wd = torch._foreach_mul([params[live[i]] for i in idx], w)
      for i, x in zip(idx, torch._foreach_add([u[i] for i in idx], wd)):
        u[i] = x
    lrs = [float(np.float32(fn(count))) for fn in self.sched_fns]
    u = _scale_groups(u, [lrs[self.sched_of[n]] for n in live])
    return torch._foreach_mul(u, -1.0), rule_state

  def update(self, grads, state, params):
    u, rule_state = self._live_updates(self.live, grads, state, params)
    updates = dict(zip(self.live, u))
    updates.update({n: torch.zeros_like(grads[n]) for n in self.frozen})
    return ({n: updates[n] for n in self.names},
            {"count": state["count"] + 1, **rule_state})

  def chunks(self, params, chunk_numel):
    """The live params in order, cut into lists of about `chunk_numel`
    elements (a param larger than that is a chunk of its own)."""
    out, size = [[]], 0
    for n in self.live:
      if out[-1] and size + params[n].numel() > chunk_numel:
        out.append([])
        size = 0
      out[-1].append(n)
      size += params[n].numel()
    return [c for c in out if c]

  @torch.no_grad()
  def apply_(self, params, grads, state, *, chunk_numel=None):
    if not chunk_numel:
      updates, state = self.update(grads, state, params)
      torch._foreach_add_([params[n] for n in self.names],
                          [updates[n] for n in self.names])
      return updates, state
    if self.clip_norm and self.clip_per_example:
      raise ValueError("a chunked update cannot clip per example")
    norm = (_global_norm([grads[n] for n in self.live])
            if self.clip_norm else None)
    for chunk in self.chunks(params, chunk_numel):
      u, rule_state = self._live_updates(chunk, grads, state, params, norm)
      torch._foreach_add_([params[n] for n in chunk], u)
      del u
      for key, part in rule_state.items():
        state[key].update(part)
      del rule_state
    state["count"] += 1
    return None, state


def make(config, params, *, sched_kw, jax_shapes=None):
  """(the config's optimizer over `params` {name: tensor}, [sched_fns]).

  `jax_shapes` ({name: JAX shape}) gives the JAX layout of params stored
  in the port's; only Adafactor's factoring reads it.
  """
  config = dict(config)
  name = config.get("optax_name")
  if name not in RULES:
    raise ValueError(f"optax_name={name!r} is not ported; the port has "
                     f"{sorted(RULES)}")
  kw = dict(config.get("optax", {}))
  if name == "big_vision.scale_by_adafactor":
    kw["jax_shapes"] = jax_shapes
  rule = RULES[name](**kw)
  names = list(params)

  schedule = config.get("schedule", {})
  if not isinstance(schedule, (tuple, list)):
    schedule = [(".*", schedule)]
  frozen, live_scheds = _split_frozen(names, schedule)
  def create_schedule(mult=1.0, **kw):
    if "base" in kw:
      raise ValueError(f"schedule takes mult, not base: {kw}")
    return schedules.create_learning_rate_schedule(base=mult, **sched_kw,
                                                   **kw)

  sched_fns = [create_schedule(**dict(s)) for _, s in live_scheds]
  sched_of = {n: next(i for i, (m, _) in enumerate(live_scheds) if m[n])
              for n in names if not frozen[n]}

  mult = dict.fromkeys(names, 1.0)
  if config.get("lr_mults"):
    patterns, mults = zip(*config["lr_mults"])
    if not all(m > 0 for m in mults):
      raise ValueError(f"Freeze with schedule=None, not lr_mults={mults}")
    for m, mask in zip(mults, trees.make_mask_trees(mult, list(patterns))):
      mult.update({n: mult[n] * m for n in names if mask[n]})

  wd = dict.fromkeys(names, 0.0)
  if config.get("wd"):
    patterns, wmults = zip(*config.get("wd_mults", [(".*/kernel$", 1.0)]))
    for m, mask in zip(wmults, trees.make_mask_trees(wd, list(patterns))):
      wd.update({n: config["wd"] * m for n in names if mask[n]})

  tx = Chain(names, rule, frozen=frozen,
             clip_norm=config.get("grad_clip_norm"),
             clip_per_example=bool(config.get("grad_clip_per_example")),
             lr=config["lr"], mult=mult, wd=wd, sched_of=sched_of,
             sched_fns=sched_fns)
  return tx, sched_fns

"""Durations, learning-rate schedules and mixup: port of
big_vision_tpu/utils/schedules.py (`steps`, `create_learning_rate_schedule`,
`get_mixup`, `mixup`).

Configs may express any duration as `{prefix}_{steps,examples,epochs,
percent}`; training code only sees integer steps. A schedule maps a step
to a float32 learning rate, computed in numpy float32 as the JAX version
computes it in jnp float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_SUFFIXES = ("steps", "examples", "epochs", "percent")


def steps(prefix, config, data_size=None, batch_size=None, total_steps=None,
          default=ValueError):
  """Resolves the duration named `prefix` in `config` to integer steps."""
  config = dict(config)
  found = [s for s in _SUFFIXES
           if (v := config.get(f"{prefix}_{s}")) is not None and v >= 0]
  if len(found) > 1:
    raise ValueError(
        f"Only one of {[f'{prefix}_{s}' for s in found]} may be set.")

  def round_nonzero(x):  # at least 1 step unless exactly zero was asked
    return max(1, round(x)) if x else 0

  if "steps" in found:
    return config[f"{prefix}_steps"]
  if "examples" in found and batch_size:
    return round_nonzero(config[f"{prefix}_examples"] / batch_size)
  if "epochs" in found and batch_size and data_size:
    return round_nonzero(config[f"{prefix}_epochs"] * data_size / batch_size)
  if "percent" in found and total_steps:
    pct = config[f"{prefix}_percent"]
    if not 0.0 <= pct <= 1.0:
      raise ValueError(f"{prefix}_percent={pct} not in [0, 1]")
    return round_nonzero(pct * total_steps)
  if default is ValueError:
    raise ValueError(
        f"Cannot resolve duration {prefix!r}: batch_size={batch_size} "
        f"data_size={data_size} total_steps={total_steps}; config keys: "
        f"{sorted(config)}")
  return default


def create_learning_rate_schedule(total_steps, batch_size=None, data_size=None,
                                  base=1.0, decay_type="stair",
                                  scale_with_batchsize=False, **kw):
  """Returns step -> lr (np.float32): linear/polynomial, cosine, rsqrt or
  stair decay, with optional warmup and cooldown durations."""
  f32 = np.float32

  def to_steps(name, default=0):
    return steps(name, kw, data_size, batch_size, total_steps, default=default)

  warmup = to_steps("warmup")
  cooldown = to_steps("cooldown")
  if total_steps > 1 and warmup >= total_steps:
    raise ValueError("warmup >= total_steps")
  if decay_type not in ("linear", "polynomial", "cosine", "rsqrt", "stair"):
    raise ValueError(f"Unknown decay_type {decay_type!r}")

  def sched(step):
    step = int(step)
    lr = f32(base)
    if scale_with_batchsize:  # Goyal et al. linear scaling rule (ref bs 256)
      lr = f32(lr * f32(batch_size) / f32(256.0))
    progress = f32(step - warmup) / f32(max(total_steps - warmup, 1))
    progress = np.clip(progress, f32(0.0), f32(1.0))
    if decay_type in ("linear", "polynomial"):
      power = kw.get("power", 1)
      end = f32(kw.get("end", kw.get("linear_end", 0)))
      lr = end + (lr - end) * (f32(1.0) - progress) ** f32(power)
    elif decay_type == "cosine":
      lr = lr * f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * progress))
    elif decay_type == "rsqrt":
      t = to_steps("timescale", default=kw.get("timescale", 10_000))
      shift = to_steps("shift", default=kw.get("shift", 0))
      lr = (lr / np.sqrt(f32(1) + f32(step + shift - warmup) / f32(t))
            if warmup <= step else
            lr / np.sqrt(f32(1) + f32(shift) / f32(t)))
    else:  # stair
      i = np.searchsorted(np.asarray(kw.get("steps", [])), step + 1)
      lr = lr * f32(([1.0] + list(kw.get("mults", [])))[i])
    if warmup:
      lr = lr * np.minimum(f32(1.0), f32(step) / f32(warmup))
    if cooldown:
      lr = lr * np.minimum(f32(1.0), f32(total_steps - step) / f32(cooldown))
    return f32(lr)

  return sched


def mix(a, *things, **more):
  """Mixes each tensor x with itself rolled by one along the batch,
  a * x + (1 - a) * roll(x, 1, axis 0), with `a` an f32 scalar as in the
  JAX package; None entries pass through. Returns (things, more)."""
  a = torch.tensor(a, dtype=torch.float32)

  def one(x):
    return None if x is None else a * x + (1 - a) * torch.roll(x, 1, 0)

  return tuple(map(one, things)), {k: one(v) for k, v in more.items()}


def get_mixup(generator, p):
  """Draws a ~ Beta(p, p) from `generator` (a CPU torch.Generator), keeps
  a = max(a, 1 - a) in f32 as the JAX `get_mixup` does, and returns `mix`
  with that a bound."""
  a = torch._sample_dirichlet(  # pylint: disable=protected-access
      torch.tensor([p, p], dtype=torch.float64), generator=generator)[0]
  a = np.float32(a.item())
  return functools.partial(mix, max(a, np.float32(1.0) - a))


def mixup(generator, *things, p, **more_things):
  """`get_mixup(generator, p)(*things, **more_things)`."""
  return get_mixup(generator, p)(*things, **more_things)

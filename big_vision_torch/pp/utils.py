"""Preprocessing-op plumbing: the port's `PPOp` and `InKeyOutKey`.

Port of big_vision_tpu/pp/utils.py, with the same two phases:

  * HOST phase: per example, in loader threads, numpy. Handles every
    variable-shape stage (decode, crops).
  * DEVICE phase: batched torch ops on the batch's device (the card in
    training), with randomness from a `torch.Generator`. The JAX package
    vmaps a per-example jax function here; the port writes the batch axis
    out instead.

An op declares which phases it has and whether it is a "staticizer"
(variable shapes in, static shapes out); `pp/builder.py` places the
boundary as the JAX builder does.
"""

from __future__ import annotations

import dataclasses
from collections import abc
from typing import Callable

import numpy as np


def maybe_repeat(arg, n_reps):
  if not isinstance(arg, abc.Sequence) or isinstance(arg, str):
    arg = (arg,) * n_reps
  return arg


@dataclasses.dataclass
class PPOp:
  """One instantiated preprocessing op.

  Attributes:
    fn: device implementation, batched: `(batch: dict) -> dict`, or
      `(batch, generator) -> dict` when `random`.
    host_fn: host implementation, per example (numpy): `(data) -> dict`,
      or `(data, np_rng) -> dict` when `random`.
    phase: "host" forces host placement; "auto" lets the builder decide.
    staticizer: output shapes are static given the op's args.
    random: whether the fns consume randomness.
    structural: pure dict plumbing, the same in either phase.
    name: the spec string, for error messages.
  """
  fn: Callable | None = None
  host_fn: Callable | None = None
  phase: str = "auto"
  staticizer: bool = False
  random: bool = False
  structural: bool = False
  name: str = ""

  def run_host(self, data, np_rng):
    if self.host_fn is None:
      raise ValueError(f"pp op {self.name!r} has no host implementation")
    return self.host_fn(data, np_rng) if self.random else self.host_fn(data)

  def run_device(self, batch, generator):
    if self.fn is None:
      raise ValueError(f"pp op {self.name!r} is host-only")
    return self.fn(batch, generator) if self.random else self.fn(batch)


def as_pp_op(phase="auto", staticizer=False, random=False,
             host_factory=None):
  """Wraps a factory of a batched device fn so that calling it yields a
  PPOp; `host_factory`, called with the same arguments, gives its per-example
  host form."""
  def deco(factory):
    def make(*args, **kw):
      return PPOp(fn=factory(*args, **kw),
                  host_fn=host_factory(*args, **kw) if host_factory else None,
                  phase=phase, staticizer=staticizer, random=random,
                  name=factory.__name__)
    make.__name__ = factory.__name__
    make.__doc__ = factory.__doc__
    return make
  return deco


class InKeyOutKey:
  """Adds `key`/`inkey`/`outkey` kwargs to single-tensor ops: lifts a
  factory of `value -> value` (or `(value, rng) -> value`) to dicts."""

  def __init__(self, indefault="image", outdefault="image", random=False):
    self.indefault = indefault
    self.outdefault = outdefault
    self.random = random

  def __call__(self, factory):
    def make(*args, key=None, inkey=self.indefault, outkey=self.outdefault,
             **kw):
      elem_fn = factory(*args, **kw)
      ik, ok = key or inkey, key or outkey

      def op(data, *rng):
        data = dict(data)
        data[ok] = elem_fn(data[ik], *rng)
        return data
      return op
    make.__name__ = factory.__name__
    make.__doc__ = factory.__doc__
    return make


# Threefry-2x32 (20 rounds), JAX's default PRNG, in numpy: the JAX package
# runs a device op that lands in the host phase eagerly, with the key
# `PRNGKey(np_rng.integers(0, 2**31 - 1))`, so the port's host forms of
# random device ops draw through it to make the same choices.
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key, x0, x1):
  """Threefry-2x32 of the counter words (x0, x1) under key (k0, k1); uint32
  numpy arrays in and out."""
  with np.errstate(over="ignore"):
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for r in range(5):
      for rot in _ROTATIONS[r % 2]:
        x0 = x0 + x1
        x1 = (x1 << np.uint32(rot)) | (x1 >> np.uint32(32 - rot))
        x1 = x1 ^ x0
      x0 = x0 + ks[(r + 1) % 3]
      x1 = x1 + ks[(r + 2) % 3] + np.uint32(r + 1)
  return x0, x1


def host_uniform(np_rng, shape=()):
  """f32 U[0, 1) of `shape` as JAX's eager host run of a random device op
  draws it: `jax.random.uniform(PRNGKey(np_rng.integers(0, 2**31 - 1)),
  shape)` (partitionable threefry: counter i in the low word, the two
  output words xor-ed; the top 23 bits as the mantissa of [1, 2))."""
  seed = int(np_rng.integers(0, 2**31 - 1))
  count = np.arange(int(np.prod(shape)), dtype=np.uint32).reshape(shape)
  b0, b1 = threefry2x32((0, seed), np.zeros_like(count), count)
  bits = (b0 ^ b1) >> np.uint32(9) | np.uint32(0x3F800000)
  return bits.view(np.float32) - np.float32(1.0)

"""Preprocessing pipeline builder: port of big_vision_tpu/pp/builder.py.

Turns a pp string ``"random_crop(224)|flip_lr|value_range(-1, 1)"`` into a
two-phase `PreprocessFn`:

  pfn = get_preprocess_fn(spec)
  example = pfn.host(raw_example, np_rng)      # loader threads, per example
  batch   = pfn.device(batch, generator)       # batched torch ops, on device
  example = pfn(raw_example)                   # one example, every op

The host/device boundary is placed exactly as the JAX builder places it, so
one pp string splits the same way in both packages. Op names are looked up
as ``preprocess_ops.<name>`` in the port's own registry.
"""

from __future__ import annotations

import numpy as np
import torch

from big_vision_torch.registry import Registry
from big_vision_torch.pp.utils import PPOp

__all__ = ["get_preprocess_fn", "PreprocessFn"]


class PreprocessFn:
  """A parsed pipeline with a host prefix and a device suffix."""

  def __init__(self, ops: list[PPOp], specs: list[str]):
    self.ops = ops
    self.specs = specs
    # The device phase starts after (a) the last host-only op and (b) the
    # first staticizer: the earliest point where shapes are static.
    last_host = max(
        (i for i, op in enumerate(ops) if op.phase == "host" or op.fn is None),
        default=-1)
    first_static = next(
        (i for i, op in enumerate(ops) if op.staticizer), -1)
    self.host_end = max(last_host, first_static)
    # Structural ops right after the host phase stay on the host.
    while (self.host_end + 1 < len(ops) and self.host_end >= 0
           and ops[self.host_end + 1].structural):
      self.host_end += 1

  @property
  def host_ops(self):
    return self.ops[:self.host_end + 1]

  @property
  def device_ops(self):
    return self.ops[self.host_end + 1:]

  def host(self, data, np_rng):
    """Runs the host phase on one example (dict of numpy/bytes)."""
    for op in self.host_ops:
      data = op.run_host(data, np_rng)
    return data

  def device(self, batch, generator):
    """Runs the device phase on a batch (dict of tensors, batch axis 0);
    random ops draw from `generator` in order."""
    for op in self.device_ops:
      batch = op.run_device(batch, generator)
    return batch

  def __call__(self, data, np_rng=None, generator=None):
    """Runs every op on one example, as the JAX builder's `__call__`: the
    host form of the host-only ops, the device form of the others (on the
    CPU, on a batch of one). Numbers come back as numpy arrays."""
    np_rng = np_rng or np.random.default_rng(0)
    for op in self.ops:
      if op.fn is None or op.phase == "host":
        data = op.run_host(data, np_rng)
        continue
      batch = {k: torch.from_numpy(np.asarray(v)[None])
               if _numeric(v) else v for k, v in data.items()}
      batch = op.run_device(batch, generator)
      data = {k: v[0].numpy() if isinstance(v, torch.Tensor) else v
              for k, v in batch.items()}
    return {k: np.asarray(v) if _numeric(v) else v for k, v in data.items()}


def _numeric(v):
  return (not isinstance(v, (str, bytes))
          and np.asarray(v).dtype.kind in "biuf")


def get_preprocess_fn(pp_pipeline):
  """Parses a pp string into a PreprocessFn. Empty/None -> identity."""
  ops, specs = [], []
  for op_spec in (pp_pipeline or "").split("|"):
    op_spec = op_spec.strip()
    if not op_spec:
      continue
    op = Registry.lookup(f"preprocess_ops.{op_spec}")()
    if not isinstance(op, PPOp):
      raise TypeError(f"Factory for {op_spec!r} must return a PPOp, got "
                      f"{type(op)}")
    op.name = op_spec
    ops.append(op)
    specs.append(op_spec)
  return PreprocessFn(ops, specs)

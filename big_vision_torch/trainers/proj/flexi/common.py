"""Shared utilities for the FlexiViT trainers: port of
big_vision_tpu/trainers/proj/flexi/common.py (numpy only).

Host-side RNG keyed by (experiment, work-unit, step), the weighted choice
of flexi arg values, and one predict_fn per combination of them. The
PCG64 stream is numpy's, so the port draws the JAX trainer's values.
The port's configs are plain dicts: a flexi arg is {"v": values, "p":
weights}.
"""

from __future__ import annotations

from functools import partial
from itertools import product

import numpy as np


def _pcg(seed=None):
  """A PCG64 Generator; seeded this equals np.random.default_rng(seed)."""
  return np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))


def mkrng(xid, wid, step):
  """Deterministic host RNG; ids are capped at 0 (local runs use -1)."""
  return _pcg(tuple(v if v > 0 else 0 for v in (xid, wid, step)))


def mkprob(weights):
  """Normalizes a weight list into a probability vector (None passthrough)."""
  if weights is None:
    return None
  arr = np.asarray(weights, dtype=float)
  return arr / arr.sum()


def choice(values, ratios, rng=None):
  """Samples one of `values` with (unnormalized) `ratios` as weights."""
  sampler = _pcg() if rng is None else rng
  probs = mkprob(ratios)
  return sampler.choice(values, p=probs)


def mkpredictfns(predict_fn, config, template="predict_{x}"):
  """One named predict_fn per combination of flexi arg values.

  For flexi args a=[1,2], b=[10,20] this yields four entries named
  "predict_a=1_b=10" etc., each a partial of predict_fn. The args are in
  sorted order, the order in which the JAX package's ConfigDict yields them.
  """
  arg_names = sorted(config)
  fns = {}
  for combo in product(*(config[a]["v"] for a in arg_names)):
    kw = dict(zip(arg_names, combo))
    label = "_".join(f"{a}={v}" for a, v in kw.items())
    fns[template.format(x=label)] = partial(predict_fn, **kw)
  return fns

"""DataSource API: port of big_vision_tpu/datasets/core.py.

A DataSource owns a dataset; the input pipeline pulls raw example dicts
(numpy) from it on host threads. The port runs one process, so a source
yields every example (the JAX package's per-process splits wait for the
multi-device slice).

`get(name, **kw)` knows "synthetic" (datasets/synthetic.py),
"imagefolder" (datasets/imagefolder.py) and "arrays" (datasets/arrays.py);
the other sources of the JAX package are not ported yet and raise.
"""

from __future__ import annotations

import hashlib
import importlib
from typing import Iterator

import numpy as np


class DataSource:
  """Interface; subclasses provide the data."""

  # Total number of examples.
  total_examples: int

  def get_examples(self, *, ordered: bool, seed: int = 0,
                   epoch: int = 0) -> Iterator[dict]:
    """Yields every example once (one epoch); shuffled with `seed` and
    `epoch` unless `ordered`. Each example carries an int64 "_id"."""
    raise NotImplementedError


_BUILTIN = {"synthetic": "big_vision_torch.datasets.synthetic",
            "imagefolder": "big_vision_torch.datasets.imagefolder",
            "arrays": "big_vision_torch.datasets.arrays"}


def get(name, **kw):
  """Instantiates a DataSource by name."""
  if name not in _BUILTIN:
    raise ValueError(f"data source {name!r} is not ported; known: "
                     f"{sorted(_BUILTIN)}")
  return importlib.import_module(_BUILTIN[name]).DataSource(**kw)


def stable_id(key) -> np.int64:
  """64-bit stable hash of a string or bytes key (an example's identity):
  the first 8 bytes of its SHA-256, little-endian, signed."""
  if isinstance(key, str):
    key = key.encode()
  h = hashlib.sha256(key).digest()
  return np.int64(int.from_bytes(h[:8], "little", signed=True))

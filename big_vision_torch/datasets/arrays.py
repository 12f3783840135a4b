"""In-memory DataSource: port of big_vision_tpu/datasets/arrays.py.

A dict of equal-length arrays (`data=`), or the arrays of an `.npz` file
(`npz=`), one example per index. The port runs one process, so the source
yields its whole range where the JAX source yields `core.process_split`'s
share of it (the same range on one process). The order is the JAX
source's: `default_rng((seed, epoch)).permutation` of the indices unless
`ordered`, each example with `_id` = its index as an int64.

The digits split files of configs/quality_digits.py (`digits_train.npz`,
`digits_test.npz`) are written from the committed scans by
`datasets.digits.make_split` when `npz=` names one that does not exist.
"""

from __future__ import annotations

import os

import numpy as np

from big_vision_torch.datasets import core
from big_vision_torch.datasets import digits


class DataSource(core.DataSource):
  """data={"image": [...], "label": [...]}; all values the same length; or
  npz="/path/file.npz" to read the arrays from disk."""

  def __init__(self, data=None, npz=None, split=None):
    del split
    if npz is not None:
      assert data is None, "pass either data= or npz=, not both"
      if (not os.path.exists(npz)
          and os.path.basename(npz) in digits.SPLIT_FILES):
        digits.make_split(os.path.dirname(npz))
      with np.load(npz) as f:
        data = dict(f)
    lengths = {k: len(v) for k, v in data.items()}
    assert len(set(lengths.values())) == 1, f"Ragged source: {lengths}"
    self.data = data
    self.total_examples = next(iter(lengths.values()))

  def num_examples_per_process(self):
    return self.total_examples

  def get_examples(self, *, ordered, seed=0, epoch=0):
    idx = np.arange(self.total_examples)
    if not ordered:
      idx = np.random.default_rng((seed, epoch)).permutation(idx)
    for i in idx:
      yield {**{k: v[i] for k, v in self.data.items()}, "_id": np.int64(i)}

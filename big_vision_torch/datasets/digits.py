"""The handwritten digits of configs/quality_digits.py, without sklearn.

`digits.npz` beside this file holds sklearn's bundled `load_digits`: the
1,797 8x8 scans (values 0..16, uint8) and their labels. `make_split`
writes from it the stratified split of the JAX package's
tools/run_quality.py (`make_split`): 36 test scans a class drawn with
`default_rng(0)`, 1437 train and 360 test, the scans scaled to 0..255 and
repeated to 3 channels (HWC3 uint8), int64 labels; the same arrays bit for
bit.
"""

from __future__ import annotations

import os

import numpy as np

SPLIT_FILES = ("digits_train.npz", "digits_test.npz")
SCANS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "digits.npz")


def load():
  """(images [1797, 8, 8] float64 in 0..16, labels [1797] int64): sklearn's
  `load_digits().images` and `.target`."""
  with np.load(SCANS) as f:
    return f["images"].astype(np.float64), f["labels"].astype(np.int64)


def make_split(npz_dir, test_per_class=36, seed=0):
  """Writes digits_train.npz and digits_test.npz into `npz_dir`; returns
  (train, test) example counts."""
  images, labels = load()
  imgs = np.round(images * (255.0 / 16.0)).astype(np.uint8)
  imgs = np.repeat(imgs[..., None], 3, axis=-1)
  rng = np.random.default_rng(seed)
  test_idx = []
  for c in range(10):
    idx_c = np.flatnonzero(labels == c)
    test_idx.append(rng.permutation(idx_c)[:test_per_class])
  test_idx = np.sort(np.concatenate(test_idx))
  train_mask = np.ones(len(labels), bool)
  train_mask[test_idx] = False
  os.makedirs(npz_dir, exist_ok=True)
  for name, sel in zip(SPLIT_FILES, (train_mask, test_idx)):
    # Written beside and renamed: a reader never sees half a file.
    tmp = os.path.join(npz_dir, f".{name}.{os.getpid()}.npz")
    np.savez(tmp, image=imgs[sel], label=labels[sel])
    os.replace(tmp, os.path.join(npz_dir, name))
  return int(train_mask.sum()), len(test_idx)

"""Image-folder DataSource: port of big_vision_tpu/datasets/imagefolder.py.

The layout torchvision calls ImageFolder, root/<class name>/<image file>:
classes are the sorted directory names, files are taken in sorted order.
Yields the encoded bytes, the class index and a stable id from the path.
The port runs one process, so the source yields every example.
"""

from __future__ import annotations

import os

import numpy as np

from big_vision_torch.datasets import core

_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class DataSource(core.DataSource):

  def __init__(self, root, split=None):
    del split
    classes = sorted(
        d for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d)))
    self.class_names = classes
    self.files = []
    for li, cls in enumerate(classes):
      cdir = os.path.join(root, cls)
      for fn in sorted(os.listdir(cdir)):
        if fn.lower().endswith(_EXTS):
          self.files.append((os.path.join(cdir, fn), li))
    self.total_examples = len(self.files)

  def get_examples(self, *, ordered, seed=0, epoch=0):
    idx = np.arange(self.total_examples)
    if not ordered:
      idx = np.random.default_rng((seed, epoch)).permutation(idx)
    for i in idx:
      path, label = self.files[int(i)]
      with open(path, "rb") as f:
        img = f.read()
      yield {"image": img, "label": np.int32(label),
             "_id": core.stable_id(path)}

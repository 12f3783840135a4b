"""Synthetic DataSource: port of big_vision_tpu/datasets/synthetic.py.

Example i has label i % num_classes and the image that numpy's
`default_rng(i % unique_images)` draws, the same values as the JAX
source: raw uint8 HWC arrays (`encoded=False`) or, by default, those
arrays as JPEG bytes of quality 90 (`encoded=True`, which exercises the
host decode as a real dataset does). Each unique image is drawn (and
encoded) once and cached: drawing 245 KB of random bytes per example in
the loader threads would starve a step of 256 images, and encoding one
costs milliseconds.
"""

from __future__ import annotations

import functools
import io

import numpy as np

from big_vision_torch.datasets import core


@functools.lru_cache(maxsize=None)  # one entry per unique image
def _image(seed, h, w):
  img = np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)
  img.flags.writeable = False
  return img


@functools.lru_cache(maxsize=None)  # one entry per unique image
def _jpeg_bytes(seed, h, w):
  from PIL import Image
  buf = io.BytesIO()
  Image.fromarray(_image(seed, h, w)).save(buf, format="JPEG", quality=90)
  return buf.getvalue()


# The words of the captions of `captions=k` (COCO's stand-in).
_ADJECTIVES = ("a small", "a large", "an old", "a red", "a white", "a black",
               "two", "a wooden", "a striped", "a happy")
_NOUNS = ("cat", "dog", "horse", "bus", "train", "pizza", "kite", "boat",
          "clock", "giraffe", "elephant", "bicycle", "zebra", "surfer",
          "skier", "sandwich")
_PLACES = ("on a street", "in a field", "near the water", "in a kitchen",
           "on a table", "at the beach", "in the snow", "under a tree")


def captions(label, k):
  """k captions of an image of class `label`: its noun in each, the other
  words varying with the caption's index."""
  noun = _NOUNS[label % len(_NOUNS)]
  return [f"{_ADJECTIVES[(label + 3 * j) % len(_ADJECTIVES)]} {noun} "
          f"{_PLACES[(label // len(_NOUNS) + j) % len(_PLACES)]}."
          for j in range(k)]


class DataSource(core.DataSource):
  """With `captions` = k > 0, each example also holds COCO's keys: its
  index as "image/id" and {"text": k captions from its label} as
  "captions" (the nesting of `datasets/builders/coco_captions.py`).
  With `side_range` = (lo, hi), each unique image has its own height and
  width in [lo, hi], drawn from `default_rng((its seed, 1))`: images of
  many aspect ratios (the port's own option, for NaFlex)."""

  def __init__(self, *, n=1024, num_classes=1000, h=256, w=256,
               encoded=True, unique_images=64, captions=0, side_range=None,
               split=None):
    del split
    self.total_examples = n
    self.num_classes = num_classes
    self.h, self.w = h, w
    self.side_range = side_range
    self.encoded = encoded
    self.unique_images = unique_images
    self.captions = captions

  def _example(self, i):
    make = _jpeg_bytes if self.encoded else _image
    label = int(i % self.num_classes)
    seed = int(i) % self.unique_images
    h, w = self.h, self.w
    if self.side_range:  # each unique image's own sides, from its seed
      lo, hi = self.side_range
      h, w = (int(x) for x in np.random.default_rng((seed, 1)).integers(
          lo, hi + 1, 2))
    ex = {"image": make(seed, h, w),
          "label": np.int32(label), "_id": np.int64(i)}
    if self.captions:
      ex["image/id"] = np.int64(i)
      ex["captions"] = {"text": np.asarray(captions(label, self.captions))}
    return ex

  def get_examples(self, *, ordered, seed=0, epoch=0):
    idx = np.arange(self.total_examples)
    if not ordered:
      idx = np.random.default_rng((seed, epoch)).permutation(idx)
    for i in idx:
      yield self._example(i)

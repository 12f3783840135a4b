"""NaFlex preprocessing (SigLIP 2): port of
big_vision_tpu/pp/proj/image_text/ops_naflex.py, on the host.

`resize_to_sequence` resizes an image, keeping its aspect ratio, to the
largest size whose patch grid fits a token budget (`get_image_size_for_seq`,
the JAX package's binary search in float64, with its true division of the
patch counts); `central_crop_to_sequence` crops to that size instead;
`patchify` cuts an image into the dict {"patches" [N, p*p*c], "yidx",
"xidx", "type" (1 for an image patch)} and `tuplify` gathers keys into a
tuple. The chain of a NaFlex tower:

  resize_to_sequence(16, 256)|value_range(-1, 1)|patchify(16)|flatten
  |pad_to_shape((256, 768), key='image/patches')|... |tuplify(...)

(`pad_to_shape` pads each key to the budget with type 0: padding).
"""

from __future__ import annotations

import numpy as np

from big_vision_torch.pp.ops_image import _pil_resize
from big_vision_torch.pp.utils import PPOp
from big_vision_torch.pp.utils import maybe_repeat
from big_vision_torch.registry import Registry
from big_vision_torch.utils import trees


def get_image_size_for_seq(image_hw, patch_size, max_sequence_len,
                           divisible_by_patch=True, eps=1e-5):
  """(ratio, (h, w)): the largest aspect-preserving size whose patch count
  is within `max_sequence_len`, by the JAX package's binary search."""
  h, w = image_hw

  def prepare(ratio):
    th, tw = h * ratio, w * ratio
    if divisible_by_patch:
      th = patch_size * np.ceil(th / patch_size)
      tw = patch_size * np.ceil(tw / patch_size)
    return (int(max(th, patch_size)), int(max(tw, patch_size)))

  def feasible(ratio):
    th, tw = prepare(ratio)
    # True division: with divisible_by_patch=False the fractional patch
    # counts decide.
    return (th / patch_size) * (tw / patch_size) <= max_sequence_len

  lb, rb = eps / 10, 100.0
  while rb - lb >= eps:
    mid = (lb + rb) / 2
    if feasible(mid):
      lb = mid
    else:
      rb = mid
  assert eps < lb < 100.0, "Binary search failed"
  return lb, prepare(lb)


@Registry.register("preprocess_ops.resize_to_sequence")
def get_resize_to_sequence(patch_size, max_sequence_len,
                           divisible_by_patch=True, eps=1e-5, key="image",
                           inkey=None, outkey=None):
  """Aspect-preserving resize so that the patch count fits the budget;
  float32 out (bilinear with antialias), not cast back."""
  ik, ok = inkey or key, outkey or key

  def _op(data):
    data = dict(data)
    img = np.asarray(data[ik])
    _, target_hw = get_image_size_for_seq(
        img.shape[:2], patch_size, max_sequence_len, divisible_by_patch, eps)
    data[ok] = _pil_resize(img.astype(np.float32), target_hw, "bilinear",
                           antialias=True)
    return data

  return PPOp(host_fn=_op, phase="host", name="resize_to_sequence")


@Registry.register("preprocess_ops.central_crop_to_sequence")
def get_central_crop_to_sequence(patch_size, max_sequence_len,
                                 divisible_by_patch=True, eps=1e-5,
                                 key="image", inkey=None, outkey=None):
  """The central crop of the size `resize_to_sequence` would resize to."""
  ik, ok = inkey or key, outkey or key

  def _op(data):
    data = dict(data)
    img = np.asarray(data[ik])
    _, (th, tw) = get_image_size_for_seq(
        img.shape[:2], patch_size, max_sequence_len, divisible_by_patch, eps)
    assert img.shape[0] >= th and img.shape[1] >= tw, (
        "central_crop_to_sequence needs an image at least target-sized")
    oy = (img.shape[0] - th) // 2
    ox = (img.shape[1] - tw) // 2
    data[ok] = img[oy:oy + th, ox:ox + tw]
    return data

  return PPOp(host_fn=_op, phase="host", name="central_crop_to_sequence")


@Registry.register("preprocess_ops.patchify")
def get_patchify(patch_size, key="image", inkey=None, outkey=None):
  """image -> {"patches" [N, ph*pw*c] in (ph, pw, c) order, "yidx",
  "xidx", "type"} (int32; remainder rows and columns dropped)."""
  ph, pw = maybe_repeat(patch_size, 2)
  ik, ok = inkey or key, outkey or key

  def _op(data):
    data = dict(data)
    img = np.asarray(data[ik])
    h, w, c = img.shape
    nh, nw = h // ph, w // pw
    patches = img[:nh * ph, :nw * pw].reshape(nh, ph, nw, pw, c)
    patches = patches.transpose(0, 2, 1, 3, 4).reshape(nh * nw, ph * pw * c)
    gy, gx = np.meshgrid(np.arange(nh), np.arange(nw), indexing="ij")
    data[ok] = {
        "patches": patches,
        "yidx": gy.reshape(-1).astype(np.int32),
        "xidx": gx.reshape(-1).astype(np.int32),
        "type": np.ones(nh * nw, np.int32),
    }
    return data

  return PPOp(host_fn=_op, phase="host", name="patchify")


@Registry.register("preprocess_ops.tuplify")
def get_tuplify(inkeys, outkey):
  """data[outkey] = the tuple of the values at `inkeys`: a key of `data`
  (as `flatten` makes them, "image/patches"), or a slash name into its
  nested dicts."""
  def _op(data):
    data = dict(data)
    data[outkey] = tuple(data[k] if k in data else trees.get(data, k)
                         for k in inkeys)
    return data
  return PPOp(host_fn=_op, phase="host", structural=True, name="tuplify")

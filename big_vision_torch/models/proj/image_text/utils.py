"""Image-text model helpers: port of
big_vision_tpu/models/proj/image_text/utils.py on one device.

`batch_shmap` maps a function over the data axis of the mesh without
communication; on one device that is a call of the function.
`subsample_batch` takes every `subsample`-th example.
"""

from __future__ import annotations


def batch_shmap(fn, *args, **kwargs):
  """`fn(*args, **kwargs)`: one device has one shard."""
  return fn(*args, **kwargs)


def subsample_batch(x, subsample: int):
  """Every `subsample`-th example of a tensor or a dict of them."""
  if subsample <= 1:
    return x
  if isinstance(x, dict):
    return {k: subsample_batch(v, subsample) for k, v in x.items()}
  return x[::subsample]

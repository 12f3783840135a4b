"""Checkpoints and `.npz` params: port of big_vision_tpu/utils/checkpoints.py.

The pointer protocol is the JAX package's: the checkpoint of a step is
written to `{prefix}-{step:09d}-tmp` (or `{prefix}-{step:09d}` with
`keep`); once it is whole on disk, `{prefix}-LAST` is atomically rewritten
to name it and the previous `-tmp` checkpoint is deleted. A resumed run
reads `-LAST`, so a job killed while writing restarts from the last whole
checkpoint. Where the JAX package writes an orbax directory, the port
writes one file with `torch.save`: a nested dict of tensors on the CPU (the
trainers save {"params": {JAX name: tensor}, "opt": optimizer state}),
staged off the device before `save` returns and written by a background
thread.

`npz_save`, `npz_load` and `load_params` read and write the `.npz` files
of the JAX package and of the published big_vision checkpoints: one array
per leaf under its `/`-joined name (`utils/trees.py`), bf16 stored as
2-byte void. numpy has no bf16, so `npz_load` widens such arrays to f32
(exactly); `npz_save` writes a bf16 tensor's bits as 2-byte void, which
the JAX package reads back as bf16.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from big_vision_torch.utils import trees

__all__ = [
    "CheckpointManager", "save_checkpoint", "load_checkpoint",
    "last_checkpoint_dir", "npz_save", "npz_load", "load_params",
]


def _to_host(tree):
  """A copy of `tree` with every tensor on the CPU (a copy even where it
  already is, so that later in-place updates do not reach the file)."""
  if isinstance(tree, dict):
    return {k: _to_host(v) for k, v in tree.items()}
  if isinstance(tree, torch.Tensor):
    return tree.detach().to("cpu", copy=True)
  return tree


class CheckpointManager:
  """Background writes with the atomic `-LAST` pointer commit."""

  def __init__(self):
    self._thread = None
    self._error = None

  def save(self, tree, prefix, step, *, keep=False):
    """Waits for the previous write, stages `tree` on the host and starts
    writing it; returns then."""
    self.wait_until_finished()
    path = os.path.abspath(f"{prefix}-{step:09d}{'' if keep else '-tmp'}")
    last = last_checkpoint_dir(prefix)
    prev_tmp = last if last and last.endswith("-tmp") and last != path \
        else None
    host = _to_host(tree)

    def write():
      try:
        partial = f"{path}.partial"
        torch.save(host, partial)
        os.replace(partial, path)
        _write_pointer(prefix, path)
        if prev_tmp and os.path.exists(prev_tmp):
          os.remove(prev_tmp)
      except Exception as e:  # pylint: disable=broad-except
        self._error = e  # raised by the next wait

    self._thread = threading.Thread(target=write, daemon=True)
    self._thread.start()

  def wait_until_finished(self):
    """Waits for the write in flight; raises what it raised."""
    if self._thread is not None:
      self._thread.join()
      self._thread = None
    if self._error is not None:
      error, self._error = self._error, None
      raise error

  def close(self):
    self.wait_until_finished()


def _write_pointer(prefix, path):
  """Atomically points {prefix}-LAST at `path` (write temp + rename)."""
  pointer = f"{prefix}-LAST"
  with open(pointer + ".tmp", "w") as f:
    f.write(os.path.basename(path))
  os.replace(pointer + ".tmp", pointer)


def last_checkpoint_dir(prefix):
  """The checkpoint {prefix}-LAST names, or None."""
  pointer = f"{prefix}-LAST"
  if not os.path.exists(pointer):
    return None
  with open(pointer) as f:
    name = f.read().strip()
  return os.path.join(os.path.dirname(prefix), name)


def save_checkpoint(tree, prefix, step, *, keep=False):
  """One blocking save."""
  mgr = CheckpointManager()
  mgr.save(tree, prefix, step, keep=keep)
  mgr.wait_until_finished()


def load_checkpoint(path):
  """The nested dict saved at `path`, tensors on the CPU."""
  return torch.load(os.path.abspath(path), map_location="cpu",
                    weights_only=True)


def _to_numpy(x):
  """A leaf as numpy; a bf16 tensor as its bits in 2-byte void."""
  if isinstance(x, torch.Tensor):
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
      return x.view(torch.int16).numpy().view(np.dtype("V2"))
    return x.numpy()
  return np.asarray(x)


def _recover_dtype(a):
  """2-byte void (how np.save stores bf16) -> the same values in f32."""
  if a.dtype.type is np.void:
    if a.itemsize != 2:
      raise ValueError(f"Unknown void dtype of width {a.itemsize}")
    return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
  return a


def npz_save(tree, fname):
  """Saves a nested dict of arrays or tensors as a flat-named npz."""
  flat = {name: _to_numpy(x) for name, x in trees.flatten(tree).items()}
  os.makedirs(os.path.dirname(os.path.abspath(fname)), exist_ok=True)
  with open(fname, "wb") as f:
    np.savez(f, **flat)


def npz_load(fname, tree=None, subtree=None):
  """Loads a flat npz into a nested dict of numpy arrays; with `subtree`,
  only the arrays under it (or under params/<subtree>). With `tree`,
  raises if the file lacks any of its leaves."""
  with open(fname, "rb") as f:
    data = np.load(f, allow_pickle=False)
    names = data.files
    if subtree is not None:
      names = [k for k in names
               if k in (subtree, f"params/{subtree}")
               or k.startswith((f"{subtree}/", f"params/{subtree}/"))]
    flat = {k: _recover_dtype(data[k]) for k in names}
  out = trees.unflatten(flat)
  if tree is not None:
    missing = sorted(set(trees.flatten(tree)) - set(flat))
    if missing:
      raise ValueError(f"Checkpoint is missing keys: {missing[:20]}")
  return out


def load_params(ckpt, **kw):
  """Params from an npz file; 'file.npz:sub/tree' selects a subtree."""
  def unwrap(params):
    # Published checkpoints often nest everything under a single "params".
    if isinstance(params, dict) and set(params) == {"params"}:
      return params["params"]
    return params

  if isinstance(ckpt, str) and ".npz:" in ckpt:
    fname, subtree = ckpt.rsplit(":", 1)
    return trees.get(unwrap(npz_load(fname, subtree=subtree, **kw)), subtree)
  if isinstance(ckpt, str) and ckpt.endswith(".npz"):
    return unwrap(npz_load(ckpt, **kw))
  if isinstance(ckpt, str) and os.path.isdir(ckpt):
    raise ValueError(
        "A directory is not npz params; use load_checkpoint() for a "
        "checkpoint of the trainers.")
  raise ValueError(f"Don't know how to load params from {ckpt!r}")

"""Generic preprocessing ops: port of big_vision_tpu/pp/ops_general.py.

Device forms are batched torch ops (axis 0 is the batch); host forms are
numpy, per example. `keep`, `drop`, `copy`, `flatten` and `rag_tensor` are
structural (the same in either phase); `setdefault`, `pad_to_shape`,
`lookup`, `choice` and `choice_no_replacement` are host-only. `onehot`,
`value_range`, `reshape`, `tile`, `squeeze_last_dim` and `concat` have
both forms: the
builder puts them on the host where a later op is host-only, as the JAX
package runs its device op there eagerly, and the host form computes the
same f32 values.
"""

from __future__ import annotations

import collections

import numpy as np
import torch
import torch.nn.functional as F

from big_vision_torch.pp.utils import InKeyOutKey, PPOp, as_pp_op, maybe_repeat
from big_vision_torch.registry import Registry
from big_vision_torch.utils import trees


def _structural(fn):
  """Pure dict manipulation: identical on host and device."""
  return PPOp(fn=fn, host_fn=fn, structural=True)


@Registry.register("preprocess_ops.keep")
def get_keep(*keys):
  """Keeps only the given keys."""
  return _structural(lambda data: {k: v for k, v in data.items() if k in keys})


@Registry.register("preprocess_ops.drop")
def get_drop(*keys):
  """Drops the given keys."""
  return _structural(
      lambda data: {k: v for k, v in data.items() if k not in keys})


@Registry.register("preprocess_ops.copy")
def get_copy(inkey, outkey):
  """Copies inkey's value (a nested dict is copied, its leaves shared) to
  outkey."""
  def copy_tree(x):
    return {k: copy_tree(v) for k, v in x.items()} if isinstance(
        x, dict) else x

  def _copy(data):
    data = dict(data)
    data[outkey] = copy_tree(data[inkey])
    return data
  return _structural(_copy)


@Registry.register("preprocess_ops.setdefault")
def get_setdefault(key, value):
  """Sets `key` to `value` where it is missing or empty (host)."""
  def _setdefault(data):
    data = dict(data)
    x = data.get(key)
    if x is None or np.asarray(x).size == 0:
      proto = np.asarray(x) if x is not None else np.asarray(value)
      data[key] = np.broadcast_to(np.asarray(value, proto.dtype),
                                  [s or 1 for s in proto.shape])
    return data
  return PPOp(host_fn=_setdefault, phase="host", name="setdefault")


def _named_leaves(tree):
  """The JAX package's flatten of a pytree into {slash name: leaf}: dicts
  by sorted key, lists and tuples by index; None is no leaf."""
  return {k: v for k, v in trees.flatten(tree).items() if v is not None}


@Registry.register("preprocess_ops.flatten")
def get_flatten(keys=None):
  """Flattens nested dicts into slash-joined keys ("captions/text")."""
  def _flatten(data):
    chosen = keys or list(data.keys())
    kept = {k: v for k, v in data.items() if k not in chosen}
    nested = {k: v for k, v in data.items() if k in chosen}
    return {**_named_leaves(nested), **kept}
  return _structural(_flatten)


@Registry.register("preprocess_ops.rag_tensor")
def get_rag_tensor(*keys):
  """Marks keys as ragged: a no-op, as in the JAX package (whose host phase
  carries variable-length values natively)."""
  del keys
  return _structural(lambda data: data)


@InKeyOutKey()
def _host_reshape(new_shape):
  return lambda x: np.reshape(np.asarray(x), new_shape)


@Registry.register("preprocess_ops.reshape")
@as_pp_op(host_factory=_host_reshape)
@InKeyOutKey()
def get_reshape(new_shape):
  """Reshapes each example to `new_shape`."""
  return lambda x: x.reshape(x.shape[0], *new_shape)


@InKeyOutKey()
def _host_tile(reps):
  return lambda x: np.tile(np.asarray(x), reps)


@Registry.register("preprocess_ops.tile")
@as_pp_op(host_factory=_host_tile)
@InKeyOutKey()
def get_tile(reps):
  """Tiles each example by `reps` (numpy's rules: the shorter of the shape
  and `reps` is padded with leading ones)."""
  reps = tuple(maybe_repeat(reps, 1))

  def _tile(x):
    shape = tuple(x.shape[1:])
    lead = len(reps) - len(shape)
    if lead > 0:
      x = x.reshape(x.shape[0], *((1,) * lead), *shape)
    return x.repeat(1, *((1,) * max(-lead, 0)), *reps)
  return _tile


@InKeyOutKey()
def _host_squeeze_last_dim():
  return lambda x: np.squeeze(np.asarray(x), axis=-1)


@Registry.register("preprocess_ops.squeeze_last_dim")
@as_pp_op(host_factory=_host_squeeze_last_dim)
@InKeyOutKey()
def get_squeeze_last_dim():
  """Drops a last axis of size 1."""
  return lambda x: x.squeeze(-1)


@Registry.register("preprocess_ops.concat")
def get_concat(inkeys, outkey=None, axis=-1):
  """Concatenates several keys along an axis of each example."""
  def _concat(data):
    data = dict(data)
    data[outkey or inkeys[0]] = torch.cat(
        [data[k] for k in inkeys], axis if axis < 0 else axis + 1)
    return data

  def _host(data):
    data = dict(data)
    data[outkey or inkeys[0]] = np.concatenate(
        [np.asarray(data[k]) for k in inkeys], axis)
    return data
  return PPOp(fn=_concat, host_fn=_host, name="concat")


@Registry.register("preprocess_ops.pad_to_shape")
def get_pad_to_shape(shape, pad_value=0, where="after", key="image",
                     inkey=None, outkey=None):
  """Pads each axis up to `shape` (None: as it is) with `pad_value`, after,
  before or on both sides (host; its output shape is static)."""
  ik, ok = inkey or key, outkey or key

  def _pads(cur, tgt):
    if tgt is None:
      return (0, 0)
    diff = tgt - cur
    assert diff >= 0, f"pad_to_shape: dim {cur} exceeds target {tgt}"
    return {"before": (diff, 0), "after": (0, diff),
            "both": (diff // 2, diff - diff // 2)}[where]

  def _pad(data):
    x = np.asarray(data[ik])
    assert x.ndim == len(shape), (x.shape, shape)
    data = dict(data)
    data[ok] = np.pad(x, [_pads(x.shape[i], shape[i])
                          for i in range(len(shape))],
                      constant_values=np.asarray(pad_value, x.dtype))
    return data

  return PPOp(host_fn=_pad, phase="host", staticizer=True,
              name="pad_to_shape")


def _host_onehot(depth, key="labels", key_result=None, multi=True, on=1.0,
                 off=0.0):
  """onehot on one example in numpy f32."""
  def _onehot(data):
    labels = np.asarray(data[key]).astype(np.int64)
    if labels.ndim > 0 and multi:
      hot = np.zeros((depth,), np.float32)
      np.add.at(hot, labels, 1.0)
      x = np.clip(hot, 0, 1) * np.float32(on - off) + np.float32(off)
    else:
      x = (np.arange(depth) == labels[..., None]).astype(np.float32)
      x = x * np.float32(on - off) + np.float32(off)
    data = dict(data)
    data[key_result or key] = x.astype(np.float32)
    return data
  return _onehot


@Registry.register("preprocess_ops.onehot")
@as_pp_op(host_factory=_host_onehot)
def get_onehot(depth, key="labels", key_result=None, multi=True, on=1.0,
               off=0.0):
  """One-hot (or, for per-example label lists with `multi`, multi-hot)
  f32 labels [N, depth], scaled to [off, on]."""
  def _onehot(batch):
    labels = batch[key].to(torch.int64)
    if labels.dim() > 1 and multi:
      hot = torch.zeros((labels.shape[0], depth), device=labels.device)
      hot.scatter_add_(1, labels, torch.ones_like(labels, dtype=hot.dtype))
      x = hot.clamp(0, 1) * (on - off) + off
    else:
      x = F.one_hot(labels, depth).to(torch.float32) * (on - off) + off
    batch = dict(batch)
    batch[key_result or key] = x
    return batch
  return _onehot


@InKeyOutKey()
def _host_value_range(vmin=-1, vmax=1, in_min=0, in_max=255.0,
                      clip_values=False):
  """value_range on one example in numpy f32, the JAX op's arithmetic."""
  lo, hi = np.asarray(in_min, np.float32), np.asarray(in_max, np.float32)

  def _value_range(image):
    image = (np.asarray(image, np.float32) - lo) / (hi - lo)
    image = vmin + image * (vmax - vmin)
    if clip_values:
      image = np.clip(image, vmin, vmax)
    return image.astype(np.float32)
  return _value_range


@Registry.register("preprocess_ops.value_range")
@as_pp_op(host_factory=_host_value_range)
@InKeyOutKey()
def get_value_range(vmin=-1, vmax=1, in_min=0, in_max=255.0,
                    clip_values=False):
  """Rescales [in_min, in_max] (per channel, as lists) to [vmin, vmax] in
  f32, with the JAX op's order of operations."""
  def _value_range(image):
    lo = torch.tensor(in_min, dtype=torch.float32, device=image.device)
    hi = torch.tensor(in_max, dtype=torch.float32, device=image.device)
    image = (image.to(torch.float32) - lo) / (hi - lo)
    image = vmin + image * (vmax - vmin)
    if clip_values:
      image = image.clamp(vmin, vmax)
    return image
  return _value_range


@Registry.register("preprocess_ops.lookup")
def get_lookup(mapping, npzkey="fnames", sep=None, key="image", inkey=None,
               outkey=None):
  """Maps a string to its int32 index in a mapping file (-1 if absent):
  the line number in a text file, `int(value)` of "key<sep>value" lines,
  or the position in an .npz's `npzkey` array (host)."""
  if mapping.endswith(".npz"):
    with open(mapping, "rb") as f:
      keys = [k.decode() if isinstance(k, bytes) else str(k)
              for k in np.load(f, allow_pickle=False)[npzkey]]
    table = {k: i for i, k in enumerate(keys)}
  else:
    with open(mapping, "r") as f:
      lines = f.read().splitlines()
    if sep is None:
      table = {k: i for i, k in enumerate(lines)}
    else:
      table = {k: int(v) for k, v in (l.split(sep) for l in lines)}
  ik, ok = inkey or key, outkey or key

  def _lookup(data):
    needle = data[ik]
    if isinstance(needle, bytes):
      needle = needle.decode()
    data = dict(data)
    data[ok] = np.int32(table.get(needle, -1))
    return data

  return PPOp(host_fn=_lookup, phase="host", name="lookup")


@Registry.register("preprocess_ops.choice")
def get_choice(n="single", key=None, fewer_ok=False, inkey=None, outkey=None):
  """Draws the same entries of all keys from the example's rng (host): one
  entry ("single"), `n` in their order, or a number in [n[0], n[1]]."""
  inkeys = maybe_repeat(inkey or key, 1)
  outkeys = maybe_repeat(outkey or key, 1)
  outkeys = [ok.format(key=ik) for ok, ik in zip(outkeys, inkeys)]
  is_varlen = isinstance(n, (list, tuple))
  min_n = n[0] if is_varlen else 1 if n == "single" else n

  def _choice(data, np_rng):
    data = dict(data)
    nitems = len(data[inkeys[0]])
    for k in inkeys:
      assert len(data[k]) == nitems, f"choice: ragged keys {inkeys}"
    if not fewer_ok:
      assert nitems >= min_n, f"choice: {nitems} < {min_n} items in {inkeys}"
    if n == "single":
      idx = int(np_rng.integers(0, nitems))
      for ik, ok in zip(inkeys, outkeys):
        data[ok] = data[ik][idx]
    else:
      end = int(np_rng.integers(n[0], n[1] + 1)) if is_varlen else n
      perm = np_rng.permutation(nitems)[:end]
      perm.sort()  # the entries keep their order
      for ik, ok in zip(inkeys, outkeys):
        data[ok] = np.asarray(data[ik])[perm]
    return data

  return PPOp(host_fn=_choice, phase="host", random=True,
              staticizer=not is_varlen and n != "single", name="choice")


@Registry.register("preprocess_ops.choice_no_replacement")
def get_choice_no_replacement(key=None, inkey=None, outkey=None):
  """One entry of each key, cycling through an example's entries (by its
  `_id`) in a fresh order per cycle before any repeats (host). The counts
  live in host memory and the orders' seed comes from the OS, as in the
  JAX op."""
  inkeys = maybe_repeat(inkey or key, 1)
  outkeys = maybe_repeat(outkey or key, 1)
  outkeys = [ok.format(key=ik) for ok, ik in zip(outkeys, inkeys)]
  counter = collections.defaultdict(lambda: -1)
  instance_seed = np.random.SeedSequence().entropy % (2 ** 31)

  def _choice(data):
    data = dict(data)
    first = np.asarray(data[inkeys[0]])
    assert first.ndim > 0, f"choice_no_replacement on scalar key(s) {inkeys}"
    nitems = len(first)
    for k in inkeys:
      assert len(data[k]) == nitems, f"ragged keys {inkeys}"
    example_id = int(np.asarray(data["_id"]))
    counter[example_id] += 1
    epoch, offset = divmod(counter[example_id], nitems)
    rng = np.random.default_rng((instance_seed, example_id, epoch))
    index = int(rng.permutation(nitems)[offset])
    for ik, ok in zip(inkeys, outkeys):
      data[ok] = np.asarray(data[ik])[index]
    return data

  return PPOp(host_fn=_choice, phase="host", name="choice_no_replacement")

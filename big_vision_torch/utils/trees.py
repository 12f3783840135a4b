"""Flat, slash-joined names for nested dicts of arrays.

The port's copy of the naming in `big_vision_tpu/utils/trees.py`: a leaf of
``{"a": {"b": x}}`` is called ``"a/b"``, keys are visited in sorted order.
These are the names the published ``.npz`` checkpoints use, and the names
`utils/convert.py` keys on.
"""

from __future__ import annotations

from typing import Any, Mapping


def flatten(tree) -> dict[str, Any]:
  """{"a": {"b": x}} -> {"a/b": x}, in sorted-key order."""
  out = {}

  def walk(node, prefix):
    if isinstance(node, Mapping):
      for k in sorted(node):
        walk(node[k], f"{prefix}{k}/")
    elif isinstance(node, (list, tuple)):
      for i, item in enumerate(node):
        walk(item, f"{prefix}{i}/")
    else:
      out[prefix.rstrip("/")] = node

  walk(tree, "")
  return out


def unflatten(flat: Mapping[str, Any]) -> dict[str, Any]:
  """Inverse of `flatten` (lists come back as dicts keyed "0", "1", ...)."""
  out: dict[str, Any] = {}
  for name, value in flat.items():
    node = out
    *parents, leaf = name.split("/")
    for p in parents:
      node = node.setdefault(p, {})
    node[leaf] = value
  return out

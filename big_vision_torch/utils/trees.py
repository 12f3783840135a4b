"""Flat, slash-joined names for nested dicts of arrays.

The port's copy of the naming in `big_vision_tpu/utils/trees.py`: a leaf of
``{"a": {"b": x}}`` is called ``"a/b"``, keys are visited in sorted order.
These are the names the published ``.npz`` checkpoints use, the names
`utils/convert.py` keys on, and the names the configs' regex rules (the
optimizer's masks, schedules and multipliers) are written against.
"""

from __future__ import annotations

import re
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


def tree_map_with_regex(fn, named: Mapping[str, Any], regex_rules,
                        not_f=lambda x: x) -> dict[str, Any]:
  """Applies `fn(leaf, arg)` to leaves whose name fullmatches a rule.

  `named` maps flat names to leaves; `regex_rules` is [(pattern, arg), ...];
  the first matching rule wins and unmatched leaves go through `not_f`.
  """
  compiled = [(re.compile(p), arg) for p, arg in regex_rules]

  def apply(name, leaf):
    for pat, arg in compiled:
      if pat.fullmatch(name):
        return fn(leaf, arg)
    return not_f(leaf)

  return {name: apply(name, leaf) for name, leaf in named.items()}


def make_mask_trees(named: Mapping[str, Any], patterns) -> list[dict]:
  """One {name: bool} mask per pattern; a leaf is True in at most one mask,
  the first whose pattern fullmatches its name. Names never start with /."""
  compiled = compile_patterns(patterns)
  first = {name: next((i for i, pat in enumerate(compiled)
                       if pat.fullmatch(name)), None) for name in named}
  return [{name: hit == i for name, hit in first.items()}
          for i in range(len(compiled))]


def compile_patterns(patterns) -> list[re.Pattern]:
  """Compiles a pattern or list of patterns; names never start with /."""
  if isinstance(patterns, str):
    patterns = [patterns]
  if not isinstance(patterns, (list, tuple)):
    raise ValueError(f"want a pattern or a list of them, got {patterns!r}")
  for p in patterns:
    if p.startswith("/"):
      raise ValueError(f"Param names never start with '/': {p!r}")
  return [re.compile(p) for p in patterns]


def get(tree, name: str):
  """The node (a leaf or an inner dict) of `tree` at the flat `name`."""
  node = tree
  for key in name.split("/"):
    if not isinstance(node, Mapping) or key not in node:
      raise KeyError(f"{name!r} not in tree. Available: "
                     f"{sorted(flatten(tree))[:50]}")
    node = node[key]
  return node

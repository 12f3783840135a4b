"""String registry: ``"name"`` or ``"name(arg, kw=value)"`` -> factory.

The port's own copy of `big_vision_tpu/registry.py` (same mini-language,
same names), so that both packages can be imported in one process without
their registrations colliding.
"""

from __future__ import annotations

import ast
import functools
from typing import Any, Callable


def parse_name(spec: str) -> tuple[str, tuple, dict]:
  """Splits ``"a.b(1, k=2)"`` into ``("a.b", (1,), {"k": 2})``.

  Arguments must be Python literals.
  """
  try:
    node = ast.parse(spec.strip(), mode="eval").body
  except SyntaxError as e:
    raise ValueError(f"Cannot parse registry spec {spec!r}") from e

  def dotted(expr) -> str:
    if isinstance(expr, ast.Name):
      return expr.id
    if isinstance(expr, ast.Attribute):
      return f"{dotted(expr.value)}.{expr.attr}"
    raise ValueError(f"Bad name component in registry spec {spec!r}")

  if isinstance(node, (ast.Name, ast.Attribute)):
    return dotted(node), (), {}
  if isinstance(node, ast.Call):
    args = tuple(ast.literal_eval(a) for a in node.args)
    kwargs = {kw.arg: ast.literal_eval(kw.value) for kw in node.keywords}
    return dotted(node.func), args, kwargs
  raise ValueError(f"Registry spec must be a name or call, got {spec!r}")


class Registry:
  """A process-global name -> factory mapping."""

  _items: dict[str, Any] = {}

  @classmethod
  def register(cls, name: str, replace: bool = False) -> Callable:
    def deco(item):
      if name in cls._items and not replace:
        raise KeyError(f"Registry name {name!r} already taken.")
      cls._items[name] = item
      return item
    return deco

  @classmethod
  def knows(cls, spec: str) -> bool:
    """Whether the name of `spec` (without its arguments) is registered."""
    return parse_name(spec)[0] in cls._items

  @classmethod
  def lookup(cls, spec: str, kwargs_extra: dict | None = None) -> Callable:
    """Returns the registered factory partially applied with spec's args."""
    name, args, kwargs = parse_name(spec)
    if kwargs_extra:
      kwargs = {**kwargs, **kwargs_extra}
    if name not in cls._items:
      known = ", ".join(sorted(
          k for k in cls._items if k.split(".")[0] == name.split(".")[0]))
      raise KeyError(f"Unknown registry name {name!r}. Similar: [{known}]")
    return functools.partial(cls._items[name], *args, **kwargs)

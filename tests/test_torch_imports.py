"""The port imports nothing of the JAX package, JAX or its libraries.

Every module of `big_vision_torch` is imported in a fresh interpreter in
which `jax`, `flax`, `optax`, `ml_collections` and `big_vision_tpu` are
blocked (set to None in `sys.modules`, so importing them raises).
"""

import os
import subprocess
import sys

_SCRIPT = """
import importlib, pkgutil, sys
for name in ("jax", "flax", "optax", "ml_collections", "big_vision_tpu"):
  sys.modules[name] = None
import big_vision_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    big_vision_torch.__path__, "big_vision_torch."))
for name in names:
  importlib.import_module(name)
print(" ".join(names))
"""


def test_port_imports_without_jax():
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  env["PYTHONPATH"] = root
  out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 0, out.stderr[-3000:]
  names = out.stdout.strip().splitlines()[-1].split()
  assert len(names) >= 30
  for name in ("utils.checkpoints", "evaluators.proj.distill.distance",
               "trainers.proj.flexi.distill",
               "configs.proj.flexivit.i21k_distill"):
    assert f"big_vision_torch.{name}" in names, name

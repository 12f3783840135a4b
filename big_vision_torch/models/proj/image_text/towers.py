"""Shared machinery of the contrastive tower models: port of
big_vision_tpu/models/proj/image_text/towers.py.

Towers are built by module path (`big_vision_torch.models.<name>`), run and
L2-normalized (`z / (||z|| + 1e-8)`) with their outputs under
"{prefix}/..."; `load_tower` and `load_scalar` read the per-tower
checkpoints of `model_init` through each tower module's `load`, on nested
dicts of numpy arrays in the JAX layout.
"""

from __future__ import annotations

import importlib

import torch

from big_vision_torch.utils import checkpoints


def module(model_name):
  return importlib.import_module(f"big_vision_torch.models.{model_name}")


def build(model_name, cfg, out_dim, **kw):
  """`big_vision_torch.models.{model_name}.Model` as a tower with `out_dim`
  outputs (0: its pre-logits); `kw` gives the port's shape and device
  arguments."""
  return module(model_name).Model(**{"num_classes": out_dim, **(cfg or {})},
                                  **kw)


def embed(tower, x, prefix, **kw):
  """Runs a tower and L2-normalizes; its outputs land under `{prefix}/...`."""
  z, aux = tower(x, **kw)
  out = {f"{prefix}/{k}": v for k, v in aux.items()}
  out[f"{prefix}/norm"] = norm = torch.linalg.vector_norm(z, dim=1,
                                                          keepdim=True)
  out[f"{prefix}/normalized"] = z = z / (norm + 1e-8)
  return z, out


def pop_any(d, *names):
  """Pops the first present key among `names` (aliases)."""
  for n in names:
    if (v := d.pop(n, None)) is not None:
      return v
  return None


def load_tower(restored, init_files, init_params, model_cfg, *, key, aliases,
               model_field, default_model, cfg_field, load_kw=None):
  """Restores one tower's checkpoint into `restored[key]` in place."""
  if init := pop_any(init_files, *aliases):
    cfg = dict(model_cfg)
    mod = module(cfg.get(model_field, default_model))
    restored[key] = mod.load(init_params[key], init, cfg.get(cfg_field, {}),
                             **(load_kw or {}))


def load_scalar(restored, init_files, *, key, aliases):
  """Restores a scalar param (temperature or bias) into `restored[key]`."""
  if init := pop_any(init_files, *aliases):
    restored[key] = checkpoints.load_params(init)

"""CLIPPO, one tower for images and for text rendered as images
(arXiv:2212.08045): port of big_vision_tpu/models/proj/clippo/one_tower.py.

The tower (`image_model`, "vit" by default, built for `image_size` and
`channels`) embeds both inputs, each L2-normalized under its own prefix
("img/...", "txt/..."); `text` is a rendered-text image, not token ids. A
learned log-temperature `t` (out["t"] = exp(t)). `load` reads `img` and
`t` (one file with those subtrees, or {"img"/"image": file, "t":
file}), the tower through its module's `load` with `img_load_kw`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from big_vision_torch.models.proj.image_text import towers


class Model(nn.Module):
  """`forward(image, text=None)` -> (zimg, ztxt, out); either input may be
  None."""

  def __init__(self, image=None, image_model="vit", out_dim=768,
               temperature_init=10.0, *, image_size=224, channels=3,
               device="cuda"):
    super().__init__()
    self.img = towers.build(image_model, image, out_dim, device=device,
                            image_size=image_size, channels=channels)
    self.temperature_init = temperature_init
    self.t = nn.Parameter(torch.empty(1, device=device))

  @torch.no_grad()
  def initialize(self, generator, head_bias=None):
    """Draws the tower's params; `t` = log(temperature_init)."""
    del head_bias
    self.img.initialize(generator)
    self.t.fill_(math.log(self.temperature_init))
    return self

  def forward(self, image, text=None, *, train=False, rng=None):
    zimg = ztxt = None
    out = {}
    if image is not None:
      zimg, aux = towers.embed(self.img, image, "img", train=train, rng=rng)
      out.update(aux)
    if text is not None:
      ztxt, aux = towers.embed(self.img, text, "txt", train=train, rng=rng)
      out.update(aux)
    out["t"] = torch.exp(self.t)
    out["t/parameter"] = self.t
    return zimg, ztxt, out


def load(init_params, init_files, model_cfg, img_load_kw=None):
  """Loads the tower and `t`; `init_files` is one path (its `:img` and
  `:t` subtrees) or {"img"/"image", "t"/"temperature": path}."""
  if isinstance(init_files, str):
    init_files = {k: f"{init_files}:{k}" for k in ("img", "t")}
  else:
    init_files = {**init_files}
  restored = {**init_params}
  towers.load_tower(restored, init_files, init_params, model_cfg,
                    key="img", aliases=("image", "img"),
                    model_field="image_model", default_model="vit",
                    cfg_field="image", load_kw=img_load_kw)
  towers.load_scalar(restored, init_files, key="t",
                     aliases=("temperature", "t"))
  assert not init_files, f"Unused model_init entries: {init_files}"
  return restored

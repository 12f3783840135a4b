"""Two-tower (LiT / CLIP / SigLIP) contrastive model: port of
big_vision_tpu/models/proj/image_text/two_towers.py.

An image tower (`image_model`, "vit" by default) and a text tower
(`text_model`, the text transformer by default, or
"proj.flaxformer.bert"), each L2-normalized; a learned log-temperature `t`
(out["t"] = exp(t)) and an optional bias `b`. `out_dim` is one width or an
(image, text) pair, where 0 means the tower's pre-logits. The port builds
the towers for their input shapes: `image_size` (and `channels`) for the
image tower's posemb, `text_len` for the text tower's.

`load` reads per-tower checkpoints (`{"img": ..., "txt": ...}`, or one file
whose `:img`, `:txt`, `:t` and `:b` subtrees are read) through each tower
module's `load`, with `img_load_kw` and `txt_load_kw`; on nested dicts of
numpy arrays in the JAX layout (`utils/convert.two_towers_params`).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from big_vision_torch.models.proj.image_text import towers

# The port's shape arguments of each tower model.
_IMAGE_KW = ("image_size", "channels")
_TEXT_KW = {"proj.image_text.text_transformer": ("text_len",),
            "proj.flaxformer.bert": ()}


class Model(nn.Module):
  """`forward(image, text=None)` -> (zimg [B, C], ztxt [B, C], out); either
  input may be None."""

  def __init__(self, image=None, text=None,
               text_model="proj.image_text.text_transformer",
               image_model="vit", out_dim=128, temperature_init=1.0,
               bias_init=None, *, image_size=224, channels=3, text_len=16,
               device="cuda"):
    super().__init__()
    dims = (out_dim, out_dim) if isinstance(out_dim, int) else tuple(out_dim)
    shapes = dict(image_size=image_size, channels=channels,
                  text_len=text_len)
    self.img = towers.build(image_model, image, dims[0], device=device,
                            **{k: shapes[k] for k in _IMAGE_KW})
    self.txt = towers.build(text_model, text, dims[1], device=device,
                            **{k: shapes[k] for k in _TEXT_KW[text_model]})
    self.temperature_init = temperature_init
    self.bias_init = bias_init
    self.t = nn.Parameter(torch.empty(1, device=device))
    self.b = (nn.Parameter(torch.empty(1, device=device))
              if bias_init is not None else None)

  @torch.no_grad()
  def initialize(self, generator, head_bias=None):
    """Draws both towers' params; `t` = log(temperature_init), `b` =
    bias_init. Returns the module."""
    del head_bias
    self.img.initialize(generator)
    self.txt.initialize(generator)
    self.t.fill_(math.log(self.temperature_init))
    if self.b is not None:
      self.b.fill_(self.bias_init)
    return self

  def forward(self, image, text=None, *, train=False, rng=None):
    zimg = ztxt = None
    out = {}
    if text is not None:
      ztxt, aux = towers.embed(self.txt, text, "txt", train=train, rng=rng)
      out.update(aux)
    if image is not None:
      zimg, aux = towers.embed(self.img, image, "img", train=train, rng=rng)
      out.update(aux)
    out["t"] = torch.exp(self.t)
    out["t/parameter"] = self.t
    if self.b is not None:
      out["b"] = self.b
    return zimg, ztxt, out


def load(init_params, init_files, model_cfg, img_load_kw=None,
         txt_load_kw=None):
  """Loads the towers (and `t`, `b`); `init_files` is {"img"/"image",
  "txt"/"text", "t"/"temperature", "b"/"bias": path} or one path."""
  if isinstance(init_files, str):
    keys = ("img", "txt", "t") + (
        ("b",) if "bias_init" in dict(model_cfg) else ())
    init_files = {k: f"{init_files}:{k}" for k in keys}
  else:
    init_files = {**init_files}

  restored = {**(init_params or {"img": None, "txt": None})}
  towers.load_tower(restored, init_files, init_params, model_cfg,
                    key="img", aliases=("image", "img"),
                    model_field="image_model", default_model="vit",
                    cfg_field="image", load_kw=img_load_kw)
  towers.load_tower(restored, init_files, init_params, model_cfg,
                    key="txt", aliases=("text", "txt"),
                    model_field="text_model",
                    default_model="proj.image_text.text_transformer",
                    cfg_field="text", load_kw=txt_load_kw)
  towers.load_scalar(restored, init_files, key="t",
                     aliases=("temperature", "t"))
  towers.load_scalar(restored, init_files, key="b", aliases=("bias", "b"))
  assert not init_files, f"Unused model_init entries (typo?): {init_files}"
  return restored

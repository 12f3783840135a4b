"""Text transformer tower: port of
big_vision_tpu/models/proj/image_text/text_transformer.py.

Token embedding plus a learned posemb, the ViT encoder (`models/vit.Encoder`,
whose "auto" attention takes the kernels K1/K2 where the JAX gate
`_kernel_ok` holds), tied vocab logits (`encoded @ embedding.T`), a readout
("last", "first", "gap"/"mean", "gmp"/"max" or the MAP head "map") and an
optional head. The posemb's length is the text length, which the port
needs when the module is built (`text_len`).
"""

from __future__ import annotations

import torch
from torch import nn

from big_vision_torch.models import common
from big_vision_torch.models import vit
from big_vision_torch.utils import checkpoints

_READOUTS = {
    "last": lambda t: t[:, -1, :],
    "first": lambda t: t[:, 0, :],
    "gap": lambda t: t.mean(dim=1),
    "mean": lambda t: t.mean(dim=1),
    "gmp": lambda t: t.max(dim=1).values,
    "max": lambda t: t.max(dim=1).values,
}


class _Model(nn.Module):
  """`forward(text [B, T] int)` -> (rep, {name: tensor})."""

  def __init__(self, num_classes, *, width=512, depth=12, num_heads=8,
               mlp_dim=2048, vocab_size=32_000, pool_type="last",
               dropout=0.0, dtype_mm="float32", attn_impl="auto",
               text_len=16, device="cuda"):
    super().__init__()
    if pool_type != "map" and pool_type not in _READOUTS:
      raise NotImplementedError(f"Unknown pool_type {pool_type!r}")
    kw = dict(device=device)
    self.pool_type = pool_type
    self.dropout = dropout
    self.embedding = nn.Parameter(torch.empty(vocab_size, width, **kw))
    self.pos_embedding = nn.Parameter(torch.empty(1, text_len, width, **kw))
    self.encoder = vit.Encoder(width, depth, num_heads, mlp_dim,
                               dtype_mm=dtype_mm, attn_impl=attn_impl,
                               dropout=dropout, **kw)
    self.map_head = (vit.MAPHead(width, num_heads, mlp_dim,
                                 dtype_mm=dtype_mm, **kw)
                     if pool_type == "map" else None)
    self.head = common.Dense(width, num_classes, **kw) if num_classes else None

  @torch.no_grad()
  def initialize(self, generator, head_bias=None):
    """Draws every parameter as the JAX model's init does: flax's `Embed`
    default (a truncated normal of variance 1 / vocab_size, as
    lecun_normal with the vocabulary as fan-in), the posemb N(0, 1/width),
    the encoder's and heads' own initializers. Returns the module."""
    del head_bias
    for module in self.modules():
      if module is not self and hasattr(module, "reset_parameters"):
        module.reset_parameters(generator)
    width = self.embedding.shape[1]
    common.init(self.embedding, "lecun_normal", generator,
                fan_in=self.embedding.shape[0])
    common.init(self.pos_embedding, ("normal", width ** -0.5), generator)
    if self.map_head is not None:
      common.init(self.map_head.probe, "xavier_uniform", generator,
                  fan_in=1, fan_out=width)
    return self

  def forward(self, text, *, train=False, rng=None):
    if train and self.dropout and rng is None:
      raise ValueError("dropout needs a generator: pass rng=")
    rng = rng if train else None
    out = {}
    tokens = out["embedded"] = self.embedding[text]
    encoded = out["transformed"] = self.encoder(
        tokens + self.pos_embedding.to(tokens.dtype), rng=rng)
    out["vocab_logits"] = encoded @ self.embedding.to(encoded.dtype).T
    if self.pool_type == "map":
      rep = self.map_head(encoded)
    else:
      rep = _READOUTS[self.pool_type](encoded)
    out["pre_logits"] = rep
    if self.head is not None:
      rep = out["logits"] = self.head(rep)
    return rep, out


def Model(num_classes, *, variant=None, scan=None, remat_policy=None, **kw):  # pylint: disable=invalid-name
  """Factory taking the JAX model's keys (`variant` "B" etc.); `scan` and
  `remat_policy` only shape the JAX compile and have no effect here."""
  del scan, remat_policy
  kw = {**vit.decode_variant(variant), **kw}
  return _Model(num_classes, **kw)


def load(init_params, init_file, model_cfg, dont_load=()):
  """Merges a checkpoint (pre-Linen names converted; a posemb stored both at
  the top and in the encoder is summed) into `init_params`."""
  del model_cfg
  params = vit.convert_pre_linen(checkpoints.load_params(init_file))
  stray = params.get("Encoder_0", {}).pop("pos_embedding", None)
  if stray is not None:
    params["pos_embedding"] = params["pos_embedding"] + stray
  return common.merge_params(params, init_params, dont_load)

"""BERT encoder with a linear head on [CLS]: port of
big_vision_tpu/models/proj/flaxformer/bert.py.

Post-LN layers (attention, residual, LayerNorm; MLP with exact GELU,
residual, LayerNorm), LayerNorm eps 1e-12, learned word, position and
segment embeddings (all segments 0), dropout 0.1 after the embeddings and
on each residual branch in training. The attention is flax's
`MultiHeadDotProductAttention` written out: q scaled by 1/sqrt(head dim),
the logits of padding keys (token id 0) set to `finfo(f32).min`, softmax
in f32. It reaches no kernel in the JAX package, and none here. The
output is the [CLS] row (`pre_logits`), then the head if `num_classes`.

`load` reads a big_vision-style `.npz` (merged with the model's own params
through `common.merge_params`). The JAX package's reader of the TF BERT
release checkpoints needs TensorFlow: the port refuses a TF checkpoint by
name.
"""

from __future__ import annotations

import math
import os

import torch
from torch import nn
import torch.nn.functional as F

from big_vision_torch.models import common
from big_vision_torch.utils import checkpoints

CONFIGS = {
    # (width, depth, mlp_dim, num_heads); vocab and type sizes are BERT's.
    "base": dict(width=768, depth=12, mlp_dim=3072, num_heads=12),
    "large": dict(width=1024, depth=24, mlp_dim=4096, num_heads=16),
    "test": dict(width=32, depth=2, mlp_dim=64, num_heads=2),
}
VOCAB_SIZE = 30_522
TYPE_VOCAB_SIZE = 2
MAX_POSITIONS = 512
LN_EPS = 1e-12


class Attention(nn.Module):
  """flax `MultiHeadDotProductAttention` (lecun_normal kernels) with a key
  padding mask."""

  def __init__(self, width, num_heads, *, device="cuda"):
    super().__init__()
    self.num_heads = num_heads
    kw = dict(device=device)
    self.query = common.Dense(width, width, **kw)
    self.key = common.Dense(width, width, **kw)
    self.value = common.Dense(width, width, **kw)
    self.out = common.Dense(width, width, **kw)

  def forward(self, x, valid):
    """x [B, T, W]; valid [B, T] bool: the keys attended to."""
    heads = lambda y: y.reshape(*y.shape[:2], self.num_heads, -1)
    q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
    q = q / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.finfo(logits.dtype).min)
    weights = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
    return self.out(out.reshape(*out.shape[:2], -1))


class Layer(nn.Module):
  """Post-LN transformer block: attention -> LN -> MLP -> LN."""

  def __init__(self, width, mlp_dim, num_heads, dropout=0.1, *,
               device="cuda"):
    super().__init__()
    kw = dict(device=device)
    self.attention = Attention(width, num_heads, **kw)
    self.attention_norm = common.LayerNorm(width, eps=LN_EPS, **kw)
    self.mlp_in = common.Dense(width, mlp_dim, **kw)
    self.mlp_out = common.Dense(mlp_dim, width, **kw)
    self.mlp_norm = common.LayerNorm(width, eps=LN_EPS, **kw)
    self.dropout = dropout

  def forward(self, x, valid, rng=None):
    y = common.dropout(self.attention(x, valid), self.dropout, rng)
    x = self.attention_norm(x + y)
    y = self.mlp_out(F.gelu(self.mlp_in(x), approximate="none"))
    y = common.dropout(y, self.dropout, rng)
    return self.mlp_norm(x + y)


class _Model(nn.Module):
  """`forward(text [B, T] int)` -> (logits or [CLS] rep, {name: tensor})."""

  def __init__(self, config="base", num_classes=None, head_zeroinit=True,
               vocab_size=VOCAB_SIZE, type_vocab_size=TYPE_VOCAB_SIZE,
               max_positions=MAX_POSITIONS, dropout=0.1, *, device="cuda"):
    super().__init__()
    cfg = CONFIGS[config]
    width = cfg["width"]
    kw = dict(device=device)
    self.word_embeddings = nn.Parameter(torch.empty(vocab_size, width, **kw))
    self.position_embeddings = nn.Parameter(
        torch.empty(max_positions, width, **kw))
    self.type_embeddings = nn.Parameter(
        torch.empty(type_vocab_size, width, **kw))
    self.embeddings_norm = common.LayerNorm(width, eps=LN_EPS, **kw)
    self.layers = nn.ModuleList([
        Layer(width, cfg["mlp_dim"], cfg["num_heads"], dropout, **kw)
        for _ in range(cfg["depth"])])
    self.dropout = dropout
    self.head = (common.Dense(
        width, num_classes,
        kernel_init="zeros" if head_zeroinit else "lecun_normal", **kw)
                 if num_classes else None)

  @torch.no_grad()
  def initialize(self, generator, head_bias=None):
    """Draws every parameter as the JAX model's init does: the embeddings
    N(0, 0.02^2), Dense kernels lecun_normal, biases 0, LayerNorms 1 and 0.
    Returns the module."""
    del head_bias
    for module in self.modules():
      if module is not self and hasattr(module, "reset_parameters"):
        module.reset_parameters(generator)
    for p in (self.word_embeddings, self.position_embeddings,
              self.type_embeddings):
      common.init(p, ("normal", 0.02), generator)
    return self

  def forward(self, text, *, train=False, rng=None):
    if train and self.dropout and rng is None:
      raise ValueError("dropout needs a generator: pass rng=")
    rng = rng if train else None
    out = {}
    seqlen = text.shape[1]
    x = (self.word_embeddings[text]
         + self.position_embeddings[:seqlen][None]
         + self.type_embeddings[0][None, None])
    x = common.dropout(self.embeddings_norm(x), self.dropout, rng)
    valid = text != 0
    for layer in self.layers:
      x = layer(x, valid, rng)
    out["transformed"] = x
    x = out["pre_logits"] = x[:, 0]
    if self.head is not None:
      x = out["logits"] = self.head(x)
    return x, out


def Model(num_classes=None, *, config="base", **kw):  # pylint: disable=invalid-name
  """Factory taking the JAX model's keys (`config`, `num_classes`,
  `head_zeroinit`, the vocab sizes)."""
  return _Model(config, num_classes, **kw)


def load(init_params, init_file, model_cfg=None, dont_load=()):
  """Merges a big_vision-style checkpoint into `init_params` (the model's
  own tree, numpy, JAX layout)."""
  del model_cfg
  ckpt = init_file if init_file.endswith(".ckpt") else os.path.join(
      init_file, "bert_model.ckpt")
  if os.path.exists(f"{ckpt}.index"):
    raise NotImplementedError(
        "reading a TF BERT release checkpoint needs TensorFlow's checkpoint "
        "reader, which the port does not use; convert it to .npz first")
  return common.merge_params(checkpoints.load_params(init_file),
                             init_params, dont_load)

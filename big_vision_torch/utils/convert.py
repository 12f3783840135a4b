"""Carries JAX param trees (numpy arrays) across to the port's modules.

The JAX models name their leaves as `utils/trees.py` flattens them
("Transformer/encoderblock_0/MlpBlock_0/Dense_0/kernel"), which are also
the names of the published `.npz` checkpoints. These functions map each
such leaf to a state-dict entry of the port's module, reshaping flax's
kernels ([in, out], DenseGeneral [D, H, hd] / [H, hd, D], einsum weights)
into the port's [out, in] matrices. Both layer layouts are read: scan
(a stacked leading depth axis under `Transformer/encoderblock` or
`layers`) and pyloop (`encoderblock_{i}`, `layers/{i}`).

Every leaf must be consumed exactly once: a leaf no rule maps raises, and
`load` raises when the module expects an entry the tree lacks.

`gemma` and its inverse `gemma_params` also carry the int8 weights of
`quant=True` and their scales, and take numpy arrays or tensors alike
(tensors stay on their device), so that a model on the card can be
quantized there.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from big_vision_torch.models import convnets
from big_vision_torch.utils import trees


class _Leaves:
  """Flat name -> array, each to be taken exactly once."""

  def __init__(self, flat):
    self._flat = dict(flat)

  def names(self):
    return sorted(self._flat)

  def take(self, name):
    if name not in self._flat:
      raise KeyError(f"param {name!r} missing from the tree")
    x = self._flat.pop(name)
    return x if isinstance(x, torch.Tensor) else np.asarray(x)

  def done(self):
    if self._flat:
      raise ValueError(f"unused params: {sorted(self._flat)}")


def _flat(params):
  flat = params if all(isinstance(v, np.ndarray) or hasattr(v, "shape")
                       for v in params.values()) else trees.flatten(params)
  return {k: v if isinstance(v, torch.Tensor) else np.asarray(v)
          for k, v in flat.items()}


def _unstack(flat, stacked, per_layer, axis=0):
  """Splits leaves under `stacked/` along `axis` into
  `per_layer.format(i)/`."""
  out = {}
  for name, x in flat.items():
    if name.startswith(stacked + "/"):
      rest = name[len(stacked) + 1:]
      for i in range(x.shape[axis]):
        out[f"{per_layer.format(i)}/{rest}"] = x[(slice(None),) * axis + (i,)]
    else:
      out[name] = x
  return out


def _dense(leaves, src, dst, out):
  """flax Dense {kernel [in, ...out], bias} -> port {weight [out, in], bias}."""
  k = leaves.take(f"{src}/kernel")
  out[f"{dst}.weight"] = k.reshape(k.shape[0], -1).T
  if f"{src}/bias" in leaves.names():
    out[f"{dst}.bias"] = leaves.take(f"{src}/bias").reshape(-1)


def _layernorm(leaves, src, dst, out):
  out[f"{dst}.weight"] = leaves.take(f"{src}/scale")
  out[f"{dst}.bias"] = leaves.take(f"{src}/bias")


def _mha(leaves, src, dst, out):
  for name in ("query", "key", "value"):  # kernel [D, H, hd]
    _dense(leaves, f"{src}/{name}", f"{dst}.{name}", out)
  k = leaves.take(f"{src}/out/kernel")  # [H, hd, D]
  out[f"{dst}.out.weight"] = k.reshape(-1, k.shape[-1]).T
  out[f"{dst}.out.bias"] = leaves.take(f"{src}/out/bias")


def _mlp(leaves, src, dst, out):
  _dense(leaves, f"{src}/Dense_0", f"{dst}.fc1", out)
  _dense(leaves, f"{src}/Dense_1", f"{dst}.fc2", out)


def vit(params) -> dict[str, np.ndarray]:
  """ViT or FlexiViT param tree -> the port's `models.vit` or
  `models.proj.flexi.vit` state dict (numpy)."""
  flat = _unstack(_flat(params), "Transformer/encoderblock",
                  "Transformer/encoderblock_{}")
  leaves, out = _Leaves(flat), {}
  k = leaves.take("embedding/kernel")  # [p, p, c, width]
  out["embedding.weight"] = k.reshape(-1, k.shape[-1]).T
  out["embedding.bias"] = leaves.take("embedding/bias")
  for name in ("pos_embedding", "cls"):
    if name in leaves.names():
      out[name] = leaves.take(name)
  blocks = sorted({int(m.group(1)) for n in leaves.names()
                   if (m := re.match(r"Transformer/encoderblock_(\d+)/", n))})
  for i in blocks:
    src, dst = f"Transformer/encoderblock_{i}", f"encoder.blocks.{i}"
    _layernorm(leaves, f"{src}/LayerNorm_0", f"{dst}.ln1", out)
    _layernorm(leaves, f"{src}/LayerNorm_1", f"{dst}.ln2", out)
    _mha(leaves, f"{src}/MultiHeadDotProductAttention_0", f"{dst}.attn", out)
    _mlp(leaves, f"{src}/MlpBlock_0", f"{dst}.mlp", out)
  _layernorm(leaves, "Transformer/encoder_norm", "encoder.encoder_norm", out)
  if "MAPHead_0/probe" in leaves.names():
    out["map_head.probe"] = leaves.take("MAPHead_0/probe")
    _mha(leaves, "MAPHead_0/MultiHeadDotProductAttention_0", "map_head.attn",
         out)
    _layernorm(leaves, "MAPHead_0/LayerNorm_0", "map_head.ln", out)
    _mlp(leaves, "MAPHead_0/MlpBlock_0", "map_head.mlp", out)
  for name in ("pre_logits", "head"):
    if f"{name}/kernel" in leaves.names():
      _dense(leaves, name, name, out)
  leaves.done()
  return out


# The port's layer names -> the JAX model's module names.
_VIT_LAYERS = {
    "embedding": "embedding", "pre_logits": "pre_logits", "head": "head",
    "patchln_pre": "patchln_pre", "patchln_post": "patchln_post",
    "encoder_norm": "encoder_norm", "ln1": "LayerNorm_0",
    "ln2": "LayerNorm_1", "ln": "LayerNorm_0",
    "mlp.fc1": "MlpBlock_0/Dense_0", "mlp.fc2": "MlpBlock_0/Dense_1",
    **{f"attn.{n}": f"MultiHeadDotProductAttention_0/{n}"
       for n in ("query", "key", "value", "out")},
}


def vit_names(module: torch.nn.Module) -> dict[str, str]:
  """{port parameter name: JAX param name} for a `models.vit` module, or a
  `models.proj.flexi.vit` one (whose parameters carry the same names:
  "embedding/kernel", "pos_embedding", "cls", "Transformer/...", "head/...").

  The JAX names (pyloop layout, e.g.
  "Transformer/encoderblock_0/MlpBlock_0/Dense_0/kernel") are what config
  regexes are written against, such as the weight-decay mask ".*/kernel$";
  `vit` converts each such leaf to the port name.
  """
  out = {}
  for name, _ in module.named_parameters():
    if name in ("pos_embedding", "cls"):
      out[name] = name
      continue
    if name == "embedding":  # the text transformer's token table
      out[name] = "Embed_0/embedding"
      continue
    if name == "map_head.probe":
      out[name] = "MAPHead_0/probe"
      continue
    layer, leaf = name.rsplit(".", 1)
    prefix = ""
    if m := re.fullmatch(r"encoder\.blocks\.(\d+)\.(.*)", layer):
      prefix, layer = f"Transformer/encoderblock_{m[1]}/", m[2]
    elif layer == "encoder.encoder_norm":
      prefix, layer = "Transformer/", "encoder_norm"
    elif layer.startswith("map_head."):
      prefix, layer = "MAPHead_0/", layer[len("map_head."):]
    jax_layer = _VIT_LAYERS[layer]
    norm = ("LayerNorm" in jax_layer or jax_layer == "encoder_norm"
            or jax_layer.startswith("patchln"))
    kind = "bias" if leaf == "bias" else "scale" if norm else "kernel"
    out[name] = f"{prefix}{jax_layer}/{kind}"
  return out


def _vit_layout(module, name, jax_name, x):
  """Parameter `name` of a `models.vit` (or FlexiViT) module, or a tensor
  of its shape, in the JAX layout of `jax_name` (a view)."""
  layer = name.rsplit(".", 1)[0]
  if jax_name == "embedding/kernel":  # [width, ph*pw*c] -> [ph, pw, c, w]
    ph, pw = module.embedding.patch_size
    return x.T.reshape(ph, pw, -1, x.shape[0])
  if re.search(r"/(query|key|value|out)/(kernel|bias)$", jax_name):
    heads = module.get_submodule(layer.rsplit(".", 1)[0]).num_heads
    width = x.shape[0]
    if jax_name.endswith("out/kernel"):  # [D, H*hd] -> [H, hd, D]
      return x.T.reshape(heads, -1, width)
    if jax_name.endswith("kernel"):  # [H*hd, D] -> [D, H, hd]
      return x.T.reshape(x.shape[1], heads, -1)
    if not jax_name.endswith("out/bias"):  # [H*hd] -> [H, hd]
      return x.reshape(heads, -1)
    return x
  if jax_name.endswith("/kernel"):  # [out, in] -> [in, out]
    return x.T
  return x


def vit_params(module: torch.nn.Module) -> dict:
  """The inverse of `vit`: a `models.vit` or `models.proj.flexi.vit`
  module's parameters as the JAX model's param tree (nested dicts of f32
  numpy arrays, pyloop layout, flax's kernel shapes)."""
  return _params(module, vit_names(module), _vit_layout)


def _params(module, names_, layout):
  """{JAX name: f32 numpy array in the JAX layout}, as a nested tree."""
  out = {}
  for name, jax_name in names_.items():
    x = module.get_parameter(name).detach().float().cpu()
    out[jax_name] = np.ascontiguousarray(
        layout(module, name, jax_name, x).numpy())
  return trees.unflatten(out)


def mixer(params) -> dict[str, np.ndarray]:
  """MLP-Mixer param tree -> the port's `models.mlp_mixer` state dict
  (numpy)."""
  leaves, out = _Leaves(_flat(params)), {}
  k = leaves.take("stem/kernel")  # [p, p, c, width]
  out["stem.weight"] = k.reshape(-1, k.shape[-1]).T
  out["stem.bias"] = leaves.take("stem/bias")
  blocks = sorted({int(m.group(1)) for n in leaves.names()
                   if (m := re.match(r"MixerBlock_(\d+)/", n))})
  for i in blocks:
    src, dst = f"MixerBlock_{i}", f"blocks.{i}"
    _layernorm(leaves, f"{src}/LayerNorm_0", f"{dst}.ln0", out)
    _layernorm(leaves, f"{src}/LayerNorm_1", f"{dst}.ln1", out)
    for mix in ("token_mixing", "channel_mixing"):
      _mlp(leaves, f"{src}/{mix}", f"{dst}.{mix}", out)
  _layernorm(leaves, "pre_head_layer_norm", "pre_head_layer_norm", out)
  if "head/kernel" in leaves.names():
    _dense(leaves, "head", "head", out)
  leaves.done()
  return out


def mixer_names(module: torch.nn.Module) -> dict[str, str]:
  """{port parameter name: JAX param name} for a `models.mlp_mixer`
  module ("MixerBlock_0/token_mixing/Dense_0/kernel", "stem/kernel",
  "pre_head_layer_norm/scale", "head/bias", ...)."""
  out = {}
  for name, _ in module.named_parameters():
    layer, leaf = name.rsplit(".", 1)
    m = re.fullmatch(r"blocks\.(\d+)\.(ln0|ln1|token_mixing|channel_mixing)"
                     r"(?:\.(fc1|fc2))?", layer)
    if m:
      part = {"ln0": "LayerNorm_0", "ln1": "LayerNorm_1"}.get(m[2], m[2])
      if m[3]:
        part += "/Dense_0" if m[3] == "fc1" else "/Dense_1"
      layer = f"MixerBlock_{m[1]}/{part}"
    norm = "LayerNorm" in layer or layer == "pre_head_layer_norm"
    kind = "bias" if leaf == "bias" else "scale" if norm else "kernel"
    out[name] = f"{layer}/{kind}"
  return out


def _mixer_layout(module, name, jax_name, x):
  """Parameter `name` of a `models.mlp_mixer` module in its JAX layout."""
  del name
  if jax_name == "stem/kernel":  # [width, ph*pw*c] -> [ph, pw, c, w]
    ph, pw = module.stem.patch_size
    return x.T.reshape(ph, pw, -1, x.shape[0])
  return x.T if jax_name.endswith("/kernel") else x


def mixer_params(module: torch.nn.Module) -> dict:
  """The inverse of `mixer`: the module's parameters as the JAX model's
  param tree (nested dicts of f32 numpy arrays, flax's kernel shapes)."""
  return _params(module, mixer_names(module), _mixer_layout)


def text_transformer_names(module: torch.nn.Module) -> dict[str, str]:
  """{port parameter name: JAX param name} of a
  `models.proj.image_text.text_transformer` module: the ViT's names with
  the encoder under "Encoder_0/" ("Embed_0/embedding", "pos_embedding",
  "Encoder_0/encoderblock_0/...", "MAPHead_0/...", "head/...")."""
  return {k: v.replace("Transformer/", "Encoder_0/", 1)
          for k, v in vit_names(module).items()}


def bert_names(module: torch.nn.Module) -> dict[str, str]:
  """{port parameter name: JAX param name} of a `models.proj.flaxformer.bert`
  module ("BertEncoder_0/layer_0/attention/query/kernel",
  "BertEncoder_0/word_embeddings/embedding", "head/bias", ...)."""
  out = {}
  for name, _ in module.named_parameters():
    if name.endswith("_embeddings"):
      out[name] = f"BertEncoder_0/{name}/embedding"
      continue
    layer, leaf = name.rsplit(".", 1)
    kind = ("bias" if leaf == "bias" else
            "scale" if layer.endswith("norm") else "kernel")
    if layer != "head":
      layer = "BertEncoder_0/" + re.sub(r"^layers\.(\d+)", r"layer_\1",
                                        layer).replace(".", "/")
    out[name] = f"{layer}/{kind}"
  return out


def two_towers_names(module: torch.nn.Module) -> dict[str, str]:
  """{port parameter name: JAX param name} of a
  `models.proj.image_text.two_towers` module: each tower's names under
  "img/" and "txt/", and "t", "b"."""
  out = {}
  for tower in ("img", "txt"):
    sub = module.get_submodule(tower)
    out.update({f"{tower}.{k}": f"{tower}/{v}"
                for k, v in names(sub).items()})
  out.update({n: n for n in ("t", "b") if getattr(module, n) is not None})
  return out


def _two_towers_layout(module, name, jax_name, x):
  """Parameter `name` of a two-tower module in its JAX layout."""
  if "." not in name:  # t, b
    return x
  tower, rest = name.split(".", 1)
  sub = module.get_submodule(tower)
  return _LAYOUTS[_kind(sub)](sub, rest, jax_name.split("/", 1)[1], x)


def _from_jax(module, names_, layout, tree,
              permuted=lambda jax_name: jax_name.endswith("/kernel")):
  """A JAX param tree -> `module`'s state dict (numpy), inverting
  `layout`: each leaf that `permuted` names (by default the kernels) has
  its elements placed through the layout of an index tensor of the
  parameter's shape; other leaves are reshaped."""
  leaves, out = _Leaves(_flat(tree)), {}
  for name, jax_name in names_.items():
    x = np.asarray(leaves.take(jax_name))
    shape = tuple(module.get_parameter(name).shape)
    if permuted(jax_name):
      idx = torch.arange(int(np.prod(shape))).reshape(shape)
      pos = layout(module, name, jax_name, idx).reshape(-1).numpy()
      y = np.empty(x.size, x.dtype)
      y[pos] = x.reshape(-1)
      x = y
    out[name] = x.reshape(shape)
  leaves.done()
  return out


def two_towers(module: torch.nn.Module, tree) -> dict[str, np.ndarray]:
  """Two-tower param tree {"img", "txt", "t"[, "b"]} -> the port module's
  state dict (numpy); the image tower through `state`, so that a ViT of any
  historical layout is read."""
  out = {}
  for tower in ("img", "txt"):
    sub = module.get_submodule(tower)
    out.update({f"{tower}.{k}": v for k, v in state(sub, tree[tower]).items()})
  for n in ("t", "b"):
    if getattr(module, n) is not None:
      out[n] = np.asarray(tree[n]).reshape(1)
  unused = set(tree) - {"img", "txt", "t", "b"}
  if unused or ("b" in tree and module.b is None):
    raise ValueError(f"unused params: {sorted(unused | ({'b'} & set(tree)))}")
  return out


def one_tower_names(module: torch.nn.Module) -> dict[str, str]:
  """{port parameter name: JAX param name} of a
  `models.proj.clippo.one_tower` module: the shared tower's names under
  "img/", and "t"."""
  out = {f"img.{k}": f"img/{v}" for k, v in names(module.img).items()}
  out["t"] = "t"
  return out


def one_tower(module: torch.nn.Module, tree) -> dict[str, np.ndarray]:
  """One-tower param tree {"img", "t"} -> the port module's state dict
  (numpy)."""
  out = {f"img.{k}": v for k, v in state(module.img, tree["img"]).items()}
  out["t"] = np.asarray(tree["t"]).reshape(1)
  unused = set(tree) - {"img", "t"}
  if unused:
    raise ValueError(f"unused params: {sorted(unused)}")
  return out


_CAPPA_BLOCK = {"ln1": "LayerNorm1", "ln2": "LayerNorm2", "ln3": "LayerNorm3",
                "self_attn": "SelfAttn", "cross_attn": "CrossAttn",
                "mlp.fc1": "MLP/Dense_0", "mlp.fc2": "MLP/Dense_1"}


def cappa_names(module: torch.nn.Module) -> dict[str, str]:
  """{port parameter name: JAX param name} of a `models.proj.cappa.cappa`
  module: the encoder's ViT names under "encoder/", "pos_embedding_decoder",
  and the decoder's ("decoder/EmbedTargets/embedding",
  "decoder/EncDecBlock0/SelfAttn/query/kernel", ".../MLP/Dense_0/bias",
  "decoder/LayerNorm/scale", "decoder/LogitsDense/kernel"), per layer."""
  out = {f"encoder.{k}": f"encoder/{v}"
         for k, v in vit_names(module.encoder).items()}
  for name, _ in module.named_parameters():
    if name.startswith("encoder."):
      continue
    if name == "pos_embedding_decoder":
      out[name] = name
      continue
    if name == "decoder.embed":
      out[name] = "decoder/EmbedTargets/embedding"
      continue
    layer, leaf = name.rsplit(".", 1)
    if m := re.fullmatch(r"decoder\.blocks\.(\d+)\.(ln\d|self_attn|cross_attn"
                         r"|mlp\.fc\d)(?:\.(query|key|value|out))?", layer):
      jax_layer = f"decoder/EncDecBlock{m[1]}/{_CAPPA_BLOCK[m[2]]}"
      if m[3]:
        jax_layer += f"/{m[3]}"
      norm = m[2].startswith("ln")
    else:
      jax_layer = {"decoder.ln": "decoder/LayerNorm",
                   "decoder.logits": "decoder/LogitsDense"}[layer]
      norm = layer == "decoder.ln"
    kind = "bias" if leaf == "bias" else "scale" if norm else "kernel"
    out[name] = f"{jax_layer}/{kind}"
  return out


def _cappa_layout(module, name, jax_name, x):
  """Parameter `name` of a CapPa module in its JAX layout."""
  if name.startswith("encoder."):
    return _vit_layout(module.encoder, name[len("encoder."):],
                       jax_name[len("encoder/"):], x)
  return _vit_layout(module, name, jax_name, x)


def cappa_pyloop(tree):
  """A CapPa param tree in the per-layer layout: a scanned encoder's
  "Transformer/encoderblock" (layers on axis 0) and a scanned decoder's
  "EncDecBlock" (layers on axis 1, where flax's `nn.scan` puts them) are
  split into "encoderblock_{i}" and "EncDecBlock{i}". Nested dicts."""
  flat = _unstack(trees.flatten(tree), "encoder/Transformer/encoderblock",
                  "encoder/Transformer/encoderblock_{}")
  flat = _unstack(flat, "decoder/EncDecBlock", "decoder/EncDecBlock{}", axis=1)
  return trees.unflatten(flat)


def cappa(module: torch.nn.Module, tree) -> dict[str, np.ndarray]:
  """CapPa param tree, scanned or per layer -> the port module's state dict
  (numpy)."""
  return _from_jax(module, cappa_names(module), _cappa_layout,
                   trees.flatten(cappa_pyloop(tree)))


def _naflex_layout(module, name, jax_name, x):
  """Parameter `name` of a NaFlex ViT in its JAX layout: the stem is a
  Dense ([out, in] -> [in, out]); the rest as the ViT's."""
  if jax_name == "embedding/kernel":
    return x.T
  return _vit_layout(module, name, jax_name, x)


def naflex(module: torch.nn.Module, tree) -> dict[str, np.ndarray]:
  """NaFlex ViT param tree (encoder scanned or per layer) -> the port
  module's state dict (numpy)."""
  flat = _unstack(_flat(tree), "Transformer/encoderblock",
                  "Transformer/encoderblock_{}")
  return _from_jax(module, vit_names(module), _naflex_layout, flat)


_JET_MASKS = {"channel_masks": "channel_coupling_masks-FREEZE_ME",
              "spatial_masks": "spatial_coupling_masks-FREEZE_ME"}


def _block_name(name):
  """A `models.vit` Encoder block's parameter name relative to the
  Encoder ("blocks.0.attn.query.weight") -> its JAX name relative to the
  JAX Encoder ("encoderblock_0/MultiHeadDotProductAttention_0/query/
  kernel"); "encoder_norm.weight" -> "encoder_norm/scale"."""
  layer, leaf = name.rsplit(".", 1)
  if m := re.fullmatch(r"blocks\.(\d+)\.(.*)", layer):
    prefix, layer = f"encoderblock_{m[1]}/", m[2]
  else:
    prefix = ""
  jax_layer = _VIT_LAYERS[layer]
  norm = "LayerNorm" in jax_layer or jax_layer == "encoder_norm"
  kind = "bias" if leaf == "bias" else "scale" if norm else "kernel"
  return f"{prefix}{jax_layer}/{kind}"


def jet_names(module: torch.nn.Module) -> dict[str, str]:
  """{port parameter name: JAX param name} of a `models.proj.jet.jet`
  module: the masks ("channel_coupling_masks-FREEZE_ME", ...) and the
  scanned couplings' stacked leaves ("couplings/dnn/init_proj/kernel",
  "couplings/dnn/posemb", "couplings/dnn/vit/encoderblock_0/...",
  "couplings/dnn/MultiHeadDotProductAttention_0/...",
  "couplings/dnn/final_proj/...")."""
  out = {}
  for name, _ in module.named_parameters():
    if name in _JET_MASKS:
      out[name] = _JET_MASKS[name]
      continue
    rest = name.removeprefix("couplings.layer.dnn.")
    if rest == "posemb":
      jax_rest = rest
    elif rest.startswith("encoder."):
      jax_rest = "vit/" + _block_name(rest[len("encoder."):])
    else:
      layer, leaf = rest.rsplit(".", 1)
      layer = layer.replace("xattn.", "MultiHeadDotProductAttention_0/")
      jax_rest = f"{layer}/{'bias' if leaf == 'bias' else 'kernel'}"
    out[name] = f"couplings/dnn/{jax_rest}"
  return out


def _stacked_layout(x, jax_name, heads):
  """A stacked [depth, ...] parameter of a scanned stack (or a tensor of
  its shape) in the JAX layout of `jax_name`: the ViT's per-layer layouts
  with the depth axis first."""
  d = x.shape[0]
  if re.search(r"/(query|key|value|out)/(kernel|bias)$", jax_name):
    if jax_name.endswith("out/kernel"):  # [d, D, H*hd] -> [d, H, hd, D]
      return x.transpose(-1, -2).reshape(d, heads, -1, x.shape[1])
    if jax_name.endswith("kernel"):  # [d, H*hd, D] -> [d, D, H, hd]
      return x.transpose(-1, -2).reshape(d, x.shape[2], heads, -1)
    if not jax_name.endswith("out/bias"):  # [d, H*hd] -> [d, H, hd]
      return x.reshape(d, heads, -1)
    return x
  if jax_name.endswith("/kernel"):  # [d, out, in] -> [d, in, out]
    return x.transpose(-1, -2)
  return x


def _jet_layout(module, name, jax_name, x):
  """Parameter `name` of a Jet module in its JAX layout."""
  if name in _JET_MASKS:
    return x
  dnn = module.couplings.layer.dnn
  heads = (dnn.xattn.num_heads if "MultiHead" in jax_name
           and "/vit/" not in jax_name
           else dnn.encoder.blocks[0].attn.num_heads)
  return _stacked_layout(x, jax_name, heads)


_JETFORMER = {"text_emb": "EmbedText/embedding",
              "text_head.weight": "LogitsText/kernel",
              "text_head.bias": "LogitsText/bias",
              "img_emb.weight": "EmbedImage/kernel",
              "img_emb.bias": "EmbedImage/bias",
              "img_head.weight": "LogitsImage/kernel",
              "img_head.bias": "LogitsImage/bias",
              "text_norm.scale": "TextNorm/scale",
              "img_norm.scale": "ImageNorm/scale",
              "final_norm.scale": "decoder/final_norm/scale"}


def _jetformer_model_names(model):
  """{port name: JAX name} of a `models.proj.jetformer.jetformer.Model`:
  the heads and the scanned "decoder/layers/..." leaves."""
  out = {}
  for name, _ in model.named_parameters():
    if name in _JETFORMER:
      out[name] = _JETFORMER[name]
      continue
    rest = name.removeprefix("layers.layer.")
    if rest.endswith("norm.scale"):
      out[name] = "decoder/layers/" + rest.replace(".", "/")
    else:
      src = {v: k for k, v in _GEMMA_LAYER.items()}[rest]
      out[name] = f"decoder/layers/{src}"
  return out


def jetformer_names(module: torch.nn.Module) -> dict[str, str]:
  """{port parameter name: JAX param name} of a JetFormer `Model`, or of a
  `Joint` of it and its Jet adaptor (the JAX trainer's tree: the model's
  names, and the adaptor's under "params_adaptor/")."""
  if not hasattr(module, "adaptor"):
    return _jetformer_model_names(module)
  out = {f"model.{k}": v
         for k, v in _jetformer_model_names(module.model).items()}
  if module.adaptor is not None:
    out.update({f"adaptor.{k}": f"params_adaptor/{v}"
                for k, v in jet_names(module.adaptor).items()})
  return out


def _jetformer_layout(module, name, jax_name, x):
  """Parameter `name` of a JetFormer `Model` or `Joint` in its JAX
  layout."""
  if hasattr(module, "adaptor"):
    sub, rest = name.split(".", 1)
    if sub == "adaptor":
      return _jet_layout(module.adaptor, rest,
                         jax_name.removeprefix("params_adaptor/"), x)
    module, name = module.model, rest
  if not name.startswith("layers."):
    return x.T if jax_name.endswith("/kernel") else x
  rest = name.removeprefix("layers.layer.")
  src = {v: k for k, v in _GEMMA_LAYER.items()}.get(rest)
  if src is None:  # the norms
    return x
  attn = module.layers.layer.attn
  h, hd, kh, d = attn.num_heads, attn.head_dim, attn.num_kv_heads, x.shape[0]
  if src == "attn/attn_vec_einsum/w":  # [d, D, H*hd] -> [d, H, hd, D]
    return x.transpose(-1, -2).reshape(d, h, hd, -1)
  if src == "mlp/linear":  # [d, D, F] -> [d, F, D]
    return x.transpose(-1, -2)
  lead = {"attn/qkv_einsum/w": (3, h), "attn/q_einsum/w": (h,),
          "attn/kv_einsum/w": (2, kh), "mlp/gating_einsum": (2,)}[src]
  return _heads_first(x, (d, *lead))


def jetformer(module: torch.nn.Module, tree) -> dict[str, np.ndarray]:
  """A JetFormer param tree (with "params_adaptor" for a `Joint`) -> the
  port module's state dict (numpy). A per-layer decoder ("decoder/layers/
  0/...") is stacked first."""
  flat = _flat(tree)
  per_layer = {}
  for k in list(flat):
    if m := re.fullmatch(r"decoder/layers/(\d+)/(.*)", k):
      per_layer.setdefault(m[2], {})[int(m[1])] = flat.pop(k)
  for rest, layers in per_layer.items():
    flat[f"decoder/layers/{rest}"] = np.stack(
        [np.asarray(layers[i]) for i in range(len(layers))])
  return _from_jax(module, jetformer_names(module), _jetformer_layout, flat,
                   permuted=lambda jax_name: True)


def bit_names(module: torch.nn.Module) -> dict[str, str]:
  """{port parameter name: JAX param name} of a `models.bit` or
  `models.bit_paper` module: the module path with "/" for ".", a conv's
  and the head's "weight" as "kernel", a GroupNorm's as "scale", and
  bit_paper's `norm_pre_head` as "norm-pre-head" (e.g.
  "block1/unit1/conv1/kernel", "block1/unit01/gn1/scale")."""
  out = {}
  for name, _ in module.named_parameters():
    layer, leaf = name.rsplit(".", 1)
    sub = module.get_submodule(layer)
    if leaf == "weight":
      leaf = "scale" if isinstance(sub, convnets.GroupNorm) else "kernel"
    jax_layer = layer.replace(".", "/")
    out[name] = ("norm-pre-head" if jax_layer == "norm_pre_head"
                 else jax_layer) + f"/{leaf}"
  return out


def _bit_layout(module, name, jax_name, x):
  """Parameter `name` of a BiT module in its JAX layout: conv kernels
  OIHW -> HWIO, the head [out, in] -> [in, out], and bit_paper's
  GroupNorm params (C,) -> (1, 1, 1, C)."""
  if x.dim() == 4:
    return x.permute(2, 3, 1, 0)
  if jax_name.startswith("head/"):
    return x.T if jax_name.endswith("/kernel") else x
  if _kind(module) == "bit_paper":
    return x.reshape(1, 1, 1, -1)
  return x


def _kind(module):
  """"mixer", "vit" (also FlexiViT), "naflex", "text", "bert",
  "two_towers", "one_tower", "cappa", "paligemma", "jet", "jetformer",
  "bit" or "bit_paper"."""
  return {"bit": "bit", "bit_paper": "bit_paper", "mlp_mixer": "mixer",
          "text_transformer": "text", "bert": "bert",
          "two_towers": "two_towers", "one_tower": "one_tower",
          "cappa": "cappa", "paligemma": "paligemma",
          "naflex_vit": "naflex", "jet": "jet",
          "jetformer": "jetformer"}.get(
              type(module).__module__.rsplit(".", 1)[-1], "vit")


def names(module: torch.nn.Module) -> dict[str, str]:
  """{port parameter name: JAX param name} of a ViT, FlexiViT, NaFlex ViT,
  Mixer, text transformer, BERT, two-tower, one-tower, CapPa, PaliGemma,
  Jet, JetFormer or BiT (either flavour) model."""
  return _NAMES[_kind(module)](module)


def params(module: torch.nn.Module) -> dict:
  """The JAX param tree of any model of `names` (numpy)."""
  return _params(module, names(module), _LAYOUTS[_kind(module)])


def state(module: torch.nn.Module, tree) -> dict:
  """A JAX param tree -> the state dict of `module`, a model of `names` of
  that tree's model."""
  kind = _kind(module)
  if kind in ("mixer", "vit"):
    return (mixer if kind == "mixer" else vit)(tree)
  if kind == "two_towers":
    return two_towers(module, tree)
  if kind == "one_tower":
    return one_tower(module, tree)
  if kind == "cappa":
    return cappa(module, tree)
  if kind == "paligemma":
    return paligemma(tree)
  if kind == "naflex":
    return naflex(module, tree)
  if kind == "jetformer":
    return jetformer(module, tree)
  return _from_jax(module, names(module), _LAYOUTS[kind], tree)


def jax_shapes(module: torch.nn.Module) -> dict[str, tuple]:
  """{JAX param name: its shape in the JAX layout} of a model of `names`
  (computed on views: nothing is copied)."""
  layout = _LAYOUTS[_kind(module)]
  return {jax: tuple(layout(module, name, jax,
                            module.get_parameter(name).detach()).shape)
          for name, jax in names(module).items()}


def _heads_last(w):
  """[..., D, hd] einsum weight -> [(..., hd), D] matrix (an int8 weight's
  scale [..., 1, hd] -> [(..., hd), 1] alike)."""
  return w.swapaxes(-1, -2).reshape(-1, w.shape[-2])


def _heads_first(w, lead):
  """Inverse of `_heads_last`: [(lead..., hd), D] -> [lead..., D, hd]."""
  return w.reshape(*lead, -1, w.shape[-1]).swapaxes(-1, -2)


# The JAX einsum weights of a Gemma layer and the port's [out, in] matrix
# of each; `_heads_last` maps the rest, `attn_vec_einsum` [H, hd, D] and
# `linear` [F, D] are transposed.
_GEMMA_LAYER = {"attn/qkv_einsum/w": "attn.qkv", "attn/q_einsum/w": "attn.q",
                "attn/kv_einsum/w": "attn.kv",
                "attn/attn_vec_einsum/w": "attn.o",
                "mlp/gating_einsum": "mlp.gating", "mlp/linear": "mlp.linear"}
# A weight's JAX leaf -> its int8 scale's leaf (models/ppp/gemma.py's
# `_QUANT_LEAVES`); the port names it `<weight>_scale`.
_SCALE_LEAF = {"w": "w_scale", "gating_einsum": "gating_einsum_scale",
               "linear": "linear_scale",
               "input_embedding": "input_embedding_scale"}


def _to_port(src, w):
  """One JAX Gemma weight (or its scale, the contracted axes kept as 1) ->
  the port's [out, in] matrix (or [out, 1] scale)."""
  if src == "attn/attn_vec_einsum/w":  # [H, hd, D]; scale [1, 1, D]
    return w.reshape(-1, w.shape[-1]).T
  if src == "mlp/linear":  # [F, D]; scale [1, D]
    return w.T
  return _heads_last(w)  # [..., D, hd] -> [(..., hd), D]


def _scale_name(src):
  parent, leaf = src.rsplit("/", 1)
  return f"{parent}/{_SCALE_LEAF[leaf]}"


def gemma(params) -> dict:
  """Gemma param tree -> the port's `models.ppp.gemma` state dict (numpy
  arrays, or tensors for a tree of tensors). An int8 weight's scale goes
  through the same transposes and reshapes as its weight, to [out, 1]."""
  flat = _flat(params)
  if not any(re.match(r"layers/\d+/", n) for n in flat):
    flat = _unstack(flat, "layers", "layers/{}")
  leaves, out = _Leaves(flat), {}
  out["embedder.input_embedding"] = leaves.take("embedder/input_embedding")
  if "embedder/input_embedding_scale" in leaves.names():  # [V, 1]
    out["embedder.input_embedding_scale"] = leaves.take(
        "embedder/input_embedding_scale")
  out["final_norm.scale"] = leaves.take("final_norm/scale")
  layers = sorted({int(m.group(1)) for n in leaves.names()
                   if (m := re.match(r"layers/(\d+)/", n))})
  for i in layers:
    src, dst = f"layers/{i}", f"layers.{i}"
    for norm in ("pre_attention_norm", "pre_ffw_norm", "post_attention_norm",
                 "post_ffw_norm"):
      if f"{src}/{norm}/scale" in leaves.names():
        out[f"{dst}.{norm}.scale"] = leaves.take(f"{src}/{norm}/scale")
    for name, port in _GEMMA_LAYER.items():
      if f"{src}/{name}" not in leaves.names():
        continue  # qkv (MHA) or q and kv (MQA, GQA)
      out[f"{dst}.{port}"] = _to_port(name, leaves.take(f"{src}/{name}"))
      scale = f"{src}/{_scale_name(name)}"
      if scale in leaves.names():
        out[f"{dst}.{port}_scale"] = _to_port(name, leaves.take(scale))
  leaves.done()
  return out


def gemma_names(module: torch.nn.Module) -> dict[str, str]:
  """{port parameter name: JAX param name} of a `models.ppp.gemma.Model`
  (pyloop layout: "layers/0/attn/q_einsum/w", "embedder/input_embedding",
  "final_norm/scale", an int8 weight's "<...>_scale" leaf)."""
  out = {}
  for name, _ in module.named_parameters():
    layer, leaf = name.rsplit(".", 1)
    scale = leaf.endswith("_scale") and leaf != "scale"
    port = f"{layer}.{leaf.removesuffix('_scale')}" if scale else name
    if port in ("embedder.input_embedding", "final_norm.scale"):
      jax_name = port.replace(".", "/")
    elif m := re.fullmatch(r"layers\.(\d+)\.(\w+_norm)\.scale", port):
      jax_name = f"layers/{m[1]}/{m[2]}/scale"
    else:
      m = re.fullmatch(r"layers\.(\d+)\.(.*)", port)
      src = {v: k for k, v in _GEMMA_LAYER.items()}[m[2]]
      jax_name = f"layers/{m[1]}/{src}"
    out[name] = _scale_name(jax_name) if scale else jax_name
  return out


def _gemma_layout(module, name, jax_name, x):
  """Parameter `name` of a `models.ppp.gemma.Model` (or a tensor of its
  shape) in the JAX layout of `jax_name`."""
  del jax_name
  m = re.fullmatch(r"layers\.(\d+)\.((?:attn|mlp)\.(?:qkv|q|kv|o|gating|"
                   r"linear))(_scale)?", name)
  if not m:  # the embedding, the norms (an int8 embedding's scale [V, 1])
    return x
  src, scale = {v: k for k, v in _GEMMA_LAYER.items()}[m[2]], bool(m[3])
  attn = module.layers[int(m[1])].attn
  h, hd, kh = attn.num_heads, attn.head_dim, attn.num_kv_heads
  if src == "attn/attn_vec_einsum/w":  # [D, H*hd] -> [H, hd, D]
    return x.T.reshape(h, hd, -1) if not scale else x.T.reshape(1, 1, -1)
  if src == "mlp/linear":  # [D, F] -> [F, D]
    return x.T
  lead = {"attn/qkv_einsum/w": (3, h), "attn/q_einsum/w": (h,),
          "attn/kv_einsum/w": (2, kh), "mlp/gating_einsum": (2,)}[src]
  return _heads_first(x, lead)


def gemma_params(module: torch.nn.Module) -> dict:
  """The inverse of `gemma`: a `models.ppp.gemma.Model`'s parameters as the
  JAX model's param tree (pyloop layout), tensors on the module's device
  in their own dtype (int8 weights with their f32 scales for `quant`)."""
  return trees.unflatten({
      jax: _gemma_layout(module, name, jax,
                         module.get_parameter(name).detach())
      for name, jax in gemma_names(module).items()})


def paligemma_names(module: torch.nn.Module) -> dict[str, str]:
  """{port parameter name: JAX param name} of a
  `models.proj.paligemma.paligemma.Model`: the image tower's names under
  "img/", the LLM's (`gemma_names`) under "llm/"."""
  out = {f"img.{k}": f"img/{v}" for k, v in names(module.img).items()}
  out.update({f"llm.model.{k}": f"llm/{v}"
              for k, v in gemma_names(module.llm.model).items()})
  return out


def _paligemma_layout(module, name, jax_name, x):
  """Parameter `name` of a PaliGemma module in its JAX layout."""
  tower, rest = name.split(".", 1)
  jax_rest = jax_name.split("/", 1)[1]
  if tower == "img":
    return _LAYOUTS[_kind(module.img)](module.img, rest, jax_rest, x)
  return _gemma_layout(module.llm.model, rest.removeprefix("model."),
                       jax_rest, x)


def paligemma(params) -> dict:
  """{"img": vit tree, "llm": gemma tree} -> the port's PaliGemma."""
  out = {f"img.{k}": v for k, v in vit(params["img"]).items()}
  out.update({f"llm.model.{k}": v for k, v in gemma(params["llm"]).items()})
  unused = set(params) - {"img", "llm"}
  if unused:
    raise ValueError(f"unused params: {sorted(unused)}")
  return out


def load(module: torch.nn.Module, state: dict, device=None, dtype=None):
  """Loads a converted state (numpy arrays or tensors) into `module`, in
  place.

  The tensors replace the module's parameters on the module's own device
  unless `device` is given, keeping the arrays' dtype unless `dtype` is
  given. `dtype` casts only the entries of the module's trained float
  parameters: one the module made untrained (`requires_grad=False`, as the
  int8 weights and their f32 scales) keeps its dtype. Raises on a missing
  or unexpected entry.
  """
  if device is None:
    device = next(module.parameters()).device
  want = set(module.state_dict())
  missing, unexpected = want - set(state), set(state) - want
  if missing or unexpected:
    raise ValueError(f"missing {sorted(missing)}; unexpected "
                     f"{sorted(unexpected)}")
  trained = {k for k, p in module.named_parameters()
             if p.requires_grad and p.is_floating_point()}
  tensors = {}
  for k, v in state.items():
    if isinstance(v, torch.Tensor):
      t = v.contiguous()
    else:
      v = np.ascontiguousarray(v)
      t = (torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
           if v.dtype.name == "bfloat16" else torch.from_numpy(v))
    cast = dtype and k in trained
    tensors[k] = t.to(device=device, dtype=dtype if cast else t.dtype)
  module.load_state_dict(tensors, strict=True, assign=True)
  return module


# Each model kind's names and layout (see `_kind`).
_NAMES = {"mixer": mixer_names, "vit": vit_names,
          "text": text_transformer_names, "bert": bert_names,
          "two_towers": two_towers_names, "one_tower": one_tower_names,
          "cappa": cappa_names, "paligemma": paligemma_names,
          "naflex": vit_names, "jet": jet_names,
          "jetformer": jetformer_names, "bit": bit_names,
          "bit_paper": bit_names}
_LAYOUTS = {"mixer": _mixer_layout, "vit": _vit_layout, "text": _vit_layout,
            "bert": _vit_layout, "two_towers": _two_towers_layout,
            "one_tower": _two_towers_layout, "cappa": _cappa_layout,
            "paligemma": _paligemma_layout, "naflex": _naflex_layout,
            "jet": _jet_layout, "jetformer": _jetformer_layout,
            "bit": _bit_layout, "bit_paper": _bit_layout}

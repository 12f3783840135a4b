"""Text preprocessing ops: port of big_vision_tpu/pp/ops_text.py.

All host ops (strings live on the host). `tokenize` has the JAX op's eos
modes:

  eos="none":   the tokens, cut or padded to max_len, no eos.
  eos="yes":    the tokens and eos, cut to max_len (eos may be cut).
  eos="sticky": the last kept token is always eos (for "last" pooling).

Its `model` is a tokenizer of `pp/tokenizer.py` ("test(128)", "sp(...)"),
else a SentencePiece model name or path. `clip_i1k_label_names` and
`i21k_label_names` read the ImageNet class-name tables of
`datasets/imagenet`.
"""

from __future__ import annotations

import numpy as np

from big_vision_torch.pp import tokenizer as bv_tok
from big_vision_torch.pp.utils import PPOp
from big_vision_torch.registry import Registry


def _pad_tokens(ids, max_len, pad_value, eos_token, force_eos):
  ids = list(ids)
  if force_eos and len(ids) >= max_len:
    ids = ids[:max_len - 1] + [eos_token]
  ids = ids[:max_len]
  return np.asarray(ids + [pad_value] * (max_len - len(ids)), np.int32)


def _text(x):
  return x.decode() if isinstance(x, bytes) else str(x)


@Registry.register("preprocess_ops.tokenize")
def get_pp_tokenize(max_len, eos, model="c4_en", lower=True,
                    sample_if_multi=True, pad_value="<pad>", add_bos=False,
                    key=None, inkey=None, outkey="labels"):
  """Tokenizes data[inkey] into int32 [max_len]; a list of texts gives one
  drawn from the example's rng (`sample_if_multi`) or all of them."""
  if eos not in ("yes", "none", "sticky"):
    raise ValueError(f"Invalid eos mode {eos!r}")
  state = {}  # the tokenizer is read at first use, in a loader thread

  def resolve():
    if "tok" not in state:
      try:
        tok = bv_tok.get_tokenizer(model)
      except (ValueError, KeyError, ModuleNotFoundError):
        # A bare name or path is a SentencePiece model; eos and bos are
        # added per call below.
        tok = bv_tok.get_tokenizer(f'sp(model="{model}", add_eos=False)')
      state["tok"] = tok
      state["pad"] = (tok.string_to_id(pad_value)
                      if isinstance(pad_value, str) else pad_value)
    return state["tok"], state["pad"]

  ik, ok = key or inkey, key or outkey
  assert ik, "tokenize needs key= or inkey="

  def tokenize_one(txt):
    tokenizer, pad = resolve()
    txt = _text(txt)
    if lower:
      txt = txt.lower()
    ids = tokenizer.to_int(txt, bos=add_bos, eos=eos != "none")
    return _pad_tokens(ids, max_len, pad, tokenizer.eos_token,
                       force_eos=eos == "sticky")

  def _op(data, np_rng):
    data = dict(data)
    txt = data[ik]
    if sample_if_multi and isinstance(txt, (list, tuple, np.ndarray)):
      txt = txt[int(np_rng.integers(0, len(txt)))] if len(txt) else ""
      data[ok] = tokenize_one(txt)
    elif isinstance(txt, (list, tuple, np.ndarray)):
      data[ok] = np.stack([tokenize_one(t) for t in txt])
    else:
      data[ok] = tokenize_one(txt)
    return data

  return PPOp(host_fn=_op, phase="host", random=True, staticizer=True,
              name="tokenize")


@Registry.register("preprocess_ops.lower")
def get_lower(key="text", inkey=None, outkey=None):
  """Lower-cases a string."""
  ik, ok = inkey or key, outkey or key

  def _op(data):
    data = dict(data)
    data[ok] = _text(data[ik]).lower()
    return data

  return PPOp(host_fn=_op, phase="host", name="lower")


@Registry.register("preprocess_ops.strfmt")
def get_strfmt(template, outkey="text"):
  """`template.format(**data)` over the keys that do not start with "_"."""
  def _op(data):
    data = dict(data)
    fields = {k: (v.decode() if isinstance(v, bytes) else v)
              for k, v in data.items() if not k.startswith("_")}
    data[outkey] = template.format(**fields)
    return data

  return PPOp(host_fn=_op, phase="host", name="strfmt")


def _label_names(names, key, outkey, name):
  """The host op that maps data[key] (a class id) to names[id]."""
  def _op(data):
    data = dict(data)
    data[outkey] = names[int(data[key])]
    return data

  return PPOp(host_fn=_op, phase="host", name=name)


@Registry.register("preprocess_ops.clip_i1k_label_names")
def get_clip_i1k_label_names(key="label", outkey="labels"):
  """Maps an ImageNet-1k label id to its CLIP class-name string."""
  from big_vision_torch.datasets import imagenet  # pylint: disable=import-outside-toplevel
  return _label_names(imagenet.clip_imagenet_class_names(), key, outkey,
                      "clip_i1k_label_names")


@Registry.register("preprocess_ops.i21k_label_names")
def get_i21k_label_names(key="label", outkey="labels"):
  """Maps an ImageNet-21k label id to its class-name string."""
  from big_vision_torch.datasets import imagenet  # pylint: disable=import-outside-toplevel
  return _label_names(imagenet.imagenet21k_class_names(), key, outkey,
                      "i21k_label_names")


@Registry.register("preprocess_ops.coco_captions")
def get_coco_captions(outkey="captions"):
  """Lifts COCO's nested "captions/text" to `outkey`."""
  def _op(data):
    data = dict(data)
    caps = data["captions"]
    if isinstance(caps, dict):
      caps = caps["text"]
    data[outkey] = caps
    return data

  return PPOp(host_fn=_op, phase="host", name="coco_captions")

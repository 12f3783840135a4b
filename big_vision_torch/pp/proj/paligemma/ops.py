"""PaliGemma preprocessing ops (host phase: string and token surgery).

Port of big_vision_tpu/pp/proj/paligemma/ops.py: `tokenizers.gemma`, and
the host ops `tolen`, `tok`, `masked_concat` (text plus one mask per
segment list), `strjoin`, `majority` and `getidx`, with the same names,
arguments and results.
"""

from __future__ import annotations

import numpy as np

from big_vision_torch.pp import tokenizer as bv_tok
from big_vision_torch.pp.utils import PPOp
from big_vision_torch.registry import Registry


@Registry.register("tokenizers.gemma")
def get_tokenizer_gemma(tokensets=(),
                        model="gs://big_vision/gemma_tokenizer.model"):
  """Gemma's SentencePiece vocab (a local `.model`; nothing is fetched)."""
  return bv_tok.get_sp_tokenizer(model=model, add_bos=False, add_eos=False,
                                 tokensets=tokensets)


def _tolen(x, length, sticky_end, pad_value):
  x = np.asarray(x)
  if not length:
    return x
  if len(x) >= length:
    if sticky_end:
      return np.concatenate([x[:length - 1], x[-1:]])
    return x[:length]
  return np.pad(x, (0, length - len(x)), constant_values=pad_value)


@Registry.register("preprocess_ops.tolen")
def get_tolen(length, *, sticky_end=False, pad_value=None, pad_key=None,
              key=None, inkey=None, outkey=None):
  """Truncates/pads a 1D token array to a fixed length (staticizer)."""
  ik, ok = inkey or key, outkey or key

  def _op(data):
    data = dict(data)
    pv = pad_value
    if pad_key is not None:
      pv = data[pad_key]
      if getattr(pv, "ndim", 0) == 1:
        pv = pv[0]
    if pv is None:
      raise ValueError("tolen needs pad_value or pad_key")
    data[ok] = _tolen(data[ik], length, sticky_end, pv)
    return data

  return PPOp(host_fn=_op, phase="host", staticizer=bool(length),
              name="tolen")


@Registry.register("preprocess_ops.tok")
def get_tok(model, length=None, *, bos="no", eos="no", text=None, key=None,
            inkey=None, outkey=None):
  """Tokenizes a string (or a constant `text`) to int32 tokens."""
  if eos not in ("no", "yes", "sticky") or bos not in ("no", "yes"):
    raise ValueError(f"tok: bos={bos!r}, eos={eos!r}")
  ik, ok = inkey or key, outkey or key
  tokenizer = bv_tok.get_tokenizer(model)

  def tokenize(s):
    if isinstance(s, bytes):
      s = s.decode()
    toks = tokenizer.to_int(str(s), bos=bos == "yes",
                            eos=eos in ("yes", "sticky"))
    return _tolen(np.asarray(toks, np.int32), length,
                  sticky_end=eos == "sticky",
                  pad_value=tokenizer.pad_token)

  if text is not None:
    if inkey is not None:
      raise ValueError("tok takes either inkey or text, not both")
    # Tokenized on first use, not at parse time: the vocab may be a
    # remote file (gs://...) that pp-string validation must not touch.
    const_state = {}

    def _op_const(data):
      if "tokens" not in const_state:
        const_state["tokens"] = tokenize(text)
      data = dict(data)
      data[ok] = const_state["tokens"]
      return data
    return PPOp(host_fn=_op_const, phase="host", staticizer=bool(length),
                name="tok")

  def _op(data):
    data = dict(data)
    data[ok] = tokenize(data[ik])
    return data

  return PPOp(host_fn=_op, phase="host", staticizer=bool(length), name="tok")


@Registry.register("preprocess_ops.masked_concat")
def get_masked_concat(keys, outkey="text", **masks):
  """Concats token arrays and emits per-segment masks.

  masked_concat(['prefix', 'suffix'], mask_ar=[0, 1], mask_loss=[0, 1])
  gives `text` plus mask_ar / mask_loss arrays marking each segment.
  """
  if not all(len(keys) == len(m) for m in masks.values()):
    raise ValueError(f"masked_concat: {keys} vs {masks}")

  def _op(data):
    data = dict(data)
    inputs = dict(data)
    data[outkey] = np.concatenate(
        [np.asarray(inputs[k], np.int32) for k in keys])
    for mask_name, mask_vals in masks.items():
      data[mask_name] = np.concatenate([
          np.full(len(np.asarray(inputs[k])), v, np.int32)
          for k, v in zip(keys, mask_vals)])
    return data

  return PPOp(host_fn=_op, phase="host", name="masked_concat")


@Registry.register("preprocess_ops.strjoin")
def get_strjoin(glue, key="text", inkey=None, outkey=None):
  ik, ok = inkey or key, outkey or key

  def _op(data):
    data = dict(data)
    vals = [v.decode() if isinstance(v, bytes) else str(v)
            for v in data[ik]]
    data[ok] = glue.join(vals)
    return data

  return PPOp(host_fn=_op, phase="host", name="strjoin")


@Registry.register("preprocess_ops.majority")
def get_majority(key="text", inkey=None, outkey=None):
  ik, ok = inkey or key, outkey or key

  def _op(data):
    data = dict(data)
    vals = list(data[ik])
    # First-seen-wins on ties (matches unique_with_counts + argmax).
    seen = {}
    for v in vals:
      v = v.decode() if isinstance(v, bytes) else v
      seen[v] = seen.get(v, 0) + 1
    data[ok] = max(seen.items(), key=lambda kv: kv[1])[0]
    return data

  return PPOp(host_fn=_op, phase="host", name="majority")


@Registry.register("preprocess_ops.getidx")
def get_getidx(inkey=None, index_key=None, outkey=None, key=None):
  """data[out] = data[in][data[index_key]], with the JAX op's positional
  order (inkey, index_key, outkey)."""
  if index_key is None:
    raise ValueError("getidx needs index_key")
  ik = inkey or key
  ok = outkey or key or ik

  def _op(data):
    data = dict(data)
    data[ok] = np.asarray(data[ik])[int(data[index_key])]
    return data

  return PPOp(host_fn=_op, phase="host", name="getidx")

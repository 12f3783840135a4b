"""The shared recipe of the PaliGemma transfer configs: port of
big_vision_tpu/configs/proj/paligemma/transfers/common.py (`tok`,
`combine_and_keep_train`, `combine_and_keep_eval`, `crop_pp`, `mkbase`,
`shrink_for_runlocal`, `add_eval_pplx`, `caption_task_config`), with the
port's stand-in for Gemma's SentencePiece model.

The JAX package's tokenizer, `gemma(tokensets=("loc", "seg"))`, reads
Gemma's published SentencePiece model, which is not in the repository.
`stand_in_tokenizer(path)` writes, where `path` does not exist yet, a
unigram model of Gemma's 256,000 pieces: "<pad>" (id 0), "</s>" (EOS, 1),
"<s>" (BOS, 2), "<unk>" (3), "▁" and "." and a "▁<word>" piece for
every word of the COCO stand-in's captions (`datasets/synthetic.captions`)
and of the prompt "caption en", then filler pieces "▁w<i>". The
tokensets add Gemma's 1,024 location and 128 segmentation tokens after
them, so the ids span the LLM's vocab of 257,152 and the loss falls on
real ids. `tokenizer(path)` is the pp string of that model. The video and
VQA builders of the JAX module are not ported (their configs are not).
"""

import os
import re

from big_vision_torch.configs import common as bvcc
from big_vision_torch.datasets import synthetic
from big_vision_torch.pp import sentencepiece_native as spn

GEMMA_PIECES = 256_000
DEFAULT_VOCAB = "build/paligemma/tokenizer.model"


def tokenizer(vocab=DEFAULT_VOCAB):
  """The JAX configs' TOKENIZER on the model file `vocab`."""
  return f"gemma(tokensets=('loc', 'seg'), model={vocab!r})"


TOKENIZER = tokenizer()


def stand_in_tokenizer(path):
  """Writes the stand-in SentencePiece model at `path` unless it exists;
  returns `path`."""
  if os.path.exists(path):
    return path
  words = sorted({w for label in range(80)
                  for c in synthetic.captions(label, 5)
                  for w in re.findall(r"[a-z]+", c)} | {"caption", "en"})
  pieces = [("<pad>", 0.0, spn.CONTROL), ("</s>", 0.0, spn.CONTROL),
            ("<s>", 0.0, spn.CONTROL), ("<unk>", 0.0, spn.UNKNOWN),
            ("▁", -2.0, spn.NORMAL), (".", -2.0, spn.NORMAL)]
  pieces += [(f"▁{w}", -1.0, spn.NORMAL) for w in words]
  pieces += [(f"▁w{i}", -5.0, spn.NORMAL)
             for i in range(GEMMA_PIECES - len(pieces))]
  os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
  tmp = f"{path}.{os.getpid()}.tmp"
  with open(tmp, "wb") as f:
    f.write(spn.serialize_model_proto(pieces, unk_id=3, bos_id=2, eos_id=1,
                                      pad_id=0))
  os.replace(tmp, path)
  return path


def tok(**kw):
  """A `tok` pp op string, on the shared tokenizer by default."""
  kw.setdefault("model", TOKENIZER)
  kw = ", ".join(f"{k}={v!r}" for k, v in kw.items())
  return f"tok({kw})"


def combine_and_keep_train(text_len, before=(), sep="\n", model=TOKENIZER):
  """prefix + sep + suffix -> text, mask_ar, mask_loss, padded to
  text_len + 1."""
  return "|".join([
      *before,
      tok(key="prefix", bos="yes", model=model),
      tok(key="suffix", eos="yes", model=model),
      tok(key="septok", text=sep, model=model),
      ("masked_concat(['prefix', 'septok', 'suffix'], outkey='text',"
       " mask_ar=[0, 0, 1], mask_loss=[0, 0, 1])"),
      # +1 because the trainer removes EOS.
      f"tolen({text_len + 1}, pad_value=0, key='text')",
      f"tolen({text_len + 1}, pad_value=1, key='mask_ar')",
      f"tolen({text_len + 1}, pad_value=0, key='mask_loss')",
      "keep('image', 'text', 'mask_ar', 'mask_loss')",
  ])


def combine_and_keep_eval(text_len, keep=(), before=(), sep="\n",
                          model=TOKENIZER):
  """The same, but the suffix defaults to empty (decoding continues it)."""
  return "|".join([
      *before,
      tok(key="prefix", bos="yes", model=model),
      tok(key="septok", text=sep, model=model),
      "setdefault('suffix', '')",
      tok(key="suffix", eos="no", model=model),
      ("masked_concat(['prefix', 'septok', 'suffix'], outkey='text',"
       " mask_ar=[0, 0, 1], mask_input=[1, 1, 1])"),
      f"tolen({text_len}, pad_value=0, key='text')",
      f"tolen({text_len}, pad_value=1, key='mask_ar')",
      f"tolen({text_len}, pad_value=0, key='mask_input')",
      "keep(" + ", ".join(
          f"'{x}'" for x in
          ("image", "text", "mask_ar", "mask_input") + tuple(keep)) + ")",
  ])


def crop_pp(res, crop):
  """The named crops of the caption and VQA transfers."""
  return {
      "ic": f"inception_crop({res}, area_min=50)",
      "rc": f"resize_small({res * 8 // 7})|random_crop({res})",
      "rs": f"resize({res})",
  }[crop]


def mkbase(c, *, res, total_epochs, lr, wd, batch_size=256,
           label_smoothing=0.0, b2=0.999):
  """Fills the sections every transfer config shares."""
  c["total_epochs"] = total_epochs
  c["input"]["batch_size"] = batch_size
  c["optax_name"] = "scale_by_adam"
  c["optax"] = dict(b2=b2)
  c["lr"] = lr
  c["wd"] = wd
  c["grad_clip_norm"] = 1.0
  c["label_smoothing"] = label_smoothing
  c["schedule"] = dict(decay_type="cosine", warmup_percent=0.05)

  c["model_name"] = "proj.paligemma.paligemma"
  c["model"] = {}
  c["model"]["img"] = dict(variant="So400m/14", pool_type="none", scan=True)
  c["model"]["llm"] = dict(vocab_size=256_000 + 1024 + 128, dropout=0.0)
  c["model_init"] = f"pt_{res}"

  c["mesh"] = [("data", -1)]
  c["sharding_strategy"] = [(".*", 'fsdp(axis="data")')]
  c["sharding_rules"] = [("act_batch", ("data",))]

  c["input"]["shuffle_buffer_size"] = 50_000
  c["log_training_steps"] = 50
  c["ckpt_steps"] = 1_000
  c["pp_modules"] = ["ops_general", "ops_image", "ops_text",
                     "proj.paligemma.ops"]
  c["seed"] = 0
  return c


def shrink_for_runlocal(c):
  """Small-footprint overrides for local runs: 16 examples an eval split
  (the stand-in's `n`: its splits take no slices), batch 2."""
  c["input"]["shuffle_buffer_size"] = None
  for ev in c["evals"].values():
    ev["data"]["n"] = 16
  c["log_training_steps"] = 1
  c["input"]["batch_size"] = 2
  return c


def add_eval_pplx(c, data_name, train_pp, splits, prefix, neval=0):
  """Perplexity evaluators over the (name, split) pairs of `data_name`, on
  the stand-in of each split (`neval` examples each where given)."""
  for name, split in splits:
    c["evals"][f"{prefix}/{name}/pplx"] = dict(
        type="proj.paligemma.perplexity", pred="logits",
        key="text", shift_labels=True, log_percent=0.05,
        data=bvcc.stand_in(data_name, split, n=neval), pp_fn=train_pp)


# The port's own args of the transfer configs and their defaults: the
# tokenizer model (written where missing), the batch, examples per eval
# split (0: the split's size), steps to stop after (0: none), steps between
# metric rows and between checkpoints, the LLM's attn_impl, and a
# `model_init` (an `.npz` with img and llm subtrees; none: the seed's).
PORT_ARGS = dict(vocab=DEFAULT_VOCAB, batch_size=64, neval=0, stop=0, log=50,
                 ckpt=1_000, attn="", init="")


def port_args(c):
  """Takes the port's args (`PORT_ARGS`) out of the parsed args `c`."""
  return {k: type(d)(c.pop(k)) if k in c else d
          for k, d in PORT_ARGS.items()}


def caption_task_config(arg, *, data_name, suffix_pp, train_split,
                        final_train_split, eval_splits, captions_pp,
                        prefix="caption en", text_len=32, total_epochs=5,
                        lr=1e-5, wd=0.0, pp_before=(), res_default=224,
                        prefix_name="cap"):
  """One builder for the captioning transfers (coco_caption scoring)."""
  c = vars(bvcc.parse_arg(arg, lazy=True, mode="xm", crop="rs",
                          res=res_default, final_split=False))
  port = port_args(c)
  model = tokenizer(stand_in_tokenizer(port["vocab"]))

  def training_data(final_split):
    split = final_train_split if final_split else train_split
    return dict(
        data=bvcc.stand_in(data_name, split),
        pp="|".join([
            *pp_before,
            "decode", crop_pp(c["res"], c["crop"]), "value_range(-1, 1)",
            suffix_pp,
            f"strfmt({prefix!r}, outkey='prefix')",
            combine_and_keep_train(text_len, model=model),
        ]))

  c["input"] = training_data(c["final_split"])

  c["evals"] = {}
  pp_eval = "|".join([
      *pp_before,
      "decode", f"resize({c['res']})", "value_range(-1, 1)",
      f"strfmt({prefix!r}, outkey='prefix')",
      combine_and_keep_eval(text_len, keep=("image/id", "captions"),
                            model=model),
  ])
  for name, split in eval_splits:
    c["evals"][f"{prefix_name}/{name}"] = dict(
        type="proj.paligemma.transfers.coco_caption",
        # Captioning evals decode with beam search.
        pred="beam_decode", pred_kw={"max_decode_len": text_len},
        log_percent=0.1, tokenizer=model,
        data=bvcc.stand_in(data_name, split, n=port["neval"]),
        pp_fn="|".join([*captions_pp, pp_eval]))
  add_eval_pplx(c, data_name, training_data(True)["pp"], eval_splits,
                prefix_name, neval=port["neval"])

  mkbase(c, res=c["res"], total_epochs=total_epochs, lr=lr, wd=wd)
  c["input"]["batch_size"] = port["batch_size"]
  del c["model_init"]  # pt_{res}: the published checkpoint, not in reach
  if port["init"]:
    c["model_init"] = port["init"]
  if port["attn"]:
    c["model"]["llm"]["attn_impl"] = port["attn"]
  c["log_training_steps"] = port["log"]
  c["ckpt_steps"] = port["ckpt"]
  if port["stop"]:
    c["stop_after_steps"] = port["stop"]
  if c["mode"] == "runlocal":
    shrink_for_runlocal(c)
  return c


parse_arg = bvcc.parse_arg

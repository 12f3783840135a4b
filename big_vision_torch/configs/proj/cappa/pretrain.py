"""CapPa pre-training (the captioner with parallel prediction,
arXiv:2306.07915) on COCO captions: port of
big_vision_tpu/configs/proj/cappa/pretrain.py.

  python -m big_vision_torch.trainers.proj.cappa.generative --workdir wd \
      --config big_vision_torch/configs/proj/cappa/pretrain.py

Kept as there: 224px images (`decode|resize|flip_lr|value_range(-1, 1)`),
one caption of each drawn by `flatten|choice` and tokenized to 64 tokens
(sticky eos, PAD 0); a ViT-B/16 encoder (12 layers, width 768, 12 heads,
MLP 3072, learned posemb) and a 6-layer decoder of the same widths, vocab
32,000, `masked_pred_prob` 0.75 and `masking_ratio` 1.0; Adam with b2
0.95, gradient clip 1.0, lr 1e-3, wd 1e-4, 10,000 warmup steps then
cosine, 366,500 steps; metric rows every 50 steps, a checkpoint every
1000, the `val_pplx` perplexity eval every 1000 steps; the args
`runlocal`, `total_steps`, `batch_size` and `warmup_steps`.

Cut (`CUTS`):
  * input.data, evals.val_pplx.data: no TFDS; COCO captions' Karpathy
    splits (train 82,783, val 5,000 images) are `common.stand_in`'s
    synthetic JPEGs of 256x320 with five captions an image;
  * input.pp, evals.val_pplx.pp_fn: T5's `c4_en` SentencePiece model is
    not in the repository. `stand_in_tokenizer` writes a unigram model of
    its 32,000 pieces in place (at the `vocab` arg,
    build/cappa/c4_en_standin.model by default): "<pad>" (0), "</s>"
    (EOS, 1), "<unk>" (2), "▁", every character, and "▁<word>" and
    "<word>" for every word of the COCO stand-in's captions and of the
    1000 CLIP ImageNet class names, then fillers "▁w<i>";
  * input.batch_size: 256 of 8192, the largest power of two at which an
    update fits in one H100's 80 GB (`chip_smoke.py --imagetext` tries
    twice the batch).

Args (`:name=value,...`), besides the JAX config's: `vocab`, `neval`
(images in the val split), `stop` (stop after that many steps), `log`
(steps between metric rows), and `scoring` (0: none): the
zero-shot scoring classifier (`proj.cappa.scoring_classifier`, pred
"score") on that many images of the imagenet2012 validation stand-in over
the 1000 CLIP class names, as eval `zeroshot_i1k` in batches of 8 (each
costs 1000 decoder passes); no JAX config sets it.
"""

import os
import re
import unicodedata

from big_vision_torch.configs import common as bvcc
from big_vision_torch.datasets import imagenet
from big_vision_torch.datasets import synthetic
from big_vision_torch.pp import sentencepiece_native as spn

CUTS = {
    "input.data": "no TFDS: coco_captions train is synthetic JPEGs with "
                  "five captions an image, of the split's size",
    "evals.val_pplx.data": "no TFDS: coco_captions val is synthetic JPEGs "
                           "with five captions an image",
    "input.pp": "the stand-in c4_en SentencePiece model, written in place",
    "evals.val_pplx.pp_fn": "the stand-in c4_en SentencePiece model, "
                            "written in place",
    "input.batch_size": "256: the largest power of two that fits on one "
                        "80 GB card",
}

C4_PIECES = 32_000
DEFAULT_VOCAB = "build/cappa/c4_en_standin.model"


def stand_in_tokenizer(path):
  """Writes the stand-in `c4_en` model at `path` unless it exists; returns
  `path`."""
  if os.path.exists(path):
    return path
  texts = [c for label in range(80) for c in synthetic.captions(label, 5)]
  texts += imagenet.clip_imagenet_class_names()
  texts = [unicodedata.normalize("NFKC", t).lower() for t in texts]
  chars = sorted({ch for t in texts for ch in t if not ch.isspace()})
  words = sorted({w for t in texts for w in re.findall(r"\w+", t)})
  pieces = [("<pad>", 0.0, spn.CONTROL), ("</s>", 0.0, spn.CONTROL),
            ("<unk>", 0.0, spn.UNKNOWN), ("▁", -2.0, spn.NORMAL)]
  pieces += [(ch, -8.0, spn.NORMAL) for ch in chars]
  pieces += [(f"▁{w}", -1.0, spn.NORMAL) for w in words]
  pieces += [(w, -1.5, spn.NORMAL) for w in words if w not in chars]
  pieces += [(f"▁w{i}", -5.0, spn.NORMAL)
             for i in range(C4_PIECES - len(pieces))]
  os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
  tmp = f"{path}.{os.getpid()}.tmp"
  with open(tmp, "wb") as f:
    f.write(spn.serialize_model_proto(pieces, unk_id=2, bos_id=-1, eos_id=1,
                                      pad_id=0))
  os.replace(tmp, path)
  return path


def get_config(arg=None):
  arg = bvcc.parse_arg(arg, runlocal=False, total_steps=366_500,
                       batch_size=256, warmup_steps=10_000,
                       vocab=DEFAULT_VOCAB, neval=0, stop=0, log=50,
                       scoring=0)
  vocab = stand_in_tokenizer(arg.vocab)
  config = {}
  config["seed"] = 0
  config["total_steps"] = arg.total_steps if not arg.runlocal else 20

  res = 224
  text_len = 64
  tokenizer = (f"tokenize(max_len=64, model='{vocab}', eos='sticky',"
               " pad_value=0, inkey='text')")
  pp_train = (
      f"decode|resize({res})|flip_lr|value_range(-1, 1)"
      "|flatten|choice(inkey='captions/text', outkey='text')"
      f"|{tokenizer}|keep('image', 'labels')")
  config["input"] = dict(
      data=bvcc.stand_in("coco_captions", "train"),
      batch_size=arg.batch_size if not arg.runlocal else 8,
      shuffle_buffer_size=250_000 if not arg.runlocal else 25,
      pp=pp_train,
  )
  config["pp_modules"] = ["ops_general", "ops_image", "ops_text"]
  config["log_training_steps"] = arg.log
  config["ckpt_steps"] = 1000
  config["init_shapes"] = [(1, res, res, 3), (1, text_len)]

  config["model_name"] = "proj.cappa.cappa"
  config["model"] = dict(
      num_layers=12, num_heads=12, mlp_dim=3072, emb_dim=768,
      vocab_size=32_000, patches=(16, 16), seq_len=text_len,
      input_seq_len=(res // 16) ** 2, posemb_type="learn",
      decoder_num_layers=6, decoder_num_heads=12, decoder_mlp_dim=3072,
      decoder_emb_dim=768,
      # 75% of the batch is trained with parallel prediction.
      masked_pred_prob=0.75, masking_ratio=1.0)

  config["optax_name"] = "scale_by_adam"
  config["optax"] = dict(b2=0.95)
  config["grad_clip_norm"] = 1.0
  config["lr"] = 0.001
  config["wd"] = 0.0001
  config["schedule"] = dict(decay_type="cosine",
                            warmup_steps=arg.warmup_steps)

  config["evals"] = {}
  config["evals"]["val_pplx"] = dict(
      type="proj.cappa.perplexity", pred="perplexity",
      data=bvcc.stand_in("coco_captions", "val", n=arg.neval),
      pp_fn=pp_train, log_steps=1000)
  if arg.scoring:
    config["evals"]["zeroshot_i1k"] = dict(
        type="proj.cappa.scoring_classifier", pred="score",
        data=bvcc.stand_in("imagenet2012", "validation", n=arg.scoring),
        dataset_name="imagenet2012", batch_size=8,
        pp_fn=(f"decode|resize({res})|value_range(-1, 1)"
               "|keep('image', 'label')"),
        pp_txt=tokenizer.replace("inkey='text'", "inkey='label'"),
        log_steps=1000)
  if arg.stop:
    config["stop_after_steps"] = arg.stop
  return config

"""Shared snippets for the image-text (LiT / SigLIP) configs: port of
big_vision_tpu/configs/proj/image_text/common.py, and the port's stand-in
BERT vocabulary.

`inits` names the published backbone inits, as the JAX configs do; the
port cannot fetch them (the configs take `.npz` files instead).
`stand_in_vocab(path)` writes, where `path` does not exist yet, a
`vocab.txt` of BERT's 30,522 rows (`models/proj/flaxformer/bert.py`):
"[PAD]" (id 0), "[unused0]" ... "[unused98]", "[UNK]", "[CLS]", "[SEP]",
"[MASK]", then the words and punctuation of the COCO stand-in's captions
(`datasets/synthetic.captions`) in sorted order, then "[unused99]" ... to
fill the rows. It returns `path`.
"""

import os

from big_vision_torch.datasets import synthetic
from big_vision_torch.pp.proj.flaxformer import bert_ops

BERT_VOCAB_SIZE = 30_522


def inits(variant):
  """Known public backbone inits for LiT-style training."""
  return {
      # (txt_name, txt_init, img_name, img_init)
      "B": ("base", "bert_base", "B/16", "howto-i21k-B/16"),
      "L": ("large", "bert_large", "L/16", "howto-i21k-L/16"),
  }[variant]


def merge(**kw):
  return dict(kw)


def stand_in_vocab(path):
  """Writes the stand-in `vocab.txt` at `path` unless it exists."""
  if os.path.exists(path):
    return path
  words = sorted({w for label in range(80)
                  for c in synthetic.captions(label, 5)
                  for w in bert_ops.basic_tokenize(c)})
  rows = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
          + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words)
  rows += [f"[unused{i}]" for i in range(99, 99 + BERT_VOCAB_SIZE
                                         - len(rows))]
  os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
  tmp = f"{path}.{os.getpid()}.tmp"
  with open(tmp, "w", encoding="utf-8") as f:
    f.write("\n".join(rows) + "\n")
  os.replace(tmp, path)
  return path

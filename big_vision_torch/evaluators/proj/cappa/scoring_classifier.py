"""The generative ("scoring") classifier: port of
big_vision_tpu/evaluators/proj/cappa/scoring_classifier.py on
`evaluators/mean.py`.

Every class name of the dataset (`CLASS_NAMES`: imagenet2012's CLIP names)
is tokenized once with `pp_txt` (the name under "label", tokens under
"labels"); the predict fn ("score") gets them as `_label_tokens` and
returns per-class scores [B, n_labels]; `prec@1` is the share of images
whose best-scoring class is their label, averaged over the split's valid
rows.

The class names are those of `data["name"]`, as in JAX; the port's
stand-in splits are named for their source ("synthetic"), so `dataset_name`
names the TFDS dataset whose class names they stand in for.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from big_vision_torch.datasets import imagenet
from big_vision_torch.evaluators import mean
from big_vision_torch.pp import builder as pp_builder

CLASS_NAMES = {
    "imagenet2012": imagenet.clip_imagenet_class_names,
}


@functools.lru_cache(maxsize=None)
def get_classes(dataset_name, pp_txt):
  """[n_labels, L]: every class name tokenized with `pp_txt`."""
  to_tokens = pp_builder.get_preprocess_fn(pp_txt)
  rows = [to_tokens({"label": name})["labels"]
          for name in CLASS_NAMES[dataset_name]()]
  return np.array(rows)


def Evaluator(predict_fn, pp_txt, *, data, dataset_name=None,  # pylint: disable=invalid-name
              device="cuda", **kw):
  """Classification accuracy by scoring every class caption."""
  class_tokens = torch.from_numpy(np.asarray(get_classes(
      dataset_name or data["name"], pp_txt))).to(device)

  def prec_at_1(train_state, batch):
    scores = predict_fn(train_state, {"_label_tokens": class_tokens, **batch})
    hit = scores.argmax(dim=-1) == batch["label"]
    return {"prec@1": hit.float()}

  return mean.Evaluator(prec_at_1, data=data, device=device, **kw)

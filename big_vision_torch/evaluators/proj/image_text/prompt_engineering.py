"""Class names and prompt templates for zero-shot classification: port of
big_vision_tpu/evaluators/proj/image_text/prompt_engineering.py.

`canonicalize_text` is the CLIP-style normalization (underscores to
spaces, punctuation dropped but for an exact keep string, whitespace
collapsed, lower case); `get_class_names` reads the CLIP names of
imagenet2012 (and its _v2 and _real sets), of the ImageNet-A and -R label
subsets and of ImageNet-21k from `datasets/imagenet`, or takes a list;
`get_prompt_templates` gives "class_name_only", "clip_paper" or
"clip_best".
"""

from __future__ import annotations

import re

from big_vision_torch.datasets import imagenet as imagenet_data


def canonicalize_text(text, *, keep_punctuation_exact_string=None):
  """Lower case, punctuation dropped (except an exact keep string),
  whitespace collapsed."""
  text = text.replace("_", " ")
  if keep_punctuation_exact_string:
    parts = text.split(keep_punctuation_exact_string)
    parts = [re.sub(r"[^\w\s]", "", p) for p in parts]
    text = keep_punctuation_exact_string.join(parts)
  else:
    text = re.sub(r"[^\w\s]", "", text)
  return re.sub(r"\s+", " ", text).strip().lower()


def get_class_names(dataset_name, source="clip", canonicalize=True):
  """The class names of a dataset; source "clip" takes the CLIP names, a
  list gives the names itself."""
  data = imagenet_data._data()  # pylint: disable=protected-access
  if source == "clip":
    if dataset_name in ("imagenet2012", "imagenet_v2", "imagenet2012_real"):
      names = data["CLIP_IMAGENET_CLASS_NAMES"]
    elif dataset_name == "imagenet_a":
      names = [data["CLIP_IMAGENET_CLASS_NAMES"][i]
               for i in data["IMAGENET_A_LABELSET"]]
    elif dataset_name == "imagenet_r":
      names = [data["CLIP_IMAGENET_CLASS_NAMES"][i]
               for i in data["IMAGENET_R_LABELSET"]]
    elif dataset_name in ("imagenet-21k", "imagenet21k"):
      names = data["IMAGENET21k_CLASS_NAMES"]
    else:
      raise ValueError(f"No clip names for {dataset_name!r}")
  elif isinstance(source, (list, tuple)):
    names = list(source)
  else:
    raise ValueError(f"Unknown class-name source {source!r}")
  if canonicalize:
    names = [canonicalize_text(n) for n in names]
  return names


def get_prompt_templates(name="clip_paper", canonicalize=True):
  data = imagenet_data._data()  # pylint: disable=protected-access
  templates = {
      "class_name_only": ["{}"],
      "clip_paper": data["CLIP_PAPER_PROMPT_TEMPLATES"],
      "clip_best": data["CLIP_BEST_PROMPT_TEMPLATES"],
  }[name]
  if canonicalize:
    templates = [canonicalize_text(t, keep_punctuation_exact_string="{}")
                 for t in templates]
  return templates

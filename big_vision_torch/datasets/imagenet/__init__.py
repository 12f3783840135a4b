"""ImageNet label-space tables: port of
big_vision_tpu/datasets/imagenet/__init__.py.

Pure data (`label_data.json`, a copy of the JAX package's file): the
CLIP-style ImageNet-1k class names, the ImageNet-21k names, the
ImageNet-A/R label subsets and the CLIP prompt templates. Provenance: the
public openai/CLIP release (MIT) as shipped in google-research/big_vision
(big_vision/datasets/imagenet/class_names.py and
evaluators/proj/image_text/prompt_engineering_constants.py).
"""

import functools
import json
import os

_JSON = os.path.join(os.path.dirname(__file__), "label_data.json")


@functools.cache
def _data():
  with open(_JSON) as f:
    return json.load(f)


def __getattr__(name):
  data = _data()
  if name in data:
    return data[name]
  raise AttributeError(name)


def clip_imagenet_class_names():
  return _data()["CLIP_IMAGENET_CLASS_NAMES"]


def imagenet21k_class_names():
  return _data()["IMAGENET21k_CLASS_NAMES"]

"""Classification through a label-space mapping: port of
big_vision_tpu/evaluators/classification_with_labelmap.py on one device.

The model predicts over a large label space (e.g. ImageNet-21k's 21,843
classes) and the eval set is labeled in a smaller one (e.g. ImageNet-1k's
1000); `label_mapping` gives each small-space class its logit column: a
list or array of indices, or a `.json` (a list) or `.npy`/`.npz` (an
array) file. Named mappings are read from `datasets/imagenet/labelmaps.json`
where it exists; neither package has that file yet, so a name raises, as
in the JAX evaluator. Metrics `prec@1` and `loss` over the gathered
columns, as the classification evaluator computes them.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from big_vision_torch.evaluators import classification
from big_vision_torch.evaluators import common
from big_vision_torch.utils import losses

_NAMED_FILE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "datasets", "imagenet", "labelmaps.json")


def resolve_label_mapping(label_mapping):
  """An int32 index array: small-space class -> logit column."""
  if isinstance(label_mapping, (list, tuple, np.ndarray)):
    return np.asarray(label_mapping, np.int32)
  if not isinstance(label_mapping, str):
    raise TypeError(f"Bad label_mapping: {type(label_mapping)}")
  if label_mapping.endswith(".json"):
    with open(label_mapping) as f:
      return np.asarray(json.load(f), np.int32)
  if label_mapping.endswith((".npy", ".npz")):
    arr = np.load(label_mapping)
    if hasattr(arr, "files"):  # an npz holds one array
      arr = arr[arr.files[0]]
    return np.asarray(arr, np.int32)
  if os.path.exists(_NAMED_FILE):
    with open(_NAMED_FILE) as f:
      named = json.load(f)
    if label_mapping in named:
      return np.asarray(named[label_mapping], np.int32)
  raise ValueError(
      f"Unknown label_mapping {label_mapping!r}. Pass an index list, a "
      f".json/.npy file path, or add the mapping under {_NAMED_FILE!r} "
      "(a name -> [logit indices] dict).")


class Evaluator:

  def __init__(self, predict_fn, loss_name, label_mapping,
               label_key="labels", **kw):
    self.get_data_iter, self.steps = common.eval_input_pipeline(**kw)
    self.mapping = resolve_label_mapping(label_mapping)
    self.loss_fn = getattr(losses, loss_name)
    self.label_key = label_key
    self.predict_fn = predict_fn

  def run(self, train_state):
    parts = []
    with torch.no_grad():
      for _, raw in zip(range(self.steps), self.get_data_iter()):
        batch, _ = common.split_batch(raw)
        labels, mask = batch.pop(self.label_key), batch.pop("_mask")
        batch.pop("_id", None)
        index = torch.from_numpy(self.mapping).long().to(labels.device)

        def mapped(ts, b):
          logits, *rest = self.predict_fn(ts, b)
          return (logits.index_select(-1, index), *rest)
        parts.append(classification.batch_sums(
            mapped, self.loss_fn, train_state, batch, labels, mask))
    totals = {k: sum(float(p[k].item()) for p in parts)
              for k in ("prec@1", "loss", "n")}
    yield ("prec@1", totals["prec@1"] / totals["n"])
    yield ("loss", totals["loss"] / totals["n"])

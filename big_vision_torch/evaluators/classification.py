"""Top-1 and loss classification evaluator: port of
big_vision_tpu/evaluators/classification.py on one device.

Each batch gives masked sums of `prec@1`, `loss` and `n`, as the JAX
`get_eval_fn` computes them: the padding rows of the inference pipeline
have `_mask` 0, and rows whose labels are all zero are left out too. The
forward runs under `torch.no_grad` on the batch's device; the sums are
added up in f64 on the host.
"""

from __future__ import annotations

import torch

from big_vision_torch.evaluators import common
from big_vision_torch.utils import losses


def batch_sums(predict_fn, loss_fn, train_state, batch, labels, mask):
  """{"prec@1", "loss", "n"}: masked sums over one batch (device scalars)."""
  logits = predict_fn(train_state, batch)[0]
  mask = mask * labels.max(dim=1).values  # ignore all-zero label rows
  top1 = logits.argmax(dim=1, keepdim=True)
  hit = labels.gather(1, top1).squeeze(1)
  loss = loss_fn(logits=logits, labels=labels, reduction=False)
  return {"prec@1": torch.sum(hit * mask), "loss": torch.sum(loss * mask),
          "n": torch.sum(mask)}


class Evaluator:

  def __init__(self, predict_fn, loss_name, label_key="labels", **kw):
    self.get_data_iter, self.steps = common.eval_input_pipeline(**kw)
    self.label_key = label_key
    self.predict_fn = predict_fn
    self.loss_fn = getattr(losses, loss_name)

  def run(self, train_state):
    parts = []
    data = self.get_data_iter()
    try:
      with torch.no_grad():
        for _, raw in zip(range(self.steps), data):
          batch, _ = common.split_batch(raw)
          mask = batch.pop("_mask")
          labels = batch.pop(self.label_key)
          batch.pop("_id", None)
          parts.append(batch_sums(self.predict_fn, self.loss_fn, train_state,
                                  batch, labels, mask))
    finally:
      if hasattr(data, "close"):
        data.close()
    totals = {k: sum(float(p[k].item()) for p in parts)
              for k in ("prec@1", "loss", "n")}
    for key in ("prec@1", "loss"):
      yield (key, totals[key] / totals["n"])

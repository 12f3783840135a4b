"""Minibatch contrastive health metrics: port of
big_vision_tpu/evaluators/proj/image_text/contrastive.py on one device.

For each eval batch, the predict fn's (zimg, ztxt, out) give the masked
mean of `utils.losses.bidirectional_contrastive_loss` at out["t"] and its
image->text top-1 rate within the batch; both are weighted by the batch's
valid rows and averaged over the split: `loss` and `ncorrect_minibatch`.
"""

from __future__ import annotations

import torch

from big_vision_torch.evaluators import common
from big_vision_torch.utils import losses


class Evaluator:

  def __init__(self, predict_fn, use_global_batch=True, **kw):
    del use_global_batch  # one device holds the whole batch
    self.get_data_iter, self.steps = common.eval_input_pipeline(**kw)
    self.predict_fn = predict_fn

  def run(self, train_state):
    loss, ncorrect, nseen = 0.0, 0.0, 0.0
    with torch.no_grad():
      for _, batch in zip(range(self.steps), self.get_data_iter()):
        batch, _ = common.split_batch(batch)
        zimg, ztxt, out = self.predict_fn(train_state, batch)
        mask = batch.get("_mask")
        l, extras = losses.bidirectional_contrastive_loss(
            zimg, ztxt, out["t"][0], mask=mask, reduction=True)
        n = float(mask.sum()) if mask is not None else zimg.shape[0]
        loss += float(l) * n
        ncorrect += float(extras["ncorrect"]) * n
        nseen += n
    yield ("loss", loss / nseen)
    yield ("ncorrect_minibatch", ncorrect / nseen)

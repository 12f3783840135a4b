"""Mean evaluator: port of big_vision_tpu/evaluators/mean.py on one device.

The predict fn returns {name: per-example values [B, ...]}; each value is
averaged over its trailing axes, then over the split's valid rows
(`_mask`), in f64 on the host.
"""

from __future__ import annotations

import torch

from big_vision_torch.evaluators import common


class Evaluator:

  def __init__(self, predict_fn, **kw):
    self.get_data_iter, self.steps = common.eval_input_pipeline(**kw)
    self.predict_fn = predict_fn

  def run(self, train_state):
    sums, nseen = None, 0.0
    with torch.no_grad():
      for _, batch in zip(range(self.steps), self.get_data_iter()):
        batch, _ = common.split_batch(batch)
        mask = batch["_mask"]
        outputs = self.predict_fn(train_state, batch)
        part = {k: float(torch.sum(v.reshape(v.shape[0], -1).mean(-1)
                                   * mask)) for k, v in outputs.items()}
        nseen += float(mask.sum())
        sums = part if sums is None else {k: sums[k] + part[k] for k in sums}
    for k, v in (sums or {}).items():
      yield (k, v / nseen)

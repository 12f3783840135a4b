"""Save evaluator: port of big_vision_tpu/evaluators/save.py on one device.

Writes the predict fn's outputs (a dict; or its first output, or the
output, as "output") and the batch's tensors on the valid rows to one
`.npz` (`keys` selects entries). `outfile` may hold "{step}": the step of
the train state's optimizer (None without one; the JAX evaluator reads its
global clock's last step).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from big_vision_torch import optim
from big_vision_torch.evaluators import common


class Evaluator:

  def __init__(self, predict_fn, outfile, keys=None, **kw):
    self.get_data_iter, self.steps = common.eval_input_pipeline(**kw)
    self.predict_fn = predict_fn
    self.outfile = outfile
    self.keys = keys

  def run(self, train_state):
    rows = []
    with torch.no_grad():
      for _, batch in zip(range(self.steps), self.get_data_iter()):
        tensors, _ = common.split_batch(batch)
        outputs = self.predict_fn(train_state, tensors)
        if not isinstance(outputs, dict):
          outputs = {"output": outputs[0] if isinstance(outputs, tuple)
                     else outputs}
        mask = tensors["_mask"].cpu().numpy() == 1
        rows.append({k: v.float().cpu().numpy()[mask]
                     if v.is_floating_point() else v.cpu().numpy()[mask]
                     for k, v in {**tensors, **outputs}.items()
                     if self.keys is None or k in self.keys})
    merged = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
    opt = (train_state or {}).get("opt")
    outfile = self.outfile.format(
        step=optim.get_count(opt) if opt is not None else None)
    os.makedirs(os.path.dirname(os.path.abspath(outfile)), exist_ok=True)
    np.savez(outfile, **merged)
    yield ("saved", 1.0)

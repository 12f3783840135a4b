"""Teacher-student distances and their evaluator: port of
big_vision_tpu/evaluators/proj/distill/distance.py on one device.

The kinds (euclidean, l2, hard, kl, logsoftmax_euclidean, agree) are the
distillation loss vocabulary of the distill trainers. Each returns one
distance per example (the feature axis reduced). The `Evaluator` runs a
predict fn giving ((_, student aux), (_, teacher aux)), takes the entries
`what` of the two aux dicts (flattened per example) and yields, for each
distance of `distances`, its mean, min and max over the examples that are
not padding, as `<kind=...>/avg`, `/min` and `/max`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from big_vision_torch.evaluators import common
from big_vision_torch.utils import losses
from big_vision_torch.utils import trees


def _sq_norm(d, axis):
  return (d * d).sum(dim=axis)


def _hard(s, t, *, axis, ls, **_):
  # Cross-entropy against the teacher's (optionally smoothed) argmax.
  pseudo = losses.onehot(t.argmax(dim=axis), t.shape[axis])
  if ls:
    off = ls / (pseudo.shape[-1] - 1)
    pseudo = pseudo * (1.0 - ls - off) + off
  return losses.softmax_xent(logits=s, labels=pseudo, reduction=False,
                             kl=True, axis=axis)


def _kl(s, t, *, axis, t_temp, **_):
  soft_teacher = torch.softmax(t / t_temp, dim=axis)
  xent = losses.softmax_xent(logits=s / t_temp, labels=soft_teacher,
                             reduction=False, kl=True, axis=axis)
  return t_temp ** 2 * xent


def _agree(s, t, *, axis, k, **_):
  def ranks(arr, kk):
    return arr.transpose(axis, -1).topk(kk, dim=-1).indices.transpose(axis,
                                                                      -1)
  return (ranks(s, k) == ranks(t, 1)).sum(dim=axis)


_KINDS = {
    "euclidean": lambda s, t, *, axis, eps, **_:
        torch.sqrt(_sq_norm(s - t, axis) + eps),
    "l2": lambda s, t, *, axis, **_: _sq_norm(s - t, axis),
    "hard": _hard,
    "kl": _kl,
    "logsoftmax_euclidean": lambda s, t, *, axis, eps, **_:
        torch.sqrt(_sq_norm(torch.log_softmax(s, dim=axis)
                            - torch.log_softmax(t, dim=axis), axis) + eps),
    "agree": _agree,
}


def dist(student, teacher, kind, feat_axis=-1, epsilon=1e-12, t=1, ls=0.0,
         k=1):
  """Distance between student and teacher representations."""
  if kind not in _KINDS:
    raise ValueError(f"Unknown distance kind {kind!r}; have {list(_KINDS)}")
  return _KINDS[kind](student, teacher, axis=feat_axis, eps=epsilon,
                      t_temp=t, ls=ls, k=k)


@functools.lru_cache(None)
def get_dist_fn(**kw):
  return functools.partial(dist, **kw)


class Evaluator:
  """Yields per-distance avg/min/max of student-teacher distances."""

  def __init__(self, student_teacher_fwd, distances,
               what=("logits", "logits"), **kw):
    self.get_data_iter, self.steps = common.eval_input_pipeline(**kw)
    self.dist_fns = tuple(get_dist_fn(**d) for d in distances)
    self.dist_names = ["_".join(f"{k}={v}" for k, v in d.items())
                       for d in distances]
    self.what = what
    self.fwd = student_teacher_fwd

  def eval_fn(self, train_state, batch):
    """[distances of each example] for each distance, on the device."""
    (_, out_s), (_, out_t) = self.fwd(train_state, batch)
    repr_s = trees.get(out_s, self.what[0])
    repr_t = trees.get(out_t, self.what[1])
    repr_s = repr_s.reshape(repr_s.shape[0], -1)
    repr_t = repr_t.reshape(repr_t.shape[0], -1)
    return [fn(repr_s, repr_t) for fn in self.dist_fns]

  def run(self, train_state):
    all_ds = [[] for _ in self.dist_names]
    data = self.get_data_iter()
    try:
      with torch.no_grad():
        for _, raw in zip(range(self.steps), data):
          batch, _ = common.split_batch(raw)
          mask = batch.pop("_mask").cpu().numpy()
          batch.pop("_id", None)
          for i, v in enumerate(self.eval_fn(train_state, batch)):
            all_ds[i].append(v.cpu().numpy()[mask == 1])
    finally:
      if hasattr(data, "close"):
        data.close()
    for name, ds in zip(self.dist_names, all_ds):
      ds = np.concatenate(ds)
      yield (f"{name}/avg", float(np.mean(ds)))
      yield (f"{name}/min", float(np.min(ds)))
      yield (f"{name}/max", float(np.max(ds)))

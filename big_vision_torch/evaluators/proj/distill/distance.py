"""Teacher-student distances: port of `dist` and `get_dist_fn` in
big_vision_tpu/evaluators/proj/distill/distance.py.

The kinds (euclidean, l2, hard, kl, logsoftmax_euclidean, agree) are the
distillation loss vocabulary of the distill trainers. Each returns one
distance per example (the feature axis reduced). The module's `Evaluator`
is not ported yet.
"""

from __future__ import annotations

import functools

import torch

from big_vision_torch.utils import losses


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

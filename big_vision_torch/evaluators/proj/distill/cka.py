"""Minibatch CKA between student and teacher representations: port of
big_vision_tpu/evaluators/proj/distill/cka.py on one device.

The minibatch estimator of Nguyen et al. 2021 ("Do Wide and Deep Networks
Learn the Same Things?", eq. 3): over the eval batches, the unbiased
HSIC terms (`hsic1`, Song et al. 2012) of the linear Gram matrices of the
centred representations are summed, and

    CKA = sum_b HSIC1(K_b, L_b)
          / sqrt(sum_b HSIC1(K_b, K_b)) / sqrt(sum_b HSIC1(L_b, L_b)).

The predict fn gives ((_, student aux), (_, teacher aux)); `what` names the
entry of each aux dict (a tap name, "/" into nested dicts), flattened per
example. The unbiased estimator has no room for padding: a padded batch
raises, so the split must be a multiple of the batch size.
"""

from __future__ import annotations

import math

import torch

from big_vision_torch.evaluators import common
from big_vision_torch.utils import trees


def hsic1(gram_k, gram_l):
  """Unbiased HSIC estimator on [n, n] Gram matrices (n >= 4)."""
  n = gram_k.shape[0]
  off = 1.0 - torch.eye(n, dtype=gram_k.dtype, device=gram_k.device)
  k, l = gram_k * off, gram_l * off  # the diagonals zeroed
  ks, ls = k.sum(dim=1), l.sum(dim=1)
  term1 = (k * l).sum()  # tr(K L) for symmetric matrices
  term2 = ks.sum() * ls.sum() / ((n - 1) * (n - 2))
  term3 = 2.0 / (n - 2) * torch.dot(ks, ls)
  return (term1 + term2 - term3) / (n * (n - 3))


class Evaluator:
  """Yields "cka", the minibatch CKA of two forward passes'
  representations."""

  def __init__(self, student_teacher_fwd, what=("logits", "logits"), **kw):
    self.get_data_iter, self.steps = common.eval_input_pipeline(**kw)
    self.fwd = student_teacher_fwd
    self.what = what

  def eval_fn(self, train_state, batch):
    """(HSIC1(S, T), HSIC1(S, S), HSIC1(T, T)) of the batch, on the
    device."""
    (_, out_s), (_, out_t) = self.fwd(train_state, batch)
    xs = trees.get(out_s, self.what[0])
    xt = trees.get(out_t, self.what[1])
    xs = xs.reshape(xs.shape[0], -1).float()
    xt = xt.reshape(xt.shape[0], -1).float()
    xs = xs - xs.mean(dim=0, keepdim=True)
    xt = xt - xt.mean(dim=0, keepdim=True)
    gram_s, gram_t = xs @ xs.T, xt @ xt.T
    return (hsic1(gram_s, gram_t), hsic1(gram_s, gram_s),
            hsic1(gram_t, gram_t))

  def run(self, train_state):
    cross = s_norm = t_norm = 0.0
    data = self.get_data_iter()
    try:
      with torch.no_grad():
        for _, raw in zip(range(self.steps), data):
          batch, _ = common.split_batch(raw)
          mask = batch.pop("_mask")
          batch.pop("_id", None)
          if not bool(mask.all()):
            raise ValueError(
                "CKA does not support batch padding: make the split size a "
                "multiple of the batch size.")
          st, ss, tt = (float(v) for v in self.eval_fn(train_state, batch))
          cross += st
          s_norm += ss
          t_norm += tt
    finally:
      if hasattr(data, "close"):
        data.close()
    yield ("cka", cross / (math.sqrt(s_norm) * math.sqrt(t_norm) + 1e-12))

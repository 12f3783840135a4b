"""Few-shot linear-probe evaluator (closed-form ridge regression): port of
big_vision_tpu/evaluators/fewshot_lsr.py on one device.

Representations are computed on the device under `torch.no_grad` (the
predict fn's aux dict entry `representation_layer`, e.g. "pre_logits", or
its first output); the L2-regularized least-squares fit stays in numpy on
the host, as in the JAX package: one eigendecomposition of the whitened
features (of x^T x where there are at least as many examples as features,
else of x x^T), then the classifier for the given l2 in closed form. For
each dataset, shot count and seed, `shot` training examples of each class
are drawn with `np.random.default_rng(seed)`; the accuracy on the test set
is averaged over the seeds and written as `a/<dataset>_<shot>shot` for the
pairs in `display_first`, `z/...` for the others.
"""

from __future__ import annotations

import numpy as np
import torch

from big_vision_torch.evaluators import common

BIAS_CONSTANT = 100.0


def _precompute_cache(x, y, num_classes):
  """Whiten, add a bias feature, eigendecompose."""
  mean = x.mean(axis=0, keepdims=True)
  std = x.std(axis=0, keepdims=True) + 1e-5
  x = (x - mean) / std
  x = np.pad(x, ((0, 0), (0, 1)), constant_values=BIAS_CONSTANT)
  y = 2.0 * (np.arange(num_classes) == y[:, None]).astype(np.float32) - 1.0

  n, d = x.shape
  if n >= d:
    eigs, q = np.linalg.eigh(x.T @ x)
    rhs = q.T @ (x.T @ y)
    lhs = q
  else:
    eigs, q = np.linalg.eigh(x @ x.T)
    rhs = q.T @ y
    lhs = x.T @ q
  return dict(eigs=eigs, rhs=rhs, lhs=lhs, mean=mean, std=std)


def _fewshot_acc(cache, x_test, y_test, l2_reg):
  x_test = (x_test - cache["mean"]) / cache["std"]
  x_test = np.pad(x_test, ((0, 0), (0, 1)), constant_values=BIAS_CONSTANT)
  scaling = (1.0 / (cache["eigs"] + l2_reg))[None, :]
  w = (cache["lhs"] * scaling) @ cache["rhs"]
  preds = np.argmax(x_test @ w, axis=1)
  return float(np.mean(preds == y_test))


class Evaluator:
  """cfg: datasets={name: dict(data_train=..., data_test=..., pp (or
  pp_train and pp_eval), num_classes)}, shots=(1, 5, 10, 25), l2_reg,
  num_seeds."""

  def __init__(self, predict_fn, batch_size, device, datasets, shots,
               l2_reg=2.0 ** 10, num_seeds=3, display_first=None,
               label_key="label", representation_layer=None, **kw):
    del kw
    self.shots = tuple(shots)
    self.l2_reg = l2_reg
    self.num_seeds = num_seeds
    self.label_key = label_key
    self.display_first = display_first
    self.predict_fn = predict_fn
    self.representation_layer = representation_layer

    self.pipelines = {}
    for name, ds in datasets.items():
      ds = dict(ds)
      num_classes = ds.pop("num_classes")
      train_pipe = common.eval_input_pipeline(
          data=ds["data_train"], pp_fn=ds.get("pp_train", ds.get("pp")),
          batch_size=batch_size, device=device)
      test_pipe = common.eval_input_pipeline(
          data=ds["data_test"], pp_fn=ds.get("pp_eval", ds.get("pp")),
          batch_size=batch_size, device=device)
      self.pipelines[name] = (train_pipe, test_pipe, num_classes)

  def represent(self, train_state, batch):
    """The representations of one batch (on its device)."""
    out = self.predict_fn(train_state, batch)
    if self.representation_layer is not None:
      # Taken from the predict fn's aux dict (e.g. "pre_logits").
      aux = out[-1] if isinstance(out, tuple) else out
      return aux[self.representation_layer]
    return out[0] if isinstance(out, tuple) else out

  def _embed(self, train_state, pipe):
    """(features [n, d], labels [n]) in numpy, padding left out."""
    get_iter, steps = pipe
    xs, ys = [], []
    data = get_iter()
    try:
      with torch.no_grad():
        for _, raw in zip(range(steps), data):
          batch, _ = common.split_batch(raw)
          mask = batch.pop("_mask").cpu().numpy().astype(bool)
          labels = batch.pop(self.label_key).cpu().numpy()
          batch.pop("_id", None)
          z = self.represent(train_state, batch).float().cpu().numpy()
          xs.append(z[mask])
          ys.append(labels[mask])
    finally:
      if hasattr(data, "close"):
        data.close()
    return np.concatenate(xs), np.concatenate(ys)

  def run(self, train_state):
    for name, (train_pipe, test_pipe, num_classes) in self.pipelines.items():
      x_tr, y_tr = self._embed(train_state, train_pipe)
      x_te, y_te = self._embed(train_state, test_pipe)
      for shot in self.shots:
        accs = []
        for seed in range(self.num_seeds):
          rng = np.random.default_rng(seed)
          idx = []
          for cls in range(num_classes):
            cls_idx = np.nonzero(y_tr == cls)[0]
            if len(cls_idx) == 0:
              continue
            take = min(shot, len(cls_idx))
            idx.extend(rng.choice(cls_idx, take, replace=False))
          idx = np.asarray(idx)
          cache = _precompute_cache(x_tr[idx], y_tr[idx], num_classes)
          accs.append(_fewshot_acc(cache, x_te, y_te, self.l2_reg))
        key = f"{name}_{shot}shot"
        if self.display_first and (name, shot) in [
            tuple(p) for p in self.display_first]:
          yield (f"a/{key}", float(np.mean(accs)))
        else:
          yield (f"z/{key}", float(np.mean(accs)))

"""GSAM, surrogate-gap guided sharpness-aware minimization (arXiv:2203.08065):
port of big_vision_tpu/trainers/proj/gsam/gsam.py on one device.

  python -m big_vision_torch.trainers.proj.gsam.train --workdir <dir> \
      --config big_vision_torch/configs/proj/gsam/smoke.py [--device cpu]

`gsam_gradient` is the two-gradient core, on {JAX name: tensor} dicts: the
clean gradient; the weights moved along it, normalized, by a rho that
follows the learning rate from `rho_max` (at `lr_max`) to `rho_min` (at
`lr_min`); the gradient there; and the part of one gradient orthogonal to
the other, scaled by `alpha`, taken out of it (`minimize_fp`) or added to
it. `rho_max` = `rho_min` and `alpha` = 0 reduce it to SAM.

`Trainer` is the twin of the JAX trainer's `update_fn`: the step is the
optimizer's count before the update, the learning rate `config.lr` times
the first schedule at that step, and both passes of a step draw the same
dropout masks (each pass builds the step's generator anew from the seed
and the step, as JAX reuses `step_rng`). `lr_max` and `lr_min` are
`config.gsam`'s where it names them; else `config.lr` and `config.lr` x
`lr_min_ratio` (0 by default). The JAX trainer passes its own values and
also the config's, so a config that names them (vit_i1k_gsam_no_aug.py)
raises a TypeError there. A step measures `training_loss` (the clean
loss) and `l2_grads` (of the GSAM gradient). The JAX trainer neither
mixes up a batch nor sets `init_head_bias`; the port refuses both keys.
The loop, its metric rows, evals and checkpoints are
`big_vision_torch/train.py`'s.
"""

from __future__ import annotations

import numpy as np
import torch

from big_vision_torch import input_pipeline
from big_vision_torch import optim
from big_vision_torch import train
from big_vision_torch.utils import convert


def _vdot(xs, ys):
  """sum over the leaves of <x, y>, in f32."""
  return torch.stack([torch.vdot(x.reshape(-1), y.reshape(-1))
                      for x, y in zip(xs, ys)]).sum()


def dual_vector(y):
  """(y / ||y||, ||y||) over the whole dict."""
  norm = torch.sqrt(_vdot(y.values(), y.values()))
  return {k: x / norm for k, x in y.items()}, norm


def value_and_grad(loss_fn, params, inputs, targets):
  """(loss, {name: d loss / d param}) of loss_fn(params, inputs, targets)
  at the values of `params`; a param the loss does not reach has a zero
  gradient, as in JAX."""
  with torch.enable_grad():
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = loss_fn(p, inputs, targets)
    grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
  return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                         for (k, v), g in zip(params.items(), grads)}


@torch.no_grad()
def gsam_gradient(loss_fn, params, inputs, targets, *, rho_max, rho_min,
                  alpha, lr, lr_max, lr_min, eps=1e-12,
                  adaptive_perturbation=False, minimize_fp=True):
  """(clean loss, GSAM gradient {name: tensor}); see the module docstring.

  `loss_fn(params, inputs, targets)` is differentiable in the tensors of
  `params`; `lr` is this step's learning rate (a float).
  """
  l_clean, g_clean = value_and_grad(loss_fn, params, inputs, targets)
  _, g_clean_length = dual_vector(g_clean)

  if lr_max == lr_min:
    sam_rho = rho_max
  else:
    sam_rho = rho_min + (rho_max - rho_min) * (lr - lr_min) / (lr_max - lr_min)

  if adaptive_perturbation:
    param_sam = {k: a + torch.abs(a) * sam_rho * g_clean[k]
                 / (g_clean_length + eps) for k, a in params.items()}
  else:
    param_sam = {k: a + sam_rho * g_clean[k] / (g_clean_length + eps)
                 for k, a in params.items()}

  _, g_robust = value_and_grad(loss_fn, param_sam, inputs, targets)
  del param_sam

  if minimize_fp:
    g_robust_normalized, _ = dual_vector(g_robust)
    proj = _vdot(g_robust_normalized.values(), g_clean.values())
    g_clean_residual = {k: a - proj * g_robust_normalized[k]
                        for k, a in g_clean.items()}
    g_gsam = {k: a - g_clean_residual[k] * alpha
              for k, a in g_robust.items()}
  else:
    g_clean_normalized, _ = dual_vector(g_clean)
    proj = _vdot(g_clean_normalized.values(), g_robust.values())
    g_robust_residual = {k: a - proj * g_clean_normalized[k]
                         for k, a in g_robust.items()}
    g_gsam = {k: a + g_robust_residual[k] * alpha
              for k, a in g_clean.items()}
  return l_clean, g_gsam


def gsam_kwargs(config):
  """The keyword arguments of `gsam_gradient` that the config fixes: its
  `gsam` block, with `lr_max` and `lr_min` from it where it names them,
  else `lr` and `lr` x `lr_min_ratio`."""
  kw = dict(config["gsam"])
  ratio = kw.pop("lr_min_ratio", 0.0)
  kw.setdefault("lr_max", config["lr"])
  kw.setdefault("lr_min", config["lr"] * ratio)
  return kw


class Trainer(train.Trainer):
  """The classification trainer with the GSAM gradient in its update."""

  def __init__(self, config, **kw):
    super().__init__(config, **kw)
    self.port_names = {j: p for p, j in convert.names(self.model).items()}
    self.gsam_kw = gsam_kwargs(self.config)

  def check_config(self, config):
    super().check_config(config)
    if "gsam" not in config:
      raise ValueError("config key 'gsam' is missing: the GSAM trainer "
                       "needs rho_max, rho_min and alpha")
    if dict(config.get("mixup") or {}).get("p"):
      raise ValueError("config key 'mixup' is not ported by the GSAM "
                       "trainer (the JAX one does not mix up)")
    if config.get("init_head_bias") is not None:
      raise ValueError("config key 'init_head_bias' is not ported by the "
                       "GSAM trainer (the JAX one does not set it)")

  def loss_at(self, params, images, labels, step):
    """The config's loss of the model at `params` {JAX name: tensor}, with
    the dropout masks of `step`."""
    rng = None
    if train._draws_in_training(self.model):
      rng = input_pipeline.step_generator(self.seed + 1, step, self.device)
    logits, _ = torch.func.functional_call(
        self.model, {self.port_names[k]: v for k, v in params.items()},
        (images,), {"train": True, "rng": rng})
    return self.loss_fn(logits=logits, labels=labels)

  def learning_rate(self, step):
    """`config.lr` times the first schedule at `step` (in f32, as the
    optimizer reads it)."""
    return self.config["lr"] * float(np.float32(self.sched_fns[0](step)))

  def update(self, batch):
    """One GSAM step; returns its measurements (device scalars)."""
    step = optim.get_count(self.opt_state)
    loss, grads = gsam_gradient(
        lambda p, x, y: self.loss_at(p, x, y, step), self.params,
        batch["image"], batch["labels"], lr=self.learning_rate(step),
        **self.gsam_kw)
    _, self.opt_state = self.tx.apply_(self.params, grads, self.opt_state)
    with torch.no_grad():
      return {"training_loss": loss, "l2_grads": train.l2(grads.values())}


def main(argv=None):
  return train.main(argv, trainer_cls=Trainer, description=__doc__)


if __name__ == "__main__":
  main()

"""Jet trainer (a normalizing flow by maximum likelihood, in bits/dim):
port of big_vision_tpu/trainers/proj/jet/train.py on one device.

  python -m big_vision_torch.trainers.proj.jet.train \
      --config big_vision_torch/configs/proj/jet/smoke.py \
      --workdir <dir> [--device cpu]

The model is the config's `model_name` (proj.jet.jet), built for the image
shape of the config's `init_shapes` [(1, H, W, C)]. A step is the JAX
`update_fn`: the batch's images plus uniform dequantization noise of one
bin (`bin_width` = (hi - lo) / 255 of `data_range`, default (0, 1)) drawn
from the step's generator of (seed + 1, the optimizer's count), the flow's
latents and log-determinant, and the loss `nll_bits_per_dim` averaged over
the batch; a class-conditional flow (a one-hot [B, K] "label") gets the
label as one context token, dropped for the whole batch with probability
`condition_drop_prob`. The measurements: `training_loss` and
`bits_per_dim` (the loss), `bits`, `nll`, `logdet`, `l2_grads` (frozen
params' gradients as 0), `l2_params` and `l2_updates`. A `schedule` that
is not a list becomes [(".*FREEZE_ME.*", None), (".*", schedule)]: the
coupling masks are always frozen.

The evaluators get the predict fn "bits_per_dim" (`bpd_fn`: half-bin
dequantization, no context drop) for the `mean` evaluator. The loop,
resume, `model_init` through `jet.load`, checkpoints and the metric rows
are `big_vision_torch/train.py`'s.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from big_vision_torch import input_pipeline
from big_vision_torch import optim
from big_vision_torch import train
from big_vision_torch.models.proj.jet import jet


def nll_bits_per_dim(z, logdet, bin_width=1.0 / 256.0):
  """-log p(x) in bits/dim of data dequantized to bins of `bin_width` under
  a standard normal prior on the latents `z` [B, ...] and the flow's
  `logdet` [B]: (bits, nll, logdet) per example, each normalized to bits
  per dim."""
  ndims = int(np.prod(z.shape[1:]))
  logp_z = -0.5 * (z ** 2 + math.log(2 * math.pi)).sum(
      dim=tuple(range(1, z.dim())))
  nll_nats = -logp_z - ndims * math.log(bin_width)
  normalizer = ndims * math.log(2.0)
  return ((nll_nats - logdet) / normalizer, nll_nats / normalizer,
          logdet / normalizer)


def frozen_schedule(schedule):
  """The JAX trainer's default: the masks frozen, the rest on `schedule`
  (a list of (regex, schedule) pairs is taken as it is)."""
  if isinstance(schedule, (list, tuple)):
    return schedule
  return [(".*FREEZE_ME.*", None), (".*", dict(schedule))]


class Trainer(train.Trainer):
  """The Jet update on the loop of `train.py`."""
  MODEL_NAME = ("proj.jet.jet",)
  MODEL_MODULE = jet

  def __init__(self, config, **kw):
    train.import_pp_modules(config)
    config = dict(config)
    config["schedule"] = frozen_schedule(config.get(
        "schedule", dict(decay_type="cosine")))
    lo, hi = config.get("data_range", (0.0, 1.0))
    self.bin_width = (hi - lo) / 255.0
    super().__init__(config, **kw)

  def check_config(self, config):
    super().check_config(config)
    if config.get("mixup") and dict(config["mixup"]).get("p"):
      raise ValueError("config key 'mixup' is not ported by the Jet trainer "
                       "(the JAX one does not read it)")

  def build_model(self, res, channels):
    """The config's flow for the `init_shapes` image, with a context token
    of the labels' width where the batches carry one-hot labels."""
    del res, channels
    (_, h, w, c), *_ = self.config["init_shapes"]
    label = input_pipeline.element_spec(self.config["input"]).get("label")
    context_dim = label[0][0] if label and len(label[0]) == 1 else None
    return jet.Model(**self.config.get("model", {}), image_shape=(h, w, c),
                     context_dim=context_dim, device=self.device)

  def step_generator(self):
    """The step's generator of (seed + 1, the optimizer's count)."""
    return input_pipeline.step_generator(
        self.seed + 1, optim.get_count(self.opt_state), self.device)

  def dequant_noise(self, x, rng):
    """Uniform noise of one bin's width, x's shape."""
    return torch.rand(x.shape, generator=rng, device=x.device) * (
        self.bin_width)

  def context(self, batch, rng=None):
    """A one-hot [B, K] label as one context token [B, 1, K], zeroed for
    the whole batch with probability `condition_drop_prob` when `rng` is
    given; None without labels."""
    label = batch.get("label")
    if label is None or label.dim() != 2:
      return None
    context = label[:, None, :].float()
    if rng is not None:
      u = torch.rand((), generator=rng, device=label.device)
      drop = self.config.get("condition_drop_prob", 0.1) > u
      context = context * (~drop)
    return context

  def loss_and_grads(self, batch):
    """(loss, {JAX name: gradient}, measures) of one batch."""
    rng = self.step_generator()
    for p in self.params.values():
      p.grad = None
    x = batch["image"]
    x = x + self.dequant_noise(x, rng)
    z, logdet = self.model(x, context=self.context(batch, rng))
    bits, nll, ld = nll_bits_per_dim(z, logdet, self.bin_width)
    loss = bits.mean()
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in self.params.items()}
    return loss.detach(), grads, {"bits": loss.detach(),
                                  "nll": nll.mean().detach(),
                                  "logdet": ld.mean().detach()}

  def predict_fns(self):
    def bpd_fn(train_state, batch):
      del train_state  # the model holds the params
      x = batch["image"] + 0.5 * self.bin_width  # half-bin dequantization
      z, logdet = self.model(x, context=self.context(batch))
      bits, nll, ld = nll_bits_per_dim(z, logdet, self.bin_width)
      return {"bits_per_dim": bits, "nll": nll, "logdet": ld}
    return {"bits_per_dim": bpd_fn}

  def update(self, batch):
    """One step; returns its measurements (device scalars)."""
    loss, grads, measures = self.loss_and_grads(batch)
    updates, self.opt_state = self.tx.apply_(self.params, grads,
                                             self.opt_state)
    with torch.no_grad():
      return {"training_loss": loss, "bits_per_dim": loss, **measures,
              "l2_grads": train.l2(grads.values()),
              "l2_params": train.l2(self.params.values()),
              "l2_updates": train.l2(updates.values())}


def main(argv=None):
  return train.main(argv, trainer_cls=Trainer, description=__doc__)


if __name__ == "__main__":
  main()

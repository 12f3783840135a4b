"""CapPa trainer (captioning, autoregressive or by parallel prediction):
port of big_vision_tpu/trainers/proj/cappa/generative.py on one device.

  python -m big_vision_torch.trainers.proj.cappa.generative \
      --config big_vision_torch/configs/proj/cappa/smoke.py \
      --workdir <dir> [--device cpu]

The model is the config's `model_name` (proj.cappa.cappa), built for the
image size of the config's `init_shapes` [(1, res, res, c), (1, text_len)]
and drawn from the seed with the JAX model's initializers. A step is the
JAX `update_fn`: the logits of `model(image, labels, train=True)` (the
parallel-prediction draws, where `masked_pred_prob` > 0, and any dropout
from the step's generator of (seed + 1, the optimizer's count)); the
softmax CE of each caption over its non-PAD tokens (`pad_token`, 0) times
`label_masks` where the batch has them, with `label_smoothing`, divided by
the kept length and averaged over the batch; the measurements
`training_loss` and `l2_grads`.

The evaluators get the predict fns "perplexity", "score" and "enc_rep"
(`trainers/proj/cappa/predict_fns.py`), keyed by each eval's `pred`. The
loop, the resume ladder (the workdir's `-LAST`, else `resume`, else
`model_init` through `cappa.load` with `model_load`, else the seed),
checkpoints, the initial evals with `skip_first` and their chrono pauses,
`stop_after_steps` and the metric rows are `big_vision_torch/train.py`'s.
"""

from __future__ import annotations

import torch

from big_vision_torch import input_pipeline
from big_vision_torch import optim
from big_vision_torch import train
from big_vision_torch.models.proj.cappa import cappa
from big_vision_torch.trainers.proj.cappa import predict_fns as cappa_predict
from big_vision_torch.utils import losses

PP_MODULES = ("ops_general", "ops_image", "ops_text")


def caption_loss(logits, labels, *, pad_token=0, label_masks=None,
                 label_smoothing=0.0):
  """The JAX `loss_fn`'s weighted CE: per caption over its non-PAD tokens
  (times `label_masks`), divided by their count, averaged over the
  batch."""
  weights = (labels != pad_token).float()
  if label_masks is not None:
    weights = weights * label_masks
  return losses.weighted_softmax_xent(
      logits=logits, labels=labels, weights=weights,
      label_smoothing=label_smoothing, reduction=True, normalize=True)


class Trainer(train.Trainer):
  """The CapPa update on the loop of `train.py`."""
  MODEL_NAME = ("proj.cappa.cappa",)
  MODEL_MODULE = cappa

  def __init__(self, config, **kw):
    train.import_pp_modules(config, PP_MODULES)
    super().__init__(config, **kw)

  def check_config(self, config):
    super().check_config(config)
    for key in ("mixup", "init_head_bias"):
      if config.get(key) and (key != "mixup" or dict(config[key]).get("p")):
        raise ValueError(f"config key {key!r} is not ported by the CapPa "
                         "trainer (the JAX one does not read it)")

  def build_model(self, res, channels):
    """The config's model for images of the `init_shapes` size."""
    (_, res, _, channels), _ = self.config["init_shapes"]
    return cappa.Model(**self.config.get("model", {}), image_size=res,
                       channels=channels, device=self.device)

  def _rng(self):
    """The step's generator of the parallel-prediction draws and dropout,
    or None where the model draws nothing."""
    cfg = self.config.get("model", {})
    if not any(cfg.get(k) for k in ("masked_pred_prob", "enc_dropout_rate",
                                     "dec_dropout_rate")):
      return None
    return input_pipeline.step_generator(
        self.seed + 1, optim.get_count(self.opt_state), self.device)

  def loss_and_grads(self, batch):
    """(loss, {JAX name: gradient}) of one batch."""
    for p in self.params.values():
      p.grad = None
    logits = self.model(batch["image"], batch["labels"], train=True,
                        rng=self._rng())
    loss = caption_loss(
        logits, batch["labels"], pad_token=self.config.get("pad_token", 0),
        label_masks=batch.get("label_masks"),
        label_smoothing=self.config.get("label_smoothing", 0.0))
    del logits
    loss.backward()
    return loss.detach(), {n: p.grad if p.grad is not None
                           else torch.zeros_like(p)
                           for n, p in self.params.items()}

  def predict_fns(self):
    # Bound late: `check_config` asks for the names before the model exists.
    def late(name):
      return lambda *a, **kw: cappa_predict.get_predict_fns(self.model)[
          name](*a, **kw)
    return {name: late(name) for name in ("perplexity", "score", "enc_rep")}

  def update(self, batch):
    """One step; returns its measurements (device scalars)."""
    loss, grads = self.loss_and_grads(batch)
    with torch.no_grad():
      l2_grads = train.l2(grads.values())
    _, self.opt_state = self.tx.apply_(self.params, grads, self.opt_state)
    return {"training_loss": loss, "l2_grads": l2_grads}


def main(argv=None):
  return train.main(argv, trainer_cls=Trainer, description=__doc__)


if __name__ == "__main__":
  main()

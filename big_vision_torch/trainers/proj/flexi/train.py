"""FlexiViT trainer: port of big_vision_tpu/trainers/proj/flexi/train.py.

  python -m big_vision_torch.trainers.proj.flexi.train \
      --config big_vision_torch/configs/proj/flexivit/i21k_sup.py \
      --workdir <dir> [--device cpu]

Each step draws its flexi args (the token grid `seqhw`) from the config's
values and weights with numpy's PCG64 seeded by (0, 0, step), as the JAX
trainer does, so both draw the same seqhw at every step. The update is the
JAX `update_fn`: mixup of images and labels (when the config's
`mixup.p` > 0), the model at the drawn grid, the config's loss, its
gradients and the optimizer of `optim.make`; it measures `training_loss`
and `l2_grads`. The loop, the metric writer and the refusal of unported
config keys are `big_vision_torch/train.py`'s. `update(batch, seqhw=...)`
takes the flexi args explicitly, so that a caller can choose them.

Evaluators take the JAX trainer's predict fns: one per combination of
the flexi args' values, "predict_seqhw=15" and so on (`mkpredictfns`), each
giving the model's (logits, {..., "pre_logits": ...}) at that grid.

Checkpoints, `resume` and `model_init` (through the FlexiViT `load`, which
resizes the posemb and the patch kernel) are the classification trainer's.
Unlike the JAX flexi trainer, which builds its params with `model.init`
alone, the port fills the head's bias with the config's `init_head_bias`,
as the classification trainer does.
"""

from __future__ import annotations

from big_vision_torch import train
from big_vision_torch.models.proj.flexi import vit as flexi_vit
from big_vision_torch.trainers.proj.flexi import common as flexi
from big_vision_torch.utils import schedules


class Trainer(train.Trainer):
  """`train.Trainer` with the FlexiViT model, flexi args and mixup."""
  MODEL_NAME = "proj.flexi.vit"
  MODEL_MODULE = flexi_vit
  PREDICT_TEMPLATE = "predict_{x}"  # the names of the predict fns

  def build_model(self, res, channels):
    del res  # the token grid, not the image size, sets the sequence
    return flexi_vit.Model(num_classes=self.config["num_classes"],
                           channels=channels, device=self.device,
                           **self.config.get("model", {}))

  def predict_fns(self):
    """{name: fn(train_state, batch) -> (logits, out)}: the model at each
    combination of the flexi args' values, named from PREDICT_TEMPLATE
    ("predict_seqhw=15", ...) as the JAX trainer names them."""
    def predict_fn(train_state, batch, **flexi_kw):
      del train_state  # the model holds the params
      return self.model(batch["image"], **flexi_kw)
    return flexi.mkpredictfns(predict_fn, self.config["flexi"],
                              self.PREDICT_TEMPLATE)

  def step_kwargs(self, step):
    """The flexi args of `step`, drawn as the JAX trainer draws them."""
    rng = flexi.mkrng(-1, -1, step)
    cfg = self.config["flexi"]
    return {name: int(flexi.choice(cfg[name]["v"], cfg[name]["p"], rng))
            for name in sorted(cfg)}

  def loss_and_grads(self, batch, **flexi_kw):
    """(loss, {JAX name: gradient}) at the given flexi args; mixup first
    when the config asks for it, with a ~ Beta(p, p) drawn from a CPU
    generator seeded from (seed, optimizer step)."""
    images, labels = batch["image"], batch["labels"]
    mixup = dict(self.config.get("mixup") or {})
    if mixup.get("p"):
      (images, labels), _ = schedules.mixup(self.mixup_generator(), images,
                                            labels, **mixup)
    for p in self.params.values():
      p.grad = None
    logits, _ = self.model(images, train=True, **flexi_kw)
    loss = self.loss_fn(logits=logits, labels=labels)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in self.params.items()}

  def update(self, batch, **flexi_kw):
    """One training step at the given flexi args (e.g. `seqhw=15`);
    returns its measurements (device scalars)."""
    loss, grads = self.loss_and_grads(batch, **flexi_kw)
    _, self.opt_state = self.tx.apply_(self.params, grads, self.opt_state)
    return {"training_loss": loss, "l2_grads": train.l2(grads.values())}


def main(argv=None):
  return train.main(argv, trainer_cls=Trainer, description=__doc__)


if __name__ == "__main__":
  main()

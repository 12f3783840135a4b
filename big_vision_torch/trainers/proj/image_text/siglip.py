"""SigLIP trainer (sigmoid contrastive image-text training): port of
big_vision_tpu/trainers/proj/image_text/siglip.py on one device.

  python -m big_vision_torch.trainers.proj.image_text.siglip \
      --config big_vision_torch/configs/proj/image_text/siglip_smoke.py \
      --workdir <dir> [--device cpu]

The model is the config's `model_name`, as in JAX: the two-tower model
(`models/proj/image_text/two_towers.py`, the default), built for the
config's `init_shapes` (the image size and the text length), or CLIPPO's
one tower (`models/proj/clippo/one_tower.py`), whose `init_shapes` are two
image shapes and whose "labels" are rendered-text images. A step is the JAX
`update_fn`: the towers embed the batch's "image" and "labels" in training
mode, with the dropout generator of the step from (seed + 1, the
optimizer's count); the loss is `parallel/contrastive.py`'s SigLIP loss at
t = exp(t) and the bias b (0 without one), `loss_impl` "chunked" (the
default) or "global"; the gradients of every param, the frozen image tower
of LiT included (JAX differentiates all params and only the optimizer's
frozen schedule drops their updates), so `l2_grads` covers them; the
measures `training_loss`, `t`, `b` (with a bias), `l2_grads` and
`l2_params` (after the update).

The evaluators get the JAX trainer's predict fns: "predict" ((zimg, ztxt,
out) of whichever of "image" and "labels" the batch holds), "loss" (the
config's `loss` of the image embedding as logits), "img" and "txt". The
loop, resume, `model_init` with `model_load`, checkpoints and the metric
rows are `big_vision_torch/train.py`'s.
"""

from __future__ import annotations

import torch

from big_vision_torch import input_pipeline
from big_vision_torch import optim
from big_vision_torch import train
from big_vision_torch.models.proj.clippo import one_tower
from big_vision_torch.models.proj.image_text import two_towers
from big_vision_torch.parallel import contrastive

PP_MODULES = ("ops_general", "ops_image", "ops_text")
# config["model_name"] -> the port's model module.
MODELS = {"proj.image_text.two_towers": two_towers,
          "proj.clippo.one_tower": one_tower}


def _draws_in_training(model):
  """Whether a tower draws dropout masks in training."""
  return any(getattr(getattr(model, t, None), "dropout", 0)
             for t in ("img", "txt"))


def predict_fns(model, loss_fn):
  """The JAX SigLIP trainer's predict fns over `model` (which holds the
  params; `train_state` is not read)."""
  def predict(train_state, batch, **kw):
    del train_state
    return model(batch.get("image"), batch.get("labels"), **kw)

  def loss(train_state, batch):
    del train_state
    zimg, _, _ = model(batch["image"])
    return {"loss": loss_fn(logits=zimg, labels=batch["labels"],
                            reduction=False)}

  return {
      "predict": predict,
      "loss": loss,
      "img": lambda ts, batch, **kw: predict(ts, {"image": batch["image"]},
                                             **kw),
      "txt": lambda ts, batch, **kw: predict(ts, {"labels": batch["labels"]},
                                             **kw),
  }


class Trainer(train.Trainer):
  """The SigLIP update on the loop of `train.py`."""
  MODEL_NAME = tuple(MODELS)

  def __init__(self, config, **kw):
    train.import_pp_modules(config, PP_MODULES)
    super().__init__(config, **kw)
    impl = self.config.get("loss_impl", "chunked")
    if impl not in ("chunked", "global"):
      raise ValueError(f"config key 'loss_impl'={impl!r}: chunked or global")
    self.siglip_loss = (contrastive.siglip_loss_fn() if impl == "chunked"
                        else contrastive.global_siglip_loss)

  def check_config(self, config):
    super().check_config(config)
    for key in ("mixup", "init_head_bias"):
      if config.get(key) and (key != "mixup" or dict(config[key]).get("p")):
        raise ValueError(f"config key {key!r} is not ported by the SigLIP "
                         "trainer (the JAX one does not read it)")

  def model_module(self):
    return MODELS[self.config.get("model_name", self.MODEL_NAME[0])]

  def build_model(self, res, channels):
    """The model for the config's `init_shapes`: [(1, res, res, c), (1,
    text_len)] of two towers, two image shapes of one tower. A NaFlex image
    tower's shape [(1, N, p*p*c)] names no image size."""
    del res, channels
    image_shape, text_shape = self.config["init_shapes"]
    kw = dict(device=self.device)
    if len(image_shape) == 4:
      kw.update(image_size=image_shape[1], channels=image_shape[3])
    if self.model_module() is two_towers:
      kw["text_len"] = text_shape[1]
    return self.model_module().Model(**self.config.get("model", {}), **kw)

  def loss_and_grads(self, batch):
    """(loss, {JAX name: gradient}, {"t", "b"}) of one batch."""
    rng = None
    if _draws_in_training(self.model):
      rng = input_pipeline.step_generator(
          self.seed + 1, optim.get_count(self.opt_state), self.device)
    for p in self.params.values():
      p.grad = None
    zimg, ztxt, out = self.model(batch["image"], batch["labels"], train=True,
                                 rng=rng)
    b = out["b"][0] if "b" in out else torch.zeros((), device=zimg.device)
    loss = self.siglip_loss(zimg, ztxt, out["t"][0], b)
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in self.params.items()}
    return loss.detach(), grads, {k: out[k].detach()[0] for k in ("t", "b")
                                  if k in out}

  def predict_fns(self):
    # Bound late: `check_config` asks for the names before the model and
    # the loss exist.
    return predict_fns(lambda *a, **kw: self.model(*a, **kw),
                       lambda **kw: self.loss_fn(**kw))

  def update(self, batch):
    """One SigLIP step; returns its measurements (device scalars)."""
    loss, grads, scalars = self.loss_and_grads(batch)
    _, self.opt_state = self.tx.apply_(self.params, grads, self.opt_state)
    with torch.no_grad():
      return {"training_loss": loss, **scalars,
              "l2_grads": train.l2(grads.values()),
              "l2_params": train.l2(self.params.values())}


def main(argv=None):
  return train.main(argv, trainer_cls=Trainer, description=__doc__)


if __name__ == "__main__":
  main()

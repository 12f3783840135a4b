"""FlexiViT distillation: port of big_vision_tpu/trainers/proj/flexi/distill.py.

  python -m big_vision_torch.trainers.proj.flexi.distill \
      --config big_vision_torch/configs/proj/flexivit/i21k_distill.py \
      --workdir <dir> [--device cpu]

A FlexiViT student is distilled from frozen teachers (the FlexiViT paper's
main recipe). Each step draws the student's flexi args (`seqhw`) as the
FlexiViT trainer does; the teachers run in eval mode without gradients,
each on `data[name]` if the batch has it, else on the image, and the
student at the drawn seqhw on `data["student"]` or the image. The loss is
the batch mean of the summed distances (`distance`, default "kl", with
`distance_kw`) between the student's logits and each teacher's; the step
also measures `task_loss_{model}` (softmax cross-entropy against the
labels, when the batch has them), `distill_loss_{teacher}`,
`distill_loss`, `training_loss` and `l2_grads`. Mixup, when the config
asks for it, mixes the image, the labels and the per-model inputs with one
draw.

Weights follow the JAX trainer's ladder: the workdir's last checkpoint,
else `resume`, restores the student, its optimizer state and the
teachers; otherwise `student_init` loads the student through its model's
`load`. A teacher with `{name}_init` is loaded through its model's `load`
in every case (the published `prof_init` is the path of a local `.npz`;
nothing is fetched). Checkpoints hold {"params": {"student": {...},
teacher: {...}}, "opt": ...} as the JAX train state does. The loop, its
metric rows and its checkpoints are `big_vision_torch/train.py`'s.
Evaluators take the student at each combination of the flexi args' values,
"student_seqhw=15" and so on, as the JAX trainer names them.
"""

from __future__ import annotations

import torch

from big_vision_torch import train
from big_vision_torch.models import vit  # pylint: disable=unused-import
from big_vision_torch.trainers.proj.distill import distill
from big_vision_torch.trainers.proj.distill.distill import getfirst
from big_vision_torch.trainers.proj.distill.distill import MODELS
from big_vision_torch.trainers.proj.flexi import train as flexi_train
from big_vision_torch.utils import schedules
from big_vision_torch.utils import writers


class Trainer(flexi_train.Trainer):
  """The FlexiViT trainer with frozen teachers and a distillation loss."""
  PREDICT_TEMPLATE = "student_{x}"

  def check_config(self, config):
    train.check_ported(config, predict_fns=self.predict_fns())
    distill.check_models(config)
    if config["student_name"] != "proj.flexi.vit":
      raise ValueError(f"config key 'student_name'="
                       f"{config['student_name']!r}: this trainer draws the "
                       f"student's seqhw, which only proj.flexi.vit takes")

  def build_model(self, res, channels):
    """The student; the teachers go to `self.teachers`."""
    self.teachers = distill.make_teachers(self.config, res, channels,
                                          self.device, self.seed)
    return distill.make_model(self.config, "student", res, channels,
                              self.device)

  def load_weights(self, resumed):
    cfg = self.config
    if not resumed and cfg.get("student_init"):
      writers.write_note(f"Initializing student from {cfg['student_init']}")
      train.load_into(self.model, MODELS[cfg["student_name"]],
                      cfg["student_init"], cfg.get("student"),
                      cfg.get("student_load"))
    for name, teacher in self.teachers.items():
      if ckpt := cfg.get(f"{name}_init"):
        writers.write_note(f"Loading teacher {name} from {ckpt}...")
        train.load_into(teacher, MODELS[cfg[f"{name}_name"]], ckpt,
                        cfg.get(name), cfg.get(f"{name}_load"))
        teacher.requires_grad_(False)

  def state(self):
    params = {"student": self.params}
    for name, teacher in self.teachers.items():
      params[name] = train.jax_name_params(teacher)
    return {"params": params, "opt": self.opt_state}

  def restore_state(self, loaded):
    """The student and its optimizer state; each teacher too, unless its
    `{name}_init` loaded it (which the JAX trainer reloads on resume)."""
    super().restore_state({"params": loaded["params"]["student"],
                           "opt": loaded["opt"]})
    with torch.no_grad():
      for name, teacher in self.teachers.items():
        if not self.config.get(f"{name}_init"):
          for n, p in train.jax_name_params(teacher).items():
            p.copy_(loaded["params"][name][n])

  def loss_and_grads(self, batch, **flexi_kw):
    """(loss, {JAX name: gradient} of the student, {name: measurement})."""
    data = dict(batch)
    mixup = dict(self.config.get("mixup") or {})
    if mixup.get("p"):
      names = [n for n in ("image", "labels", "student", *self.teachers)
               if n in data]
      _, mixed = schedules.mixup(self.mixup_generator(), **mixup,
                                 **{n: data[n] for n in names})
      data.update({n: mixed[n] for n in names})
    for p in self.params.values():
      p.grad = None
    with torch.no_grad():
      logits = {name: teacher(getfirst(data, name, "image"))[0]
                for name, teacher in self.teachers.items()}
    logits["student"], _ = self.model(getfirst(data, "student", "image"),
                                      train=True, **flexi_kw)

    loss, measurements = distill.distill_loss(self.config, logits,
                                              data.get("labels"))
    loss.backward()
    measurements = {k: v.detach().mean() for k, v in measurements.items()}
    return (loss.detach(), {n: p.grad for n, p in self.params.items()},
            measurements)

  def update(self, batch, **flexi_kw):
    """One distillation step at the given flexi args (e.g. `seqhw=40`);
    returns its measurements (device scalars)."""
    loss, grads, measurements = self.loss_and_grads(batch, **flexi_kw)
    _, self.opt_state = self.tx.apply_(self.params, grads, self.opt_state)
    return {**measurements, "training_loss": loss,
            "l2_grads": train.l2(grads.values())}


def main(argv=None):
  return train.main(argv, trainer_cls=Trainer, description=__doc__)


if __name__ == "__main__":
  main()

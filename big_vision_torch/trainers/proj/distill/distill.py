"""Knowledge distillation, the "patient and consistent" recipe: port of
big_vision_tpu/trainers/proj/distill/distill.py on one device.

  python -m big_vision_torch.trainers.proj.distill.distill \
      --config big_vision_torch/configs/proj/distill/smoke.py:teacher_init=<teacher.npz> \
      --workdir <dir> [--device cpu]

A student (`student_name`, `student`) learns to match frozen teachers
(`teachers`, each `<name>_name` and `<name>`), every model built as the
config's models are (`MODELS`). Every teacher is loaded from its
checkpoint `<name>_init` through its model's `load` (with `<name>_load`)
at every start, and runs in eval mode without gradients; the student is
loaded from `student_init` (or `model_init`) unless the run resumes. Each
model sees `data[<its name>]` where the batch has it, else the image
(`getfirst`). With `mixup.p` > 0 the image, the labels and the per-model
images are mixed with one draw. The loss is the batch mean of the summed
distances (`distance`, default "kl", with `distance_kw`) between the
student's logits and each teacher's; a step measures `task_loss_<model>`
(softmax cross-entropy against the labels, for every model, where the
batch has labels), `distill_loss_<teacher>`, `distill_loss`,
`training_loss` and `l2_grads`.

The predict fns are the JAX trainer's: "student_fwd" and "predict" (the
student's (logits, out)), "<teacher>_fwd", and "student_<teacher>_fwd"
(both pairs), for the classification and distance evaluators. A
checkpoint holds {"student": {JAX name: tensor}, "opt": ..., "chrono": ...}
as the JAX trainer writes it; a resumed run restores the student, the
optimizer state and the clock. The loop, its metric rows, evals and
checkpoints are `big_vision_torch/train.py`'s.
"""

from __future__ import annotations

import torch

from big_vision_torch import input_pipeline
from big_vision_torch import optim
from big_vision_torch import train
from big_vision_torch.evaluators.proj.distill import distance
from big_vision_torch.models import bit
from big_vision_torch.models import bit_paper
from big_vision_torch.models import vit
from big_vision_torch.models.proj.flexi import vit as flexi_vit
from big_vision_torch.utils import losses
from big_vision_torch.utils import schedules
from big_vision_torch.utils import writers

# The models the distill trainers build, by the config's `<name>_name`.
MODELS = {"vit": vit, "proj.flexi.vit": flexi_vit, "bit": bit,
          "bit_paper": bit_paper}


def getfirst(d, *keys):
  """The value of the first of `keys` in `d` (per-model data routing)."""
  for k in keys:
    if k in d:
      return d[k]
  raise KeyError(f"None of {keys} in {list(d)}")


def check_models(config):
  """Raises ValueError unless the student's and every teacher's model is
  one of MODELS."""
  for name in ("student", *config["teachers"]):
    if config[f"{name}_name"] not in MODELS:
      raise ValueError(f"config key '{name}_name'="
                       f"{config[f'{name}_name']!r} is not ported yet; "
                       f"the distill trainers build {sorted(MODELS)}")


def make_model(config, name, res, channels, device):
  """The config's model `name` ("student" or a teacher) for images of
  res x res x channels."""
  kw = dict(config.get(name, {}))
  if "num_classes" in config:
    kw.setdefault("num_classes", config["num_classes"])
  module = MODELS[config[f"{name}_name"]]
  if module is vit:  # its learned posemb needs the image size
    kw.setdefault("image_size", res)
  return module.Model(channels=channels, device=device, **kw)


def make_teachers(config, res, channels, device, seed):
  """{name: teacher}, each drawn from a generator seeded from (seed, its
  index), frozen and in eval mode."""
  teachers = {}
  for i, name in enumerate(config["teachers"]):
    teacher = make_model(config, name, res, channels, device)
    teacher.initialize(torch.Generator(device=device).manual_seed(
        seed + 1 + i))
    teachers[name] = teacher.eval().requires_grad_(False)
  return teachers


def distill_loss(config, logits, labels=None):
  """(loss, {name: per-example measurement}) from {model name: logits}:
  the task losses against `labels` (when given), each teacher's distance
  from the student and their sum, whose batch mean is the loss."""
  measurements = {}
  if labels is not None:
    for name, lg in logits.items():
      measurements[f"task_loss_{name}"] = losses.softmax_xent(
          logits=lg, labels=labels, reduction=False)
  total = 0.0
  for name in config["teachers"]:
    d = distance.dist(logits["student"], logits[name],
                      config.get("distance", "kl"),
                      **config.get("distance_kw", {}))
    measurements[f"distill_loss_{name}"] = d
    total = total + d
  measurements["distill_loss"] = total
  return total.mean(), measurements


class Trainer(train.Trainer):
  """`train.Trainer` with a student, frozen teachers and a distillation
  loss."""

  def check_config(self, config):
    train.check_ported(config, predict_fns=self.predict_fns())
    check_models(config)
    for name in config["teachers"]:
      if not config.get(f"{name}_init"):
        raise ValueError(f"config key '{name}_init' is needed: every "
                         "teacher is loaded from its checkpoint")

  def build_model(self, res, channels):
    """The student; the teachers go to `self.teachers`."""
    self.teachers = make_teachers(self.config, res, channels, self.device,
                                  self.seed)
    return make_model(self.config, "student", res, channels, self.device)

  def load_weights(self, resumed):
    cfg = self.config
    for name, teacher in self.teachers.items():
      writers.write_note(f"Loading teacher {name} from "
                         f"{cfg[f'{name}_init']}...")
      train.load_into(teacher, MODELS[cfg[f"{name}_name"]],
                      cfg[f"{name}_init"], cfg.get(name),
                      cfg.get(f"{name}_load"))
      teacher.requires_grad_(False)
    student_init = cfg.get("student_init", cfg.get("model_init"))
    if not resumed and student_init:
      writers.write_note(f"Initializing student from {student_init}...")
      train.load_into(self.model, MODELS[cfg["student_name"]], student_init,
                      cfg.get("student"),
                      cfg.get("student_load", cfg.get("model_load")))

  def state(self):
    """What a checkpoint holds: the student and its optimizer state."""
    return {"student": self.params, "opt": self.opt_state}

  def restore_state(self, loaded):
    super().restore_state({"params": loaded["student"],
                           "opt": loaded["opt"]})

  def loss_and_grads(self, batch):
    """(loss, {JAX name: gradient} of the student, {name: measurement})."""
    data = dict(batch)
    mixup_p = dict(self.config.get("mixup") or {}).get("p")
    if mixup_p:
      names = [n for n in ("image", "labels", "student", *self.teachers)
               if n in data]
      _, mixed = schedules.mixup(self.mixup_generator(), p=mixup_p,
                                 **{n: data[n] for n in names})
      data.update(mixed)
    for p in self.params.values():
      p.grad = None
    with torch.no_grad():
      logits = {name: teacher(getfirst(data, name, "image"))[0]
                for name, teacher in self.teachers.items()}
    kw = {}
    if getattr(self.model, "dropout", 0):  # one generator per step
      kw["rng"] = input_pipeline.step_generator(
          self.seed + 1, optim.get_count(self.opt_state), self.device)
    logits["student"], _ = self.model(getfirst(data, "student", "image"),
                                      train=True, **kw)
    loss, measurements = distill_loss(self.config, logits,
                                      data.get("labels"))
    loss.backward()
    measurements = {k: v.detach().mean() for k, v in measurements.items()}
    return (loss.detach(), {n: p.grad for n, p in self.params.items()},
            measurements)

  def update(self, batch):
    """One distillation step; returns its measurements (device scalars)."""
    loss, grads, measurements = self.loss_and_grads(batch)
    _, self.opt_state = self.tx.apply_(self.params, grads, self.opt_state)
    return {**measurements, "training_loss": loss,
            "l2_grads": train.l2(grads.values())}

  def predict_fns(self):
    """{name: fn(train_state, batch)} as the JAX trainer names them: the
    student's (logits, out) as "student_fwd" and "predict", each teacher's
    as "<teacher>_fwd", and both as "student_<teacher>_fwd"."""
    def student_fwd(train_state, batch):
      del train_state  # the models hold the params
      return self.model(batch["image"])

    fns = {"student_fwd": student_fwd, "predict": student_fwd}
    for t in self.config["teachers"]:
      def teacher_fwd(train_state, batch, t=t):
        del train_state
        return self.teachers[t](batch["image"])

      def student_teacher_fwd(train_state, batch, fwd=teacher_fwd):
        return student_fwd(train_state, batch), fwd(train_state, batch)
      fns[f"{t}_fwd"] = teacher_fwd
      fns[f"student_{t}_fwd"] = student_teacher_fwd
    return fns


def main(argv=None):
  return train.main(argv, trainer_cls=Trainer, description=__doc__)


if __name__ == "__main__":
  main()

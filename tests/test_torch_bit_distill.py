"""The BiT distillation configs on the CPU.

Each `runlocal` takes one step after its step-0 evals, on 16 examples an
eval split, through the generic distill trainer, with BiT students and a
teacher read from a local `.npz` (`teacher_init`): bit_i1k (R152x2 -> R50x1, cut to
R26x0.5 for both; the TF layout) with a CKA eval of the two models'
`pre_logits` taps added beside its classification, teacher and distance
evals, and the two bigsweeps at 128 px (the JAX layout). The teacher is
frozen and every metric row is finite.
"""

import json
import math

import pytest
import torch

from big_vision_torch import train as t_train
from big_vision_torch.models import bit_paper as t_bit_paper
from big_vision_torch.trainers.proj.distill import distill as t_distill
from big_vision_torch.utils import checkpoints
from big_vision_torch.utils import convert

CONFIGS = "big_vision_torch/configs"


def _rows(workdir):
  return [json.loads(line) for line in
          (workdir / "big_vision_metrics.txt").read_text().splitlines()]


def _bit_paper_npz(path, num_classes, tf_layout, seed):
  """A random R26x0.5 bit_paper (runlocal's size), with a random head, as
  an `.npz`: in the BiT release's TF layout or the JAX one."""
  model = t_bit_paper.Model(num_classes=num_classes, depth=26, width=0.5,
                            device="cpu")
  model.initialize(torch.Generator().manual_seed(seed))
  with torch.no_grad():
    model.head.weight.normal_(0.0, 0.05,
                              generator=torch.Generator().manual_seed(seed))
  params = convert.params(model)
  if tf_layout:
    params = t_bit_paper.to_big_transfer_format(params)
  checkpoints.npz_save(params, path)
  return path


def _check_step(workdir, evals):
  rows = _rows(workdir)
  assert sorted({k.split("/")[0] for k in rows[0] if not k.startswith("z/")
                 and k.endswith(("/loss", "/avg", "/cka"))}) == evals
  (step,) = [r for r in rows if "training_loss" in r]
  assert step["step"] == 1 and math.isfinite(step["training_loss"])
  return rows


@pytest.mark.parametrize("spec,evals", [
    ("bit_i1k.py:runlocal,neval=16,fewshot=none",
     ["cka", "distance_val", "student_minival", "student_v2", "student_val",
      "teacher_val"]),
    ("bigsweep_flowers_pet.py:runlocal,neval=16", ["student_val"]),
    ("bigsweep_food_sun.py:runlocal,data=sun,neval=16", ["student_val"]),
])
def test_distill_config_takes_a_step(tmp_path, spec, evals):
  path, _, args = spec.partition(":")
  config = t_train.load_config(f"{CONFIGS}/proj/distill/{path}:{args}")
  teacher = _bit_paper_npz(str(tmp_path / "t.npz"), config["num_classes"],
                           path == "bit_i1k.py", 2)
  config = t_train.load_config(
      f"{CONFIGS}/proj/distill/{spec},teacher_init={teacher},stop=1,log=1")
  if "cka" in evals:
    val = config["evals"]["distance_val"]
    config["evals"]["cka"] = dict(
        type="proj.distill.cka", pred="student_prof_m_fwd", data=val["data"],
        pp_fn=val["pp_fn"], log_steps=1000, batch_size=8,
        what=("pre_logits", "pre_logits"))
  trainer = t_train.train(config, str(tmp_path / "wd"), device="cpu",
                          trainer_cls=t_distill.Trainer)
  for model in (trainer.model, trainer.teachers["prof_m"]):
    assert isinstance(model, t_bit_paper.Model)
  assert not any(p.requires_grad
                 for p in trainer.teachers["prof_m"].parameters())
  rows = _check_step(tmp_path / "wd", evals)
  if "cka" in evals:
    assert 0 < rows[0]["cka/cka"] <= 1 + 1e-6, rows[0]

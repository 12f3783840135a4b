"""bit_i1k, bit_i21k and BiT-M transfer on the CPU through `train.main`.

Each `runlocal` (R26x0.5) takes one step after its step-0 evals on 16
examples: bit_i1k with the `bit` model (softmax_xent, momentum_hp, 224
px, batch 32), bit_i21k with `bit_paper` (sigmoid_xent, the head bias at
-10, 21,843 classes), and transfer.py with model bit-m-r50x1 (384 px,
batch 16) from a local `.npz` in the BiT release's TF layout, so that
`maybe_convert_big_transfer_format` runs on the path; the step's loss is
finite.
"""

import json
import math

import pytest
import torch

from big_vision_torch import train as t_train
from big_vision_torch.models import bit_paper as t_bit_paper
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
  assert sorted(k.split("/")[0] for k in rows[0]
                if k.endswith("/loss")) == evals
  (step,) = [r for r in rows if "training_loss" in r]
  assert step["step"] == 1 and math.isfinite(step["training_loss"])


@pytest.mark.parametrize("spec,evals,model_name", [
    ("bit_i1k.py:runlocal,neval=16", ["val"], "bit"),
    ("bit_i21k.py:runlocal,neval=16,fewshot=none", ["val"], "bit_paper"),
])
def test_recipe_takes_a_step(tmp_path, spec, evals, model_name):
  trainer = t_train.main([
      "--config", f"{CONFIGS}/{spec},stop=1,log=1",
      "--workdir", str(tmp_path / "wd"), "--device", "cpu"])
  assert trainer.config["model_name"] == model_name
  assert type(trainer.model).__module__.endswith(model_name)
  _check_step(tmp_path / "wd", evals)


def test_bit_m_transfer_takes_a_step(tmp_path):
  init = _bit_paper_npz(str(tmp_path / "bit_m.npz"), 21843, True, 1)
  trainer = t_train.main([
      "--config", f"{CONFIGS}/transfer.py:runlocal,model=bit-m-r50x1,"
      f"neval=16,init={init},stop=1,log=1",
      "--workdir", str(tmp_path / "wd"), "--device", "cpu"])
  assert trainer.config["model_name"] == "bit_paper"
  assert isinstance(trainer.model, t_bit_paper.Model)
  _check_step(tmp_path / "wd", ["test", "val"])

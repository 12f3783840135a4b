"""The dynamics twin on the CPU: the port's training loop against the JAX
package's, step by step, over a whole run.

The JAX trainer (`big_vision_tpu.train.main`) and the port's
(`big_vision_torch.train.train`, device "cpu") each run
configs/twin_dynamics.py (their own copy of it, at `side=my`) on one
`arrays` file of the JAX package's twin data (tools/dynamics_twin.py
`make_data`): no shuffle, no mixup, dropout 0, an empty pp. Both start from
one JAX init, written as an `.npz` and read through `model_init`. Every
step's `training_loss`, `l2_grads`, `l2_params`, `l2_updates` and
`global_schedule` agree within 1e-3 relative (the bar of
tools/dynamics_twin.py), and the loss falls. The short case (width 32,
depth 1, batch 16, 20 steps: T = 64, D = 8) is in tier 1; the twin's full
size (width 128, depth 2, batch 64, 200 steps) is marked slow.

The GSAM twin: the JAX GSAM trainer (`trainers/proj/gsam/gsam.main`) and
the port's (`trainers/proj/gsam/gsam.Trainer` through `train.train`) on
the same data and init, with configs/proj/gsam/smoke.py's `gsam` block:
`training_loss` and `l2_grads` (the JAX GSAM trainer's measurements)
within 1e-3 relative at every step.

Each test prints the worst relative difference of each measurement.
"""

import json

import jax
import numpy as np
import pytest

from big_vision_torch import train as t_train
from big_vision_torch.configs import twin_dynamics as t_twin
from big_vision_torch.configs.proj.gsam import smoke as t_gsam_smoke
from big_vision_torch.trainers.proj.gsam import gsam as t_gsam
from big_vision_torch.utils import checkpoints
from big_vision_tpu import train as j_train
from big_vision_tpu.configs import twin_dynamics as j_twin
from big_vision_tpu.models import vit as j_vit
from big_vision_tpu.trainers.proj.gsam import gsam as j_gsam
from tools import dynamics_twin

BAR = 1e-3  # per step, relative (tools/dynamics_twin.py --tol_loss_rel)
METRICS = ("training_loss", "l2_grads", "l2_params", "l2_updates",
           "global_schedule")
GSAM_METRICS = ("training_loss", "l2_grads")


def _setup(tmp_path, steps, batch, width, depth):
  """(config arg, init .npz): the twin data and one JAX init on disk."""
  npz = str(tmp_path / "data.npz")
  np.savez(npz, **dynamics_twin.make_data(steps, batch))
  model = j_vit.Model(num_classes=10, width=width, depth=depth,
                      mlp_dim=4 * width, num_heads=4, patch_size=(4, 4),
                      posemb="learn", pool_type="gap", rep_size=False,
                      attn_impl="xla")  # the params do not depend on it
  params = jax.jit(model.init)(
      jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32))["params"]
  init = str(tmp_path / "init.npz")
  checkpoints.npz_save(jax.device_get(params), init)
  arg = (f"side=my,npz={npz},steps={steps},batch={batch},width={width},"
         f"depth={depth}")
  return arg, init


def _rows(workdir):
  with open(workdir / "big_vision_metrics.txt") as f:
    return [r for r in map(json.loads, f) if "training_loss" in r]


def _compare(jax_rows, port_rows, steps, metrics):
  """Asserts every step's metrics within BAR; returns {metric: (worst
  relative difference, its step)}."""
  assert [r["step"] for r in jax_rows] == list(range(1, steps + 1))
  assert [r["step"] for r in port_rows] == list(range(1, steps + 1))
  worst = {}
  for m in metrics:
    want = np.array([r[m] for r in jax_rows])
    got = np.array([r[m] for r in port_rows])
    rel = np.abs(got - want) / np.maximum(1e-12, np.abs(want))
    worst[m] = (float(rel.max()), int(rel.argmax()) + 1)
  print("worst relative difference (step): " + ", ".join(
      f"{m} {e:.3e} ({s})" for m, (e, s) in worst.items()))
  assert all(e <= BAR for e, _ in worst.values()), worst
  losses = [r["training_loss"] for r in jax_rows]
  assert losses[-1] < losses[0], losses
  return worst


def _twin(tmp_path, steps, batch, width, depth):
  arg, init = _setup(tmp_path, steps, batch, width, depth)
  jax_config = j_twin.get_config(arg)
  jax_config.model_init = init
  j_train.main(config=jax_config, workdir=str(tmp_path / "jax"))
  config = t_twin.get_config(arg)
  config["model_init"] = init
  t_train.train(config, str(tmp_path / "port"), device="cpu")
  _compare(_rows(tmp_path / "jax"), _rows(tmp_path / "port"), steps,
           METRICS)


def test_twin_tracks_the_jax_loop(tmp_path):
  _twin(tmp_path, steps=20, batch=16, width=32, depth=1)


@pytest.mark.slow
def test_twin_tracks_the_jax_loop_at_full_size(tmp_path):
  _twin(tmp_path, steps=200, batch=64, width=128, depth=2)


def test_gsam_twin_tracks_the_jax_gsam_trainer(tmp_path):
  steps = 12
  arg, init = _setup(tmp_path, steps=steps, batch=16, width=32, depth=1)
  block = t_gsam_smoke.get_config()["gsam"]
  jax_config = j_twin.get_config(arg)
  jax_config.model_init = init
  jax_config.gsam = dict(block)
  jax_config.init_shapes = [(1, 32, 32, 3)]  # the JAX GSAM trainer needs it
  j_gsam.main(config=jax_config, workdir=str(tmp_path / "jax"))
  config = t_twin.get_config(arg)
  config.update(model_init=init, gsam=dict(block))
  t_train.train(config, str(tmp_path / "port"), device="cpu",
                trainer_cls=t_gsam.Trainer)
  _compare(_rows(tmp_path / "jax"), _rows(tmp_path / "port"), steps,
           GSAM_METRICS)


def test_chip_smoke_draws_the_twin_data_of_the_jax_tool():
  import chip_smoke
  want = dynamics_twin.make_data(3, 4)
  got = chip_smoke.twin_data(3, 4)
  assert sorted(got) == sorted(want)
  for k in want:
    assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])

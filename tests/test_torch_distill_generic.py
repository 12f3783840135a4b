"""Port's generic distill trainer and distance evaluator vs the JAX ones.

On `configs/proj/distill/smoke.py` (ViT-mu/16 student and teacher at
32px), the port's loss, its measures (`task_loss_<model>`,
`distill_loss_prof`, `distill_loss`) and the student's gradients equal the
JAX trainer's `loss_fn` and its gradients on the same params and batch
within 1e-5 relative (the JAX side is built in the test as that `loss_fn`
computes). The distance `Evaluator` on the same models and synthetic
JPEGs gives the JAX evaluator's rows (kl and euclidean within 1e-5
relative, agreement exactly). The smoke config trains end to end through
the command line with its `val` and `distance` evals at steps 0 and 10; a
run cut at step 5 and resumed from its checkpoint ({"student", "opt",
"chrono"}, as the JAX trainer writes) continues as the whole run did.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch import train as t_train
from big_vision_torch.configs.proj.distill import smoke
from big_vision_torch.evaluators.proj.distill import distance as t_dist
from big_vision_torch.models import vit as t_vit
from big_vision_torch.trainers.proj.distill import distill as t_distill
from big_vision_torch.utils import checkpoints as t_ckpt
from big_vision_torch.utils import convert
from big_vision_tpu.evaluators.proj.distill import distance as j_dist
from big_vision_tpu.models import vit as j_vit
from big_vision_tpu.utils import losses as j_losses
import big_vision_tpu.pp.ops_general  # noqa: F401  (JAX registrations)
import big_vision_tpu.pp.ops_image  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SPEC = "big_vision_torch/configs/proj/distill/smoke.py"


@pytest.fixture(name="teacher")
def teacher_fixture(tmp_path):
  """The path of a random ViT-mu/16 teacher `.npz`."""
  model = t_vit.Model(10, variant="mu/16", posemb="sincos2d",
                      head_zeroinit=False, image_size=32, device="cpu")
  model.initialize(torch.Generator().manual_seed(3))
  path = str(tmp_path / "prof.npz")
  t_ckpt.npz_save(convert.vit_params(model), path)
  return path


def _trainer(teacher, **overrides):
  config = {**smoke.get_config(f"teacher_init={teacher}"), **overrides}
  return t_distill.Trainer(config, device="cpu")


def _jax_model():
  return j_vit.Model(10, variant="mu/16", posemb="sincos2d",
                     head_zeroinit=False)


def test_loss_and_measures_match_the_jax_loss_fn(teacher):
  trainer = _trainer(teacher, mixup={})
  it = trainer.input_iter()
  batch = next(it)
  it.close()
  params = {"student": convert.vit_params(trainer.model),
            "prof": convert.vit_params(trainer.teachers["prof"])}
  loss, grads, measures = trainer.loss_and_grads(batch)
  model = _jax_model()
  data = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

  def loss_fn(student_params):  # the JAX trainer's loss_fn
    all_params = {**params, "student": student_params}
    logits = {name: model.apply({"params": w}, data["image"],
                                train=name == "student")[0]
              for name, w in all_params.items()}
    m = {f"task_loss_{name}": j_losses.softmax_xent(
        logits=lg, labels=data["labels"], reduction=False)
         for name, lg in logits.items()}
    m["distill_loss_prof"] = j_dist.dist(logits["student"], logits["prof"],
                                         "kl", t=2.0)
    m["distill_loss"] = m["distill_loss_prof"]
    return jax.tree.map(jnp.mean, (m["distill_loss"], m))

  (want, want_m), want_g = jax.value_and_grad(loss_fn, has_aux=True)(
      params["student"])
  np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
  assert sorted(measures) == sorted(want_m)
  for k, v in want_m.items():
    np.testing.assert_allclose(measures[k].item(), float(v), rtol=1e-5,
                               err_msg=k)
  want_g = convert.vit(jax.device_get(want_g))
  got_g = {port: grads[jax_name] for port, jax_name in
           convert.vit_names(trainer.model).items()}
  norm = np.sqrt(sum(np.sum(np.square(g)) for g in want_g.values()))
  for name, g in want_g.items():
    np.testing.assert_allclose(got_g[name].numpy(), g, atol=1e-5 * norm,
                               rtol=0, err_msg=name)


def test_distance_evaluator_matches_jax(teacher):
  trainer = _trainer(teacher)
  spec = dict(trainer.config["evals"]["distance"])
  kw = dict(distances=spec["distances"], data=spec["data"],
            pp_fn=spec["pp_fn"], batch_size=8, cache="none")
  fns = trainer.predict_fns()
  got = dict(t_dist.Evaluator(fns["student_prof_fwd"], device="cpu",
                              **kw).run(None))
  model = _jax_model()
  params = {"student": convert.vit_params(trainer.model),
            "prof": convert.vit_params(trainer.teachers["prof"])}

  def fwd(train_state, batch):
    return tuple(model.apply({"params": train_state[n]}, batch["image"])
                 for n in ("student", "prof"))
  want = dict(j_dist.Evaluator(fwd, devices=[jax.devices()[0]],
                               **kw).run(params))
  assert sorted(got) == sorted(want) and len(got) == 9
  for k, v in want.items():
    if "agree" in k:
      assert got[k] == float(v), k
    else:
      np.testing.assert_allclose(got[k], float(v), rtol=1e-5, err_msg=k)
  assert got["kind=kl/min"] < got["kind=kl/avg"] < got["kind=kl/max"]


def _rows(workdir):
  return [json.loads(line) for line in
          (workdir / "big_vision_metrics.txt").read_text().splitlines()]


def test_smoke_config_trains_and_resumes(tmp_path, teacher):
  whole = t_distill.main(["--device", "cpu", "--workdir",
                          str(tmp_path / "whole"), "--config",
                          f"{SPEC}:teacher_init={teacher}"])
  assert isinstance(whole, t_distill.Trainer) and whole.first_step == 0
  rows = _rows(tmp_path / "whole")
  evals = [r for r in rows if "val/prec@1" in r]
  assert [r["step"] for r in evals] == [0, 10]
  for r in evals:
    for kind in ("kind=kl", "kind=euclidean", "kind=agree_k=1"):
      for stat in ("avg", "min", "max"):
        assert math.isfinite(r[f"distance/{kind}/{stat}"])
    assert r["z/secs/eval/distance"] > 0 and math.isfinite(r["val/loss"])
  steps = [r for r in rows if "training_loss" in r]
  assert [r["step"] for r in steps] == [5, 10]
  for r in steps:
    assert math.isfinite(r["distill_loss"]) and r["distill_loss"] > 0
    assert {"task_loss_student", "task_loss_prof", "l2_grads"} <= set(r)
  ckpt = t_ckpt.load_checkpoint(t_ckpt.last_checkpoint_dir(
      str(tmp_path / "whole" / "ckpt.bv")))
  assert sorted(ckpt) == ["chrono", "opt", "student"]

  config = smoke.get_config(f"teacher_init={teacher}")
  config.update(ckpt_steps=5, stop_after_steps=5)
  cut = str(tmp_path / "cut")
  t_train.train(config, cut, device="cpu", trainer_cls=t_distill.Trainer)
  del config["stop_after_steps"]
  resumed = t_train.train(config, cut, device="cpu",
                          trainer_cls=t_distill.Trainer)
  assert resumed.first_step == 5
  for name, p in whole.params.items():
    torch.testing.assert_close(p, resumed.params[name], atol=1e-6, rtol=0,
                               msg=name)
  want = [r for r in rows if r["step"] == 10 and "training_loss" in r][0]
  got = [r for r in _rows(tmp_path / "cut") if r["step"] == 10
         and "training_loss" in r][0]
  assert got["training_loss"] == pytest.approx(want["training_loss"],
                                                rel=1e-6)


def test_refuses_to_start_without_a_card(tmp_path, teacher):
  if torch.cuda.is_available():
    pytest.skip("this machine has a CUDA device")
  with pytest.raises(RuntimeError, match="--device cpu"):
    t_distill.main(["--config", f"{SPEC}:teacher_init={teacher}",
                    "--workdir", str(tmp_path)])


@pytest.mark.parametrize("key,value", [
    ("prof_init", ""), ("student_name", "proj.uvim.vit"),
    ("prof_name", "proj.uvim.vit"),
    ("evals", dict(timing=dict(type="timing"))),
    ("evals", dict(val=dict(type="classification", pred="student_seqhw=5"))),
])
def test_unported_or_missing_keys_are_refused(teacher, key, value):
  with pytest.raises(ValueError, match=key):
    _trainer(teacher, **{key: value})

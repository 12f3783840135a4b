"""Port's trainer vs the JAX update, its command line, and its refusals.

Parity: the `runlocal` version of configs/vit_b16_synthetic.py in f32
(mu/16 at 32px, batch 8, fused attention: the JAX Pallas kernels in
interpret mode, the port's plain versions), with the first moment in f32
too: gradients that differ in their last bits round a bf16 moment to
neighbouring values now and then, which moves single updates by 2^-8 (the
bf16 moment is held against optax in test_torch_optim.py). The JAX side
is built in the test as train.py:210-220 builds it, from `vit.Model`, `optim.make` and
`softmax_xent`; both start from the same params (the JAX init, with a
seeded head kernel so the trunk gets gradients from the first step) and
take the same three batches from the port's input pipeline. The loss of
each step agrees within 1e-5 relative; the total update the params took
agrees within 1e-4 of its l2 norm.

End to end on the CPU: the `runlocal` config's command line (an eval at
step 0 and at the last step), and the port of the JAX package's
configs/smoke.py (JPEG decode and inception crop, mixup, gradient clip,
checkpoints and a classification eval every 10 steps). With mixup the
trainer's loss is the model's on the batch mixed with the trainer's draw.

The ImageNet recipes (vit_s16_i1k, AugReg vit_i1k, mlp_mixer_i1k with
`model_name` "mlp_mixer", and transfer from a local `.npz`) each take one
step of their `runlocal` through `train.main`, RandAugment included, after
their evals at step 0. A run stopped after a checkpoint at step 1 and
resumed to step 2 ends with the params and optimizer state (Adam,
momentum_hp, Adafactor) of a run that was never stopped.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from big_vision_torch import train as t_train
from big_vision_torch.configs import smoke
from big_vision_torch.configs import vit_b16_synthetic
from big_vision_torch.configs import vit_s16_i1k
from big_vision_torch.models import vit as t_vit
from big_vision_torch.utils import checkpoints
from big_vision_torch.utils import trees as t_trees
from big_vision_torch.utils import schedules as t_sched
from big_vision_torch.utils import convert
from big_vision_tpu import optim as j_optim
from big_vision_tpu.models import vit as j_vit
from big_vision_tpu.utils import losses as j_losses

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _config(**model):
  config = vit_b16_synthetic.get_config("runlocal")
  config["model"].update(dtype_mm="float32", **model)
  config["optax"] = {}  # an f32 first moment: see the module docstring
  return config


def test_three_updates_match_the_jax_update():
  config = _config()
  trainer = t_train.Trainer(config, device="cpu")
  jmodel = j_vit.Model(num_classes=config["num_classes"], **config["model"])
  params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
  params = jax.device_get(params["params"])
  params["head"]["kernel"] = np.random.RandomState(0).randn(
      *params["head"]["kernel"].shape).astype(np.float32) * 0.1
  start = convert.vit(params)
  trainer.model.load_state_dict(
      {k: torch.from_numpy(np.array(v)) for k, v in start.items()})
  tx, _ = j_optim.make(config, params, sched_kw=dict(
      total_steps=trainer.total_steps, batch_size=trainer.batch_size,
      data_size=config["input"]["data"]["n"]))
  opt = tx.init(params)

  @jax.jit
  def update(params, opt, images, labels):
    def loss_fn(p):
      logits, _ = jmodel.apply({"params": p}, images, train=True)
      return j_losses.softmax_xent(logits=logits, labels=labels)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt = tx.update(grads, opt, params)
    return optax.apply_updates(params, updates), opt, loss

  it = trainer.input_iter()
  try:
    for _ in range(3):
      batch = next(it)
      got = trainer.update(batch)["training_loss"].item()
      params, opt, want = update(params, opt, jnp.asarray(batch["image"]),
                                 jnp.asarray(batch["labels"]))
      np.testing.assert_allclose(got, float(want), rtol=1e-5)
  finally:
    it.close()
  # The updates the three steps made, on both sides. A key bias's gradient
  # is rounding noise (zero in exact arithmetic: the softmax ignores a
  # constant added to a row of logits), which Adam scales up to a full
  # step of either sign, so key biases are left out.
  want = convert.vit(jax.device_get(params))
  diff = moved = 0.0
  for name, p in trainer.model.named_parameters():
    if name.endswith("attn.key.bias"):
      continue
    diff += np.sum((p.detach().numpy() - want[name]) ** 2)
    moved += np.sum((want[name] - start[name]) ** 2)
  assert moved > 0 and (diff / moved) ** 0.5 <= 1e-4, (diff / moved) ** 0.5


def _rows(workdir):
  return [json.loads(line) for line in
          (workdir / "big_vision_metrics.txt").read_text().splitlines()]


_EVAL_KEYS = ["val/loss", "val/prec@1", "z/secs/eval/val"]


def test_command_line_runs_three_steps(tmp_path):
  spec = "big_vision_torch/configs/vit_b16_synthetic.py:runlocal"
  trainer = t_train.main(["--config", spec, "--workdir", str(tmp_path),
                          "--device", "cpu"])
  assert trainer.device.type == "cpu"
  rows = _rows(tmp_path)
  assert sorted(rows[0]) == sorted(["step", "num_params", *_EVAL_KEYS])
  assert rows[0]["step"] == 0
  assert [r["step"] for r in rows[1:]] == [1, 2, 3, 3]
  for r in rows[1:4]:
    assert math.isfinite(r["training_loss"])
    for key in ("l2_grads", "l2_params", "l2_updates", "global_schedule",
                "img/sec", "input_stall_pct"):
      assert key in r
  assert sorted(rows[4]) == sorted(["step", *_EVAL_KEYS])  # the final eval
  for r in (rows[0], rows[4]):
    assert 0 <= r["val/prec@1"] <= 1 and math.isfinite(r["val/loss"])


def test_smoke_config_trains_end_to_end(tmp_path):
  """configs/smoke.py through `train.main`: 20 steps with mixup, eval rows
  at steps 0, 10 and 20, checkpoints at 10 and 20."""
  trainer = t_train.main(["--config", "big_vision_torch/configs/smoke.py",
                          "--workdir", str(tmp_path), "--device", "cpu"])
  assert trainer.config["mixup"] == {"p": 0.2}
  rows = _rows(tmp_path)
  evals = [r for r in rows if "val/prec@1" in r]
  assert [r["step"] for r in evals] == [0, 10, 20]
  for r in evals:
    assert 0 <= r["val/prec@1"] <= 1 and math.isfinite(r["val/loss"])
    assert r["z/secs/eval/val"] > 0
  train_rows = [r for r in rows if "training_loss" in r]
  assert [r["step"] for r in train_rows] == [5, 10, 15, 20]
  assert all(math.isfinite(r["training_loss"]) for r in train_rows)
  assert os.path.exists(tmp_path / "ckpt.bv-LAST")


def test_stop_after_steps_skips_the_final_eval(tmp_path):
  config = smoke.get_config("stop=3,total_steps=6,log=1")
  config["evals"]["late"] = dict(config["evals"]["val"], skip_first=True,
                                 log_steps=2)
  t_train.train(config, str(tmp_path), device="cpu")
  rows = _rows(tmp_path)
  assert [r["step"] for r in rows if "val/loss" in r] == [0]
  assert [r["step"] for r in rows if "late/loss" in r] == [2]
  assert max(r["step"] for r in rows) == 3


def test_mixup_mixes_the_batch():
  config = _config()
  config["mixup"] = dict(p=0.2)
  trainer = t_train.Trainer(config, device="cpu")
  it = trainer.input_iter()
  batch = next(it)
  it.close()
  loss, _ = trainer.loss_and_grads(batch)
  (images, labels), _ = t_sched.mixup(trainer.mixup_generator(),
                                      batch["image"], batch["labels"], p=0.2)
  assert not torch.equal(images, batch["image"])
  with torch.no_grad():
    logits, _ = trainer.model(images, train=True)
    want = trainer.loss_fn(logits=logits, labels=labels)
  np.testing.assert_allclose(loss.item(), want.item(), rtol=1e-6)


@pytest.mark.parametrize("key,value", [
    ("evals", dict(val={})),
    ("evals", dict(val=dict(type="classification", pred="predict_seqhw=15"))),
    ("model_name", "proj.uvim.vit"),
])
def test_unported_keys_are_refused(key, value):
  with pytest.raises(ValueError, match=key):
    t_train.Trainer({**_config(), key: value}, device="cpu")


@pytest.mark.parametrize("key,value", [
    ("ckpt_steps", 10), ("resume", "/some/ckpt"),
    ("model_init", "i1k-s16-300ep"), ("mixup", dict(p=0.2)),
    ("evals", dict(val=dict(type="classification", pred="represent"))),
])
def test_checkpoint_keys_are_ported(key, value):
  t_train.check_ported({**_config(), key: value})


def test_resume_without_seeking_the_stream_is_refused():
  config = _config()
  config["input"] = {**config["input"], "resume_seek": False}
  with pytest.raises(ValueError, match="resume_seek"):
    t_train.Trainer(config, device="cpu")


def test_unported_key_without_effect_is_accepted():
  t_train.check_ported({**_config(), "mixup": dict(p=0.0)})


def test_cuda_is_not_silently_replaced_by_the_cpu():
  if torch.cuda.is_available():
    pytest.skip("this machine has a CUDA device")
  with pytest.raises(RuntimeError, match="--device cpu"):
    t_train.Trainer(_config(), device="cuda")


def _transfer_init(path):
  """A random ViT-mu/16 (the runlocal cut of vit-s16) as an `.npz` in the
  JAX layout, with a 1000-class head that the transfer does not load."""
  model = t_vit.Model(num_classes=1000, variant="mu/16", pool_type="gap",
                      posemb="sincos2d", rep_size=True, device="cpu")
  model.initialize(torch.Generator().manual_seed(7))
  checkpoints.npz_save(convert.vit_params(model), path)
  return path


@pytest.mark.parametrize("spec,evals,model_name", [
    ("vit_s16_i1k.py:runlocal", ["val"], "vit"),
    ("vit_i1k.py:runlocal", ["val"], "vit"),
    ("mlp_mixer_i1k.py:runlocal", ["minival", "train", "v2", "val"],
     "mlp_mixer"),
    ("transfer.py:runlocal,model=vit-s16,init={init}", ["test", "val"],
     "vit"),
])
def test_recipe_takes_a_step(tmp_path, spec, evals, model_name):
  spec = spec.format(init=_transfer_init(str(tmp_path / "init.npz")))
  trainer = t_train.main(["--config", f"big_vision_torch/configs/{spec},"
                          "stop=1,log=1", "--workdir", str(tmp_path / "wd"),
                          "--device", "cpu"])
  assert trainer.config["model_name"] == model_name
  assert "randaug" in trainer.config["input"]["pp"] or "transfer" in spec
  rows = _rows(tmp_path / "wd")
  assert sorted(k.split("/")[0] for k in rows[0]
                if k.endswith("/prec@1")) == evals
  (step,) = [r for r in rows if "training_loss" in r]
  assert step["step"] == 1 and math.isfinite(step["training_loss"])


@pytest.mark.parametrize("optax_name", [
    "scale_by_adam", "big_vision.momentum_hp",
    "big_vision.scale_by_adafactor"])
def test_resume_restores_the_optimizer_state(tmp_path, optax_name):
  config = vit_s16_i1k.get_config("runlocal")
  config.update(optax_name=optax_name, optax={}, ckpt_steps=1, evals={},
                log_training_steps=1, stop_after_steps=1)
  t_train.train(config, str(tmp_path / "a"), device="cpu")
  resumed = t_train.train(dict(config, stop_after_steps=2),
                          str(tmp_path / "a"), device="cpu")
  assert resumed.first_step == 1
  whole = t_train.train(dict(config, stop_after_steps=2),
                        str(tmp_path / "b"), device="cpu")
  for name, p in whole.params.items():
    torch.testing.assert_close(resumed.params[name], p, rtol=0, atol=0)
  want = t_trees.flatten(whole.opt_state)
  got = t_trees.flatten(resumed.opt_state)
  assert sorted(got) == sorted(want) and len(want) > 1
  for key, value in want.items():
    if isinstance(value, torch.Tensor):
      assert got[key].dtype == value.dtype, key
      torch.testing.assert_close(got[key], value, rtol=0, atol=0)
    else:
      assert got[key] == value, key


def test_mixer_is_ported():
  t_train.check_ported({**_config(), "model_name": "mlp_mixer"})

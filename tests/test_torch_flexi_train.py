"""Port's FlexiViT trainer vs the JAX one: seqhw draws, mixup, updates, CLI.

The update parity runs the `runlocal` version of
configs/proj/flexivit/i21k_sup.py (ViT-mu at 240px, batch 8) in f32 with
an f32 first moment, as tests/test_torch_train.py does: gradients that
differ in their last bits round a bf16 moment to neighbouring values now
and then. The JAX side is built in the test as the JAX flexi trainer's
`update_fn` computes: mixup of images and labels (with the same a as the
port's step, put in place of `jax.random.beta`), the model at the step's
seqhw, `sigmoid_xent`, its gradients, `optim.make`'s optimizer and
`l2_grads` (of the JAX gradients, summed in f64). Both start from the JAX
init (with a seeded head) and take the port's input batches, RandAugment
included. Loss and `l2_grads` of each step agree within 1e-5 relative;
the total update the params took within 1e-4 of its l2 norm.
"""

import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from big_vision_torch import input_pipeline
from big_vision_torch import optim as t_optim
from big_vision_torch.configs.proj.flexivit import i21k_sup
from big_vision_torch.trainers.proj.flexi import common as t_common
from big_vision_torch.trainers.proj.flexi import train as t_train
from big_vision_torch.utils import convert
from big_vision_torch.utils import schedules as t_sched
from big_vision_tpu import optim as j_optim
from big_vision_tpu.models.proj.flexi import vit as j_flexi
from big_vision_tpu.trainers.proj.flexi import common as j_common
from big_vision_tpu.utils import losses as j_losses
from big_vision_tpu.utils import schedules as j_sched

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SPEC = "big_vision_torch/configs/proj/flexivit/i21k_sup.py:runlocal"


def _config(mixup_p=0.2):
  config = i21k_sup.get_config("runlocal")
  config["optax"] = {}  # an f32 first moment: see the module docstring
  config["mixup"] = dict(p=mixup_p, fold_in=None)
  return config


def test_seqhw_draws_match_jax():
  trainer = t_train.Trainer(_config(), device="cpu")
  cfg = i21k_sup.get_config()["flexi"]["seqhw"]
  got = [trainer.step_kwargs(step)["seqhw"] for step in range(1, 101)]
  want = [int(j_common.choice(cfg["v"], cfg["p"],
                              j_common.mkrng(-1, -1, step)))
          for step in range(1, 101)]
  assert got == want
  assert set(got) > {15, 30, 40}


def test_predict_fns_match_jax():
  import ml_collections
  fn = lambda train_state, batch, **kw: kw
  cfg = {"seqhw": {"v": (5, 10, 15)}, "other": {"v": (1, 2)}}
  got = t_common.mkpredictfns(fn, cfg, "predict_{x}")
  want = j_common.mkpredictfns(fn, ml_collections.ConfigDict(cfg),
                               "predict_{x}")
  assert len(got) == 6
  assert ({k: f(None, None) for k, f in got.items()}
          == {k: f(None, None) for k, f in want.items()})


def _patch_beta(monkeypatch, a):
  monkeypatch.setattr(jax.random, "beta",
                      lambda *args, **kw: jnp.float32(a))


def test_mixup_matches_jax(monkeypatch):
  rs = np.random.RandomState(0)
  images = rs.randn(4, 6, 6, 3).astype(np.float32)
  labels = rs.rand(4, 10).astype(np.float32)
  a = np.float32(0.3)  # JAX keeps max(a, 1 - a)
  _patch_beta(monkeypatch, a)
  _, want, more = j_sched.mixup(jax.random.PRNGKey(0), images, labels,
                                p=0.2, fold_in=None)
  got, got_more = t_sched.mix(max(a, np.float32(1) - a),
                              torch.from_numpy(images),
                              torch.from_numpy(labels), fold_in=None)
  assert more == got_more == {"fold_in": None}
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_mixup_draw_is_seeded():
  draw = lambda seed: t_sched.get_mixup(
      torch.Generator().manual_seed(seed), 0.2).args[0]
  assert draw(3) == draw(3)
  values = [draw(s) for s in range(50)]
  assert all(0.5 <= a <= 1.0 for a in values) and len(set(values)) > 40


def test_three_updates_match_the_jax_update(monkeypatch):
  config = _config(mixup_p=0.0)  # step 1 without mixup, then with it
  trainer = t_train.Trainer(config, device="cpu")
  model_kw = {k: v for k, v in config["model"].items() if k != "attn_impl"}
  jmodel = j_flexi.Model(config["num_classes"], **model_kw)
  params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 240, 240, 3)))
  params = jax.device_get(params["params"])
  params["head"]["kernel"] = 0.1 * np.random.RandomState(0).randn(
      *params["head"]["kernel"].shape).astype(np.float32)
  params["head"]["bias"] = np.full_like(params["head"]["bias"], -10.0)
  start = convert.vit(params)
  trainer.model.load_state_dict(
      {k: torch.from_numpy(np.array(v)) for k, v in start.items()})
  tx, _ = j_optim.make(config, params, sched_kw=dict(
      total_steps=trainer.total_steps, batch_size=trainer.batch_size,
      data_size=config["input"]["data"]["n"]))
  opt = tx.init(params)

  @functools.partial(jax.jit, static_argnums=4)
  def update(params, opt, images, labels, seqhw):
    def loss_fn(p):
      logits, _ = jmodel.apply({"params": p}, images, train=True,
                               seqhw=seqhw)
      return j_losses.sigmoid_xent(logits=logits, labels=labels)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt = tx.update(grads, opt, params)
    return optax.apply_updates(params, updates), opt, loss, grads

  it = trainer.input_iter()
  try:
    for step in range(1, 4):
      batch = next(it)
      images, labels = np.asarray(batch["image"]), np.asarray(batch["labels"])
      if step > 1:
        trainer.config["mixup"] = dict(p=0.2, fold_in=None)
        a = t_sched.get_mixup(input_pipeline.step_generator(
            trainer.seed + 2, t_optim.get_count(trainer.opt_state), "cpu"),
                              0.2).args[0]
        _patch_beta(monkeypatch, a)
        _, (images, labels), _ = j_sched.mixup(
            jax.random.PRNGKey(step), images, labels, p=0.2, fold_in=None)
      kw = trainer.step_kwargs(step)
      got = trainer.update(batch, **kw)
      params, opt, loss, grads = update(params, opt, jnp.asarray(images),
                                        jnp.asarray(labels), kw["seqhw"])
      # `l2_grads` of the JAX gradients, summed in f64 (XLA's f32 sum over
      # the 21843-class head, inside the jit, is off by up to about 1e-5).
      l2 = np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                       for g in jax.tree.leaves(grads)))
      np.testing.assert_allclose(got["training_loss"].item(), float(loss),
                                 rtol=1e-5)
      np.testing.assert_allclose(got["l2_grads"].item(), float(l2),
                                 rtol=1e-5)
  finally:
    it.close()
  want = convert.vit(jax.device_get(params))
  diff = moved = 0.0
  for name, p in trainer.model.named_parameters():
    if name.endswith("attn.key.bias"):  # rounding noise, scaled up by Adam
      continue
    diff += np.sum((p.detach().numpy() - want[name]) ** 2)
    moved += np.sum((want[name] - start[name]) ** 2)
  assert moved > 0 and (diff / moved) ** 0.5 <= 1e-4, (diff / moved) ** 0.5


def test_command_line_runs_three_steps(tmp_path):
  trainer = t_train.main(["--config", SPEC, "--workdir", str(tmp_path),
                          "--device", "cpu"])
  assert isinstance(trainer, t_train.Trainer)
  assert trainer.device.type == "cpu"
  rows = [json.loads(line) for line in
          (tmp_path / "big_vision_metrics.txt").read_text().splitlines()]
  steps = [r for r in rows if "training_loss" in r]
  assert [r["step"] for r in steps] == [1, 2, 3]
  for r in steps:
    assert math.isfinite(r["training_loss"]) and r["l2_grads"] > 0
    assert "global_schedule" in r and "img/sec" in r and "uptime" in r
  assert "core_hours_cpu" in steps[-1] and steps[-1]["examples_seen"] == 24
  # Every eval of the config at step 0 and after the last step.
  evals = [r for r in rows if "test_05/prec@1" in r]
  assert [r["step"] for r in evals] == [0, 3]
  for r in evals:
    for s in ("05", "10", "15", "30"):
      assert math.isfinite(r[f"test_{s}/loss"]), r
      assert 0 <= r[f"test_{s}/prec@1"] <= 1 and r[f"z/secs/eval/test_{s}"] > 0
    assert {k for k in r if k.startswith("fewshot/")} == {
        f"fewshot/{'a' if n == 10 else 'z'}/pets_{n}shot"
        for n in (1, 5, 10, 25)}
    assert r["z/secs/eval/fewshot"] > 0


def test_refuses_to_start_without_a_card(tmp_path):
  if torch.cuda.is_available():
    pytest.skip("this machine has a CUDA device")
  with pytest.raises(RuntimeError, match="--device cpu"):
    t_train.main(["--config", SPEC, "--workdir", str(tmp_path)])


@pytest.mark.parametrize("key,value", [
    ("evals", dict(test={})), ("model_name", "vit"),
])
def test_unported_keys_are_refused(key, value):
  with pytest.raises(ValueError, match=key):
    t_train.Trainer({**_config(), key: value}, device="cpu")

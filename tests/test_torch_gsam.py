"""The port's GSAM against the JAX package's.

`dual_vector` and `gsam_gradient` (trainers/proj/gsam/gsam.py) against
the JAX functions on a tiny ViT (width 32, depth 2, 2 heads, 8x8 patches
at 32px, the plain attention on both sides), from one set of params and on
one batch: the clean loss and the GSAM gradient (its l2 distance over its
l2 norm) within 1e-5, with `minimize_fp` on and off, with
`adaptive_perturbation`, and with `lr_max` = `lr_min` (SAM's fixed rho).

The port's trainer: with rho 0 and alpha 0 the GSAM gradient is the
gradient at the perturbed weights, which are the weights themselves; with
dropout 0.1 it equals the clean gradient of the step bit for bit, so both
passes of a step draw the same dropout masks (and another step's masks
give another gradient).

configs/proj/gsam/vit_i1k_gsam_no_aug.py: the JAX GSAM trainer raises a
TypeError on it (its `config.gsam` names `lr_max` and `lr_min`, which the
trainer also passes); the port's trainer takes the config's values, and
its first step's loss equals JAX `gsam_gradient`'s called with them within
1e-5, and its gradient norm within 1e-4 (JAX's own eager and jitted runs
of this gradient differ by 9.7e-6: from zero-initialized heads, the step
is ill-conditioned in f32).

The smoke config through the command line of
trainers/proj/gsam/train.py: 10 steps, rows at 5 and 10, a checkpoint.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from big_vision_torch.configs.proj.gsam import smoke as t_smoke
from big_vision_torch.configs.proj.gsam import vit_i1k_gsam_no_aug as t_i1k
from big_vision_torch.models import vit as t_vit
from big_vision_torch.trainers.proj.gsam import gsam as t_gsam
from big_vision_torch.utils import convert
from big_vision_torch.utils import losses as t_losses
from big_vision_tpu.configs.proj.gsam import vit_i1k_gsam_no_aug as j_i1k
from big_vision_tpu.models import vit as j_vit
from big_vision_tpu.trainers.proj.gsam import gsam as j_gsam
from big_vision_tpu.utils import losses as j_losses

MODEL = dict(width=32, depth=2, mlp_dim=64, num_heads=2, patch_size=(8, 8),
             posemb="learn", pool_type="gap", rep_size=True,
             attn_impl="xla")
BAR = 1e-5


def _setup(seed=0, n=8):
  """(JAX model, JAX params, port model with those params, images,
  one-hot labels)."""
  jmodel = j_vit.Model(num_classes=10, **MODEL)
  params = jax.device_get(jmodel.init(
      jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)))["params"])
  rng = np.random.RandomState(seed)
  params["head"]["kernel"] = (0.1 * rng.randn(
      *params["head"]["kernel"].shape)).astype(np.float32)
  tmodel = t_vit.Model(num_classes=10, image_size=32, device="cpu", **MODEL)
  tmodel.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in convert.vit(params).items()})
  images = rng.randn(n, 32, 32, 3).astype(np.float32)
  labels = np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)]
  return jmodel, params, tmodel, images, labels


def _port_loss(tmodel):
  port = {j: p for p, j in convert.names(tmodel).items()}

  def loss_fn(p, x, y):
    logits, _ = torch.func.functional_call(
        tmodel, {port[k]: v for k, v in p.items()}, (x,), {"train": True})
    return t_losses.softmax_xent(logits=logits, labels=y)
  return loss_fn


def _jax_loss(jmodel):
  def loss_fn(p, x, y):
    logits, _ = jmodel.apply({"params": p}, x, train=True)
    return j_losses.softmax_xent(logits=logits, labels=y)
  return loss_fn


def _rel(got, want):
  """||got - want|| / ||want|| over the whole tree: got {port name:
  tensor}, want a JAX tree."""
  want = convert.vit(want)
  diff = sum(np.sum((got[k].numpy() - v) ** 2) for k, v in want.items())
  return float(np.sqrt(diff / sum(np.sum(v ** 2) for v in want.values())))


def test_dual_vector_matches_jax():
  rng = np.random.RandomState(1)
  tree = {"a": rng.randn(3, 4).astype(np.float32),
          "b": rng.randn(7).astype(np.float32)}
  want, want_norm = j_gsam.dual_vector(tree)
  got, got_norm = t_gsam.dual_vector(
      {k: torch.from_numpy(v) for k, v in tree.items()})
  np.testing.assert_allclose(got_norm.item(), float(want_norm), rtol=1e-6)
  for k in tree:
    np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(minimize_fp=True),
    dict(minimize_fp=False),
    dict(adaptive_perturbation=True),
    dict(adaptive_perturbation=True, minimize_fp=False),
    dict(lr_max=1e-3, lr_min=1e-3),  # SAM: rho is rho_max
], ids=["minimize_fp", "maximize_fp", "adaptive", "adaptive_maximize_fp",
        "sam"])
def test_gsam_gradient_matches_jax(kw):
  jmodel, params, tmodel, images, labels = _setup()
  kw = dict(dict(rho_max=0.6, rho_min=0.1, alpha=0.6, lr=6e-4, lr_max=1e-3,
                 lr_min=0.0), **kw)
  want_loss, want = jax.jit(lambda p, x, y: j_gsam.gsam_gradient(
      _jax_loss(jmodel), p, x, y, **kw))(params, images, labels)
  jax_names = {j: p for p, j in convert.names(tmodel).items()}
  tparams = {j: tmodel.get_parameter(p) for j, p in jax_names.items()}
  got_loss, got = t_gsam.gsam_gradient(
      _port_loss(tmodel), tparams, torch.from_numpy(images),
      torch.from_numpy(labels), **kw)
  got = {jax_names[k]: v for k, v in got.items()}
  np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=BAR)
  err = _rel(got, jax.device_get(want))
  print(f"{kw}: GSAM gradient rel l2 err {err:.3e}")
  assert err <= BAR, err


def _smoke_trainer(**gsam):
  config = t_smoke.get_config()
  config["model"] = dict(config["model"], dropout=0.1)
  config["gsam"] = dict(config["gsam"], **gsam)
  return t_gsam.Trainer(config, device="cpu")


def test_both_passes_draw_the_same_dropout_masks():
  trainer = _smoke_trainer(rho_max=0.0, rho_min=0.0, alpha=0.0)
  it = trainer.input_iter()
  batch = next(it)
  it.close()
  x, y = batch["image"], batch["labels"]

  def loss(step):
    return lambda p, a, b: trainer.loss_at(p, a, b, step)
  _, clean = t_gsam.value_and_grad(loss(0), trainer.params, x, y)
  _, robust = t_gsam.gsam_gradient(loss(0), trainer.params, x, y, lr=1e-3,
                                   **trainer.gsam_kw)
  for k in clean:
    assert torch.equal(robust[k], clean[k]), k
  _, other = t_gsam.value_and_grad(loss(1), trainer.params, x, y)
  assert not all(torch.equal(other[k], clean[k]) for k in clean)


def test_the_jax_trainer_cannot_run_vit_i1k_gsam_no_aug(tmp_path):
  config = j_i1k.get_config("runlocal")
  config.model.variant = "mu/32"
  config.model.attn_impl = "xla"  # quicker to trace; the error comes first
  config.evals = {}
  # 300 epochs of 512 examples: past the 10,000 warmup steps.
  config.input.data = dict(name="synthetic", n=512, num_classes=1000, h=64,
                           w=64)
  config.input.batch_size = 8
  with pytest.raises(TypeError, match="multiple values for keyword "
                                      "argument 'lr_max'"):
    j_gsam.main(config=config, workdir=str(tmp_path))


def test_port_takes_the_config_lr_max_and_lr_min():
  config = t_i1k.get_config("runlocal,fewshot=none")
  config["evals"] = {}
  config["input"]["batch_size"] = 4
  trainer = t_gsam.Trainer(config, device="cpu")
  gsam = config["gsam"]
  assert trainer.gsam_kw == dict(gsam, lr_max=0.003, lr_min=0.003 * 3e-5)
  jmodel = j_vit.Model(num_classes=1000, **config["model"],
                       attn_impl="xla")
  params = convert.vit_params(trainer.model)
  it = trainer.input_iter()
  batch = next(it)
  it.close()
  step = 0
  lr = trainer.learning_rate(step)
  assert lr == config["lr"] * float(np.float32(trainer.sched_fns[0](step)))

  def loss_fn(p, x, y):
    logits, _ = jmodel.apply({"params": p}, x, train=True)
    return j_losses.sigmoid_xent(logits=logits, labels=y)
  want_loss, want = jax.jit(lambda p, x, y: j_gsam.gsam_gradient(
      loss_fn, p, x, y, lr=lr, **gsam))(
          params, batch["image"].numpy(), batch["labels"].numpy())
  got = trainer.update(batch)
  np.testing.assert_allclose(got["training_loss"].item(), float(want_loss),
                             rtol=BAR)
  # Zero-initialized heads make this gradient ill-conditioned in f32: the
  # JAX function's own eager and jitted runs differ by 9.7e-6 in it.
  np.testing.assert_allclose(got["l2_grads"].item(),
                             float(optax.global_norm(want)), rtol=1e-4)


def test_smoke_config_trains_through_the_command_line(tmp_path):
  from big_vision_torch.trainers.proj.gsam import train as t_gsam_train
  trainer = t_gsam_train.main([
      "--config", "big_vision_torch/configs/proj/gsam/smoke.py",
      "--workdir", str(tmp_path), "--device", "cpu"])
  assert isinstance(trainer, t_gsam.Trainer)
  with open(tmp_path / "big_vision_metrics.txt") as f:
    rows = [r for r in map(json.loads, f) if "training_loss" in r]
  assert [r["step"] for r in rows] == [5, 10]
  assert all(np.isfinite(r["training_loss"]) and r["l2_grads"] > 0
             for r in rows)
  assert os.path.exists(tmp_path / "ckpt.bv-LAST")

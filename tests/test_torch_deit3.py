"""DeiT-III distillation into FlexiViT in the port vs the JAX package.

The distill trainer names its predict fns "student_seqhw=<s>" and gives the
student's (logits, out) there. The DeiT-III init: a checkpoint in the
layout of the published ViT-B/16 at 384px (ViT-mu/16 here, random) loads
into the FlexiViT student (24x24 posemb to 7x7, patch 16 to 16) and into
the ViT teacher at 240px (24x24 to 15x15) as the JAX `load`s do, within
1e-6. `i1k_deit3_distill.py:runlocal` trains end to end on the CPU, with
its `minival` evals at step 0 and at the end.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from big_vision_torch.configs.proj.flexivit import i1k_deit3_distill
from big_vision_torch.models import vit as t_vit
from big_vision_torch.trainers.proj.flexi import distill as t_distill
from big_vision_torch.utils import checkpoints as t_ckpt
from big_vision_torch.utils import convert
from big_vision_torch.utils import trees
from big_vision_tpu.models import vit as j_vit
from big_vision_tpu.models.proj.flexi import vit as j_flexi


def test_distill_predict_fns_are_the_students():
  trainer = t_distill.Trainer(i1k_deit3_distill.get_config("runlocal"),
                              device="cpu")
  fns = trainer.predict_fns()
  assert "student_seqhw=30" in fns and "predict_seqhw=30" not in fns
  images = torch.from_numpy(np.random.RandomState(2).uniform(
      -1, 1, (2, 240, 240, 3)).astype(np.float32))
  with torch.no_grad():
    logits, out = fns["student_seqhw=10"](None, {"image": images})
    want, _ = trainer.model(images, seqhw=10)
  assert torch.equal(logits, want) and out["pre_logits"].shape == (2, 32)


def write_deit3(path, variant="mu/16", seed=5):
  """A random ViT at 384px in the DeiT-III checkpoint's layout (a 24x24
  posemb, [cls], a 1000-class head with nonzero weights)."""
  model = t_vit.Model(1000, variant=variant, pool_type="tok", image_size=384,
                      device="cpu")
  gen = torch.Generator().manual_seed(seed)
  model.initialize(gen)
  with torch.no_grad():
    model.head.weight.normal_(0.0, 0.02, generator=gen)
  t_ckpt.npz_save(convert.vit_params(model), path)


def test_deit3_init_matches_jax_load(tmp_path):
  path = str(tmp_path / "deit3.npz")
  write_deit3(path)
  config = i1k_deit3_distill.get_config(f"runlocal,init={path}")
  trainer = t_distill.Trainer(config, device="cpu")
  student_cfg = {k: v for k, v in config["student"].items()
                 if k != "attn_impl"}
  jstudent = j_flexi.Model(1000, **student_cfg)
  init = jax.device_get(jax.jit(jstudent.init)(
      jax.random.PRNGKey(0), jnp.zeros((1, 240, 240, 3)))["params"])
  want = j_flexi.load(init, path, student_cfg)
  got = convert.vit_params(trainer.model)
  assert got["pos_embedding"].shape == (1, 49, 32)
  for name, w in trees.flatten(jax.device_get(want)).items():
    np.testing.assert_allclose(trees.flatten(got)[name], w, atol=1e-6,
                               rtol=0, err_msg=name)
  jteacher = j_vit.Model(1000, variant="mu/16", pool_type="tok")
  init = jax.device_get(jax.jit(jteacher.init)(
      jax.random.PRNGKey(1), jnp.zeros((1, 240, 240, 3)))["params"])
  want = j_vit.load(init, path, {"variant": "mu/16", "pool_type": "tok"})
  got = convert.vit_params(trainer.teachers["prof"])
  assert got["pos_embedding"].shape == (1, 225, 32)
  for name, w in trees.flatten(jax.device_get(want)).items():
    np.testing.assert_allclose(trees.flatten(got)[name], w, atol=1e-6,
                               rtol=0, err_msg=name)


def test_deit3_runlocal_trains_with_its_evals(tmp_path):
  path = str(tmp_path / "deit3.npz")
  write_deit3(path)
  trainer = t_distill.main([
      "--device", "cpu", "--workdir", str(tmp_path / "wd"), "--config",
      f"big_vision_torch/configs/proj/flexivit/i1k_deit3_distill.py:"
      f"runlocal,init={path}"])
  assert trainer.first_step == 0
  rows = [json.loads(line) for line in
          (tmp_path / "wd" / "big_vision_metrics.txt").read_text()
          .splitlines()]
  steps = [r for r in rows if "training_loss" in r]
  assert [r["step"] for r in steps] == [1, 2, 3]
  for r in steps:
    assert math.isfinite(r["distill_loss"]) and r["distill_loss"] > 0
    assert r["distill_loss"] == r["distill_loss_prof"]
  evals = [r for r in rows if "minival_05/prec@1" in r]
  assert [r["step"] for r in evals] == [0, 3]
  for r in evals:
    for s in ("05", "10", "15", "30"):
      assert math.isfinite(r[f"minival_{s}/loss"])
      assert r[f"z/secs/eval/minival_{s}"] > 0
  # The student's head came from the checkpoint: its logits vary, so
  # the eval losses differ across the grids.
  assert len({evals[0][f"minival_{s}/loss"] for s in ("05", "10", "15",
                                                      "30")}) == 4

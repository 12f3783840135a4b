"""FlexiViT's eval predict fns in the port vs the JAX package.

The FlexiViT trainer's predict fns ("predict_seqhw=<s>") give the JAX
model's `apply(..., seqhw=s)` logits and `pre_logits` within 1e-5 relative
(f32, the JAX init with a seeded head carried over by `utils/convert`) at
240px at every seqhw of the evals (5, 10, 15 and 30; T = 901 takes the
port's blocked path) and at 224px at 15, the few-shot eval's images
(patch 14: a 16x16 grid). tests/test_torch_deit3.py has the distill
trainer's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch.configs.proj.flexivit import i21k_sup
from big_vision_torch.trainers.proj.flexi import train as t_train
from big_vision_torch.utils import convert
from big_vision_tpu.models.proj.flexi import vit as j_flexi

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _rel(got, want):
  return np.abs(got - want).max() / np.abs(want).max()


def _flexi_trainer():
  config = i21k_sup.get_config("runlocal")
  trainer = t_train.Trainer(config, device="cpu")
  kw = {k: v for k, v in config["model"].items() if k != "attn_impl"}
  jmodel = j_flexi.Model(config["num_classes"], **kw)
  params = jax.device_get(jax.jit(jmodel.init)(
      jax.random.PRNGKey(0), jnp.zeros((1, 240, 240, 3)))["params"])
  params["head"]["kernel"] = 0.1 * np.random.RandomState(0).randn(
      *params["head"]["kernel"].shape).astype(np.float32)
  convert.load(trainer.model, convert.vit(params))
  return trainer, jmodel, params


@pytest.mark.parametrize("res,seqhws", [(240, (5, 10, 15, 30)), (224, (15,))])
def test_predict_seqhw_matches_jax(res, seqhws):
  trainer, jmodel, params = _flexi_trainer()
  fns = trainer.predict_fns()
  assert sorted(fns) == sorted(f"predict_seqhw={s}" for s in (
      5, 6, 8, 10, 12, 15, 20, 24, 30, 40))
  images = np.random.RandomState(1).uniform(-1, 1, (2, res, res, 3)).astype(
      np.float32)
  apply = jax.jit(jmodel.apply, static_argnames="seqhw")
  for s in seqhws:
    with torch.no_grad():
      logits, out = fns[f"predict_seqhw={s}"](None, {
          "image": torch.from_numpy(images)})
    jlogits, jout = apply({"params": params}, jnp.asarray(images), seqhw=s)
    grid = res // (res // s)
    assert out["pre_logits_2d"].shape[1:3] == (grid, grid)
    assert _rel(logits.numpy(), np.asarray(jlogits)) <= 1e-5, s
    assert _rel(out["pre_logits"].numpy(),
                np.asarray(jout["pre_logits"])) <= 1e-5, s

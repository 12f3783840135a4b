"""Port's ViT vs the JAX ViT, with weights carried over by utils/convert.py.

A mu-sized tower at 64px, patch 16 (T=16, so the JAX model takes its flash
kernel in interpret mode and the port the kernel's plain version). Every
param leaf is drawn from a seed, so no zero-initialised head or norm can
hide a wrong mapping. Both the scan and the pyloop layouts go through the
converter. f32 throughout: outputs agree within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch.models import vit as t_vit
from big_vision_torch.utils import convert
from big_vision_torch.utils import trees
from big_vision_tpu.models import vit as j_vit

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def random_params(model, *inputs, seed=0, scale=0.5):
  """Every leaf of `model`'s param tree drawn from N(0, scale^2)."""
  shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *inputs)
  rs = np.random.RandomState(seed)
  return jax.tree.map(
      lambda s: (rs.randn(*s.shape) * scale).astype(np.float32),
      shapes["params"])


def close(got, want, rtol=1e-5):
  want = np.asarray(want)
  scale = max(1e-6, float(np.abs(want).max()))
  np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                             atol=rtol * scale)


@pytest.mark.parametrize("pool,rep,posemb,scan", [
    ("none", False, "learn", True),
    ("map", True, "sincos2d", False),
    ("tok", 24, "learn", False),
    ("gap", False, "sincos2d", True),
])
def test_vit_matches_jax(pool, rep, posemb, scan):
  cfg = dict(variant="mu/16", depth=2, pool_type=pool, rep_size=rep,
             posemb=posemb)
  image = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
  jmodel = j_vit.Model(num_classes=40, scan=scan, **cfg)
  params = random_params(jmodel, jnp.asarray(image))
  want, want_out = jmodel.apply({"params": params}, jnp.asarray(image))

  tmodel = t_vit.Model(num_classes=40, image_size=64, device="cpu", **cfg)
  convert.load(tmodel, convert.vit(params))
  with torch.no_grad():
    got, got_out = tmodel(torch.from_numpy(image))
  close(got, want)
  for key in ("encoded", "pre_logits", "logits_2d"):
    close(got_out[key], want_out[key])


def test_converter_rejects_unused_and_missing_leaves():
  model = j_vit.Model(num_classes=8, variant="mu/16")
  params = random_params(model, jnp.zeros((1, 32, 32, 3)))
  flat = trees.flatten(params)
  assert "Transformer/encoderblock_0/MlpBlock_0/Dense_0/kernel" in flat
  assert trees.flatten(trees.unflatten(flat)).keys() == flat.keys()
  assert convert.vit(flat).keys() == convert.vit(params).keys()
  with pytest.raises(ValueError, match="unused"):
    convert.vit({**params, "extra": np.zeros(3, np.float32)})
  state = convert.vit(params)
  state.pop("head.bias")
  with pytest.raises(ValueError, match="missing"):
    convert.load(t_vit.Model(num_classes=8, variant="mu/16", image_size=32,
                             device="cpu"), state)

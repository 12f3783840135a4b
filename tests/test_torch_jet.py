"""The port's Jet flow and its trainer against the JAX package's, on the
CPU.

Masks: the spatial masks bit-equal to JAX's initializer for every kind;
`mask_to_perm` equal to JAX's `_mask_to_perm` on JAX's random channel
permutations. The flow (random weights, `final_proj` too, carried by
`utils/convert.py`): forward latents, inverse and log-determinants
within 1e-5 of the JAX model's, with channel and spatial couplings and
with a context token's cross-attention; every gradient within 1e-4 of its
max; the round trip; the param tree back to JAX's names. `nll_bits_per_dim`
against JAX's. The trainer: a 3-step twin of configs/proj/jet/smoke.py, the
port's `train.train` against the JAX trainer's `main` from one init (an
`.npz` through `model_init`), the port's dequantization noise replaced by
the JAX trainer's draws of each step; every metric of every step within
1e-4 relative. The JAX conditioners' attention runs on its plain
reference (`_kernel_ok` patched to False: its Pallas kernels in interpret
mode only slow the test down); the port's runs the kernels' plain
versions.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch import optim as t_optim
from big_vision_torch import train as t_train
from big_vision_torch.configs.proj.jet import smoke as t_smoke
from big_vision_torch.models.proj.jet import jet as t_jet
from big_vision_torch.trainers.proj.jet import train as t_jet_train
from big_vision_torch.utils import checkpoints
from big_vision_torch.utils import convert
from big_vision_torch.utils import trees
from big_vision_tpu.configs.proj.jet import smoke as j_smoke
from big_vision_tpu.models.proj.jet import jet as j_jet
from big_vision_tpu.ops import attention as j_attention
from big_vision_tpu.trainers.proj.jet import train as j_jet_train

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True)
def _plain_jax_attention(monkeypatch):
  monkeypatch.setattr(j_attention, "_kernel_ok", lambda *a, **kw: False)


@pytest.mark.parametrize("kind", ["checkerboard", "checkerboard-inv",
                                  "vstripes", "vstripes-inv", "hstripes",
                                  "hstripes-inv", "zero"])
def test_spatial_masks_equal_jax(kind):
  kinds = (kind, "checkerboard")
  want = j_jet.get_spatial_coupling_init(2, (1, 8, 12, 3), 2, kinds)(
      None, jnp.float32)
  got = t_jet.spatial_masks(kinds, 4, 6)
  np.testing.assert_array_equal(got, np.asarray(want))


def test_mask_to_perm_equals_jax():
  masks = j_jet.get_channels_coupling_init(3, (1, 8, 8, 3), 2,
                                           ("random", "zero", "random"))(
      jax.random.PRNGKey(3), jnp.float32)
  for m in masks:
    want = j_jet._mask_to_perm(m)
    got = t_jet.mask_to_perm(torch.from_numpy(np.asarray(m)))
    for a, b in zip(want, got):
      np.testing.assert_array_equal(b.numpy(), np.asarray(a))
  x = np.random.RandomState(0).randn(2, 5, 12).astype(np.float32)
  fwd, inv = t_jet.mask_to_perm(torch.from_numpy(np.asarray(masks[0])))
  np.testing.assert_allclose(torch.from_numpy(x)[..., fwd].numpy(),
                             x @ np.asarray(masks[0]), atol=1e-6)
  np.testing.assert_allclose(torch.from_numpy(x)[..., inv].numpy(),
                             x @ np.asarray(masks[0]).T, atol=1e-6)


def _random_params(model, x, context=None, seed=0, scale=0.2):
  params = jax.jit(model.init)(jax.random.PRNGKey(seed), x,
                               context)["params"]
  rs = np.random.RandomState(seed)
  return jax.tree_util.tree_map_with_path(
      lambda p, v: np.asarray(v) if "FREEZE_ME" in jax.tree_util.keystr(p)
      else (rs.randn(*v.shape) * scale).astype(np.float32), params)


@pytest.mark.parametrize("case", ["channels+spatial", "context"])
def test_flow_equals_jax(case):
  cfg = dict(depth=3, block_depth=2, emb_dim=16, num_heads=2, ps=2,
             kinds=("channels", "spatial", "channels"),
             spatial_coupling_projs=("vstripes", "checkerboard-inv"))
  rs = np.random.RandomState(1)
  x = rs.rand(2, 8, 8, 3).astype(np.float32)
  context = None
  if case == "context":
    context = np.eye(5, dtype=np.float32)[[1, 3]][:, None, :]
  jmodel = j_jet.Model(**cfg)
  params = _random_params(jmodel, jnp.asarray(x),
                          None if context is None else jnp.asarray(context))
  tmodel = t_jet.Model(**cfg, image_shape=(8, 8, 3), device="cpu",
                       context_dim=None if context is None else 5)
  convert.load(tmodel, convert.state(tmodel, params))
  jc = None if context is None else jnp.asarray(context)
  tc = None if context is None else torch.from_numpy(context)

  def loss(p):
    z, ld = jmodel.apply({"params": p}, jnp.asarray(x), jc)
    return jnp.sum(z ** 2) - jnp.sum(ld), (z, ld)
  (_, (z, ld)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
      params)
  tz, tld = tmodel(torch.from_numpy(x), tc)
  ((tz ** 2).sum() - tld.sum()).backward()
  np.testing.assert_allclose(tz.detach().numpy(), np.asarray(z), rtol=1e-5,
                             atol=1e-5)
  np.testing.assert_allclose(tld.detach().numpy(), np.asarray(ld),
                             rtol=1e-5, atol=1e-5)
  want = convert.state(tmodel, jax.device_get(grads))
  top = max(np.abs(w).max() for w in want.values())
  for name, p in tmodel.named_parameters():
    if p.grad is None:
      assert "masks" in name
      continue
    scale = top if name.endswith("key.bias") else np.abs(want[name]).max()
    assert np.abs(p.grad.numpy() - want[name]).max() <= 1e-4 * scale, name

  xi, ldi = jax.jit(lambda p, z, c: jmodel.apply(
      {"params": p}, z, c, method=jmodel.inverse))(params, z, jc)
  with torch.no_grad():
    txi, tldi = tmodel.inverse(tz, tc)
  np.testing.assert_allclose(txi.numpy(), np.asarray(xi), atol=1e-5)
  np.testing.assert_allclose(tldi.numpy(), np.asarray(ldi), rtol=1e-5,
                             atol=1e-5)
  np.testing.assert_allclose(txi.numpy(), x, atol=1e-4)
  np.testing.assert_allclose(tldi.numpy(), -tld.detach().numpy(), rtol=1e-5,
                             atol=1e-5)
  back = trees.flatten(convert.params(tmodel))
  flat = trees.flatten(params)
  assert sorted(back) == sorted(flat)
  for k, v in flat.items():
    np.testing.assert_array_equal(back[k], v)


def test_init_is_the_identity_with_frozen_permutations():
  model = t_jet.Model(depth=4, ps=4, image_shape=(16, 16, 3), device="cpu")
  model.initialize(torch.Generator().manual_seed(0))
  x = torch.rand(2, 16, 16, 3)
  with torch.no_grad():
    z, ld = model(x)
  torch.testing.assert_close(z, x, rtol=0, atol=0)
  assert torch.all(ld == 0)
  for m in model.channel_masks[:2]:  # channel layers: permutations
    assert torch.all(m.sum(0) == 1) and torch.all(m.sum(1) == 1)
  assert not model.channel_masks.requires_grad


def test_bits_per_dim_equals_jax():
  rs = np.random.RandomState(0)
  z = rs.randn(4, 8, 8, 3).astype(np.float32)
  logdet = rs.randn(4).astype(np.float32) * 10
  for bw in (1.0 / 256.0, 2.0 / 255.0):
    want = j_jet_train.nll_bits_per_dim(jnp.asarray(z), jnp.asarray(logdet),
                                        bw)
    got = t_jet_train.nll_bits_per_dim(torch.from_numpy(z),
                                       torch.from_numpy(logdet), bw)
    for a, b in zip(want, got):
      np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def _jax_noise(config, count, shape, bin_width):
  """The JAX trainer's dequantization noise of the step `count`."""
  rng = jax.random.PRNGKey(config.get("seed", 0))
  rng, _ = jax.random.split(rng)
  _, rng_loop = jax.random.split(rng)
  rng_noise, _ = jax.random.split(jax.random.fold_in(rng_loop, count))
  return np.asarray(jax.random.uniform(rng_noise, shape)) * bin_width


def _rows(workdir):
  with open(workdir / "big_vision_metrics.txt") as f:
    return [r for r in map(json.loads, f) if "training_loss" in r]


def test_smoke_twin_tracks_the_jax_trainer(tmp_path):
  steps = 3
  init = tmp_path / "init.npz"
  model = t_jet.Model(**t_smoke.get_config()["model"],
                      image_shape=(16, 16, 3), device="cpu")
  model.initialize(torch.Generator().manual_seed(0))
  with torch.no_grad():  # a flow that is not the identity
    g = torch.Generator().manual_seed(1)
    fp = model.couplings.layer.dnn.final_proj
    fp.weight.copy_(0.05 * torch.randn(fp.weight.shape, generator=g))
  checkpoints.npz_save(convert.params(model), str(init))

  jax_config = j_smoke.get_config(f"total_steps={steps}")
  jax_config.update(model_init=str(init), log_training_steps=1,
                    ckpt_steps=None)
  j_jet_train.main(config=jax_config, workdir=str(tmp_path / "jax"))

  class Twin(t_jet_train.Trainer):
    def dequant_noise(self, x, rng):
      count = t_optim.get_count(self.opt_state)
      return torch.from_numpy(_jax_noise(self.config, count, tuple(x.shape),
                                         self.bin_width))

  config = t_smoke.get_config(f"total_steps={steps}")
  config.update(model_init=str(init), log_training_steps=1, ckpt_steps=None)
  t_train.train(config, str(tmp_path / "port"), device="cpu",
                trainer_cls=Twin)
  jax_rows, port_rows = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
  assert [r["step"] for r in jax_rows] == list(range(1, steps + 1))
  assert [r["step"] for r in port_rows] == list(range(1, steps + 1))
  for key in ("training_loss", "bits", "nll", "logdet", "l2_grads",
              "l2_params", "l2_updates"):
    for jr, pr in zip(jax_rows, port_rows):
      rel = abs(pr[key] - jr[key]) / max(abs(jr[key]), 1e-12)
      assert rel <= 1e-4, (key, jr["step"], pr[key], jr[key])

"""Port's MLP-Mixer vs JAX `models/mlp_mixer.py`.

A small Mixer (width 32, patch 8, 30px images: the SAME stem pads them to
a 4x4 grid) with the same params on both sides (the port's init from a
seed, the head kernel drawn too, so that the trunk gets gradients): logits and the gradients of
every param agree within 1e-5 relative in f32, in inference and in
training at `stoch_depth=1.0` over two blocks, where the blocks' drop
probabilities are 0 and 1, so that the masks are the same on both sides.
`load` reads a checkpoint in the model's layout and in the original
paper's ("Mixer"/"encoderblock_i" with fused MLP names) as the JAX `load`
does, and the converters carry params both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch.models import mlp_mixer as t_mixer
from big_vision_torch.utils import checkpoints
from big_vision_torch.utils import convert
from big_vision_tpu.models import mlp_mixer as j_mixer
from big_vision_tpu.utils import trees as j_trees

GEOM = dict(patch_size=(8, 8), hidden_dim=32, num_blocks=2,
            tokens_mlp_dim=12, channels_mlp_dim=64)
RES, CLASSES = 30, 10


def _rel(got, want):
  want = np.asarray(want)
  return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(),
                                                     1e-30)


def _setup(stoch_depth=0.0):
  """(JAX model, its params, the port's model with the same params,
  images): the port's init from a seed, the head kernel drawn too."""
  tmodel = t_mixer.Model(num_classes=CLASSES, stoch_depth=stoch_depth,
                         image_size=RES, device="cpu", **GEOM).initialize(
                             torch.Generator().manual_seed(0))
  with torch.no_grad():
    tmodel.head.weight.normal_(generator=torch.Generator().manual_seed(2))
  params = convert.mixer_params(tmodel)
  jmodel = j_mixer.Model(num_classes=CLASSES, stoch_depth=stoch_depth,
                         **GEOM)
  images = np.random.RandomState(1).uniform(
      -1, 1, (4, RES, RES, 3)).astype(np.float32)
  return jmodel, params, tmodel, images


def _check(train):
  jmodel, params, tmodel, images = _setup(1.0 if train else 0.0)
  weights = np.random.RandomState(3).randn(4, CLASSES).astype(np.float32)

  def jloss(p):
    logits, out = jmodel.apply({"params": p}, jnp.asarray(images),
                               train=train,
                               rngs={"dropout": jax.random.PRNGKey(5)})
    return jnp.sum(logits * weights), (logits, out["pre_logits"])

  (_, (jlogits, jpre)), jgrads = jax.jit(jax.value_and_grad(
      jloss, has_aux=True))(params)
  gen = torch.Generator().manual_seed(5)
  tlogits, out = tmodel(torch.from_numpy(images), train=train,
                        rng=gen if train else None)
  (tlogits * torch.from_numpy(weights)).sum().backward()
  assert _rel(tlogits.detach(), jlogits) <= 1e-5
  assert _rel(out["pre_logits"].detach(), jpre) <= 1e-5
  jflat = dict(j_trees.tree_flatten_with_names(jgrads)[0])
  tgrads = {name: p.grad for name, p in tmodel.named_parameters()}
  grads_tree = convert._params(tmodel, convert.mixer_names(tmodel),
                               lambda m, n, j, x: convert._mixer_layout(
                                   m, n, j, tgrads[n]))
  tflat = dict(j_trees.tree_flatten_with_names(grads_tree)[0])
  assert sorted(tflat) == sorted(jflat)
  scale = max(np.abs(g).max() for g in jflat.values())
  for name in jflat:
    if name.endswith("token_mixing/Dense_1/bias"):
      # A constant per token over the channels, which every later
      # LayerNorm removes: zero in exact arithmetic, rounding noise here.
      assert np.abs(tflat[name]).max() <= 1e-5 * scale, name
      continue
    assert _rel(tflat[name], jflat[name]) <= 1e-5, name
  return tlogits, tmodel, images


def test_logits_and_grads_match_jax():
  _check(train=False)


def test_stochastic_depth_at_one_drops_the_last_block():
  """p = 1.0 * i / (2 - 1): block 0 always kept, block 1 always dropped
  (no 1 / (1 - p) rescale), so training is deterministic and equals a
  model whose second block is the identity."""
  logits, tmodel, images = _check(train=True)
  del tmodel.blocks[1]
  want, _ = tmodel(torch.from_numpy(images))
  torch.testing.assert_close(logits.detach(), want, rtol=1e-6, atol=1e-6)


def test_variants_and_init():
  for variant in ("S/16", "B/16", "L/16", "H/14"):
    tm = t_mixer.Model(num_classes=5, variant=variant, device="meta")
    jm = j_mixer.Model(num_classes=5, variant=variant)
    assert (jm.hidden_dim, jm.num_blocks, jm.tokens_mlp_dim,
            jm.channels_mlp_dim, jm.patch_size) == (
                tm.stem.weight.shape[0], len(tm.blocks),
                tm.blocks[0].token_mixing.fc1.weight.shape[0],
                tm.blocks[0].channel_mixing.fc1.weight.shape[0],
                tm.stem.patch_size)
  tm = t_mixer.Model(num_classes=CLASSES, image_size=RES, device="cpu",
                     **GEOM).initialize(torch.Generator().manual_seed(0),
                                        head_bias=-6.9)
  assert not tm.head.weight.any()
  assert torch.all(tm.head.bias == -6.9)
  assert tm.blocks[0].ln0.eps == 1e-6
  with pytest.raises(ValueError, match="generator"):
    t_mixer.Model(num_classes=3, stoch_depth=0.1, image_size=RES,
                  device="cpu", **GEOM)(torch.zeros(1, RES, RES, 3),
                                        train=True)


def _paper_layout(params):
  """The original paper's checkpoint layout of a Mixer param tree."""
  paper = {"embedding": params["stem"], "head": params["head"],
           "Mixer": {"encoder_norm": params["pre_head_layer_norm"]}}
  for i in range(GEOM["num_blocks"]):
    block = dict(params[f"MixerBlock_{i}"])
    for mix in ("token_mixing", "channel_mixing"):
      mlp = block.pop(mix)
      block[f"{mix}_phase_0"] = {
          f"{k}{j + 1}": mlp[f"Dense_{j}"][k][None] for j in range(2)
          for k in ("kernel", "bias")}
    paper["Mixer"][f"encoderblock_{i}"] = block
  return paper


def test_load_and_converters_round_trip(tmp_path):
  _, params, tmodel, _ = _setup()
  back = convert.mixer_params(tmodel)
  flat = dict(j_trees.tree_flatten_with_names(params)[0])
  for name, x in j_trees.tree_flatten_with_names(back)[0]:
    np.testing.assert_array_equal(x, flat[name])
  assert set(convert.jax_shapes(tmodel).items()) == {
      (n, x.shape) for n, x in flat.items()}
  assert set(convert.names(tmodel).values()) == set(flat)
  init = jax.tree.map(np.zeros_like, params)
  for layout, tree in (("model", params), ("paper", _paper_layout(params))):
    path = str(tmp_path / f"{layout}.npz")
    checkpoints.npz_save(tree, path)
    got = t_mixer.load(init, path, None, dont_load=["head/.*"])
    want = j_mixer.load(init, path, None, dont_load=["head/.*"])
    want = dict(j_trees.tree_flatten_with_names(want)[0])
    got = dict(j_trees.tree_flatten_with_names(got)[0])
    assert sorted(got) == sorted(want)
    for name in want:
      np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert not got["head/kernel"].any()  # dont_load keeps the init
    np.testing.assert_array_equal(
        got["MixerBlock_1/token_mixing/Dense_0/kernel"],
        flat["MixerBlock_1/token_mixing/Dense_0/kernel"])

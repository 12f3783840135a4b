"""Port's BiT `load`s and converter (`models/bit.py`, `models/bit_paper.py`,
`utils/convert.py`) vs the JAX package.

`load` reads a checkpoint with (1, 1, 1, C) GN params (`bit`) and a
TF-release-layout `.npz` (`bit_paper`), both written here, as the JAX
`load`s read them; `fix_old_checkpoints` renumbers pre-linen class
counters as flax's `convert_pre_linen` does (the JAX function takes 14 s
to import its checkpoint library, so its renumbering is held by
`tests/test_torch_vit_load.py`'s copy). A `gs://` name is refused. The
converter carries params both ways, each flavour in its JAX GN shape.
Models at depth 26 and width 0.5, with every GN param drawn.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch.models import bit as t_bit
from big_vision_torch.models import bit_paper as t_bit_paper
from big_vision_torch.models import convnets as t_cn
from big_vision_torch.utils import checkpoints
from big_vision_torch.utils import convert
from big_vision_torch.utils import trees as t_trees
from big_vision_tpu.models import bit as j_bit
from big_vision_tpu.models import bit_paper as j_bit_paper

DEPTH, WIDTH, CLASSES = 26, 0.5, 10
MODULES = {"bit": (t_bit, j_bit), "bit_paper": (t_bit_paper, j_bit_paper)}


def _port(flavour, seed):
  """The port's model from a seed, with every GN param drawn."""
  model = MODULES[flavour][0].Model(
      num_classes=CLASSES, depth=DEPTH, width=WIDTH, device="cpu")
  model.initialize(torch.Generator().manual_seed(seed))
  gen = torch.Generator().manual_seed(seed + 1)
  with torch.no_grad():
    for module in model.modules():
      if isinstance(module, t_cn.GroupNorm):
        module.weight.add_(0.3 * torch.randn(module.weight.shape,
                                             generator=gen))
        module.bias.add_(0.3 * torch.randn(module.bias.shape, generator=gen))
  return model


def _images(n, res, seed=2):
  return torch.from_numpy(np.random.RandomState(seed).uniform(
      -1, 1, (n, res, res, 3)).astype(np.float32))

def test_bit_paper_load_reads_the_tf_release_layout(tmp_path):
  source, target = _port("bit_paper", 7), _port("bit_paper", 8)
  path = str(tmp_path / "bit_m.npz")
  checkpoints.npz_save(
      t_bit_paper.to_big_transfer_format(convert.params(source)), path)
  init = convert.params(target)
  cfg = dict(depth=DEPTH, width=WIDTH)
  got = t_bit_paper.load(init, path, cfg, dont_load=["head/.*"])
  want = j_bit_paper.load(init, path, cfg, dont_load=["head/.*"])
  got, want = t_trees.flatten(got), t_trees.flatten(jax.device_get(want))
  assert sorted(got) == sorted(want)
  src = t_trees.flatten(convert.params(source))
  for name in want:
    np.testing.assert_array_equal(got[name], want[name])
    assert got[name].shape == src[name].shape, name
    kept = name.startswith("head/")
    np.testing.assert_array_equal(
        got[name], t_trees.flatten(init)[name] if kept else src[name])
  convert.load(target, convert.state(target, t_trees.unflatten(got)))
  with torch.no_grad():
    x = _images(1, 32)
    np.testing.assert_array_equal(source(x)[1]["pre_logits"].numpy(),
                                  target(x)[1]["pre_logits"].numpy())


def test_bit_load_squeezes_old_group_norm_params(tmp_path):
  source, target = _port("bit", 7), _port("bit", 8)
  old = t_trees.flatten(convert.params(source))
  old = {k: v.reshape(1, 1, 1, -1) if "/gn" in f"/{k}" else v
         for k, v in old.items()}
  path = str(tmp_path / "bit_old.npz")
  checkpoints.npz_save(t_trees.unflatten(old), path)
  got = t_trees.flatten(t_bit.load(convert.params(target), path, None))
  want = t_trees.flatten(convert.params(source))
  assert sorted(got) == sorted(want)
  for name in want:
    np.testing.assert_array_equal(got[name], want[name])


def test_fix_old_checkpoints_renumbers_class_counters():
  c = 4
  old = {"Dense_1": {"kernel": np.ones((2, 3))},
         "Conv_0": {"kernel": np.ones((1, 1, 2, 2))},
         "Dense_3": {"kernel": np.zeros((3, 2))},
         "block1": {"unit1": {"gn1": {"scale": np.ones((1, 1, 1, c)),
                                      "bias": np.zeros((1, 1, 1, c))}}}}
  got = t_bit.fix_old_checkpoints(old)
  assert sorted(got) == ["Conv_0", "Dense_0", "Dense_1", "block1"]
  np.testing.assert_array_equal(got["Dense_1"]["kernel"], np.zeros((3, 2)))
  assert got["block1"]["unit1"]["gn1"]["scale"].shape == (c,)
  assert got["Conv_0"]["kernel"].shape == (1, 1, 2, 2)


@pytest.mark.parametrize("module,name", [
    (t_bit, "gs://bit_models/BiT-M-R50x1.npz"), (t_bit_paper, "M"),
    (t_bit_paper, "FunMatch-224px-i1k82.8")])
def test_published_names_are_refused(module, name):
  with pytest.raises(ValueError, match="not fetched.*`init`"):
    module.load({}, name, dict(depth=50, width=1))


@pytest.mark.parametrize("flavour", ["bit", "bit_paper"])
def test_converter_carries_params_both_ways(flavour):
  tmodel = _port(flavour, 0)
  params = convert.params(tmodel)
  jmodel = MODULES[flavour][1].Model(num_classes=CLASSES, depth=DEPTH,
                                     width=WIDTH)
  shapes = jax.eval_shape(lambda: jmodel.init(
      jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))["params"]
  want = {k: v.shape for k, v in t_trees.flatten(shapes).items()}
  got = t_trees.flatten(params)
  assert {k: v.shape for k, v in got.items()} == want
  assert convert.jax_shapes(tmodel) == want
  gn = "block1/unit01/gn1/scale" if flavour == "bit_paper" else (
      "block1/unit1/gn1/scale")
  assert want[gn] == ((1, 1, 1, 32) if flavour == "bit_paper" else (32,))
  other = _port(flavour, 9)
  convert.load(other, convert.state(other, params))
  for name, p in tmodel.state_dict().items():
    assert torch.equal(other.state_dict()[name], p), name

"""Port's ViT and FlexiViT checkpoint loading vs the JAX package's.

The same numpy trees (random leaves in the shapes of the JAX models'
params) go through both packages' `resample_posemb`,
`fix_old_checkpoints` (the three old layouts: the posemb in its own
`posembed_input` module with an extra [cls] row, the posemb inside
`Transformer`, the MAP head inlined at the top; and pre-Linen module
numbering), `pyloop_to_scan`/`scan_to_pyloop`, and `load` of both models
from an `.npz` file; `convert.vit_params` of the port's model gives the
JAX model's names and shapes.
Results agree exactly or within 1e-6 (posemb and patch-kernel resizes,
which both compute in f32 in another order).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch.models import vit as t_vit
from big_vision_torch.models.proj.flexi import vit as t_flexi
from big_vision_torch.utils import checkpoints as t_ckpt
from big_vision_torch.utils import convert
from big_vision_torch.utils import trees
from big_vision_tpu.models import vit as j_vit
from big_vision_tpu.models.proj.flexi import vit as j_flexi
from big_vision_tpu.utils import checkpoints as j_ckpt


def _assert_trees_close(got, want, atol=0.0):
  got, want = trees.flatten(got), trees.flatten(jax.device_get(want))
  assert sorted(got) == sorted(want)
  for name, w in want.items():
    assert np.shape(got[name]) == np.shape(w), name
    np.testing.assert_allclose(np.asarray(got[name]), np.asarray(w),
                               atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("old,new", [(7, 7), (14, 10), (4, 9)])
def test_resample_posemb_matches_jax(old, new):
  rs = np.random.RandomState(old + new)
  a = rs.randn(1, old * old, 8).astype(np.float32)
  b = np.zeros((1, new * new, 8), np.float32)
  np.testing.assert_allclose(t_vit.resample_posemb(a, b),
                             j_vit.resample_posemb(a, b), atol=1e-6, rtol=0)


def _leaf(rs, *shape):
  return rs.randn(*shape).astype(np.float32)


def _old_layouts():
  rs = np.random.RandomState(0)
  block = lambda: {"LayerNorm_0": {"scale": _leaf(rs, 4)},
                   "MlpBlock_3": {"Dense_0": {"kernel": _leaf(rs, 4, 8)},
                                  "Dense_1": {"kernel": _leaf(rs, 8, 4)}}}
  very_old = {  # pre-Linen numbering, posembed_input, N+1 posemb rows
      "cls": _leaf(rs, 1, 1, 4),
      "Transformer": {"posembed_input": {"pos_embedding": _leaf(rs, 1, 17, 4)},
                      **{f"encoderblock_{i}": block() for i in (0, 2, 10)}}}
  pre_2022 = {"cls": _leaf(rs, 1, 1, 4),
              "Transformer": {"pos_embedding": _leaf(rs, 1, 16, 4),
                              "encoderblock_0": block()}}
  map_inlined = {"probe": _leaf(rs, 1, 1, 4), "MlpBlock_0": block(),
                 "MultiHeadDotProductAttention_0": {"w": _leaf(rs, 4)},
                 "LayerNorm_0": {"scale": _leaf(rs, 4)},
                 "Transformer": {"encoderblock_0": block()}}
  return [very_old, pre_2022, map_inlined]


@pytest.mark.parametrize("i", range(3))
def test_fix_old_checkpoints_matches_jax(i):
  tree = _old_layouts()[i]
  got = t_vit.fix_old_checkpoints(copy.deepcopy(tree))
  want = j_vit.fix_old_checkpoints(copy.deepcopy(tree))
  _assert_trees_close(got, want)
  if i == 0:  # encoderblock_{0,2,10} renumbered 0, 1, 2 in natural order
    assert sorted(got["Transformer"]) == [f"encoderblock_{j}"
                                          for j in range(3)]
    assert "MlpBlock_0" in got["Transformer"]["encoderblock_2"]


def test_scan_and_pyloop_layouts_match_jax():
  tree = _old_layouts()[1]
  tree = t_vit.fix_old_checkpoints(tree)
  tree["Transformer"]["encoderblock_1"] = copy.deepcopy(
      tree["Transformer"]["encoderblock_0"])
  scan = t_vit.pyloop_to_scan(tree)
  _assert_trees_close(scan, j_vit.pyloop_to_scan(tree))
  _assert_trees_close(t_vit.scan_to_pyloop(scan), j_vit.scan_to_pyloop(scan))
  _assert_trees_close(t_vit.scan_to_pyloop(scan), tree)


def _jax_init(model, res, seed=0):
  """The JAX model's param tree at `res` px (shapes from `eval_shape`),
  every leaf drawn from `seed`."""
  rs = np.random.RandomState(seed)
  shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, res, res, 3)))["params"]
  return jax.tree.map(lambda x: rs.randn(*x.shape).astype(np.float32),
                      shapes)


def _old_checkpoint(params, rs):
  """`params` in the oldest layout: posemb with a [cls] row, hoisted into
  Transformer/posembed_input."""
  old = copy.deepcopy(params)
  pe = old.pop("pos_embedding")
  pe = np.concatenate([_leaf(rs, 1, 1, pe.shape[-1]), pe], axis=1)
  old["Transformer"]["posembed_input"] = {"pos_embedding": pe}
  return old


def test_vit_load_matches_jax(tmp_path):
  kw = dict(variant="mu/8", pool_type="tok", posemb="learn")
  ckpt = _old_checkpoint(_jax_init(j_vit.Model(10, **kw), 40, 1),
                         np.random.RandomState(1))
  fname = str(tmp_path / "old.npz")
  j_ckpt.npz_save(ckpt, fname)

  init = _jax_init(j_vit.Model(10, **kw), 56)  # posemb 5x5 -> 7x7
  port = t_vit.Model(10, image_size=56, device="cpu", **kw)
  _assert_trees_close(jax.tree.map(np.zeros_like, convert.vit_params(port)),
                      jax.tree.map(np.zeros_like, init))
  got = t_vit.load(init, fname, kw, dont_load=["head/.*"])
  want = j_vit.load(init, fname, kw, dont_load=["head/.*"])
  _assert_trees_close(got, want, atol=1e-6)
  np.testing.assert_array_equal(got["head"]["kernel"], init["head"]["kernel"])
  convert.load(port, convert.vit(got))  # the tree fits the port's module


def test_flexi_load_matches_jax(tmp_path):
  ckpt = _old_checkpoint(
      _jax_init(j_vit.Model(10, variant="mu/8", pool_type="tok"), 48, 2),
      np.random.RandomState(2))
  fname = str(tmp_path / "b8.npz")
  j_ckpt.npz_save({"params": ckpt}, fname)  # published files nest "params"
  kw = dict(variant="mu", pool_type="tok", patch_size=(16, 16),
            posemb_size=(5, 5))
  init = _jax_init(j_flexi.Model(10, **kw), 80)
  got = t_flexi.load(init, fname, kw)
  want = j_flexi.load(init, fname, kw)
  _assert_trees_close(got, want, atol=1e-6)
  port = t_flexi.Model(10, device="cpu", **kw)
  convert.load(port, convert.vit(got))
  torch.testing.assert_close(
      port.embedding.weight,
      torch.from_numpy(np.asarray(want["embedding"]["kernel"]).reshape(
          -1, 32).T.copy()), atol=1e-6, rtol=0)
  assert t_ckpt.load_params(fname)["cls"].shape == (1, 1, 32)

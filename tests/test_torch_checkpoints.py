"""Port's checkpoints and `.npz` params vs the JAX package's.

`.npz` files written by either package are read by the other with equal
arrays (bf16 leaves come back as bf16 in JAX and as the same values in f32
in the port); `load_params` selects a `file.npz:sub/tree` and unwraps
{"params": ...} as the JAX one does; `merge_params` keeps `dont_load`
leaves at their init and lists any other mismatch. The port's own
checkpoints keep the JAX pointer protocol (`{prefix}-LAST`, `-tmp`
checkpoints replaced by the next one, kept ones left), and a trainer
built on a workdir with a checkpoint, or given `resume`, restores params
and optimizer state bit for bit; `model_init` loads params through the
model's `load`.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch import train as t_train
from big_vision_torch.configs import vit_b16_synthetic
from big_vision_torch.models import common as t_common
from big_vision_torch.utils import checkpoints as t_ckpt
from big_vision_torch.utils import convert
from big_vision_tpu.models import common as j_common
from big_vision_tpu.utils import checkpoints as j_ckpt


def _tree(seed=0):
  rs = np.random.RandomState(seed)
  return {"params": {
      "a": {"kernel": rs.randn(3, 4).astype(np.float32),
            "bias": rs.randn(4).astype(np.float32)},
      "b": {"c": {"w": rs.randint(0, 9, (2, 5)).astype(np.int32)}},
      "scale": rs.randn(6).astype(np.float32)}}


def test_npz_written_by_jax_is_read_by_the_port(tmp_path):
  tree = _tree()
  tree["params"]["half"] = jnp.asarray(np.arange(5, dtype=np.float32) / 3,
                                       jnp.bfloat16)
  j_ckpt.npz_save(tree, str(tmp_path / "j.npz"))
  got = t_ckpt.npz_load(str(tmp_path / "j.npz"))
  want = j_ckpt.npz_load(str(tmp_path / "j.npz"))
  assert set(t_ckpt.trees.flatten(got)) == set(t_ckpt.trees.flatten(want))
  for name, x in t_ckpt.trees.flatten(want).items():
    g = t_ckpt.trees.flatten(got)[name]
    np.testing.assert_array_equal(g, np.asarray(x, np.float32))
    if name.endswith("half"):
      assert g.dtype == np.float32 and str(x.dtype) == "bfloat16"
    else:
      assert g.dtype == x.dtype


def test_npz_written_by_the_port_is_read_by_jax(tmp_path):
  tree = _tree(1)
  tree["params"]["t"] = torch.arange(6, dtype=torch.float32).reshape(2, 3)
  tree["params"]["half"] = (torch.arange(5) / 3).to(torch.bfloat16)
  t_ckpt.npz_save(tree, str(tmp_path / "sub" / "t.npz"))
  got = j_ckpt.npz_load(str(tmp_path / "sub" / "t.npz"))
  flat = j_ckpt.trees.tree_flatten_with_names(got)[0]
  assert len(flat) == 6
  for name, x in flat:
    want = t_ckpt.trees.get(tree, name)
    if isinstance(want, torch.Tensor):
      if want.dtype == torch.bfloat16:
        assert str(x.dtype) == "bfloat16"
      want = want.float().numpy()
    np.testing.assert_array_equal(np.asarray(x, np.float32), want)
  with pytest.raises(ValueError, match="missing"):
    t_ckpt.npz_load(str(tmp_path / "sub" / "t.npz"),
                    tree={"params": {"nope": 0}})


@pytest.mark.parametrize("spec", ["{f}", "{f}:a", "{f}:b/c"])
def test_load_params_matches_jax(tmp_path, spec):
  fname = str(tmp_path / "p.npz")
  j_ckpt.npz_save(_tree(2), fname)
  got = t_ckpt.load_params(spec.format(f=fname))
  want = j_ckpt.load_params(spec.format(f=fname))
  got_flat, want_flat = (t_ckpt.trees.flatten(x) for x in (got, want))
  assert set(got_flat) == set(want_flat) and got_flat
  for name in want_flat:
    np.testing.assert_array_equal(got_flat[name], want_flat[name])
  with pytest.raises(ValueError):
    t_ckpt.load_params(str(tmp_path))


def test_merge_params_matches_jax():
  loaded = _tree(3)["params"]
  inited = {**_tree(4)["params"], "new": {"kernel": np.zeros(2, np.float32)}}
  del inited["scale"]
  dont_load = ["new/.*", "scale"]
  got = t_common.merge_params(loaded, inited, dont_load)
  want = j_common.merge_params(loaded, inited, dont_load)
  assert t_ckpt.trees.flatten(got).keys() == t_ckpt.trees.flatten(want).keys()
  for name, x in t_ckpt.trees.flatten(want).items():
    np.testing.assert_array_equal(t_ckpt.trees.flatten(got)[name], x)
  np.testing.assert_array_equal(got["a"]["kernel"], loaded["a"]["kernel"])
  np.testing.assert_array_equal(got["new"]["kernel"], inited["new"]["kernel"])

  for fn in (t_common.merge_params, j_common.merge_params):
    with pytest.raises(ValueError) as err:
      fn(loaded, inited, ["new/.*"])
    assert " + scale  (in checkpoint, not in model)" in str(err.value)
    with pytest.raises(ValueError) as err:
      fn(loaded, inited)
    assert " - new/kernel  (in model, not in checkpoint)" in str(err.value)


def test_last_pointer_advances(tmp_path):
  prefix = str(tmp_path / "ckpt.bv")
  assert t_ckpt.last_checkpoint_dir(prefix) is None
  x = torch.arange(4.0)
  mgr = t_ckpt.CheckpointManager()
  mgr.save({"params": {"x": x}, "opt": {"count": 1}}, prefix, 1)
  x += 10  # after the save returns: not in the file
  mgr.save({"params": {"x": x}, "opt": {"count": 2}}, prefix, 2, keep=True)
  mgr.wait_until_finished()
  assert t_ckpt.last_checkpoint_dir(prefix) == f"{prefix}-000000002"
  assert not os.path.exists(f"{prefix}-000000001-tmp")
  mgr.save({"params": {"x": x * 2}, "opt": {"count": 3}}, prefix, 3)
  mgr.close()
  assert t_ckpt.last_checkpoint_dir(prefix) == f"{prefix}-000000003-tmp"
  assert os.path.exists(f"{prefix}-000000002")  # kept
  loaded = t_ckpt.load_checkpoint(t_ckpt.last_checkpoint_dir(prefix))
  assert loaded["opt"]["count"] == 3
  torch.testing.assert_close(loaded["params"]["x"], x * 2, rtol=0, atol=0)
  kept = t_ckpt.load_checkpoint(f"{prefix}-000000002")
  torch.testing.assert_close(kept["params"]["x"], torch.arange(4.0) + 10,
                             rtol=0, atol=0)


def _config():
  config = vit_b16_synthetic.get_config("runlocal")
  config["optax"] = dict(mu_dtype="bfloat16")  # a bf16 moment survives too
  return config


def _equal_state(a, b):
  assert a.opt_state["count"] == b.opt_state["count"]
  for name in a.params:
    assert torch.equal(a.params[name], b.params[name]), name
  for part in ("mu", "nu"):
    for name, x in a.opt_state[part].items():
      y = b.opt_state[part][name]
      assert x.dtype == y.dtype and torch.equal(x, y), (part, name)


def test_resumed_trainer_restores_params_and_optimizer(tmp_path):
  config = _config()
  trainer = t_train.Trainer(config, device="cpu", workdir=str(tmp_path))
  assert trainer.first_step == 0
  it = trainer.input_iter()
  for _ in range(2):
    trainer.update(next(it))
  it.close()
  t_ckpt.save_checkpoint(trainer.state(), trainer.ckpt_prefix, 2)

  resumed = t_train.Trainer(config, device="cpu", workdir=str(tmp_path))
  assert resumed.first_step == 2
  _equal_state(trainer, resumed)
  # `resume` (no checkpoint in the workdir) restores the same state.
  path = t_ckpt.last_checkpoint_dir(trainer.ckpt_prefix)
  other = t_train.Trainer({**config, "resume": path}, device="cpu")
  assert other.first_step == 2
  _equal_state(trainer, other)


def test_model_init_loads_through_vit_load(tmp_path):
  config = _config()
  source = t_train.Trainer({**config, "seed": 7}, device="cpu")
  fname = str(tmp_path / "init.npz")
  t_ckpt.npz_save(convert.vit_params(source.model), fname)
  trainer = t_train.Trainer({**config, "model_init": fname,
                             "model_load": dict(dont_load=["head/.*"])},
                            device="cpu")
  fresh = t_train.Trainer(config, device="cpu")
  for name, p in trainer.params.items():
    want = (fresh if name.startswith("head/") else source).params[name]
    assert torch.equal(p, want), name

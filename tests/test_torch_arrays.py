"""The `arrays` source and the digits of configs/quality_digits.py.

The port's `arrays` source (datasets/arrays.py) against the JAX package's:
the same examples in the same order, `_id` included, for an ordered pass
and for shuffled epochs, from a dict and from an `.npz`. The digits split
that the port writes from its committed scans (`datasets.digits`) equals
the one the JAX package's tools/run_quality.py `make_split` writes from
sklearn's `load_digits`, bit for bit; the `arrays` source writes it where
a config names a digits file that is absent. configs/quality_digits.py's
`runlocal` trains on it through `train.main` on the CPU, with its evals.
configs/twin_dynamics.py refuses `side=ref`.
"""

import json
import os

import numpy as np
import pytest

from big_vision_torch import train as t_train
from big_vision_torch.configs import twin_dynamics as t_twin
from big_vision_torch.datasets import arrays as t_arrays
from big_vision_torch.datasets import core as t_core
from big_vision_torch.datasets import digits
from big_vision_tpu.datasets import arrays as j_arrays
from tools import run_quality


def _data():
  rng = np.random.default_rng(3)
  return {"image": rng.integers(0, 255, (23, 4, 4, 3), np.uint8),
          "label": rng.integers(0, 10, 23)}


def _equal(got, want):
  got, want = list(got), list(want)
  assert len(got) == len(want) > 0
  for a, b in zip(got, want):
    assert sorted(a) == sorted(b)
    for k in b:
      assert type(a[k]) is type(b[k]) and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("ordered,seed,epoch", [
    (True, 0, 0), (False, 0, 0), (False, 0, 1), (False, 5, 2)])
def test_arrays_source_matches_jax(tmp_path, ordered, seed, epoch):
  path = str(tmp_path / "a.npz")
  np.savez(path, **_data())
  for kw in (dict(data=_data()), dict(npz=path)):
    port, ref = t_core.get("arrays", **kw), j_arrays.DataSource(**kw)
    assert port.total_examples == ref.total_examples == 23
    assert port.num_examples_per_process() == ref.num_examples_per_process()
    _equal(port.get_examples(ordered=ordered, seed=seed, epoch=epoch),
           ref.get_examples(ordered=ordered, seed=seed, epoch=epoch))


def test_ragged_arrays_are_refused():
  with pytest.raises(AssertionError, match="Ragged"):
    t_arrays.DataSource(data={"a": np.zeros(3), "b": np.zeros(4)})


def test_digits_split_equals_run_quality(tmp_path):
  want = run_quality.make_split(str(tmp_path / "jax"))
  assert digits.make_split(str(tmp_path / "port")) == want == (1437, 360)
  for name in digits.SPLIT_FILES:
    a = np.load(tmp_path / "jax" / name)
    b = np.load(tmp_path / "port" / name)
    assert sorted(a) == sorted(b) == ["image", "label"]
    for k in a:
      assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
  assert b["image"].shape == (360, 8, 8, 3) and b["label"].dtype == np.int64


def test_arrays_source_writes_an_absent_digits_split(tmp_path):
  src = t_arrays.DataSource(npz=str(tmp_path / "d" / "digits_test.npz"))
  assert src.total_examples == 360
  assert sorted(os.listdir(tmp_path / "d")) == sorted(digits.SPLIT_FILES)
  with pytest.raises(FileNotFoundError):
    t_arrays.DataSource(npz=str(tmp_path / "d" / "other.npz"))


def test_quality_digits_runlocal_trains(tmp_path):
  spec = (f"big_vision_torch/configs/quality_digits.py:runlocal=True,"
          f"batch_size=32,npz_dir={tmp_path / 'digits'}")
  t_train.main(["--config", spec, "--workdir", str(tmp_path / "wd"),
                "--device", "cpu"])
  with open(tmp_path / "wd" / "big_vision_metrics.txt") as f:
    rows = list(map(json.loads, f))
  evals = [r for r in rows if "val/prec@1" in r]
  assert [r["step"] for r in evals] == [0, 20, 40]
  assert all(0 <= r["val/prec@1"] <= 1 for r in evals)
  losses = [r["training_loss"] for r in rows if "training_loss" in r]
  assert len(losses) == 1 and np.isfinite(losses[0])  # logged at step 40


def test_twin_refuses_the_reference_side():
  with pytest.raises(ValueError, match="side='ref'"):
    t_twin.get_config("side=ref,npz=x")

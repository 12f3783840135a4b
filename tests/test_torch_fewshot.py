"""Port's few-shot linear probe (`evaluators/fewshot_lsr.py`) vs the JAX
package's.

The fit is numpy on the host in both packages, so the held values are
equal, not close: the ridge cache in both of its branches (n >= d, from
x^T x, and n < d, from x x^T), the accuracies of a run over every shot
count and seed on features with class structure (class means plus noise,
where a fit that draws other examples or solves another system gives
other accuracies), with the `a/` prefix on `display_first` pairs and `z/`
on the others. The representations themselves (`_embed`: the predict fn's
`pre_logits` on the eval pipeline's batches, padding left out) are held
within 1e-6 on synthetic JPEGs, and the few-shot config's keys against
`big_vision_tpu/configs/common_fewshot.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch.configs import common_fewshot as t_cfg
from big_vision_torch.evaluators import fewshot_lsr as t_fs
from big_vision_tpu.configs import common_fewshot as j_cfg
from big_vision_tpu.evaluators import fewshot_lsr as j_fs
import big_vision_tpu.pp.ops_general  # noqa: F401  (JAX registrations)
import big_vision_tpu.pp.ops_image  # noqa: F401

PP = "decode|resize(12)|value_range(-1, 1)|keep('image', 'label')"


def _data(n, num_classes):
  return dict(name="synthetic", n=n, num_classes=num_classes, h=20, w=24,
              unique_images=n)


def _datasets():
  return {"pets": dict(data_train=_data(14, 3), data_test=_data(7, 3),
                       pp=PP, num_classes=3)}


def _structured(rng, n, d, num_classes, noise=1.5):
  """(features [n, d], labels [n]): class means plus noise."""
  means = rng.normal(size=(num_classes, d)).astype(np.float32)
  y = rng.integers(0, num_classes, n).astype(np.int32)
  x = means[y] + noise * rng.normal(size=(n, d)).astype(np.float32)
  return x, y


@pytest.mark.parametrize("n,d", [(60, 9), (12, 40)])
def test_ridge_cache_matches_jax(n, d):
  rng = np.random.default_rng(0)
  x, y = _structured(rng, n, d, 4)
  got = t_fs._precompute_cache(x, y, 4)
  want = j_fs._precompute_cache(x, y, 4)
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  x_te, y_te = _structured(rng, 30, d, 4)
  for l2 in (2.0 ** 10, 1.0):
    assert (t_fs._fewshot_acc(got, x_te, y_te, l2)
            == j_fs._fewshot_acc(want, x_te, y_te, l2))


def _evaluators(**kw):
  t_pred = lambda ts, b: (b["image"].sum(), {
      "pre_logits": b["image"].reshape(b["image"].shape[0], -1)[:, ::37]})
  j_pred = lambda ts, b: (b["image"].sum(), {
      "pre_logits": b["image"].reshape(b["image"].shape[0], -1)[:, ::37]})
  got = t_fs.Evaluator(t_pred, batch_size=4, device="cpu",
                       datasets=_datasets(), **kw)
  want = j_fs.Evaluator(j_pred, batch_size=4, devices=[jax.devices()[0]],
                        datasets=_datasets(), **kw)
  return got, want


def test_representations_match_jax():
  got, want = _evaluators(shots=(1,), representation_layer="pre_logits")
  for i in range(2):  # the training split, then the test split
    x, y = got._embed({}, got.pipelines["pets"][i])
    jx, jy = want._embed({}, want.pipelines["pets"][i])
    assert x.shape == jx.shape and x.shape[0] == (14, 7)[i]
    np.testing.assert_allclose(x, jx, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(y, jy)


def test_run_matches_jax_on_structured_features():
  """Two datasets: "easy" (d=8, so 1 shot of 6 classes takes the n < d
  branch and more shots the n >= d one) and "wide" (d=300, n < d
  throughout)."""
  kw = dict(shots=(1, 5, 10, 25), num_seeds=3, l2_reg=2.0 ** 4,
            display_first=[("easy", 5), ("wide", 25)])
  got, want = _evaluators(**kw)
  rng = np.random.default_rng(1)
  feats = {}
  for name, d in (("easy", 8), ("wide", 300)):
    means = rng.normal(size=(6, d)).astype(np.float32) * 2
    for split, n in (("train", 200), ("test", 90)):
      y = np.arange(n, dtype=np.int32) % 6
      x = means[y] + rng.normal(size=(n, d)).astype(np.float32)
      feats[(split, name)] = (x, y)
  for ev in (got, want):
    ev.pipelines = {name: (("train", name), ("test", name), 6)
                    for name in ("easy", "wide")}
    ev._embed = lambda train_state, pipe: feats[pipe]
  rows, jrows = list(got.run({})), list(want.run({}))
  assert rows == [(k, float(v)) for k, v in jrows]
  assert [k for k, _ in rows] == [
      f"{'a' if (name, shot) in kw['display_first'] else 'z'}/"
      f"{name}_{shot}shot" for name in ("easy", "wide")
      for shot in kw["shots"]]
  accs = dict(rows)
  assert 0.4 < accs["a/easy_5shot"] <= 1.0  # chance is 1/6
  assert len(set(accs.values())) > 3


@pytest.mark.parametrize("runlocal", [False, True])
def test_config_keys_match_jax(runlocal):
  got = t_cfg.get_fewshot_lsr(runlocal=runlocal)
  want = j_cfg.get_fewshot_lsr(runlocal=runlocal).to_dict()
  assert sorted(got) == sorted(want)
  for k in want:
    if k != "datasets":
      assert tuple(got[k]) == tuple(want[k]) if isinstance(
          want[k], (list, tuple)) else got[k] == want[k], k
  assert sorted(got["datasets"]) == sorted(want["datasets"])
  for name, ds in want["datasets"].items():
    assert got["datasets"][name]["num_classes"] == ds["num_classes"]
    assert got["datasets"][name]["pp"] == ds["pp"]
    for split in ("data_train", "data_test"):
      data = got["datasets"][name][split]
      assert data["name"] == "synthetic"
      assert data["num_classes"] == ds["num_classes"]
  only = t_cfg.get_fewshot_lsr(examples=925, only=("pets",))
  assert list(only["datasets"]) == ["pets"]
  assert only["datasets"]["pets"]["data_train"]["n"] == 925

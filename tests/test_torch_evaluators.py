"""Port's eval plumbing and classification evaluator vs the JAX package's.

`make_for_inference` on 13 synthetic JPEGs in batches of 4 gives the JAX
pipeline's batches (one JAX device): images within 1e-6, labels, `_mask`
(1 for the 13 examples, 0 for the 3 of padding) and `_id` (-1 on padding)
equal. The classification evaluator on a tiny ViT, with the JAX params
carried across by `utils/convert`, gives the JAX evaluator's `prec@1`
(the same count of hits) and its `loss` within 1e-5 relative; its masked
sums leave out padding and all-zero label rows as the JAX `get_eval_fn`
does. Also: the
spec normalization (prefix, predict fn, log steps, the batch-size ladder)
against the JAX `_normalize_spec`, the cache levels of
`eval_input_pipeline`, the refusal of evaluators the port lacks, and the
image-folder source against the JAX one.
"""

import io

import jax
import jax.numpy as jnp
import ml_collections
import numpy as np
import pytest
import torch
from PIL import Image

from big_vision_torch import input_pipeline as t_ip
from big_vision_torch.datasets import core as t_core
from big_vision_torch.evaluators import classification as t_cls
from big_vision_torch.evaluators import common as t_common
from big_vision_torch.models import vit as t_vit
from big_vision_torch.utils import convert
from big_vision_torch.utils import losses as t_losses
from big_vision_tpu import input_pipeline as j_ip
from big_vision_tpu.datasets import core as j_core
from big_vision_tpu.evaluators import classification as j_cls
from big_vision_tpu.evaluators import common as j_common
from big_vision_tpu.models import vit as j_vit
import big_vision_tpu.pp.ops_general  # noqa: F401  (JAX registrations)
import big_vision_tpu.pp.ops_image  # noqa: F401

DATA = dict(name="synthetic", n=13, num_classes=3, h=40, w=48,
            unique_images=13)
PP = ("decode|resize_small(36)|central_crop(32)|value_range(-1, 1)"
      "|onehot(3, key='label', key_result='labels')|keep('image', 'labels')")
MODEL = dict(width=16, depth=1, num_heads=2, mlp_dim=32, patch_size=(8, 8),
             posemb="sincos2d", pool_type="gap")


def _jax_device():
  return [jax.devices()[0]]


def test_make_for_inference_equals_jax():
  make, steps = t_ip.make_for_inference(DATA, PP, 4, device="cpu",
                                        cache_raw=True)
  jmake, jsteps = j_ip.make_for_inference(DATA, PP, 4, devices=_jax_device(),
                                          num_threads=2)
  assert steps == jsteps == 4
  want = [jax.device_get(b) for b in jmake()]
  for _ in range(2):  # the second pass reads the cached raw examples
    got = [{k: v.numpy() for k, v in b.items()} for b in make()]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
      assert sorted(g) == sorted(w) == ["_id", "_mask", "image", "labels"]
      np.testing.assert_allclose(g["image"], w["image"], atol=1e-6, rtol=0)
      for k in ("labels", "_mask", "_id"):
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
  np.testing.assert_array_equal(np.concatenate([b["_mask"] for b in got]),
                                [1] * 13 + [0] * 3)
  np.testing.assert_array_equal(np.concatenate([b["_id"] for b in got]),
                                list(range(13)) + [-1] * 3)
  assert got[0]["_id"].dtype == np.int64


def _models():
  jmodel = j_vit.Model(num_classes=3, **MODEL)
  params = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 32, 32, 3)))["params"])
  params["head"]["kernel"] = np.random.RandomState(0).randn(
      *params["head"]["kernel"].shape).astype(np.float32) * 3
  params["head"]["bias"] = np.asarray([0.3, -0.2, 0.1], np.float32)
  tmodel = t_vit.Model(num_classes=3, image_size=32, device="cpu", **MODEL)
  tmodel.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in convert.vit(params).items()})
  return jmodel, params, tmodel


def test_classification_evaluator_equals_jax():
  jmodel, params, tmodel = _models()
  t_eval = t_cls.Evaluator(lambda ts, b: (tmodel(b["image"])[0], {}),
                           "softmax_xent", data=DATA, pp_fn=PP,
                           batch_size=4, device="cpu", cache="none")
  j_eval = j_cls.Evaluator(
      lambda ts, b: (jmodel.apply({"params": ts["params"]}, b["image"])[0],
                     {}),
      "softmax_xent", data=DATA, pp_fn=PP, batch_size=4,
      devices=_jax_device(), cache="none")
  got = dict(t_eval.run({}))
  want = dict(j_eval.run({"params": params}))
  assert sorted(got) == sorted(want) == ["loss", "prec@1"]
  # The same count of hits; JAX divides by n in f32, the port in f64.
  assert round(got["prec@1"] * 13) == round(float(want["prec@1"]) * 13)
  assert got["prec@1"] == pytest.approx(float(want["prec@1"]), rel=1e-7)
  assert 0 < got["prec@1"] < 1
  np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=1e-5)


def test_masked_sums_equal_jax_get_eval_fn():
  """Padding rows (mask 0) and all-zero label rows count nowhere."""
  rng = np.random.default_rng(1)
  logits = rng.normal(size=(6, 4)).astype(np.float32)
  labels = np.eye(4, dtype=np.float32)[[0, 1, 2, 3, 1, 0]]
  labels[2] = 0.0  # an example without a label
  labels[5] = [0.0, 0.5, 0.5, 0.0]  # soft labels
  mask = np.asarray([1, 1, 1, 1, 1, 0], np.int32)
  got = t_cls.batch_sums(lambda ts, b: (b["logits"],), t_losses.softmax_xent,
                         None, {"logits": torch.from_numpy(logits)},
                         torch.from_numpy(labels), torch.from_numpy(mask))
  j_fn = j_cls.get_eval_fn(lambda ts, b: (b["logits"],), "softmax_xent")
  want = j_fn(None, {"logits": jnp.asarray(logits)}, jnp.asarray(labels),
              jnp.asarray(mask))
  assert float(got["n"]) == float(want["n"]) == 4.0
  for k in ("prec@1", "loss"):
    np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)


def test_spec_normalization_equals_jax():
  get_steps = lambda key, cfg: cfg.get(f"{key}_steps")
  spec = dict(type="classification", pred="represent", pred_kw={"a": 1},
              prefix="x/", skip_first=True, log_steps=7, data=DATA,
              pp_fn=PP, loss_name="softmax_xent")
  for ladder in ({"batch_size_eval": 5, "input": {"batch_size": 8}},
                 {"input": {"batch_size": 8}}, {"batch_size": 9}):
    for own in ({}, {"batch_size": 3}):
      cfg = {**spec, **own}
      got = t_common._normalize_spec("val", cfg, ladder, get_steps)
      want = j_common._normalize_spec(
          "val", cfg, ml_collections.ConfigDict(ladder), get_steps, None)
      assert got == want, (ladder, own)
  meta, _ = t_common._normalize_spec("val", {}, {"batch_size": 2},
                                     get_steps)
  assert meta == {"module": "val", "pred_key": "predict", "pred_kw": None,
                  "prefix": "val/", "logsteps": None}


def test_from_config_builds_and_refuses():
  config = {"input": {"batch_size": 4}, "evals": {"v": dict(
      type="classification", data=DATA, pp_fn=PP, loss_name="softmax_xent",
      log_steps=3, prefix="p/", cache="none")}}
  fns = {"predict": lambda ts, b: (b["image"].mean((1, 2)), {})}
  [(name, ev, every, prefix)] = t_common.from_config(config, fns,
                                                     device="cpu")
  assert (name, every, prefix, ev.steps) == ("v", 3, "p/", 4)
  assert isinstance(ev, t_cls.Evaluator)
  with pytest.raises(ValueError, match="Unknown predict_fn"):
    t_common.from_config(config, {"represent": fns["predict"]}, device="cpu")
  for missing in ("timing", "proj.givt.nyu_depth",
                  "val"):
    with pytest.raises(ValueError, match="not ported"):
      t_common.evaluator_module(missing)


def test_eval_input_pipeline_cache_levels():
  kw = dict(data=DATA, pp_fn=PP, batch_size=8, device="cpu")
  with pytest.raises(ValueError, match="cache level"):
    t_common.eval_input_pipeline(**kw, cache="all")
  assert (t_common.eval_input_pipeline(**kw, cache="none")
          is not t_common.eval_input_pipeline(**kw, cache="none"))
  assert (t_common.eval_input_pipeline(**kw, cache="pipeline")
          is t_common.eval_input_pipeline(**kw, cache="pipeline"))
  get_iter, steps = t_common.eval_input_pipeline(**kw, cache="final_data")
  first, second = list(get_iter()), list(get_iter())
  assert steps == len(first) == 2
  assert all(a["image"] is b["image"] for a, b in zip(first, second))
  got = list(t_common.eval_input_pipeline(**kw, cache="raw_data")[0]())
  for a, b in zip(first, got):
    assert torch.equal(a["image"], b["image"])


def test_imagefolder_equals_jax(tmp_path):
  rng = np.random.default_rng(2)
  for cls, names in (("cat", ["b.jpg", "a.JPEG", "notes.txt"]),
                     ("dog", ["c.png"])):
    (tmp_path / cls).mkdir()
    for name in names:
      arr = rng.integers(0, 255, (9, 11, 3), np.uint8)
      buf = io.BytesIO()
      if name.endswith(".txt"):
        buf.write(b"not an image")
      else:
        Image.fromarray(arr).save(buf, format="PNG" if name.endswith(".png")
                                  else "JPEG")
      (tmp_path / cls / name).write_bytes(buf.getvalue())
  src = t_core.get("imagefolder", root=str(tmp_path))
  jsrc = j_core.get("imagefolder", root=str(tmp_path))
  assert src.total_examples == jsrc.total_examples == 3
  assert src.class_names == jsrc.class_names == ["cat", "dog"]
  for ordered in (True, False):
    got = list(src.get_examples(ordered=ordered, seed=1, epoch=2))
    want = list(jsrc.get_examples(ordered=ordered, seed=1, epoch=2))
    for g, w in zip(got, want, strict=True):
      assert g["image"] == w["image"] and g["label"] == w["label"]
      assert g["_id"] == w["_id"] and g["_id"].dtype == np.int64

"""The port's SigLIP trainer and image-text evaluators against the JAX
package's, on the CPU.

The twin: the JAX SigLIP trainer (`trainers/proj/image_text/siglip.main`)
and the port's (`trainers/proj/image_text/siglip.Trainer` through
`train.train`, device "cpu") each run their own copy of
configs/proj/image_text/siglip_smoke.py for 10 steps (a metric row each
step, no checkpoint, no eval) from one init, written as an `.npz` and
read through `model_init`. Both pipelines draw the same examples (the same
shuffle and per-example rng keys, the same host pp, bit for bit), so every
step's `training_loss`, `t`, `b`, `l2_grads` and `l2_params` agree within
1e-3 relative; the worst is printed. The JAX loss is the chunked ring over
the 8 virtual CPU devices, the port's the single resident block.

The evaluators: `contrastive` and `retrieval` (the `pp_fn` form) of both
packages on one synthetic split and one set of params give the same
metrics; the port's `retrieval` in the config form (`pp_img`, `pp_txt`,
`txt_name`) gives the recalls of its `pp_fn` form on the same rows.
"""

import json

import jax
import numpy as np
import pytest
import torch

from big_vision_torch import train as t_train
from big_vision_torch.configs.proj.image_text import siglip_smoke as t_smoke
from big_vision_torch.datasets import core as ds_core
from big_vision_torch.evaluators.proj.image_text import contrastive as t_con
from big_vision_torch.evaluators.proj.image_text import retrieval as t_ret
from big_vision_torch.models.proj.image_text import two_towers as t_tt
from big_vision_torch.trainers.proj.image_text import siglip as t_siglip
from big_vision_torch.utils import checkpoints
from big_vision_torch.utils import convert
from big_vision_tpu.configs.proj.image_text import siglip_smoke as j_smoke
from big_vision_tpu.evaluators.proj.image_text import contrastive as j_con
from big_vision_tpu.evaluators.proj.image_text import retrieval as j_ret
from big_vision_tpu.models.proj.image_text import two_towers as j_tt
from big_vision_tpu.trainers.proj.image_text import siglip as j_siglip

BAR = 1e-3  # per step, relative
METRICS = ("training_loss", "t", "b", "l2_grads", "l2_params")
STEPS = 10


def _init(path, model_cfg, res=32, text_len=8):
  """One init of the two towers (the port's, from a seed), written as an
  `.npz` of the JAX param tree; returns (the tree, the port model)."""
  port = t_tt.Model(**model_cfg, image_size=res, text_len=text_len,
                    device="cpu")
  port.initialize(torch.Generator().manual_seed(0))
  params = convert.params(port)
  checkpoints.npz_save(params, str(path))
  return params, port


def _rows(workdir):
  with open(workdir / "big_vision_metrics.txt") as f:
    return [r for r in map(json.loads, f) if "training_loss" in r]


def test_siglip_twin_tracks_the_jax_trainer(tmp_path):
  arg = f"total_steps={STEPS}"
  init = tmp_path / "init.npz"
  _init(init, t_smoke.get_config(arg)["model"])
  jax_config = j_smoke.get_config(arg)
  jax_config.update(model_init=str(init), log_training_steps=1,
                    ckpt_steps=None, evals={})
  j_siglip.main(config=jax_config, workdir=str(tmp_path / "jax"))
  config = t_smoke.get_config(arg)
  config.update(model_init=str(init), log_training_steps=1, ckpt_steps=None,
                evals={})
  t_train.train(config, str(tmp_path / "port"), device="cpu",
                trainer_cls=t_siglip.Trainer)
  jax_rows, port_rows = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
  assert [r["step"] for r in jax_rows] == list(range(1, STEPS + 1))
  assert [r["step"] for r in port_rows] == list(range(1, STEPS + 1))
  worst = {}
  for m in METRICS:
    want = np.array([r[m] for r in jax_rows])
    got = np.array([r[m] for r in port_rows])
    rel = np.abs(got - want) / np.maximum(1e-12, np.abs(want))
    worst[m] = (float(rel.max()), int(rel.argmax()) + 1)
  print("worst relative difference (step): " + ", ".join(
      f"{m} {e:.3e} ({s})" for m, (e, s) in worst.items()))
  assert all(e <= BAR for e, _ in worst.values()), worst
  losses = [r["training_loss"] for r in jax_rows]
  assert losses[-1] < losses[0], losses


def _models(tmp_path):
  """(JAX model, params, port model) of siglip_smoke's two towers."""
  cfg = t_smoke.get_config()["model"]
  params, port = _init(tmp_path / "init.npz", cfg)
  return j_tt.Model(**cfg), params, port


def _jax_predict(model):
  def predict_fn(train_state, batch, **kw):
    return model.apply({"params": train_state["params"]},
                       batch.get("image"), batch.get("labels"), **kw)
  return predict_fn


def _port_predict(port):
  return t_siglip.predict_fns(port, None)["predict"]


# Rows whose captions name their image's class; ids shared by the 4
# examples of each of the 8 images.
RETRIEVAL_PP = (
    "decode|resize(32)|value_range(-1, 1)"
    "|strfmt('photo number {label}', outkey='text')"
    "|tokenize(8, eos='sticky', model='test(128)', pad_value=1, "
    "inkey='text', outkey='labels')|copy('label', 'image/id')"
    "|keep('image', 'labels', 'image/id')")
DATA = dict(name="synthetic", n=32, num_classes=8, h=40, w=40,
            unique_images=8)


def test_contrastive_and_retrieval_equal_jax(tmp_path):
  jax_model, params, port = _models(tmp_path)
  pp = t_smoke.get_config()["evals"]["contrastive"]["pp_fn"]
  kw = dict(data=dict(DATA), pp_fn=pp, batch_size=16)
  want = dict(j_con.Evaluator(_jax_predict(jax_model), devices=jax.devices(),
                              **kw).run({"params": params}))
  got = dict(t_con.Evaluator(_port_predict(port), device="cpu",
                             **kw).run(None))
  assert want.keys() == got.keys()
  for k in want:
    np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, atol=1e-6)

  kw = dict(data=dict(DATA), pp_fn=RETRIEVAL_PP, batch_size=16)
  want = dict(j_ret.Evaluator(_jax_predict(jax_model), devices=jax.devices(),
                              **kw).run({"params": params}))
  got = dict(t_ret.Evaluator(_port_predict(port), device="cpu",
                             **kw).run(None))
  assert want == got, (want, got)


@pytest.mark.parametrize("unique_images", [8, 32])
def test_retrieval_config_form_equals_the_pp_fn_form(tmp_path,
                                                     unique_images):
  _, _, port = _models(tmp_path)
  tokenize = ("tokenize(8, eos='sticky', model='test(128)', pad_value=1, "
              "inkey='text', outkey='labels')")
  data = dict(name="synthetic", n=24, num_classes=8, h=40, w=40,
              unique_images=unique_images, captions=5)
  rows_pp = (f"decode|resize(32)|value_range(-1, 1)|{tokenize}"
             "|keep('image', 'labels', 'image/id')")
  # The pp_fn form's rows: one per caption, each with its image.
  images, texts, ids = [], [], []
  for ex in ds_core.get(**data).get_examples(ordered=True):
    for cap in ex["captions"]["text"]:
      images.append(ex["image"])
      texts.append(cap)
      ids.append(ex["image/id"])
  obj = np.empty(len(images), object)
  obj[:] = images
  rows = dict(name="arrays", data={"image": obj, "text": np.asarray(texts),
                                   "image/id": np.asarray(ids)})
  want = dict(t_ret.Evaluator(_port_predict(port), data=rows,
                              pp_fn=rows_pp, batch_size=16,
                              device="cpu", cache="none").run(None))
  got = dict(t_ret.Evaluator(
      _port_predict(port), data=data, batch_size=16, device="cpu",
      pp_img="resize(32)|value_range(-1, 1)", pp_txt=tokenize,
      txt_name=("captions", "text")).run(None))
  assert want == got, (want, got)
  assert 0 < got["txt2img/recall@10"] <= 1


def test_siglip_trainer_refuses_unknown_loss_impl():
  config = t_smoke.get_config("loss_impl=ring")
  with pytest.raises(ValueError, match="loss_impl"):
    t_siglip.Trainer(config, device="cpu")


def test_predict_fns_read_either_half(tmp_path):
  _, _, port = _models(tmp_path)
  fns = t_siglip.predict_fns(port, None)
  img = torch.zeros(2, 32, 32, 3)
  txt = torch.ones(2, 8, dtype=torch.int64)
  with torch.no_grad():
    zimg, ztxt, _ = fns["img"](None, {"image": img, "labels": txt})
    assert ztxt is None and zimg.shape == (2, 32)
    zimg, ztxt, _ = fns["txt"](None, {"image": img, "labels": txt})
    assert zimg is None and ztxt.shape == (2, 32)

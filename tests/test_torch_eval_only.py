"""The port's eval-only path and small evaluators against the JAX
package's, on the CPU.

  * `tools/eval_only` on `configs/load_and_eval.py:name=smoke` (both
    packages' own copies, one `.npz` init through `init=`) gives the JAX
    tool's `val/prec@1` and `val/loss`, and its `predict` and `represent`
    fns give the JAX tool's on one batch;
  * on a two-tower model it gives the recalls of the JAX retrieval
    evaluator called with the JAX SigLIP trainer's predict fn on the same
    params and rows (the JAX tool itself cannot evaluate such a model); and
    on a SigLIP trainer's checkpoint, the metrics of that trainer's own
    final evals;
  * `load_and_eval` of a dotted name passes its extra args on;
  * `mean`, `save` and `classification_with_labelmap` equal JAX's on one
    ViT and split;
  * `utils/chrono.log_memory` writes the JAX package's keys.
"""

import json

import jax
import numpy as np
import pytest
import torch

from big_vision_torch import train as t_train
from big_vision_torch.configs import load_and_eval as t_load_and_eval
from big_vision_torch.configs import smoke as t_smoke_vit
from big_vision_torch.configs.proj.image_text import siglip_smoke as t_smoke
from big_vision_torch.evaluators import classification_with_labelmap as t_lm
from big_vision_torch.evaluators import mean as t_mean
from big_vision_torch.evaluators import save as t_save
from big_vision_torch.models import vit as t_vit
from big_vision_torch.tools import eval_only as t_eval_only
from big_vision_torch.trainers.proj.image_text import siglip as t_siglip
from big_vision_torch.utils import checkpoints
from big_vision_torch.utils import chrono as t_chrono
from big_vision_torch.utils import convert
from big_vision_tpu.configs import load_and_eval as j_load_and_eval
from big_vision_tpu.evaluators import classification_with_labelmap as j_lm
from big_vision_tpu.evaluators import mean as j_mean
from big_vision_tpu.evaluators import save as j_save
from big_vision_tpu.evaluators.proj.image_text import retrieval as j_ret
from big_vision_tpu.models import vit as j_vit
from big_vision_tpu.models.proj.image_text import two_towers as j_tt
from big_vision_tpu.tools import eval_only as j_eval_only
from big_vision_tpu import utils as j_utils

SMOKE_VIT = t_smoke_vit.get_config()["model"]


def _vit_init(path):
  """A ViT-mu/16 of the smoke config (10 classes) from a seed, as an
  `.npz`; returns (JAX params, port model)."""
  model = t_vit.Model(10, image_size=32, **SMOKE_VIT, device="cpu")
  model.initialize(torch.Generator().manual_seed(0))
  params = convert.params(model)
  checkpoints.npz_save(params, str(path))
  return params, model


def _metrics(workdir):
  rows = [json.loads(l) for l in open(workdir / "big_vision_metrics.txt")]
  return {k: v for r in rows for k, v in r.items() if "/" in k}


def test_eval_only_on_smoke_equals_the_jax_tool(tmp_path):
  init = tmp_path / "init.npz"
  _vit_init(init)
  arg = f"name=smoke,init={init},batch_size=16"
  j_eval_only.main(config=j_load_and_eval.get_config(arg),
                   workdir=str(tmp_path / "jax"))
  got = t_eval_only.evaluate(t_load_and_eval.get_config(arg),
                             str(tmp_path / "port"), device="cpu")
  want = _metrics(tmp_path / "jax")
  assert got.pop("z/secs/eval/val") > 0
  assert sorted(got) == sorted(want) == ["val/loss", "val/prec@1"]
  for k in want:
    np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
  port_rows = _metrics(tmp_path / "port")
  port_rows.pop("z/secs/eval/val")
  assert port_rows == pytest.approx(got)


def test_predict_and_represent_equal_the_jax_tool(tmp_path):
  params, _ = _vit_init(tmp_path / "init.npz")
  config = t_load_and_eval.get_config(
      f"name=smoke,init={tmp_path / 'init.npz'}")
  model, _ = t_eval_only.build_model(config, "cpu")
  fns = t_eval_only.predict_fns(config, model)
  jm = j_vit.Model(10, **SMOKE_VIT)
  img = np.random.default_rng(0).uniform(-1, 1, (3, 32, 32, 3)).astype(
      np.float32)
  logits, out = jm.apply({"params": params}, img)
  with torch.no_grad():
    got = fns["predict"](None, {"image": torch.from_numpy(img)})
    rep = fns["represent"](None, {"image": torch.from_numpy(img)})
  np.testing.assert_allclose(got[0].numpy(), logits, rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(rep[0].numpy(), out["pre_logits"], rtol=1e-5,
                             atol=1e-5)
  assert t_eval_only.shape_kwargs([(1, 224, 224, 3), (1, 16)]) == dict(
      image_size=224, channels=3, text_len=16)


RETRIEVAL = dict(
    type="proj.image_text.retrieval",
    data=dict(name="synthetic", n=32, num_classes=8, h=40, w=40,
              unique_images=8),
    pp_fn=("decode|resize(32)|value_range(-1, 1)"
           "|strfmt('photo number {label}', outkey='text')"
           "|tokenize(8, eos='sticky', model='test(128)', pad_value=1, "
           "inkey='text', outkey='labels')|copy('label', 'image/id')"
           "|keep('image', 'labels', 'image/id')"),
    batch_size=16, log_steps=6)


def _smoke_config(**kw):
  config = t_smoke.get_config("total_steps=6")
  config.update(evals={"retrieval": dict(RETRIEVAL)}, **kw)
  return config


def test_eval_only_on_two_towers_equals_jax_retrieval(tmp_path):
  config = _smoke_config()
  model = t_siglip.Trainer(config, device="cpu").model
  params = convert.params(model)
  checkpoints.npz_save(params, str(tmp_path / "tt.npz"))
  jm = j_tt.Model(**config["model"])

  def jax_predict(train_state, batch, **kw):  # the JAX SigLIP trainer's
    return jm.apply({"params": train_state["params"]}, batch.get("image"),
                    batch.get("labels"), **kw)

  spec = {k: v for k, v in RETRIEVAL.items()
          if k not in ("type", "log_steps")}
  want = dict(j_ret.Evaluator(jax_predict, devices=jax.devices(),
                              **spec).run({"params": params}))
  config.update(total_steps=0, model_init=str(tmp_path / "tt.npz"))
  got = t_eval_only.evaluate(config, device="cpu")
  assert got.pop("z/secs/eval/retrieval") > 0
  assert got == {f"retrieval/{k}": v for k, v in want.items()}


def test_eval_only_on_a_siglip_checkpoint_equals_its_trainer(tmp_path):
  config = _smoke_config(ckpt_steps=6)
  t_train.train(config, str(tmp_path / "wd"), device="cpu",
                trainer_cls=t_siglip.Trainer)
  rows = [json.loads(l) for l in open(tmp_path / "wd" /
                                      "big_vision_metrics.txt")]
  want = {k: v for r in rows if r["step"] == 6 for k, v in r.items()
          if k.startswith("retrieval/")}
  ckpt = checkpoints.last_checkpoint_dir(str(tmp_path / "wd" / "ckpt.bv"))
  config.update(total_steps=0, model_init=ckpt)
  got = t_eval_only.evaluate(config, device="cpu")
  got.pop("z/secs/eval/retrieval")
  assert len(want) == 6 and got == want


def test_load_and_eval_passes_extra_args_on():
  config = t_load_and_eval.get_config(
      "name=proj.image_text.siglip_lit_coco,neval=64,batch_size=8,"
      "vocab=build/siglip/vocab.txt")
  assert config["total_steps"] == 0 and config["input"]["batch_size"] == 8
  assert config["evals"]["retrieval_coco"]["data"]["n"] == 64


def _vit_models(tmp_path):
  params, model = _vit_init(tmp_path / "init.npz")
  jm = j_vit.Model(10, **SMOKE_VIT)
  return params, jm, model


EVAL = dict(
    data=dict(name="synthetic", n=40, num_classes=10, h=40, w=40),
    pp_fn=("decode|resize(32)|value_range(-1, 1)"
           "|onehot(10, key='label', key_result='labels')"
           "|keep('image', 'labels')"),
    batch_size=16)


def test_mean_save_and_labelmap_equal_jax(tmp_path):
  params, jm, model = _vit_models(tmp_path)

  def j_means(ts, batch):
    logits, _ = jm.apply({"params": ts["params"]}, batch["image"])
    return {"logits": logits, "top": logits.max(-1)}

  def t_means(ts, batch):
    logits, _ = model(batch["image"])
    return {"logits": logits, "top": logits.max(-1).values}

  state = {"params": params}
  want = dict(j_mean.Evaluator(j_means, devices=jax.devices(),
                               **EVAL).run(state))
  got = dict(t_mean.Evaluator(t_means, device="cpu", **EVAL).run(None))
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)

  out = {p: str(tmp_path / f"{p}.npz") for p in ("jax", "port")}
  j_pred = lambda ts, b: jm.apply({"params": ts["params"]}, b["image"])
  t_pred = lambda ts, b: model(b["image"])
  assert dict(j_save.Evaluator(j_pred, out["jax"], devices=jax.devices(),
                               **EVAL).run(state)) == {"saved": 1.0}
  assert dict(t_save.Evaluator(t_pred, out["port"], device="cpu",
                               **EVAL).run(None)) == {"saved": 1.0}
  want, got = np.load(out["jax"]), np.load(out["port"])
  assert sorted(got.files) == sorted(want.files)
  for k in want.files:
    np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)

  mapping = [9, 8, 7, 6, 5, 4, 3, 2, 1, 0]
  kw = dict(EVAL, loss_name="softmax_xent", label_mapping=mapping)
  want = dict(j_lm.Evaluator(j_pred, devices=jax.devices(), **kw).run(state))
  got = dict(t_lm.Evaluator(t_pred, device="cpu", **kw).run(None))
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)
  with pytest.raises(ValueError, match="Unknown label_mapping"):
    t_lm.resolve_label_mapping("i1k_i21k")


def test_log_memory_writes_the_jax_keys(monkeypatch):
  want, got = {}, {}
  j_utils.log_memory(lambda k, v: want.setdefault(k, v))
  t_chrono.log_memory(lambda k, v: got.setdefault(k, v), device="cpu")
  host = {k for k in want if k.startswith("y/hostmem/")}
  assert set(got) == host == {"y/hostmem/total", "y/hostmem/available"}

  class Props:
    total_memory = 80 << 30
  monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: {
      "allocated_bytes.all.current": 5, "allocated_bytes.all.peak": 7})
  monkeypatch.setattr(torch.cuda, "get_device_properties",
                      lambda d: Props())
  card = {}
  t_chrono.log_memory(lambda k, v: card.setdefault(k, v), device="cuda")
  assert {k: v for k, v in card.items() if "devmem" in k} == {
      "y/devmem/dev0/bytes_in_use": 5,
      "y/devmem/dev0/peak_bytes_in_use": 7,
      "y/devmem/dev0/bytes_limit": 80 << 30}

"""The port's PaliGemma evaluators against the JAX package's, on the CPU.

* `textmetrics` (levenshtein, ANLS, BLEU-4, ROUGE-L, CIDEr-D, METEOR, the
  Porter stemmer): equal to the JAX module's, exactly, on the corpora of
  the JAX package's tests/test_paligemma_transfers.py and on the COCO
  stand-in's captions.
* `coco_caption`: both evaluators, one fake decode (the same token rows:
  a reference of the row's own image, another image's, or a shuffle of
  one) through the stand-in Gemma tokenizer: equal metrics.
* `perplexity`: the `logits` predict fn of both packages' PaliGemma (mu/16
  + gemma_test) on one set of params and the smoke config's split: "sum"
  and "avg" within 1e-5; the port trainer's "perplexity" predict fn
  equals the JAX evaluator's "avg".
* The slice on the CPU: configs/proj/paligemma/transfers/cococap.py with
  the model cut to mu/16 + gemma_test, trained 2 steps through the port's
  trainer with its beam-decode caption evals and perplexity evals (4
  images a split) at steps 0 and 2: every metric finite.
"""

import json
import math

import jax
import numpy as np
import pytest
import torch

from big_vision_torch import train as t_train
from big_vision_torch.configs.proj.paligemma import smoke as t_smoke
from big_vision_torch.configs.proj.paligemma.transfers import cococap
from big_vision_torch.configs.proj.paligemma.transfers import (
    common as t_common)
from big_vision_torch.datasets import synthetic
from big_vision_torch.evaluators.proj.paligemma import (
    perplexity as t_pplx)
from big_vision_torch.evaluators.proj.paligemma.transfers import (
    coco_caption as t_coco)
from big_vision_torch.evaluators.proj.paligemma.transfers import (
    textmetrics as t_tm)
from big_vision_torch.models.ppp import gemma as t_gemma
from big_vision_torch.models.proj.paligemma import paligemma as t_pg
from big_vision_torch.models.proj.paligemma import predict_fns as t_pf
from big_vision_torch.pp import tokenizer as t_tok
from big_vision_torch.trainers.proj.paligemma import train as t_pgtrain
from big_vision_torch.utils import convert
from big_vision_tpu.evaluators.proj.paligemma import perplexity as j_pplx
from big_vision_tpu.evaluators.proj.paligemma.transfers import (
    coco_caption as j_coco)
from big_vision_tpu.evaluators.proj.paligemma.transfers import (
    textmetrics as j_tm)
from big_vision_tpu.models.proj.paligemma import paligemma as j_pg
from big_vision_tpu.models.proj.paligemma import predict_fns as j_pf
import big_vision_tpu.pp.ops_general  # noqa: F401  (registers the pp ops)
import big_vision_tpu.pp.ops_image  # noqa: F401
import big_vision_tpu.pp.ops_text  # noqa: F401
import big_vision_tpu.pp.proj.paligemma.ops  # noqa: F401
import big_vision_torch.pp.proj.paligemma.ops  # noqa: F401

# (references by image, hypotheses by image): the corpora of the JAX
# package's tests/test_paligemma_transfers.py, then the COCO stand-in's.
CORPORA = [
    ({0: ["a cat sits on the mat"], 1: ["two dogs play in the park"]},
     {0: ["a cat sits on the mat"], 1: ["two dogs play in the park"]}),
    ({0: ["a cat sits on the mat", "a cat on a mat"],
      1: ["green trains arrive early"]},
     {0: ["a cat sits on a mat"], 1: ["green trains arrive early"]}),
    ({0: ["a cat sits on the mat", "a cat on a mat"],
      1: ["green trains arrive early"]},
     {0: ["bright orange submarine flies"], 1: ["green trains arrive early"]}),
    ({0: ["the cat sat on the mat"]}, {0: ["the cat sat on the mat"]}),
    ({0: ["the cat sits on the mat"]}, {0: ["the cats sitting on the mats"]}),
    ({0: ["green trains arrive"]}, {0: ["purple elephant dances"]}),
    ({0: ["a big dog runs fast"]}, {0: ["fast runs dog big a"]}),
    ({i: synthetic.captions(i, 5) for i in range(12)},
     {i: [synthetic.captions(i + (i % 3 == 0), 5)[i % 5]]
      for i in range(12)}),
]
WORDS = ["caresses", "ponies", "cats", "feed", "agreed", "plastered",
         "motoring", "sing", "conflated", "hopping", "happy", "relational",
         "conditional", "rational", "probate", "cease", "generalizations",
         "oscillators", "giraffe", "elephants", "skiing", "bicycle"]


@pytest.mark.parametrize("corpus", range(len(CORPORA)))
def test_caption_metrics_equal_jax(corpus):
  gts, res = CORPORA[corpus]
  for tm in (t_tm, j_tm):
    assert tm.ptb_lite_tokenize("A Cat, on: the MAT.") == [
        "a", "cat", "on", "the", "mat"]
  toks = t_tm.ptb_lite_tokenize
  gts = {k: [toks(c) for c in v] for k, v in gts.items()}
  res = {k: [toks(c) for c in v] for k, v in res.items()}
  for metric in ("bleu4", "rouge_l", "cider_d", "meteor"):
    assert getattr(t_tm, metric)(gts, res) == getattr(j_tm, metric)(
        gts, res), metric


def test_edit_distances_and_stemmer_equal_jax():
  pairs = [("kitten", "sitting"), ("", "abc"), ("abc", "abc"),
           ("abc", "abd"), ("abc", "xyz"), ("", "")]
  for a, b in pairs:
    assert t_tm.levenshtein(a, b) == j_tm.levenshtein(a, b)
    assert t_tm.anls_metric(a, b) == j_tm.anls_metric(a, b)
  for w in WORDS:
    assert t_tm.porter_stem(w) == j_tm.porter_stem(w), w


# ----------------------------------------------------------------------------
# The evaluators end to end.
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
  return t_common.stand_in_tokenizer(
      str(tmp_path_factory.mktemp("vocab") / "tokenizer.model"))


def test_coco_caption_equals_jax(vocab):
  n = 12
  data = {"image": np.zeros((n, 2, 2, 3), np.float32),
          "image/id": np.arange(100, 100 + n),
          "captions": np.asarray([synthetic.captions(i, 5)
                                  for i in range(n)])}
  spec = t_common.tokenizer(vocab)
  tok = t_tok.get_tokenizer(spec)
  rows = np.zeros((n, 12), np.int32)
  for i in range(n):
    text = synthetic.captions(i + (i % 3 == 0), 5)[i % 5]
    if i % 4 == 1:
      text = " ".join(reversed(text.split()))
    ids = tok.to_int(text, eos=True)
    rows[i, :len(ids)] = ids

  def decoded(ids):  # padding examples (id 0) decode row 0
    return rows[np.maximum(np.asarray(ids) - 100, 0)]

  kw = dict(data=dict(name="arrays", data=data), pp_fn="", batch_size=8)
  metrics = ("cider", "bleu-4", "rouge", "meteor")
  want = dict(j_coco.Evaluator(
      lambda ts, batch: jax.numpy.asarray(decoded(batch["image/id"])),
      tokenizer=spec, metrics=metrics, devices=jax.devices(), **kw).run(None))
  got = dict(t_coco.Evaluator(
      lambda ts, batch: torch.from_numpy(decoded(batch["image/id"].numpy())),
      tokenizer=spec, metrics=metrics, device="cpu", **kw).run(None))
  assert sorted(got) == sorted(metrics)
  assert got == pytest.approx(want, rel=1e-12), (got, want)
  assert 0 < got["cider"] < 10 and 0 < got["bleu-4"] < 1, got


def test_perplexity_equals_jax():
  config = t_smoke.get_config()
  pp = config["evals"]["perplexity"]["pp_fn"]
  model_cfg = config["model"]
  jmodel = j_pg.Model(**model_cfg)
  port = t_pg.Model(**model_cfg, device="cpu")
  port.initialize(torch.Generator().manual_seed(3))
  params = convert.params(port)
  params["llm"] = t_gemma.pyloop_to_scan(params["llm"])  # the JAX scan
  kw = dict(data=dict(config["evals"]["perplexity"]["data"]), pp_fn=pp,
            batch_size=8, key="text", shift_labels=True)
  jax_logits = j_pf.make_predict_fns(jmodel)["logits"]
  want = dict(j_pplx.Evaluator(jax_logits, devices=jax.devices(),
                               **kw).run({"params": params}))
  port_logits = t_pf.make_predict_fns(port)["logits"]
  got = dict(t_pplx.Evaluator(lambda ts, batch: port_logits(batch),
                              device="cpu", **kw).run(None))
  assert sorted(got) == sorted(want) == ["avg", "sum"]
  for k in want:
    assert abs(got[k] - float(want[k])) <= 1e-5 * abs(float(want[k])), k
  trainer_fn = lambda ts, batch: t_pgtrain.perplexity(port, batch)
  got = dict(t_pplx.Evaluator(trainer_fn, device="cpu", **kw).run(None))
  assert abs(got["perplexity"] - float(want["avg"])) <= 1e-5 * float(
      want["avg"])


def test_cococap_trains_and_evaluates_at_tiny_size(tmp_path, vocab):
  config = cococap.get_config(f"vocab={vocab},neval=4,batch_size=4,log=1")
  del config["total_epochs"]
  config.update(total_steps=2, ckpt_steps=None)
  config["model"]["img"] = dict(config["model"]["img"], variant="mu/16")
  config["model"]["llm"] = dict(config["model"]["llm"], variant="gemma_test",
                                vocab_size=257_152)
  for ev in config["evals"].values():
    ev["log_steps"] = 2
    ev.pop("log_percent")
    if "pred_kw" in ev:
      ev["pred_kw"] = {"max_decode_len": 4}
  trainer = t_train.train(config, str(tmp_path), device="cpu",
                          trainer_cls=t_pgtrain.Trainer)
  assert trainer.total_steps == 2
  with open(tmp_path / "big_vision_metrics.txt") as f:
    rows = [json.loads(line) for line in f]
  for step in (0, 2):
    row = {k: v for r in rows if r["step"] == step for k, v in r.items()}
    for split in ("minitrain", "minival", "eval"):
      for key in (f"cococap/{split}/cider", f"cococap/{split}/pplx/avg",
                  f"cococap/{split}/pplx/sum"):
        assert math.isfinite(row[key]), (step, key, row.get(key))

"""The port's CapPa (model, predict fns, evaluators, trainer) against the
JAX package's, on the CPU, at the size of configs/proj/cappa/smoke.py
(width 32, 2 heads, 2 encoder and 2 decoder layers, 8x8 patches at 16px,
vocab 64, 8 tokens). The JAX encoder's attention runs its plain
reference (XLA), the port's the kernels' plain versions.

* The model, through the converter from the JAX params (per layer with
  the decoder's biases and `masked_pred_prob` 0; scanned without them
  and with `masked_pred_prob` 1 at `masking_ratio` 1: the two settings
  where the parallel draw decides nothing):
  logits within 1e-5 in eval and in training, every gradient of a
  weighted CE within 1e-4.
* The law of the parallel draw at 0 < p < 1 (torch cannot draw JAX's
  numbers): exactly int(ratio * L) [MASK]s in each parallel row, the
  other rows teacher-forced, the parallel share within 4 standard errors
  of p, every position masked as often.
* The step-0 loss is ln(vocab) on any batch (LogitsDense starts at zero).
* `score` and the scoring classifier: scores within 1e-5 of JAX's (also
  with a prompt, and over several decoder passes), `prec@1` equal.
* The perplexity evaluator: within 1e-5 relative of JAX's.
* The trainer against the JAX trainer on the smoke config with
  `masked_pred_prob` 0: 3 steps from one init, the loss within 1e-5 a
  step; a run stopped and resumed from its checkpoint continues
  bit-equal (with the parallel draws of the config's p = 0.5).
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch import train as t_train
from big_vision_torch.configs.proj.cappa import smoke as t_smoke
from big_vision_torch.evaluators.proj.cappa import perplexity as t_pplx
from big_vision_torch.evaluators.proj.cappa import scoring_classifier as t_sc
from big_vision_torch.models.proj.cappa import cappa as t_cappa
from big_vision_torch.pp import ops_text as t_ops_text  # noqa: F401
from big_vision_torch.trainers.proj.cappa import generative as t_gen
from big_vision_torch.trainers.proj.cappa import predict_fns as t_pfns
from big_vision_torch.utils import checkpoints
from big_vision_torch.utils import convert
from big_vision_torch.utils import losses as t_losses
from big_vision_tpu.configs.proj.cappa import smoke as j_smoke
from big_vision_tpu.evaluators.proj.cappa import perplexity as j_pplx
from big_vision_tpu.evaluators.proj.cappa import scoring_classifier as j_sc
from big_vision_tpu.models.proj.cappa import cappa as j_cappa
from big_vision_tpu.ops import attention as j_attention
from big_vision_tpu.pp import ops_text as j_ops_text  # noqa: F401
from big_vision_tpu.trainers.proj.cappa import generative as j_gen
from big_vision_tpu.trainers.proj.cappa import predict_fns as j_pfns
from big_vision_tpu.utils import losses as j_losses

@pytest.fixture(autouse=True)
def _jax_plain_attention(monkeypatch):
  """The JAX encoder's attention through its plain (XLA) reference: on the
  CPU its Pallas kernel would run in interpret mode, to the same function
  at many times the compile time."""
  monkeypatch.setattr(j_attention, "_kernel_ok", lambda *a, **kw: False)


CFG = dict(num_heads=2, num_layers=2, mlp_dim=64, emb_dim=32, vocab_size=64,
           seq_len=8, patches=(8, 8), posemb_type="learn")


def _inputs(b=4):
  rs = np.random.RandomState(0)
  img = rs.randn(b, 16, 16, 3).astype(np.float32)
  txt = rs.randint(4, 64, (b, 8)).astype(np.int32)
  for i in range(b):  # eos then PAD after a length of 3 to 8 tokens
    n = 3 + i % 6
    txt[i, n - 1] = 1
    txt[i, n:] = 0
  return img, txt


def _jax_model(seed=0, **kw):
  """(JAX model, its params with LogitsDense drawn N(0, 0.1^2), so that
  the logits are not all zero)."""
  model = j_cappa.Model(**{**CFG, **kw})
  img, txt = _inputs(1)
  params = model.init(jax.random.PRNGKey(seed), img, txt)["params"]
  kernel = params["decoder"]["LogitsDense"]["kernel"]
  params["decoder"]["LogitsDense"]["kernel"] = 0.1 * jax.random.normal(
      jax.random.PRNGKey(seed + 1), kernel.shape)
  return model, params


def _port(params, **kw):
  port = t_cappa.Model(**{**CFG, **kw}, image_size=16, device="cpu")
  convert.load(port, convert.state(port, params))
  return port


def _jax_loss(logits, txt):
  return j_losses.weighted_softmax_xent(
      logits=logits, labels=txt, weights=(txt != 0).astype(jnp.float32))


@pytest.mark.parametrize("scan,decoder_bias,masked_pred_prob",
                         [(False, True, 0.0), (True, False, 1.0)])
def test_model_and_gradients_match_jax(scan, decoder_bias, masked_pred_prob):
  kw = dict(scan=scan, decoder_bias=decoder_bias,
            masked_pred_prob=masked_pred_prob, masking_ratio=1.0)
  model, params = _jax_model(**kw)
  port = _port(params, **kw)
  img, txt = _inputs()
  rngs = {"dropout": jax.random.PRNGKey(7)}
  apply = jax.jit(model.apply, static_argnames="train")
  for train in (False, True):
    want = apply({"params": params}, img, txt, train=train, rngs=rngs)
    got = port(torch.from_numpy(img), torch.from_numpy(txt), train=train,
               rng=torch.Generator().manual_seed(0))
    assert got.shape == (4, 8, 64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5, err_msg=f"train={train}")

  def loss(p):
    return _jax_loss(model.apply({"params": p}, img, txt, train=True,
                                 rngs=rngs), txt)

  want_grads = convert.state(port, jax.jit(jax.grad(loss))(params))
  port.zero_grad()
  t_gen.caption_loss(port(torch.from_numpy(img), torch.from_numpy(txt),
                          train=True, rng=torch.Generator().manual_seed(0)),
                     torch.from_numpy(txt)).backward()
  got_grads = dict(port.named_parameters())
  assert sorted(want_grads) == sorted(got_grads)
  for name, g in want_grads.items():
    np.testing.assert_allclose(got_grads[name].grad.numpy(), np.asarray(g),
                               rtol=0, atol=1e-4, err_msg=name)


def test_the_converter_reads_both_layouts_and_writes_the_jax_names():
  _, scanned = _jax_model(scan=True)
  port = _port(scanned, scan=True)
  tree = convert.params(port)  # per layer
  _, pyloop = _jax_model(scan=False)
  flat = lambda t: {k: np.asarray(v) for k, v in
                    convert.trees.flatten(t).items()}
  assert sorted(flat(tree)) == sorted(flat(pyloop))
  stacked = flat(scanned)
  for name, x in flat(tree).items():
    if "/EncDecBlock" in name:  # layers on axis 1
      layer = int(name.split("/EncDecBlock")[1].split("/")[0])
      src = name.replace(f"/EncDecBlock{layer}/", "/EncDecBlock/")
      np.testing.assert_array_equal(x, stacked[src][:, layer], err_msg=name)
    elif "/encoderblock_" in name:  # layers on axis 0
      layer = int(name.split("/encoderblock_")[1].split("/")[0])
      src = name.replace(f"/encoderblock_{layer}/", "/encoderblock/")
      np.testing.assert_array_equal(x, stacked[src][layer], err_msg=name)
    else:
      np.testing.assert_array_equal(x, stacked[name], err_msg=name)


def test_the_parallel_draw_follows_its_law():
  b, length, p, ratio, vocab = 4000, 16, 0.3, 0.5, 64
  rs = np.random.RandomState(1)
  tokens = torch.from_numpy(rs.randint(1, vocab, (b, length)))
  causal = t_cappa.make_causal_mask(tokens)
  inp, mask = t_cappa.parallel_or_ar(
      tokens, causal, mask_id=vocab, masked_pred_prob=p,
      masking_ratio=ratio, rng=torch.Generator().manual_seed(0))
  parallel = mask.reshape(b, -1).all(dim=1)
  ar = ~parallel
  assert torch.equal(mask[ar], causal[ar])
  assert torch.equal(inp[ar], t_cappa.shift_right(tokens)[ar])
  hits = inp[parallel] == vocab
  assert (hits.sum(dim=1) == int(ratio * length)).all()
  assert torch.equal(inp[parallel][~hits], tokens[parallel][~hits])
  share, se = parallel.float().mean().item(), math.sqrt(p * (1 - p) / b)
  assert abs(share - p) < 4 * se, share
  per_pos = hits.float().mean(dim=0)  # each position masked w.p. ratio
  n = int(parallel.sum())
  assert (per_pos - ratio).abs().max() < 4 * math.sqrt(
      ratio * (1 - ratio) / n), per_pos
  # p = 1 with ratio 1: every slot is [MASK] under a full mask.
  inp, mask = t_cappa.parallel_or_ar(
      tokens, causal, mask_id=vocab, masked_pred_prob=1.0, masking_ratio=1.0,
      rng=torch.Generator().manual_seed(1))
  assert (inp == vocab).all() and mask.all()


@pytest.mark.parametrize("masked_pred_prob", [0.0, 0.75])
def test_step0_loss_is_ln_vocab(masked_pred_prob):
  port = t_cappa.Model(**CFG, masked_pred_prob=masked_pred_prob,
                       masking_ratio=1.0, image_size=16, device="cpu")
  port.initialize(torch.Generator().manual_seed(3))
  img, txt = _inputs()
  for train in (False, True):
    logits = port(torch.from_numpy(img), torch.from_numpy(txt), train=train,
                  rng=torch.Generator().manual_seed(0))
    loss = t_gen.caption_loss(logits, torch.from_numpy(txt)).item()
    assert abs(loss - math.log(64)) < 1e-6, loss
  model = j_cappa.Model(**CFG, masked_pred_prob=masked_pred_prob,
                        masking_ratio=1.0)
  params = model.init(jax.random.PRNGKey(3), img, txt)["params"]
  loss = float(_jax_loss(model.apply({"params": params}, img, txt), txt))
  assert abs(loss - math.log(64)) < 1e-6, loss


def test_weighted_softmax_xent_matches_jax():
  rs = np.random.RandomState(2)
  logits = rs.randn(3, 5, 11).astype(np.float32)
  labels = rs.randint(0, 11, (3, 5)).astype(np.int32)
  weights = (rs.rand(3, 5) > 0.3).astype(np.float32)
  for kw in (dict(), dict(label_smoothing=0.1), dict(normalize=False),
             dict(reduction=False, weights=weights),
             dict(weights=weights, label_smoothing=0.2, normalize=False)):
    want = j_losses.weighted_softmax_xent(logits=logits, labels=labels,
                                          **kw)
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    got = t_losses.weighted_softmax_xent(logits=torch.from_numpy(logits),
                                         labels=torch.from_numpy(labels),
                                         **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6, err_msg=str(kw))


def _score_fns():
  model, params = _jax_model()
  port = _port(params)
  return (j_pfns.get_predict_fns(model), {"params": params},
          t_pfns.get_predict_fns(port))


@pytest.mark.parametrize("score_rows", [t_pfns.SCORE_ROWS, 6])
def test_score_matches_jax(monkeypatch, score_rows):
  monkeypatch.setattr(t_pfns, "SCORE_ROWS", score_rows)
  jfns, state, tfns = _score_fns()
  img, _ = _inputs(3)
  captions = _inputs(5)[1][:, :5]  # 3 prompt tokens + 5: the posemb's 8
  for kw in (dict(), dict(prompt="a photo of", prompt_tokenizer="test(64)")):
    want = jfns["score"](state, {"image": jnp.asarray(img),
                                 "_label_tokens": jnp.asarray(captions)},
                         **kw)
    with torch.no_grad():
      got = tfns["score"](None, {"image": torch.from_numpy(img),
                                 "_label_tokens": torch.from_numpy(captions)},
                          **kw)
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5, err_msg=str(kw))
  assert t_pfns.make_prompt("a photo of", "test(64)") == j_pfns.make_prompt(
      "a photo of", "test(64)")


def test_scoring_classifier_matches_jax(monkeypatch):
  jfns, state, tfns = _score_fns()
  captions = _inputs(5)[1]
  for mod in (j_sc, t_sc):
    monkeypatch.setitem(mod.CLASS_NAMES, "arrays", lambda: list("abcde"))
    monkeypatch.setattr(mod, "get_classes", lambda name, pp: captions)
  rs = np.random.RandomState(4)
  data = {"image": rs.randn(10, 16, 16, 3).astype(np.float32),
          "label": rs.randint(0, 5, 10).astype(np.int32)}
  want = dict(j_sc.Evaluator(
      jfns["score"], "", data=dict(name="arrays", data=data), pp_fn="",
      batch_size=4, devices=jax.devices()).run(state))
  got = dict(t_sc.Evaluator(
      tfns["score"], "", data=dict(name="arrays", data=data), pp_fn="",
      batch_size=4, device="cpu").run(None))
  assert want.keys() == got.keys() == {"prec@1"}
  assert got["prec@1"] == pytest.approx(float(want["prec@1"]), abs=1e-9)


def test_scoring_classifier_tokenizes_the_imagenet_names_as_jax():
  pp = ("tokenize(max_len=16, model='test(64)', eos='sticky', pad_value=0, "
        "inkey='label')")
  got = t_sc.get_classes("imagenet2012", pp)
  assert got.shape == (1000, 16)
  np.testing.assert_array_equal(got, j_sc.get_classes("imagenet2012", pp))


@pytest.mark.parametrize("normalize_by_seqlen", [False, True])
def test_perplexity_evaluator_matches_jax(normalize_by_seqlen):
  model, params = _jax_model()
  port = _port(params)
  img, txt = _inputs(6)
  data = {"image": img, "labels": txt}
  kw = dict(data=dict(name="arrays", data=data), pp_fn="", batch_size=4,
            normalize_by_seqlen=normalize_by_seqlen)
  want = dict(j_pplx.Evaluator(j_pfns.get_predict_fns(model)["perplexity"],
                               devices=jax.devices(), **kw).run(
                                   {"params": params}))
  got = dict(t_pplx.Evaluator(t_pfns.get_predict_fns(port)["perplexity"],
                              device="cpu", **kw).run(None))
  assert want.keys() == got.keys() == {"perplexity"}
  np.testing.assert_allclose(got["perplexity"], float(want["perplexity"]),
                             rtol=1e-5)


def _rows(workdir):
  with open(workdir / "big_vision_metrics.txt") as f:
    return [r for r in map(json.loads, f) if "training_loss" in r]


def test_trainer_tracks_the_jax_trainer(tmp_path):
  init = tmp_path / "init.npz"
  port = t_cappa.Model(**CFG, image_size=16, device="cpu")
  port.initialize(torch.Generator().manual_seed(0))
  checkpoints.npz_save(convert.params(port), str(init))
  overrides = dict(model_init=str(init), log_training_steps=1,
                   ckpt_steps=None, evals={})
  jax_config = j_smoke.get_config("total_steps=3")
  jax_config.update(overrides)
  jax_config.evals = {}  # `update` merges nested ConfigDicts
  jax_config.model.masked_pred_prob = 0.0
  j_gen.main(config=jax_config, workdir=str(tmp_path / "jax"))
  config = t_smoke.get_config("total_steps=3")
  config.update(overrides)
  config["model"]["masked_pred_prob"] = 0.0
  t_train.train(config, str(tmp_path / "port"), device="cpu",
                trainer_cls=t_gen.Trainer)
  want, got = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
  assert [r["step"] for r in want] == [r["step"] for r in got] == [1, 2, 3]
  assert abs(got[0]["training_loss"] - math.log(64)) < 1e-5
  for w, g in zip(want, got):
    for k in ("training_loss", "l2_grads"):
      assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]), (k, w, g)


def test_resumed_run_continues_bit_equal(tmp_path):
  def run(workdir, **kw):
    config = t_smoke.get_config("total_steps=6")
    config.update(log_training_steps=1, ckpt_steps=3, evals={}, **kw)
    return t_train.train(config, str(workdir), device="cpu",
                         trainer_cls=t_gen.Trainer)

  whole = run(tmp_path / "whole")
  run(tmp_path / "cut", stop_after_steps=3)
  resumed = run(tmp_path / "cut")
  assert resumed.first_step == 3
  rows = {r["step"]: r["training_loss"] for r in _rows(tmp_path / "cut")}
  for r in _rows(tmp_path / "whole"):
    assert rows[r["step"]] == r["training_loss"], r["step"]
  for name, p in whole.params.items():
    assert torch.equal(p, resumed.params[name]), name


def test_decode_with_the_cache_is_refused():
  port = t_cappa.Model(**CFG, image_size=16, device="cpu")
  with pytest.raises(NotImplementedError, match="decode=True"):
    port(torch.zeros(1, 16, 16, 3), torch.zeros(1, 8, dtype=torch.int32),
         decode=True)

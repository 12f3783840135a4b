"""The port's PaliGemma training path against the JAX package, on the CPU.

* The LLM's fused training attention: PaliGemma (mu/16 + gemma_test) with
  the LLM's `attn_impl="flash"` (the kernels' plain versions on the CPU,
  fed `seg`) against the JAX model's "xla" and "flash" paths (the JAX
  kernels in interpret mode) on one set of params: text logits within
  2e-4 and every gradient within 3e-4, the bars of the JAX package's
  tests/test_paligemma.py (test_flash_seg_training_forward_matches_xla).
  The batch has no input mask, so `seg` has no zeros and every row,
  padding included, is compared.
* Remat: the gradients of the LLM's and the scanned image tower's blocks
  under `torch.utils.checkpoint` equal those without it, bit for bit.
* The initializers: `gemma.Model.initialize` against flax's `init` of the
  same model, leaf by leaf: the same shapes, zero norms, and moments (std
  within 3%, mean within 4 standard errors, the truncated normal's bound).
* The trainer: the port's (`trainers/proj/paligemma/train.py`) and the
  JAX one each run their copy of configs/proj/paligemma/smoke.py from one
  init, written as two `.npz` files and read through `model_init`: the
  loss of every step within 1e-5 relative and every updated param within
  1e-5 of the leaf's largest magnitude, with and without
  `label_smoothing` (3 steps, and the config's 20 under `attn=flash`,
  whose loss falls).
* A run stopped and resumed from its checkpoint continues bit-equal.
* The optimizer over chunks of params is bit-equal to the whole chain.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch import optim as t_optim
from big_vision_torch import train as t_train
from big_vision_torch.configs.proj.paligemma import smoke as t_smoke
from big_vision_torch.models.ppp import gemma as t_gemma
from big_vision_torch.models.proj.paligemma import paligemma as t_pg
from big_vision_torch.trainers.proj.paligemma import train as t_pgtrain
from big_vision_torch.utils import checkpoints
from big_vision_torch.utils import convert
from big_vision_torch.utils import trees
from big_vision_tpu.configs.proj.paligemma import smoke as j_smoke
from big_vision_tpu.models.ppp import gemma as j_gemma
from big_vision_tpu.models.proj.paligemma import paligemma as j_pg
from big_vision_tpu.trainers.proj.paligemma import train as j_pgtrain

IMG = dict(variant="mu/16", pool_type="none", posemb="sincos2d",
           head_zeroinit=False)


def _llm(attn_impl, **kw):
  return dict(variant="gemma_test", scan=True, cache_dtype=None,
              attn_impl=attn_impl, **kw)


def _inputs():
  rs = np.random.RandomState(0)
  img = rs.randn(2, 16, 16, 3).astype(np.float32)
  txt = np.asarray([[3, 4, 5, 1, 0, 0], [5, 6, 7, 8, 9, 1]], np.int32)
  mask_ar = np.asarray([[0, 0, 1, 1, 1, 1], [0, 1, 1, 1, 1, 1]], np.int32)
  return img, txt, mask_ar


def _port(attn_impl, params, img=None, llm=None):
  model = t_pg.Model(img=dict(IMG, image_size=16, **(img or {})),
                     llm=_llm(attn_impl, **(llm or {})), device="cpu")
  convert.load(model, convert.paligemma(params))
  return model


def _params(seed):
  """A params tree of the test model in the JAX layout, drawn by the
  port's initializers from `seed`."""
  model = t_pg.Model(img=dict(IMG, image_size=16), llm=_llm("xla"),
                     device="cpu")
  return convert.params(model.initialize(torch.Generator().manual_seed(seed)))


def _loss_and_grads(model, img, txt, mask_ar):
  """(text logits, {port name: gradient}) of sum(logits^2) / size."""
  model.zero_grad()
  logits, _ = model(*map(torch.from_numpy, (img, txt, mask_ar)), train=True)
  (logits.float().square().sum() / logits.numel()).backward()
  return logits.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


def test_llm_flash_with_seg_matches_the_jax_xla_and_flash_paths():
  img, txt, mask_ar = _inputs()
  j_x, j_f = (j_pg.Model(img=IMG, llm=_llm(a)) for a in ("xla", "flash"))
  params = j_x.init(jax.random.PRNGKey(0), jnp.asarray(img),
                    jnp.asarray(txt), jnp.asarray(mask_ar))["params"]
  port = _port("flash", params)
  got, got_grads = _loss_and_grads(port, img, txt, mask_ar)
  for jmodel in (j_x, j_f):
    want, _ = jmodel.apply({"params": params}, img, txt, mask_ar)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)

    def loss(p, jmodel=jmodel):
      logits, _ = jmodel.apply({"params": p}, img, txt, mask_ar, train=True)
      return jnp.sum(logits.astype(jnp.float32) ** 2) / logits.size

    want_grads = convert.paligemma(jax.grad(loss)(params))
    assert sorted(want_grads) == sorted(got_grads)
    for name, g in want_grads.items():
      np.testing.assert_allclose(got_grads[name].numpy(), np.asarray(g),
                                 rtol=0, atol=3e-4, err_msg=name)


def test_flash_and_einsum_paths_of_the_port_agree_on_every_row():
  img, txt, mask_ar = _inputs()
  params = _params(1)
  lf, gf = _loss_and_grads(_port("flash", params), img, txt, mask_ar)
  lx, gx = _loss_and_grads(_port("xla", params), img, txt, mask_ar)
  np.testing.assert_allclose(lf.numpy(), lx.numpy(), rtol=0, atol=2e-5)
  for name in gx:
    np.testing.assert_allclose(gf[name].numpy(), gx[name].numpy(), rtol=0,
                               atol=3e-5, err_msg=name)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_remat_gradients_are_bit_equal(attn_impl):
  img, txt, mask_ar = _inputs()
  params = _params(2)
  with_remat = _port(attn_impl, params, img=dict(scan=True),
                     llm=dict(remat_policy="nothing_saveable"))
  without = _port(attn_impl, params, img=dict(scan=False),
                  llm=dict(remat_policy="none"))
  assert with_remat.img.encoder.remat and not without.img.encoder.remat
  calls = []
  hook = torch.utils.checkpoint.checkpoint
  torch.utils.checkpoint.checkpoint = lambda fn, *a, **kw: (
      calls.append(type(fn).__name__), hook(fn, *a, **kw))[1]
  try:
    l1, g1 = _loss_and_grads(with_remat, img, txt, mask_ar)
  finally:
    torch.utils.checkpoint.checkpoint = hook
  l2, g2 = _loss_and_grads(without, img, txt, mask_ar)
  # gemma_test's two blocks, mu/16's one (and its plain attention's own
  # checkpoint, a function, in the forward and in the recompute).
  blocks = sorted(c for c in calls if c != "function")
  assert blocks == ["Block", "Block", "Encoder1DBlock"], calls
  assert torch.equal(l1, l2)
  for name in g2:
    assert torch.equal(g1[name], g2[name]), name


def test_gemma_initializers_match_flax():
  cfg = dict(variant="x", width=512, depth=2, mlp_dim=1024, num_heads=4,
             num_kv_heads=1, head_dim=128, norm_eps=1e-6, vocab_size=2048)
  want = j_gemma.Model(**cfg).init(jax.random.PRNGKey(0),
                                   jnp.ones((1, 4), jnp.int32))["params"]
  port = t_gemma.Model(**cfg, device="cpu")
  port.initialize(torch.Generator().manual_seed(0))
  got = convert.gemma_params(port)
  flat = lambda t: dict(trees.flatten(t))
  want, got = flat(want), {k: v.numpy() for k, v in flat(got).items()}
  assert sorted(want) == sorted(got)
  for name, w in want.items():
    w, g = np.asarray(w, np.float64), got[name].astype(np.float64)
    assert w.shape == g.shape, name
    if name.endswith("scale"):  # RMSNorm: zeros
      assert not w.any() and not g.any(), name
      continue
    assert abs(g.std() / w.std() - 1) < 0.03, (name, g.std(), w.std())
    assert abs(g.mean()) < 4 * w.std() / np.sqrt(g.size), name
    if "embedding" not in name:  # truncated at 2 stddevs of the normal
      assert np.abs(g).max() <= np.abs(w).max() * 1.01, name


# ----------------------------------------------------------------------------
# The trainer against the JAX trainer.
# ----------------------------------------------------------------------------


def _write_init(tmp_path):
  """One init of the smoke model (the port's, from a seed) as two `.npz`
  files in the JAX layout; returns {"img": path, "llm": path}."""
  model = t_pg.Model(**t_smoke.get_config()["model"], device="cpu")
  model.initialize(torch.Generator().manual_seed(0))
  params = convert.params(model)
  files = {}
  for part in ("img", "llm"):
    files[part] = str(tmp_path / f"{part}.npz")
    checkpoints.npz_save(params[part], files[part])
  return files


def _rows(workdir):
  with open(workdir / "big_vision_metrics.txt") as f:
    return [r for r in map(json.loads, f) if "training_loss" in r]


def _twin(tmp_path, arg, **overrides):
  """(JAX rows, port rows, JAX params, the port trainer) of the smoke
  config under `arg` from one init, no checkpoint, no eval."""
  overrides = dict(model_init=_write_init(tmp_path), log_training_steps=1,
                   ckpt_steps=None, evals={}, **overrides)
  jax_config = j_smoke.get_config(arg)
  jax_config.update(overrides)
  jax_state = j_pgtrain.main(config=jax_config, workdir=str(tmp_path / "jax"))
  config = t_smoke.get_config(arg)
  config.update(overrides)
  trainer = t_train.train(config, str(tmp_path / "port"), device="cpu",
                          trainer_cls=t_pgtrain.Trainer)
  return (_rows(tmp_path / "jax"), _rows(tmp_path / "port"),
          jax.device_get(jax_state["params"]), trainer)


# Three steps of the config (the first at the warmup's learning rate of 0)
# with label smoothing, and its 20 steps under attn=flash without.
@pytest.mark.parametrize("arg,label_smoothing", [("total_steps=3", 0.1),
                                                 ("attn=flash", 0.0)])
def test_updates_equal_the_jax_trainer(tmp_path, arg, label_smoothing):
  jax_rows, port_rows, jax_params, trainer = _twin(
      tmp_path, arg, label_smoothing=label_smoothing)
  assert len(jax_rows) == trainer.total_steps
  worst = 0.0
  for j, t in zip(jax_rows, port_rows, strict=True):
    assert j["step"] == t["step"]
    for m in ("training_loss", "avg_sup_seqlen", "max_sup_seqlen",
              "l2_grads", "l2_params"):
      rel = abs(t[m] - j[m]) / abs(j[m])
      worst = max(worst, rel)
      assert rel <= 1e-5, (j["step"], m, t[m], j[m])
  want = convert.paligemma(jax_params)
  got = trainer.model.state_dict()
  assert sorted(want) == sorted(got)
  for name, w in want.items():
    w = np.asarray(w)
    err = np.abs(got[name].numpy() - w).max() / max(np.abs(w).max(), 1e-30)
    worst = max(worst, err)
    assert err <= 1e-5, (name, err)
  print(f"{arg}: worst relative difference {worst:.3e}")
  losses = [r["training_loss"] for r in port_rows]
  assert losses[-1] < losses[0], losses


def test_resumed_run_continues_bit_equal(tmp_path):
  def run(workdir, arg):
    config = t_smoke.get_config(arg)
    config.update(log_training_steps=1, evals={})
    return t_train.train(config, str(workdir), device="cpu",
                         trainer_cls=t_pgtrain.Trainer)

  whole = run(tmp_path / "whole", "total_steps=8,ckpt=4")
  run(tmp_path / "cut", "total_steps=8,ckpt=4,stop=4")
  resumed = run(tmp_path / "cut", "total_steps=8,ckpt=4")
  assert resumed.first_step == 4
  rows = {r["step"]: r["training_loss"] for r in _rows(tmp_path / "cut")}
  for r in _rows(tmp_path / "whole"):
    assert rows[r["step"]] == r["training_loss"], r["step"]
  for name, p in whole.params.items():
    assert torch.equal(p, resumed.params[name]), name
  for key in ("mu", "nu"):
    for name, x in whole.opt_state[key].items():
      assert torch.equal(x, resumed.opt_state[key][name]), (key, name)


def test_chunked_optimizer_is_bit_equal_to_the_whole_chain():
  gen = torch.Generator().manual_seed(0)
  shapes = {"a/kernel": (64, 48), "b/bias": (48,), "c/w": (300, 16),
            "d/kernel": (7, 5), "frozen/kernel": (4, 4)}

  def tree():
    return {n: torch.randn(s, generator=gen) for n, s in shapes.items()}

  params, grads = tree(), tree()
  config = dict(optax_name="scale_by_adam", optax=dict(b2=0.95), lr=1e-2,
                wd=1e-3, grad_clip_norm=0.5,
                lr_mults=[("c/.*", 0.5)],
                schedule=[("frozen/.*", None),
                          (".*", dict(warmup_steps=1, decay_type="cosine"))])
  tx, _ = t_optim.make(config, params, sched_kw=dict(total_steps=10))
  p1 = {n: x.clone() for n, x in params.items()}
  p2 = {n: x.clone() for n, x in params.items()}
  s1, s2 = tx.init(p1), tx.init(p2)
  assert tx.chunks(p2, 3200) == [["a/kernel", "b/bias"], ["c/w"],
                                 ["d/kernel"]]
  for _ in range(3):
    _, s1 = tx.apply_(p1, grads, s1)
    _, s2 = tx.apply_(p2, grads, s2, chunk_numel=3200)
    grads = {n: g * 1.5 for n, g in grads.items()}
  assert s1["count"] == s2["count"] == 3
  for n in shapes:
    assert torch.equal(p1[n], p2[n]), n
  for key in ("mu", "nu"):
    assert sorted(s1[key]) == sorted(s2[key])
    for n, x in s1[key].items():
      assert torch.equal(x, s2[key][n]), (key, n)

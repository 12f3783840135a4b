"""The port's PaliGemma video input, decode oracle and loader vs JAX.

A mu/16 image tower at 32px plus `gemma_test`, every param leaf drawn from
a seed and carried over by utils/convert.py. Video: clips [B, F, H, W, C]
through `embed_image` and a greedy decode, against the JAX model. The
oracle (`_fallback_prefill_cache` / `_fallback_extend_cache`, a full
prefix-LM forward per step): the port's fast KV-cache path against its
own oracle at every step, and the port's oracle against JAX's, logits
within 1e-5 relative (f32). `paligemma.load` of the `.npz` files that JAX
writes against JAX's `load`, bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch.models.ppp import gemma as t_gemma
from big_vision_torch.models.proj.paligemma import gemma_bv as t_gemma_bv
from big_vision_torch.models.proj.paligemma import paligemma as t_pg
from big_vision_torch.models.proj.paligemma import predict_fns as t_pf
from big_vision_torch.utils import checkpoints as t_ckpt
from big_vision_torch.utils import convert
from big_vision_tpu.models.ppp import gemma as j_gemma
from big_vision_tpu.models.proj.paligemma import paligemma as j_pg
from big_vision_tpu.models.proj.paligemma import predict_fns as j_pf
from big_vision_tpu.utils import checkpoints as j_ckpt

IMG = dict(variant="mu/16", pool_type="none")
LLM = dict(variant="gemma_test", cache_dtype=None, decode_impl="xla")


@functools.lru_cache(maxsize=None)
def models(frames=None):
  rs = np.random.RandomState(1)
  shape = (2,) + ((frames,) if frames else ()) + (32, 32, 3)
  batch = dict(image=rs.randn(*shape).astype(np.float32),
               text=rs.randint(4, 256, (2, 4)).astype(np.int32),
               mask_input=np.arange(4)[None, :] < np.array([[2], [4]]),
               mask_ar=np.array([[0, 0, 1, 1], [0, 1, 1, 1]], np.int32))
  jmodel = j_pg.Model(img=IMG, llm=LLM)
  shapes = jax.eval_shape(lambda: jmodel.init(
      jax.random.PRNGKey(0), jnp.asarray(batch["image"]),
      jnp.asarray(batch["text"]), jnp.asarray(batch["mask_ar"])))
  params = jax.tree.map(
      lambda s: (rs.randn(*s.shape) * 0.3).astype(np.float32),
      shapes["params"])
  tmodel = t_pg.Model(img=dict(IMG, image_size=32), llm=LLM, device="cpu")
  convert.load(tmodel, convert.paligemma(params))
  return jmodel, params, tmodel, batch


def close(got, want, rtol=1e-5):
  want = np.asarray(want)
  np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                             atol=rtol * float(np.abs(want).max()))


def test_video_embed_image_and_decode_match_jax():
  jmodel, params, tmodel, batch = models(frames=3)
  want, _ = jmodel.apply({"params": params}, jnp.asarray(batch["image"]),
                         method=jmodel.embed_image)
  with torch.no_grad():
    got, _ = tmodel.embed_image(torch.from_numpy(batch["image"]))
  assert got.shape == (2, 3 * 4, 32)  # 3 frames of 2x2 tokens
  close(got, want)
  want_tok, want_lp = j_pf.make_predict_fns(
      jmodel, max_decode_len=5, eos_token=-1)["decode_with_logp"](
          {"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
  got_tok, got_lp = t_pf.make_predict_fns(
      tmodel, max_decode_len=5, eos_token=-1)["decode_with_logp"](
          {k: torch.from_numpy(v) for k, v in batch.items()})
  np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
  np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), rtol=0,
                             atol=1e-4)


def test_oracle_matches_the_fast_path_and_jax():
  jmodel, params, tmodel, batch = models()
  steps = 4
  (x, mask, ar), _ = tmodel.embed_image_and_text(
      torch.from_numpy(batch["image"]), torch.from_numpy(batch["text"]),
      input_mask=torch.from_numpy(batch["mask_input"]),
      mask_ar=torch.from_numpy(batch["mask_ar"]))
  cache_size = x.shape[1] + steps
  with torch.no_grad():
    fast, fcache = tmodel.prefill_cache(x, mask, ar, cache_size=cache_size)
    slow, scache = tmodel._fallback_prefill_cache(x, mask, ar, cache_size)
  jx, jmask, jar = (jnp.asarray(t.detach().numpy()) for t in (x, mask, ar))
  want, jcache = jmodel.apply(
      {"params": params}, jx, jmask, jar, cache_size,
      method=jmodel._fallback_prefill_cache, mutable=["cache"])
  close(slow, want)
  close(fast, slow)
  tokens = np.array([[5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
  for i in range(steps):
    with torch.no_grad():
      emb, _ = tmodel.embed_text(torch.from_numpy(tokens[:, i:i + 1]))
      fast, fcache = tmodel.extend_cache(emb, fcache)
      slow, scache = tmodel._fallback_extend_cache(emb, scache)
    want, jcache = jmodel.apply(
        {"params": params, **jcache}, jnp.asarray(emb.numpy()),
        method=jmodel._fallback_extend_cache, mutable=["cache"])
    close(slow, want)
    close(fast, slow)
  np.testing.assert_array_equal(scache.length.numpy(),
                                np.asarray(jcache["cache"]["length"]))


class _NoCacheLLM(t_gemma_bv.Model):
  """The LLM without `prefill_cache`, as an LLM the oracle serves."""

  def __getattribute__(self, name):
    if name in ("prefill_cache", "extend_cache"):
      raise AttributeError(name)
    return super().__getattribute__(name)


def test_decode_takes_the_oracle_without_a_kv_cache():
  _, params, tmodel, batch = models()
  oracle = t_pg.Model(img=dict(IMG, image_size=32), llm=LLM, device="cpu")
  oracle.llm.__class__ = _NoCacheLLM
  assert not hasattr(oracle.llm, "prefill_cache")
  convert.load(oracle, convert.paligemma(params))
  tb = {k: torch.from_numpy(v) for k, v in batch.items()}
  for fn in ("decode", "beam_decode"):
    want = t_pf.make_predict_fns(tmodel, max_decode_len=4, eos_token=-1)[fn]
    got = t_pf.make_predict_fns(oracle, max_decode_len=4, eos_token=-1)[fn]
    np.testing.assert_array_equal(got(tb).numpy(), want(tb).numpy())


def _jax_trees(params):
  return {"img": params["img"], "llm": params["llm"]}


def test_load_matches_jax(tmp_path, monkeypatch):
  jmodel, params, tmodel, _ = models()
  paths = {}
  for part in ("img", "llm"):
    paths[part] = str(tmp_path / f"{part}.npz")
    j_ckpt.npz_save(params[part], paths[part])
  cfg = dict(img=IMG, llm=dict(LLM, vocab_size=256))
  want = j_pg.load(None, paths, cfg)
  got = t_pg.load(None, paths, cfg)
  _assert_equal(got, want)
  # One combined file, by its name (the JAX loader sends "f.npz:llm" to
  # orbax); with the port's own tree as the target.
  combined = str(tmp_path / "both.npz")
  j_ckpt.npz_save(_jax_trees(params), combined)
  init = {"img": convert.vit_params(tmodel.img),
          "llm": convert.gemma_params(tmodel.llm.model)}
  _assert_equal(t_pg.load(init, combined, cfg), want)
  with pytest.raises(ValueError, match="Unused"):
    t_pg.load(None, dict(paths, txt=paths["img"]), cfg)
  # Vanity names resolve under $BV_GEMMA_DIR, as in JAX.
  assert t_pg.VANITY_NAMES.keys() == j_pg.VANITY_NAMES.keys()
  monkeypatch.setattr(t_pg, "VANITY_NAMES", {"pt_224": combined})
  _assert_equal(t_pg.load(None, "pt_224", cfg), want)


def test_load_quantizes_the_llm_into_an_int8_target(tmp_path):
  _, params, _, _ = models()
  path = str(tmp_path / "both.npz")
  j_ckpt.npz_save(_jax_trees(params), path)
  qmodel = t_pg.Model(img=dict(IMG, image_size=32),
                      llm=dict(LLM, quant=True), device="cpu")
  init = {"img": convert.vit_params(qmodel.img),
          "llm": convert.gemma_params(qmodel.llm.model)}
  got = t_pg.load(init, path, dict(img=IMG, llm=dict(LLM, quant=True)))
  want = j_gemma.quantize_params(j_gemma.scan_to_pyloop(params["llm"]))
  _assert_equal(got["llm"], want)
  convert.load(qmodel, convert.paligemma(got))
  assert qmodel.llm.model.embedder.input_embedding.dtype == torch.int8


def test_still_refused():
  """What the port still refuses: the LLM's ring attention over a device
  mesh (the fused training attention and the LLM's dropout are ported: a
  model with dropout builds, and draws it only from a given generator)."""
  with pytest.raises(NotImplementedError, match="ring"):
    t_gemma.Model(**t_gemma.get_config("gemma_test"), attn_impl="ring",
                  device="cpu")
  model = t_gemma.Model(**t_gemma.get_config("gemma_test"), dropout=0.1,
                        device="cpu").initialize(torch.Generator())
  tokens = torch.arange(6)[None] % 256
  with torch.no_grad():
    plain = model(tokens)[0]
    dropped = model(tokens, rng=torch.Generator().manual_seed(1))[0]
  torch.testing.assert_close(model(tokens)[0].detach(), plain)
  assert not torch.equal(dropped, plain)
  t_gemma.Model(**t_gemma.get_config("gemma_test"), attn_impl="flash",
                device="cpu")


def _assert_equal(got, want):
  got = dict(jax.tree_util.tree_flatten_with_path(
      jax.tree.map(lambda x: x.numpy() if isinstance(x, torch.Tensor)
                   else np.asarray(x), got))[0])
  want = dict(jax.tree_util.tree_flatten_with_path(
      jax.tree.map(np.asarray, want))[0])
  assert sorted(map(str, got)) == sorted(map(str, want))
  for k, w in want.items():
    assert got[k].dtype == w.dtype, (k, got[k].dtype, w.dtype)
    np.testing.assert_array_equal(got[k], w, err_msg=str(k))


def test_checkpoint_tree_round_trips_through_the_port_writer(tmp_path):
  """A tree the port writes (`npz_save`) is the tree JAX reads."""
  _, params, _, _ = models()
  path = str(tmp_path / "port.npz")
  t_ckpt.npz_save(_jax_trees(params), path)
  _assert_equal(t_ckpt.load_params(f"{path}:llm"),
                j_ckpt.load_params(f"{path}:llm"))

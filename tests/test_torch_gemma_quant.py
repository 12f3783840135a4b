"""The port's int8 Gemma weights vs the JAX package.

`quantize_params` bit for bit (both layer layouts, MHA and GQA, numpy and
tensors, a tree quantized twice); the quantized model's logits and decode
steps against JAX `Model(quant=True)` within 1e-5 relative (f32);
`convert.gemma` and `gemma_params` inverse to each other with the scales;
`gemma.load` of `.npz` files that the JAX package writes (a float file into
an int8 target, an int8 file into a float target refused, vocab extension,
orbax refused); and the `quantize_ckpt` CLI, whose output JAX's `load`
reads. `gemma_test` sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch.models.ppp import gemma as t_gemma
from big_vision_torch.tools import quantize_ckpt as t_quantize_ckpt
from big_vision_torch.utils import checkpoints as t_ckpt
from big_vision_torch.utils import convert
from big_vision_tpu.models.ppp import gemma as j_gemma
from big_vision_tpu.tools import quantize_ckpt as j_quantize_ckpt
from big_vision_tpu.utils import checkpoints as j_ckpt
import big_vision_tpu.utils as j_u

torch.backends.cuda.matmul.allow_tf32 = False

TOKENS = np.array([[3, 7, 11, 2, 9, 1], [4, 5, 6, 8, 10, 12]], np.int32)
# MHA (one qkv_einsum), MQA (gemma_test: q_einsum and kv_einsum) and a
# Gemma-2-shaped GQA variant (4 heads on 2 kv heads, post-norms, softcaps).
VARIANTS = {
    "mha": dict(num_kv_heads=2),
    "mqa": dict(),
    "gqa-gemma2": dict(num_heads=4, num_kv_heads=2, post_norms=True,
                       final_logits_softcap=5.0, attn_logits_softcap=3.0),
}


def jax_cfg(variant, scan=False, **kw):
  return {**j_gemma.get_config("gemma_test"), **VARIANTS[variant],
          "scan": scan, **kw}


def port_cfg(cfg):
  return {k: v for k, v in cfg.items() if k not in ("scan", "remat_policy")}


def random_params(cfg, seed=0):
  shapes = jax.eval_shape(lambda: j_gemma.Model(**cfg).init(
      jax.random.PRNGKey(0), jnp.asarray(TOKENS)))["params"]
  rs = np.random.RandomState(seed)
  return jax.tree.map(
      lambda s: (rs.randn(*s.shape) * 0.3).astype(np.float32), shapes)


def assert_trees_equal(got, want):
  got = {k: np.asarray(v) for k, v in
         jax.tree_util.tree_flatten_with_path(got)[0]}
  want = {k: np.asarray(v) for k, v in
          jax.tree_util.tree_flatten_with_path(want)[0]}
  assert sorted(map(str, got)) == sorted(map(str, want))
  for k, w in want.items():
    assert got[k].dtype == w.dtype, (k, got[k].dtype, w.dtype)
    np.testing.assert_array_equal(got[k], w, err_msg=str(k))


def close(got, want, rtol=1e-5):
  want = np.asarray(want)
  np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                             atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("scan", [False, True], ids=["pyloop", "scan"])
@pytest.mark.parametrize("variant", ["mha", "gqa-gemma2"])
def test_quantize_params_is_bit_equal_to_jax(variant, scan):
  params = random_params(jax_cfg(variant, scan))
  params["layers"] = dict(params["layers"])
  want = j_gemma.quantize_params(params)
  assert_trees_equal(t_gemma.quantize_params(params), want)
  # The same on tensors, as the card quantizes a model it holds.
  as_tensors = jax.tree.map(lambda x: torch.from_numpy(np.asarray(x)),
                            params)
  got = jax.tree.map(lambda t: t.numpy(),
                     t_gemma.quantize_params(as_tensors))
  assert_trees_equal(got, want)


def test_quantizing_a_quantized_tree_does_what_jax_does():
  params = random_params(jax_cfg("mqa"))
  # Shift some rows so that a second pass sees int8 absmax below 127.
  params["embedder"]["input_embedding"][:3] = 0.0
  once = t_gemma.quantize_params(params)
  twice_want = j_gemma.quantize_params(j_gemma.quantize_params(params))
  assert_trees_equal(t_gemma.quantize_params(once), twice_want)


def test_quantize_params_needs_a_gemma_tree():
  with pytest.raises(ValueError, match="no quantizable"):
    t_gemma.quantize_params({"a": {"b": np.ones((2, 2), np.float32)}})


@pytest.mark.parametrize("variant", ["mha", "gqa-gemma2"])
def test_quantized_logits_and_decode_match_jax(variant):
  cfg = jax_cfg(variant, quant=True)
  qparams = j_gemma.quantize_params(random_params(jax_cfg(variant)))
  jmodel = j_gemma.Model(**cfg)
  apply = jax.jit(jmodel.apply, static_argnames=("decode", "mutable"))
  tmodel = t_gemma.Model(**port_cfg(cfg), device="cpu")
  convert.load(tmodel, convert.gemma(qparams))
  want, _ = apply({"params": qparams}, jnp.asarray(TOKENS))
  with torch.no_grad():
    got, out = tmodel(torch.from_numpy(TOKENS).long())
  close(got, want)
  # pre_logits -> logits: the int8 table converted, then the row scales.
  want, _ = jmodel.apply({"params": qparams}, None,
                         pre_logits=jnp.asarray(out["pre_logits"].numpy()))
  with torch.no_grad():
    got, _ = tmodel(None, pre_logits=out["pre_logits"])
  close(got, want)

  # Prefill and two one-token steps through the KV cache.
  b, t, cache_size = 2, TOKENS.shape[1], TOKENS.shape[1] + 2
  mask = np.zeros((b, 1, t, cache_size), bool)
  mask[..., :t] = np.tril(np.ones((t, t), bool))
  positions = np.arange(t)[None].repeat(b, 0).astype(np.int32)
  (want, _), cvars = apply(
      {"params": qparams}, jnp.asarray(TOKENS), positions=positions,
      mask=jnp.asarray(mask), decode=True, mutable=("cache",))
  cache = t_gemma.KVCache()
  with torch.no_grad():
    got, _ = tmodel(torch.from_numpy(TOKENS).long(),
                    positions=torch.from_numpy(positions),
                    mask=torch.from_numpy(mask), cache=cache)
  close(got, want)
  for i in range(2):
    tok = np.array([[5 + i], [9]], np.int32)
    pos = np.full((b, 1), t + i, np.int32)
    step = np.zeros((b, 1, 1, cache_size), bool)
    step[..., :t + i + 1] = True
    (want, _), cvars = apply(
        {"params": qparams, **cvars}, jnp.asarray(tok), positions=pos,
        mask=jnp.asarray(step), decode=True, mutable=("cache",))
    with torch.no_grad():
      got, _ = tmodel(torch.from_numpy(tok).long(),
                      positions=torch.from_numpy(pos),
                      mask=torch.from_numpy(step), cache=cache)
    close(got, want)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("variant", ["mha", "gqa-gemma2"])
def test_gemma_params_inverts_convert(variant, quant):
  params = random_params(jax_cfg(variant))
  if quant:
    params = j_gemma.quantize_params(params)
  cfg = port_cfg(jax_cfg(variant, quant=quant))
  tmodel = t_gemma.Model(**cfg, device="cpu")
  convert.load(tmodel, convert.gemma(params))
  got = jax.tree.map(lambda t: t.numpy(), convert.gemma_params(tmodel))
  assert_trees_equal(got, params)


def test_convert_load_casts_floats_but_not_int8_weights_or_scales():
  params = j_gemma.quantize_params(random_params(jax_cfg("mqa")))
  tmodel = t_gemma.Model(**port_cfg(jax_cfg("mqa", quant=True)),
                         device="cpu")
  convert.load(tmodel, convert.gemma(params), dtype=torch.bfloat16)
  attn = tmodel.layers[0].attn
  assert attn.q.dtype == torch.int8 and attn.q_scale.dtype == torch.float32
  assert tmodel.final_norm.scale.dtype == torch.bfloat16
  assert not attn.q.requires_grad


def save_jax(tree, path):
  j_ckpt.npz_save(tree, str(path))
  return str(path)


def port_init(variant, quant, vocab=None):
  """The port's target tree, as `load` takes it."""
  cfg = port_cfg(jax_cfg(variant, quant=quant))
  if vocab:
    cfg["vocab_size"] = vocab
  return convert.gemma_params(t_gemma.Model(**cfg, device="cpu"))


def jax_init(variant, quant, scan=False, vocab=None):
  cfg = jax_cfg(variant, scan, quant=quant)
  if vocab:
    cfg["vocab_size"] = vocab
  return jax.eval_shape(lambda: j_gemma.Model(**cfg).init(
      jax.random.PRNGKey(0), jnp.asarray(TOKENS)))["params"]


def to_numpy(tree):
  return jax.tree.map(lambda x: x.numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x), tree)


@pytest.mark.parametrize("scan", [False, True], ids=["pyloop", "scan"])
def test_load_quantizes_a_float_file_into_an_int8_target(tmp_path, scan):
  path = save_jax(random_params(jax_cfg("gqa-gemma2", scan=True)),
                  tmp_path / "float.npz")
  want = j_gemma.load(jax_init("gqa-gemma2", True, scan), path,
                      jax_cfg("gqa-gemma2", scan))
  if scan:  # the port's target is per-layer; compare in JAX's layout
    want = j_gemma.scan_to_pyloop(want)
  got = t_gemma.load(port_init("gqa-gemma2", True), path,
                     port_cfg(jax_cfg("gqa-gemma2")))
  assert_trees_equal(to_numpy(got), want)
  # The stacked layout, when the target has it.
  stacked = t_gemma.load(None, path, {"scan": True})
  assert_trees_equal(to_numpy(stacked), j_gemma.load(
      None, path, {"scan": True}))


def test_load_refuses_an_int8_file_in_a_float_model(tmp_path):
  qparams = j_gemma.quantize_params(random_params(jax_cfg("mqa")))
  path = save_jax(qparams, tmp_path / "int8.npz")
  with pytest.raises(ValueError, match="int8-quantized checkpoint"):
    j_gemma.load(jax_init("mqa", False), path, {})
  with pytest.raises(ValueError, match="int8-quantized checkpoint"):
    t_gemma.load(port_init("mqa", False), path, {})
  # Into an int8 target it passes through unchanged.
  got = t_gemma.load(port_init("mqa", True), path, {})
  assert_trees_equal(to_numpy(got), j_gemma.load(jax_init("mqa", True),
                                                 path, {}))


def test_load_extends_the_vocab(tmp_path):
  params = random_params(jax_cfg("mqa"))
  path = save_jax(params, tmp_path / "float.npz")
  cfg = {"vocab_size": 300}
  want = j_gemma.load(jax_init("mqa", False, vocab=300), path, cfg)
  got = to_numpy(t_gemma.load(port_init("mqa", False, vocab=300), path,
                              cfg))
  # The new rows come from numpy's unseeded global RNG: compare the
  # checkpoint's own rows, and the shapes.
  emb_got = got["embedder"].pop("input_embedding")
  emb_want = np.asarray(want["embedder"].pop("input_embedding"))
  assert emb_got.shape == emb_want.shape == (300, 32)
  np.testing.assert_array_equal(emb_got[:256], emb_want[:256])
  assert 0 < emb_got[256:].std() < 0.05
  assert_trees_equal(got, want)
  # An int8 table cannot be extended.
  qpath = save_jax(j_gemma.quantize_params(params), tmp_path / "int8.npz")
  with pytest.raises(ValueError, match="needs a float checkpoint"):
    t_gemma.load(None, qpath, cfg)
  with pytest.raises(ValueError, match="needs a float checkpoint"):
    j_gemma.load(None, qpath, cfg)


def test_load_refuses_orbax_directories(tmp_path):
  with pytest.raises(ValueError, match="orbax"):
    t_gemma.load(None, str(tmp_path), {})


@pytest.mark.parametrize("layout", ["unrolled", "scan"])
def test_quantize_ckpt_cli_output_is_read_by_jax(tmp_path, layout, capsys):
  params = random_params(jax_cfg("mqa", scan=True))
  src = save_jax({"llm": params, "img": {"w": np.ones((2, 3), np.float32)}},
                 tmp_path / "float.npz")
  dst = str(tmp_path / "int8.npz")
  t_quantize_ckpt.main(["--ckpt", src, "--subtree", "llm", "--out", dst,
                        "--layout", layout])
  assert "int8 weights" in capsys.readouterr().out
  loaded = j_u.load_params(dst)
  np.testing.assert_array_equal(np.asarray(loaded["img"]["w"]),
                                np.ones((2, 3)))
  # The same file the JAX tool writes, leaf for leaf.
  ref = str(tmp_path / "ref.npz")
  j_quantize_ckpt.main(["--ckpt", src, "--subtree", "llm", "--out", ref,
                        "--layout", layout])
  assert_trees_equal(loaded, j_u.load_params(ref))
  # JAX's loader reads it into its quant=True model, and it serves.
  scan = layout == "scan"
  jparams = j_gemma.load(jax_init("mqa", True, scan),
                         _llm_only(dst, tmp_path), jax_cfg("mqa", scan))
  logits, _ = j_gemma.Model(**jax_cfg("mqa", scan, quant=True)).apply(
      {"params": jparams}, jnp.asarray(TOKENS))
  assert np.isfinite(np.asarray(logits)).all()


def _llm_only(path, tmp_path):
  """The `llm` subtree as a file of its own (JAX's `gemma.load` takes a
  bare `.npz` path)."""
  out = str(tmp_path / "llm_only.npz")
  t_ckpt.npz_save(t_ckpt.load_params(f"{path}:llm"), out)
  return out

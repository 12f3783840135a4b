"""Port's Gemma (and its gemma_bv wrapper) vs the JAX model.

`gemma_test`-sized models with every param leaf drawn from a seed: the
full forward, then a prefill plus 2 one-token steps through the KV cache,
for MQA and MHA, both decode paths ("flash": the K6 kernel in JAX's
interpret mode vs the port's plain K6; "xla": the einsum path), both param
layouts, and the Gemma-2 options; then gemma_bv's right-aligned
`prefill_cache` plus 4 `extend_cache` steps on prompts of different
lengths. f32 throughout: logits agree within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch.models.ppp import gemma as t_gemma
from big_vision_torch.models.proj.paligemma import gemma_bv as t_gemma_bv
from big_vision_torch.utils import convert
from big_vision_tpu.models.ppp import gemma as j_gemma
from big_vision_tpu.models.proj.paligemma import gemma_bv as j_gemma_bv
from big_vision_tpu.models.proj.paligemma import paligemma as j_paligemma

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def random_params(model, *inputs, seed=0, scale=0.3, **kw):
  shapes = jax.eval_shape(
      lambda *a: model.init(jax.random.PRNGKey(0), *a, **kw), *inputs)
  rs = np.random.RandomState(seed)
  return jax.tree.map(
      lambda s: (rs.randn(*s.shape) * scale).astype(np.float32),
      shapes["params"])


def close(got, want, rtol=1e-5):
  want = np.asarray(want)
  scale = float(np.abs(want).max())
  np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                             atol=rtol * scale)


CASES = {
    "mqa-xla-scan": dict(scan=True, decode_impl="xla"),
    "mqa-flash-bf16cache": dict(decode_impl="flash", cache_dtype="bfloat16"),
    "mha-flash-scan": dict(scan=True, decode_impl="flash", num_kv_heads=2),
    "gemma2-opts-xla": dict(decode_impl="xla", final_logits_softcap=5.0,
                            attn_logits_softcap=3.0, post_norms=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gemma_forward_and_decode_match_jax(case):
  kw = {"scan": False, **CASES[case]}
  cfg = {**j_gemma.get_config("gemma_test"), **kw}
  b, t, cache_size, steps = 2, 5, 8, 2
  rs = np.random.RandomState(1)
  tokens = rs.randint(1, 255, (b, t)).astype(np.int32)
  jmodel = j_gemma.Model(**cfg)
  params = random_params(jmodel, jnp.asarray(tokens))
  tcfg = {k: v for k, v in cfg.items() if k not in ("scan", "remat_policy")}
  tmodel = t_gemma.Model(**tcfg, device="cpu")
  convert.load(tmodel, convert.gemma(params))

  # Full (causal) forward.
  want, _ = jmodel.apply({"params": params}, jnp.asarray(tokens))
  with torch.no_grad():
    got, _ = tmodel(torch.from_numpy(tokens).long())
  close(got, want)

  # Prefill, then one token at a time through the cache.
  mask = np.zeros((b, 1, t, cache_size), bool)
  mask[:, :, :, :t] = np.tril(np.ones((t, t), bool))
  positions = np.arange(t)[None].repeat(b, 0).astype(np.int32)
  (want, _), cvars = jmodel.apply(
      {"params": params}, jnp.asarray(tokens), positions=positions,
      mask=jnp.asarray(mask), decode=True, mutable=["cache"])
  cache = t_gemma.KVCache()
  with torch.no_grad():
    got, _ = tmodel(torch.from_numpy(tokens).long(),
                    positions=torch.from_numpy(positions),
                    mask=torch.from_numpy(mask), cache=cache)
  close(got, want)
  for i in range(steps):
    tok = rs.randint(1, 255, (b, 1)).astype(np.int32)
    pos = np.full((b, 1), t + i, np.int32)
    mstep = np.zeros((b, 1, 1, cache_size), bool)
    mstep[..., :t + i + 1] = True
    (want, _), cvars = jmodel.apply(
        {"params": params, **cvars}, jnp.asarray(tok), positions=pos,
        mask=jnp.asarray(mstep), decode=True, mutable=["cache"])
    with torch.no_grad():
      got, _ = tmodel(torch.from_numpy(tok).long(),
                      positions=torch.from_numpy(pos),
                      mask=torch.from_numpy(mstep), cache=cache)
    close(got, want)
  assert cache.idx == t + steps


@pytest.mark.parametrize("decode_impl,cache_dtype", [
    ("xla", "bfloat16"), ("flash", "bfloat16"), ("xla", "int8"),
    ("flash", "int8")], ids=["xla", "flash", "xla-int8", "flash-int8"])
def test_gemma_bv_prefill_extend_match_jax(decode_impl, cache_dtype):
  b, n, steps = 2, 7, 4
  cache_size = n + steps + 2
  rs = np.random.RandomState(2)
  x = rs.randn(b, n, 32).astype(np.float32)
  input_mask = np.arange(n)[None, :] < np.array([[4], [7]])
  mask_ar = np.array([[0, 0, 1, 1, 1, 1, 1], [0, 0, 0, 1, 1, 1, 1]])
  attn = np.asarray(j_paligemma.make_attn_mask(jnp.asarray(input_mask),
                                               jnp.asarray(mask_ar)))
  kw = dict(variant="gemma_test", decode_impl=decode_impl,
            cache_dtype=cache_dtype)
  jmodel = j_gemma_bv.Model(**kw)
  params = random_params(jmodel, jnp.asarray(x))
  tmodel = t_gemma_bv.Model(**kw, device="cpu")
  convert.load(tmodel.model, convert.gemma(params))

  want, cvars = jmodel.apply(
      {"params": params}, jnp.asarray(x), jnp.asarray(input_mask),
      jnp.asarray(attn), cache_size=cache_size,
      method=jmodel.prefill_cache, mutable=["cache"])
  with torch.no_grad():
    got, cache = tmodel.prefill_cache(
        torch.from_numpy(x), torch.from_numpy(input_mask),
        torch.from_numpy(attn.copy()), cache_size=cache_size)
  close(got, want)
  for _ in range(steps):
    xt = rs.randn(b, 1, 32).astype(np.float32)
    want, cvars = jmodel.apply(
        {"params": params, **cvars}, jnp.asarray(xt),
        method=jmodel.extend_cache, mutable=["cache"])
    with torch.no_grad():
      got, cache = tmodel.extend_cache(torch.from_numpy(xt), cache)
    close(got, want)
  if cache_dtype == "int8":  # JAX's int8 cache and scales, per layer
    jcache = cvars["cache"]["layers"]["attn"]  # the scan stacks axis 1
    kv = cache.kv
    for name, got in (("k_cache", kv.k), ("v_cache", kv.v),
                      ("k_scale", kv.k_scale), ("v_scale", kv.v_scale)):
      for i, layer in enumerate(got):
        want = np.asarray(jcache[name])[:, i]
        assert layer.dtype == torch.from_numpy(want).dtype, name
        np.testing.assert_allclose(layer.float().numpy(), want,
                                   rtol=1e-6, atol=0)


def test_quant_kv_is_bit_equal_to_jax():
  rs = np.random.RandomState(4)
  x = (rs.randn(3, 2, 17, 64) * np.exp(rs.randn(3, 2, 17, 1))).astype(
      np.float32)
  x[0, 0, 0] = 0.0  # an all-zero row: the 1e-30 floor
  x[1, 1, 3, 5] = 1e4  # one large element
  want_q, want_s = j_gemma._quant_kv(jnp.asarray(x))
  got_q, got_s = t_gemma._quant_kv(torch.from_numpy(x))
  assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
  np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
  np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
  # Halfway cases round to even, as jnp.round does.
  half = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]], np.float32)
  np.testing.assert_array_equal(
      t_gemma._quant_kv(torch.from_numpy(half))[0].numpy(),
      np.asarray(j_gemma._quant_kv(jnp.asarray(half))[0]))


@pytest.mark.parametrize("cache_dtype", [torch.int8, "int32", "uint8"])
def test_integer_cache_dtypes_are_refused(cache_dtype):
  """Only the string "int8" selects the quantized cache; an integer dtype
  would store unscaled values (the JAX model raises too)."""
  with pytest.raises(ValueError, match="not a storage format"):
    t_gemma.Attention(2, 1, 32, 16, cache_dtype=cache_dtype, device="cpu")

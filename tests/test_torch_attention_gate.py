"""The port's dispatch gates against the JAX package's.

`ops.attention`'s "auto" must take the fused kernels exactly where the JAX
package's does (`_kernel_ok`: `supports`, then `oneshot_fits` or scores over
`XLA_SCORES_BYTES_LIMIT`), with and without `seg`; and the Gemma decode
step must reach the decode kernel only where `decode_attention.fits` holds,
taking the einsum path past it, as the JAX model does. Both packages'
decisions are read by spies in place of their two attention paths, on
abstract inputs (JAX's `eval_shape`, the port's "meta" tensors), so the
grid reaches shapes whose scores would not fit in memory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch.models.ppp import gemma as t_gemma
from big_vision_torch.ops import attention as t_attention
from big_vision_torch.ops import decode_attention as t_da
from big_vision_torch.ops import flash_attention as t_flash
from big_vision_torch.utils import convert
from big_vision_tpu.models.ppp import gemma as j_gemma
from big_vision_tpu.ops import attention as j_attention
from big_vision_tpu.ops import decode_attention as j_da
from big_vision_tpu.ops import flash_attention as j_flash

BATCHES, HEADS = (1, 8, 32, 256), (1, 12)
LENGTHS = (8, 15, 16, 197, 577, 785, 901, 1025, 1601, 2305, 4097)


def _spies(monkeypatch, flash_mod, attn_mod):
  """Replaces both packages' paths by recorders; returns the record."""
  calls = []

  def flash(q, k, v, **kw):
    calls.append("flash")
    return q

  def xla(q, k, v, mask=None):
    calls.append("xla")
    return q

  monkeypatch.setattr(flash_mod, "flash_attention", flash)
  monkeypatch.setattr(attn_mod, "_xla_attention", xla)
  return calls


def _jax_choice(monkeypatch, b, t, h, d, tkv, with_seg):
  """JAX's path for a global batch that, split over its devices (the
  factor `_batch_shard_factor` takes with no mesh), is b per device."""
  calls = _spies(monkeypatch, j_flash, j_attention)
  n = jax.device_count()
  q = jax.ShapeDtypeStruct((b * n, t, h, d), jnp.float32)
  kv = jax.ShapeDtypeStruct((b * n, tkv, h, d), jnp.float32)
  seg = jax.ShapeDtypeStruct((b * n, t), jnp.int32) if with_seg else None
  jax.eval_shape(lambda q, k, v, s: j_attention.dot_product_attention(
      q, k, v, seg=s), q, kv, kv, seg)
  return calls[-1]


def _torch_choice(monkeypatch, b, t, h, d, tkv, with_seg):
  calls = _spies(monkeypatch, t_flash, t_attention)
  q = torch.empty((b, t, h, d), device="meta")
  kv = torch.empty((b, tkv, h, d), device="meta")
  seg = (torch.empty((b, t), dtype=torch.int32, device="meta")
         if with_seg else None)
  t_attention.dot_product_attention(q, kv, kv, seg=seg)
  return calls[-1]


@pytest.mark.parametrize("with_seg", [False, True])
@pytest.mark.parametrize("d", [16, 64, 72, 128, 256, 288])
def test_auto_takes_the_jax_packages_path(monkeypatch, d, with_seg):
  seen = set()
  for b in BATCHES:
    for h in HEADS:
      for t in LENGTHS:
        for tkv in ((t,) if with_seg else (t, 2 * t)):
          want = _jax_choice(monkeypatch, b, t, h, d, tkv, with_seg)
          got = _torch_choice(monkeypatch, b, t, h, d, tkv, with_seg)
          assert got == want, (b, t, h, d, tkv, with_seg, got, want)
          seen.add(got)
  if d <= 256:  # the grid reaches both paths
    assert seen == {"flash", "xla"}, seen


def test_kernel_ok_and_its_parts_equal_the_jax_packages():
  assert t_attention.XLA_SCORES_BYTES_LIMIT == j_attention.XLA_SCORES_BYTES_LIMIT
  n = jax.device_count()
  for d in (1, 64, 72, 256, 257):
    for t in LENGTHS:
      assert t_flash.supports(t, d) == j_flash.supports(t, d), (t, d)
      for b in BATCHES:
        for h in HEADS:
          assert (t_attention._kernel_ok(t, d, b, h)
                  == j_attention._kernel_ok(t, d, b * n, h)), (t, d, b, h)


def test_flexivit_b_takes_the_plain_path_at_seqhw_30_and_40():
  """The FlexiViT-B config's batch 32, 12 heads, D=64: one-shot kernels up
  to seqhw 28, the plain path at 30 and 40 (scores under 2 GiB)."""
  for seqhw, kernel in ((15, True), (24, True), (28, True), (30, False),
                        (40, False)):
    assert t_attention._kernel_ok(seqhw ** 2 + 1, 64, 32, 12) == kernel


def test_decode_fits_equals_the_jax_packages():
  for s in (1, 127, 128, 352, 2048, 2944, 3071, 3072, 3073, 5760, 5887,
            5888, 5889, 8192, 100_000):
    for h in (16, 64, 128, 200, 256):
      for itemsize in (1, 2, 4):
        assert t_da.fits(s, h, itemsize) == j_da.fits(s, h, itemsize), (
            s, h, itemsize)
  assert t_da.fits(352, 256, 4) and not t_da.fits(8192, 256, 2)


def _random_params(model, tokens, seed=0, scale=0.3):
  shapes = jax.eval_shape(
      lambda t: model.init(jax.random.PRNGKey(0), t), tokens)
  rs = np.random.RandomState(seed)
  return jax.tree.map(
      lambda s: (rs.randn(*s.shape) * scale).astype(np.float32),
      shapes["params"])


@pytest.mark.parametrize("cache_size", [64, 6016])
def test_decode_step_takes_the_kernel_only_where_it_fits(monkeypatch,
                                                          cache_size):
  """A tiny Gemma (f32 activations, so the JAX gate counts 4-byte slots)
  with decode_impl="flash": within `fits` each one-token step calls the
  decode kernel's wrapper once per layer; past it (6016 slots at head dim
  16, padded to 128) none, and the step is the einsum path's, as in the
  JAX model. The second example's step has no visible slot, where the
  einsum path gives the mean of v and the kernel 0."""
  cfg = {**j_gemma.get_config("gemma_test"), "decode_impl": "flash",
         "scan": False}
  head_dim = cfg["head_dim"]
  assert t_da.fits(cache_size, head_dim, 4) == (cache_size == 64)
  b, t = 2, 5
  rs = np.random.RandomState(2)
  tokens = rs.randint(1, 255, (b, t)).astype(np.int32)
  jmodel = j_gemma.Model(**cfg)
  params = _random_params(jmodel, jnp.asarray(tokens))
  tcfg = {k: v for k, v in cfg.items() if k not in ("scan", "remat_policy")}
  models = {}
  for impl in ("flash", "xla"):
    models[impl] = t_gemma.Model(**{**tcfg, "decode_impl": impl},
                                 device="cpu")
    convert.load(models[impl], convert.gemma(params))

  mask = np.zeros((b, 1, t, cache_size), bool)
  mask[:, :, :, :t] = np.tril(np.ones((t, t), bool))
  positions = np.arange(t)[None].repeat(b, 0).astype(np.int32)
  tok = rs.randint(1, 255, (b, 1)).astype(np.int32)
  pos = np.full((b, 1), t, np.int32)
  mstep = np.zeros((b, 1, 1, cache_size), bool)
  mstep[0, ..., :t + 1] = True
  _, cvars = jmodel.apply(
      {"params": params}, jnp.asarray(tokens), positions=positions,
      mask=jnp.asarray(mask), decode=True, mutable=["cache"])
  (want, _), _ = jmodel.apply(
      {"params": params, **cvars}, jnp.asarray(tok), positions=pos,
      mask=jnp.asarray(mstep), decode=True, mutable=["cache"])

  calls = []
  real = t_da.decode_attention
  monkeypatch.setattr(t_da, "decode_attention",
                      lambda *a, **kw: calls.append(1) or real(*a, **kw))
  got = {}
  for impl, model in models.items():
    cache = t_gemma.KVCache()
    with torch.no_grad():
      model(torch.from_numpy(tokens).long(),
            positions=torch.from_numpy(positions),
            mask=torch.from_numpy(mask), cache=cache)
      assert not calls  # prefill never takes the decode kernel
      got[impl], _ = model(torch.from_numpy(tok).long(),
                           positions=torch.from_numpy(pos),
                           mask=torch.from_numpy(mstep), cache=cache)
    want_calls = cfg["depth"] if impl == "flash" and cache_size == 64 else 0
    assert len(calls) == want_calls, (impl, len(calls))
    calls.clear()
  want = np.asarray(want)
  atol = 1e-5 * float(np.abs(want).max())
  np.testing.assert_allclose(got["flash"].numpy(), want, rtol=0, atol=atol)
  if cache_size != 64:
    torch.testing.assert_close(got["flash"], got["xla"], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_path_checkpoint_keeps_the_gradients(dtype, masked):
  """`_xla_attention` runs `_xla_core` under a checkpoint where autograd
  records: the output and the gradients are bit-equal to the core's own,
  and no [B, H, Tq, Tkv] tensor is kept for the backward."""
  b, tq, tkv, h, d = 2, 24, 40, 3, 16
  rs = np.random.RandomState(5)
  q, k, v, do = (torch.from_numpy(rs.randn(*s).astype(np.float32)).to(dtype)
                 for s in ((b, tq, h, d), (b, tkv, h, d), (b, tkv, h, d),
                           (b, tq, h, d)))
  mask = (torch.from_numpy(rs.rand(b, 1, tq, tkv) < 0.7) if masked
          else None)
  results = []
  for fn in (t_attention._xla_core, t_attention._xla_attention):
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
        lambda x: saved.append(x.numel()) or x, lambda x: x):
      out = fn(*leaves, mask)
    out.backward(do)
    results.append((out.detach(), [x.grad for x in leaves], saved))
  (o1, g1, saved1), (o2, g2, saved2) = results
  assert torch.equal(o1, o2)
  for x, y in zip(g1, g2):
    assert torch.equal(x, y)
  assert b * h * tq * tkv in saved1
  assert b * h * tq * tkv not in saved2, saved2
  with torch.no_grad():  # nothing recorded: no checkpoint
    assert torch.equal(t_attention._xla_attention(q, k, v, mask), o1)


@pytest.mark.parametrize("cache_size", [6016, 12032])
def test_int8_decode_step_gates_on_one_byte_slots(monkeypatch, cache_size):
  """With cache_dtype="int8" the JAX model gates its kernel on the int8
  store's itemsize, 1 (gemma.py `_da.fits(..., k.dtype.itemsize)`), not on
  the compute dtype's 4: at 6016 slots of head dim 16 both packages take
  their decode kernel (f32 slots would not fit), at 12032 neither. The
  step's logits agree within 1e-5 of max|logit|."""
  cfg = {**j_gemma.get_config("gemma_test"), "decode_impl": "flash",
         "scan": False, "cache_dtype": "int8"}
  head_dim = cfg["head_dim"]
  takes = cache_size == 6016
  assert t_da.fits(cache_size, head_dim, 1) == takes
  assert not t_da.fits(cache_size, head_dim, 4)
  b, t = 2, 5
  rs = np.random.RandomState(3)
  tokens = rs.randint(1, 255, (b, t)).astype(np.int32)
  jmodel = j_gemma.Model(**cfg)
  params = _random_params(jmodel, jnp.asarray(tokens))
  tcfg = {k: v for k, v in cfg.items() if k not in ("scan", "remat_policy")}
  tmodel = t_gemma.Model(**tcfg, device="cpu")
  convert.load(tmodel, convert.gemma(params))

  mask = np.zeros((b, 1, t, cache_size), bool)
  mask[:, :, :, :t] = np.tril(np.ones((t, t), bool))
  positions = np.arange(t)[None].repeat(b, 0).astype(np.int32)
  tok = rs.randint(1, 255, (b, 1)).astype(np.int32)
  pos = np.full((b, 1), t, np.int32)
  mstep = np.zeros((b, 1, 1, cache_size), bool)
  mstep[..., :t + 1] = True
  calls = {"jax": 0, "torch": 0}
  for name, mod in (("jax", j_da), ("torch", t_da)):
    real = mod.decode_attention
    monkeypatch.setattr(
        mod, "decode_attention",
        lambda *a, real=real, name=name, **kw: (
            calls.__setitem__(name, calls[name] + 1) or real(*a, **kw)))
  _, cvars = jmodel.apply(
      {"params": params}, jnp.asarray(tokens), positions=positions,
      mask=jnp.asarray(mask), decode=True, mutable=["cache"])
  (want, _), _ = jmodel.apply(
      {"params": params, **cvars}, jnp.asarray(tok), positions=pos,
      mask=jnp.asarray(mstep), decode=True, mutable=["cache"])
  cache = t_gemma.KVCache()
  with torch.no_grad():
    tmodel(torch.from_numpy(tokens).long(),
           positions=torch.from_numpy(positions),
           mask=torch.from_numpy(mask), cache=cache)
    got, _ = tmodel(torch.from_numpy(tok).long(),
                    positions=torch.from_numpy(pos),
                    mask=torch.from_numpy(mstep), cache=cache)
  want_calls = cfg["depth"] if takes else 0
  assert calls == {"jax": want_calls, "torch": want_calls}, calls
  want = np.asarray(want)
  np.testing.assert_allclose(got.numpy(), want, rtol=0,
                             atol=1e-5 * float(np.abs(want).max()))

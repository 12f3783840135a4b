"""The port's PaliGemma serving paths vs the JAX package: beam search,
best-of-n and the int8-weight bench.

A mu/16 image tower at 32px plus `gemma_test` (f32 cache, the einsum decode
path on both sides), batch 2, prompts of different lengths, every param
leaf drawn from a seed and carried over by utils/convert.py. EOS is a token
of the model's own greedy output, so that some beams finish early. Tokens
are compared exactly, scores and log-probabilities within 1e-4 (f32, summed
over the steps).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch.models.proj.paligemma import paligemma as t_pg
from big_vision_torch.models.proj.paligemma import predict_fns as t_pf
from big_vision_torch.tools import bench_decode
from big_vision_torch.trainers.proj.paligemma import predict_fns as t_tpf
from big_vision_torch.utils import convert
from big_vision_tpu.models.proj.paligemma import paligemma as j_pg
from big_vision_tpu.models.proj.paligemma import predict_fns as j_pf

IMG = dict(variant="mu/16", pool_type="none")
LLM = dict(variant="gemma_test", cache_dtype=None, decode_impl="xla")
DECODE = 6


@functools.lru_cache(maxsize=None)
def setup():
  rs = np.random.RandomState(0)
  batch = dict(image=rs.randn(2, 32, 32, 3).astype(np.float32),
               text=rs.randint(4, 256, (2, 5)).astype(np.int32),
               mask_input=np.arange(5)[None, :] < np.array([[3], [5]]),
               mask_ar=np.zeros((2, 5), np.int32))
  jmodel = j_pg.Model(img=IMG, llm=LLM)
  shapes = jax.eval_shape(lambda: jmodel.init(
      jax.random.PRNGKey(0), jnp.asarray(batch["image"]),
      jnp.asarray(batch["text"]), jnp.asarray(batch["mask_ar"])))
  params = jax.tree.map(
      lambda s: (rs.randn(*s.shape) * 0.3).astype(np.float32),
      shapes["params"])
  tmodel = t_pg.Model(img=dict(IMG, image_size=32), llm=LLM, device="cpu")
  convert.load(tmodel, convert.paligemma(params))
  # EOS: the third greedy token of example 0.
  tokens, _ = t_pf.decode_with_logp(tmodel, torch_batch(batch),
                                    max_decode_len=DECODE, eos_token=-1)
  return jmodel, params, tmodel, batch, int(tokens[0, 2])


def torch_batch(batch):
  return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_batch(batch):
  return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("beam_size", [1, 2, 3])
def test_beam_decode_matches_jax(beam_size):
  jmodel, params, tmodel, batch, eos = setup()
  want_tok, want_score = jax.jit(functools.partial(
      j_pf._beam_decode_jit, model=jmodel, max_decode_len=DECODE,
      eos_token=eos, beam_size=beam_size))(params, jax_batch(batch))
  got_tok, got_score = t_pf.beam_decode_with_score(
      tmodel, torch_batch(batch), max_decode_len=DECODE, eos_token=eos,
      beam_size=beam_size)
  np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
  np.testing.assert_allclose(got_score.numpy(), np.asarray(want_score),
                             rtol=0, atol=1e-4)
  fns = t_tpf.get_all(tmodel, max_decode_len=DECODE, eos_token=eos,
                      beam_size=beam_size)
  np.testing.assert_array_equal(
      fns["beam_decode"](torch_batch(batch)).numpy(), got_tok.numpy())
  if beam_size == 1:  # one beam is greedy decoding, here ending early
    assert got_tok[0, 2] == eos and not got_tok[0, 3:].any()
    tok, logp = fns["decode_with_logp"](torch_batch(batch))
    np.testing.assert_array_equal(tok.numpy(), got_tok.numpy())
    np.testing.assert_allclose(logp.numpy(), got_score.numpy(), rtol=0,
                               atol=1e-5)


def test_best_of_n_greedy_matches_jax():
  jmodel, params, tmodel, batch, eos = setup()
  want_tok, want_lp = j_pf.make_predict_fns(
      jmodel, max_decode_len=DECODE, eos_token=eos)["decode_with_logp"](
          {"params": params}, jax_batch(batch), best_of_n=3)
  got_tok, got_lp = t_pf.make_predict_fns(
      tmodel, max_decode_len=DECODE, eos_token=eos, best_of_n=3)[
          "decode_with_logp"](torch_batch(batch))
  np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
  np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), rtol=0,
                             atol=1e-4)


def test_best_of_n_keeps_the_most_likely_sample():
  """With a sampler, the kept candidate has the largest logp of the n that
  the same generator draws (JAX's RNG cannot be matched)."""
  _, _, tmodel, batch, eos = setup()
  n = 4
  fns = t_pf.make_predict_fns(tmodel, max_decode_len=DECODE, eos_token=eos,
                              sampler="temperature(2.0)")
  got_tok, got_lp = fns["decode_with_logp"](
      torch_batch(batch), torch.Generator().manual_seed(7), best_of_n=n)
  rep = {k: v.repeat_interleave(n, 0) for k, v in
         torch_batch(batch).items()}
  all_tok, all_lp = fns["decode_with_logp"](
      rep, torch.Generator().manual_seed(7))
  all_tok, all_lp = all_tok.reshape(2, n, -1), all_lp.reshape(2, n)
  assert len({tuple(t) for t in all_tok[0].tolist()}) > 1  # real choice
  best = all_lp.argmax(-1)
  np.testing.assert_array_equal(got_lp.numpy(), all_lp.max(-1).values)
  for b in range(2):
    np.testing.assert_array_equal(got_tok[b].numpy(), all_tok[b, best[b]])


def test_bench_decode_runs_with_int8_weights_on_cpu(capsys, monkeypatch):
  bench_decode.main(["--device", "cpu", "--quant", "int8", "--img_variant",
                     "mu/16", "--res", "64", "--batch", "2", "--prefill_len",
                     "6", "--decode_len", "8", "--iters", "1"])
  line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert line["quant"] == "int8" and line["device"] == "cpu"
  model = bench_decode.build_model("gemma_test", "mu/16", 64, quant="int8",
                                   device="cpu")
  assert model.llm.model.layers[0].mlp.gating.dtype == torch.int8
  plain = bench_decode.build_model("gemma_test", "mu/16", 64, kernels=False,
                                   like=model)
  assert plain.llm.model.layers[0].mlp.gating_scale.dtype == torch.float32
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(SystemExit, match="no CUDA"):
    bench_decode.main(["--quant", "int8"])

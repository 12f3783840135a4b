"""The port's serving slice as a whole vs the JAX package.

A mu/16 image tower (64px: 16 image tokens, so both take their flash path)
plus `gemma_test` with the fused decode path, batch 2, prompts of
different lengths (so right-alignment matters), 8 greedy tokens through
`make_predict_fns(...)["decode_with_logp"]`. Every param leaf is drawn
from a seed and carried over by utils/convert.py. Tokens must be identical
and log-probabilities within 1e-4 (f32, summed over 8 steps). Also checks
that the port imports nothing of JAX or of the JAX package.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch.models.proj.paligemma import paligemma as t_pg
from big_vision_torch.models.proj.paligemma import predict_fns as t_pf
from big_vision_torch.tools import bench_decode
from big_vision_torch.utils import convert
from big_vision_tpu.models.proj.paligemma import paligemma as j_pg
from big_vision_tpu.models.proj.paligemma import predict_fns as j_pf

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = Path(__file__).resolve().parents[1]
IMG = dict(variant="mu/16", pool_type="none")


@pytest.mark.parametrize("cache_dtype,decode_impl", [
    (None, "flash"), ("bfloat16", "flash"), ("int8", "flash"),
    ("int8", "xla")], ids=["None", "bfloat16", "int8-flash", "int8-xla"])
def test_greedy_decode_matches_jax(cache_dtype, decode_impl):
  llm = dict(variant="gemma_test", cache_dtype=cache_dtype,
             decode_impl=decode_impl)
  rs = np.random.RandomState(0)
  image = rs.randn(2, 64, 64, 3).astype(np.float32)
  text = rs.randint(2, 256, (2, 6)).astype(np.int32)
  mask_input = np.arange(6)[None, :] < np.array([[3], [6]])
  mask_ar = np.zeros((2, 6), np.int32)

  jmodel = j_pg.Model(img=dict(IMG, scan=True), llm=dict(llm, scan=True))
  shapes = jax.eval_shape(
      lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(image),
                          jnp.asarray(text), jnp.asarray(mask_ar)))
  params = jax.tree.map(
      lambda s: (rs.randn(*s.shape) * 0.3).astype(np.float32),
      shapes["params"])
  batch = dict(image=image, text=text, mask_input=mask_input,
               mask_ar=mask_ar)
  want_tok, want_lp = j_pf.make_predict_fns(
      jmodel, max_decode_len=8, eos_token=1)["decode_with_logp"](
          {"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})

  tmodel = t_pg.Model(img=dict(IMG, image_size=64), llm=llm, device="cpu")
  convert.load(tmodel, convert.paligemma(params))
  got_tok, got_lp = t_pf.make_predict_fns(
      tmodel, max_decode_len=8, eos_token=1)["decode_with_logp"](
          {k: torch.from_numpy(v) for k, v in batch.items()})
  np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
  np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), rtol=0,
                             atol=1e-4)


def _modules():
  pkg = ROOT / "big_vision_torch"
  return sorted(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax():
  banned = ("jax", "flax", "big_vision_tpu")
  for path in _modules():
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
      if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
      elif isinstance(node, ast.ImportFrom):
        names = [node.module or ""]
      else:
        continue
      for name in names:
        assert name.split(".")[0] not in banned, (path, name)
  # And at run time: import every module in a fresh interpreter.
  mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
          for p in _modules() if p.name != "chip_smoke.py"]
  code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
          + "; ".join(f"import {m.removesuffix('.__init__')}" for m in mods)
          + "; bad = [m for m in sys.modules if m.split('.')[0] in "
          + f"{banned!r}]; assert not bad, bad")
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  subprocess.run([sys.executable, "-I", "-c", code], check=True, env=env,
                 timeout=120)


def test_logits_fn_matches_jax():
  rs = np.random.RandomState(3)
  image = rs.randn(2, 32, 32, 3).astype(np.float32)
  text = rs.randint(0, 256, (2, 5)).astype(np.int32)
  mask_ar = np.array([[0, 0, 1, 1, 1], [0, 1, 1, 1, 1]], np.int32)
  llm = dict(variant="gemma_test")
  jmodel = j_pg.Model(img=IMG, llm=llm)
  shapes = jax.eval_shape(
      lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(image),
                          jnp.asarray(text), jnp.asarray(mask_ar)))
  params = jax.tree.map(
      lambda s: (rs.randn(*s.shape) * 0.3).astype(np.float32),
      shapes["params"])
  want, _ = jmodel.apply({"params": params}, jnp.asarray(image),
                         jnp.asarray(text), jnp.asarray(mask_ar))
  tmodel = t_pg.Model(img=dict(IMG, image_size=32), llm=llm, device="cpu")
  convert.load(tmodel, convert.paligemma(params))
  got, out = t_pf.make_predict_fns(tmodel)["logits"](
      {"image": torch.from_numpy(image), "text": torch.from_numpy(text),
       "mask_ar": torch.from_numpy(mask_ar)})
  want = np.asarray(want)
  np.testing.assert_allclose(got.numpy(), want, rtol=0,
                             atol=1e-5 * np.abs(want).max())
  assert out["text_tokens"].shape == (2, 5)


def test_samplers():
  logits = torch.tensor([[0.0, 5.0, 1.0, -2.0]])
  gen = torch.Generator().manual_seed(0)
  for spec in ("greedy", "temperature(0.0001)", "nucleus(0.1)", "topk(1)"):
    assert int(t_pf.get_sampler(spec)(logits, gen)[0]) == 1, spec


def test_bench_decode_runs_on_cpu(capsys):
  bench_decode.main(["--device", "cpu", "--img_variant", "mu/16", "--res",
                     "32", "--batch", "2", "--prefill_len", "4",
                     "--decode_len", "4", "--iters", "1"])
  line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert line["device"] == "cpu" and line["e2e_ms_per_batch"] > 0


def test_bench_decode_runs_with_the_int8_cache_on_cpu(capsys):
  bench_decode.main(["--device", "cpu", "--img_variant", "mu/16", "--res",
                     "32", "--batch", "2", "--prefill_len", "4",
                     "--decode_len", "4", "--iters", "1", "--cache_dtype",
                     "int8"])
  line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert line["cache_dtype"] == "int8" and line["e2e_ms_per_batch"] > 0

#!/usr/bin/env python3
"""Drives the PyTorch port (big_vision_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:
  1. builds every CUDA kernel from big_vision_torch/csrc (one nvcc each, in
     parallel);
  2. holds each kernel against its plain PyTorch version in bf16 (K1 also
     in f32, the ViT's default dtype), at the shapes of the serving path
     and at the edge cases (masks, Tq != Tkv, int8 cache, softcap, fully
     masked rows), with the bar max|kernel - plain| / max|plain| <= 1e-2
     (docs/flash_parity.md);
  3. serves PaliGemma-3B (So400m/14 at 224px + gemma_2b, random bf16
     weights from SEED) to a batch of 8 requests through predict_fns,
     checks that the image tower launched K1 once per layer and every AR
     step launched K6 once per layer, and holds the prefill logits and 4
     teacher-forced AR steps against the plain path (math attention,
     einsum decode) on the same card within 2e-2 of max|logit|, the bar
     of tests/test_decode_attention.py;
  4. times prefill, the AR step and each kernel (CUDA events, inputs
     rotated through more than the 50 MB L2) beside its plain version and
     F.scaled_dot_product_attention, which the port never calls.
The line before the last is {"kernels": [...]}: each kernel's max_abs_err
and max_rel_err are at the serving shape, and rel_tolerance is the bar the
relative error was held to. The last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import math
import sys
import time

import torch
import torch.nn.functional as F

from big_vision_torch.tools.kernel_timing import bound
from big_vision_torch.tools.kernel_timing import k1_inputs
from big_vision_torch.tools.kernel_timing import k1_work
from big_vision_torch.tools.kernel_timing import k6_inputs
from big_vision_torch.tools.kernel_timing import k6_work
from big_vision_torch.tools.kernel_timing import nvidia_smi
from big_vision_torch.tools.kernel_timing import time_ms

SEED = 0
BATCH, RES, PROMPT, DECODE = 8, 224, 32, 64
IMG_TOKENS = (RES // 14) ** 2  # So400m/14 at 224px: 256
CACHE = IMG_TOKENS + PROMPT + DECODE  # KV cache slots of the serving run
K1_BAR, K6_BAR, E2E_BAR = 1e-2, 1e-2, 2e-2


def rel_err(got, want):
  got, want = got.float(), want.float()
  return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


# ----------------------------------------------------------------------------
# Phase 2: kernels against their plain versions.
# ----------------------------------------------------------------------------


def check_k1(fa):
  """Returns (max abs, max rel error) at the So400m serving shape."""
  cases = [
      ("So400m/14 B=8", dict(b=8, tq=256, h=16, d=72), {}),
      ("So400m/14 f32", dict(b=8, tq=256, h=16, d=72, dtype=torch.float32),
       {}),
      ("B/16 B=8", dict(b=8, tq=196, h=12, d=64), {}),
      ("D=256 T=288", dict(b=2, tq=288, h=8, d=256), {}),
      ("causal", dict(b=2, tq=200, h=4, d=64), dict(causal=True)),
      ("seg", dict(b=3, tq=150, h=4, d=72), dict(seg=True)),
      ("Tq!=Tkv", dict(b=2, tq=100, h=4, d=64, tkv=300), {}),
      ("Tq!=Tkv causal", dict(b=2, tq=100, h=4, d=128, tkv=300),
       dict(causal=True)),
  ]
  path_err = None
  for i, (name, shape, opts) in enumerate(cases):
    q, k, v = k1_inputs(**shape, seed=i)
    kw = {"causal": opts.get("causal", False)}
    if opts.get("seg"):
      b, t = q.shape[:2]
      seg = torch.zeros((b, t), dtype=torch.int32, device="cuda")
      seg[0] = 1 + (torch.arange(t, device="cuda") >= t // 3).int()
      seg[1, : t - 20] = 1 + torch.arange(t - 20, device="cuda") // 7
      kw["seg"] = seg  # row 2 stays all zero: its output must be exact 0
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    print(f"K1 {name:16s} {tuple(q.shape)} kv {tuple(k.shape)} "
          f"rel err {err:.3e} (bar {K1_BAR})")
    assert math.isfinite(err) and err <= K1_BAR, (name, err)
    if opts.get("seg"):
      assert got[2].abs().max().item() == 0.0, "all-zero seg row not zero"
    if i == 0:
      path_err = (got.float() - want.float()).abs().max().item(), err
  return path_err


def check_k6(da):
  """Returns (max abs, max rel error) at the gemma_2b serving shape."""
  cases = [
      ("gemma_2b B=8", dict(b=8, kh=1, g=8, s=CACHE, h=256), {}),
      ("K=4 G=2", dict(b=4, kh=4, g=2, s=300, h=128), {}),
      ("K=2 G=3", dict(b=3, kh=2, g=3, s=129, h=64), {}),
      ("K=2 G=3 f32", dict(b=3, kh=2, g=3, s=129, h=64, cache="f32"), {}),
      ("int8", dict(b=8, kh=1, g=8, s=CACHE, h=256, cache="int8"), {}),
      ("int8 softcap", dict(b=4, kh=4, g=2, s=200, h=128, cache="int8"),
       dict(logits_softcap=0.5)),
      ("masked row", dict(b=3, kh=1, g=8, s=96, h=256, masked_row=True), {}),
  ]
  path_err = None
  for i, (name, shape, opts) in enumerate(cases):
    q, k, v, mask, scales = k6_inputs(**shape, seed=i)
    got = da.decode_attention(q, k, v, mask, **scales, **opts)
    want = da.decode_attention_reference(q, k, v, mask, **scales, **opts)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    print(f"K6 {name:16s} q {tuple(q.shape)} cache {tuple(k.shape)} "
          f"{k.dtype} rel err {err:.3e} (bar {K6_BAR})")
    assert math.isfinite(err) and err <= K6_BAR, (name, err)
    if shape.get("masked_row"):
      assert got[-1].abs().max().item() == 0.0, "masked row not zero"
    if i == 0:
      path_err = (got.float() - want.float()).abs().max().item(), err
  return path_err


# ----------------------------------------------------------------------------
# Phase 3: serving.
# ----------------------------------------------------------------------------


def serve(model, plain, batch, fa, da):
  """The main path with its launch counts, then kernel vs plain path."""
  from big_vision_torch.models.proj.paligemma import predict_fns
  fns = predict_fns.make_predict_fns(model, max_decode_len=DECODE,
                                     eos_token=-1)
  fa.flash_attention.launches = da.decode_attention.launches = 0
  tokens, logp = fns["decode_with_logp"](batch)
  torch.cuda.synchronize()
  counts = {"K1": fa.flash_attention.launches,
            "K6": da.decode_attention.launches}
  depth_img = len(model.img.encoder.blocks)
  depth_llm = len(model.llm.model.layers)
  print(f"serving: {BATCH} requests, {DECODE} greedy tokens; launches "
        f"K1 {counts['K1']} (want {depth_img}), K6 {counts['K6']} "
        f"(want {depth_llm} x {DECODE})")
  assert counts["K1"] == depth_img, counts
  assert counts["K6"] == depth_llm * DECODE, counts
  assert tokens.shape == (BATCH, DECODE) and torch.isfinite(logp).all()

  # Kernel path vs plain path on the same card: prefill logits, then 4 AR
  # steps teacher-forced with the kernel path's tokens.
  errs, agree = [], []
  with torch.inference_mode():
    states = []
    for m in (model, plain):
      mask_input, mask_ar = batch["mask_input"], batch["mask_ar"]
      (x, full_mask, full_ar), _ = m.embed_image_and_text(
          batch["image"], batch["text"], input_mask=mask_input,
          mask_ar=mask_ar)
      states.append(m.prefill_cache(x, full_mask, full_ar,
                                    cache_size=x.shape[1] + 8))
    for step in range(5):
      (lk, ck), (lp, cp) = states
      errs.append(rel_err(lk, lp))
      agree.append((lk.argmax(-1) == lp.argmax(-1)).float().mean().item())
      if step == 4:
        break
      tok = tokens[:, step:step + 1]
      states = [m.extend_cache(m.embed_text(tok)[0], c)
                for m, c in ((model, ck), (plain, cp))]
  for i, (e, a) in enumerate(zip(errs, agree)):
    what = "prefill" if i == 0 else f"AR step {i}"
    print(f"kernel vs plain path, {what}: logits rel err {e:.3e} "
          f"(bar {E2E_BAR}), greedy agreement {a:.3f}")
    assert math.isfinite(e) and e <= E2E_BAR, (what, e)
  plain_tokens = predict_fns.make_predict_fns(
      plain, max_decode_len=DECODE, eos_token=-1)["decode"](batch)
  print(f"greedy tokens equal to the plain path's: "
        f"{(plain_tokens == tokens).float().mean().item():.3f}")
  return counts


def main():
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    return 1
  from big_vision_torch.ops import _build
  from big_vision_torch.ops import decode_attention as da
  from big_vision_torch.ops import flash_attention as fa
  from big_vision_torch.tools import bench_decode

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  gpu = nvidia_smi()
  print(f"gpu: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")

  # 1. Build.
  t0 = time.perf_counter()
  logs = _build.build_all(["flash_fwd", "decode_attention"])
  print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
  for name, log in logs.items():
    for line in log.splitlines():
      if "Used" in line or "spill" in line:
        print(f"  {name}: {line.strip()}")

  # 2. Kernels vs plain versions.
  (k1_abs, k1_rel), (k6_abs, k6_rel) = check_k1(fa), check_k6(da)

  # 3. Serving PaliGemma-3B.
  t0 = time.perf_counter()
  model = bench_decode.build_model("gemma_2b", "So400m/14", RES, seed=SEED)
  plain = bench_decode.build_model("gemma_2b", "So400m/14", RES,
                                   kernels=False)
  plain.load_state_dict(model.state_dict(), assign=True)
  n_params = sum(p.numel() for p in model.parameters())
  batch = bench_decode.make_batch(BATCH, RES, PROMPT, 256_000, "cuda", SEED)
  print(f"PaliGemma-3B: {n_params / 1e9:.3f} B params (bf16), built in "
        f"{time.perf_counter() - t0:.1f} s")
  counts = serve(model, plain, batch, fa, da)

  # 4. Times.
  r = bench_decode.measure(model, batch, DECODE, 3, "cuda")
  rp = bench_decode.measure(plain, batch, DECODE, 3, "cuda")
  for name, x in (("kernel path", r), ("plain path", rp)):
    print(f"[{gpu}] serving {name} B={BATCH} prompt {PROMPT} decode "
          f"{DECODE}: prefill {x['prefill_s'] * 1e3:.3f} ms, AR step "
          f"{x['step_s'] * 1e3:.3f} ms, {BATCH / x['step_s']:.1f} tok/s, "
          f"e2e {x['t_full'] * 1e3:.3f} ms")
  bench_decode.print_profile(bench_decode.profile(model, batch, DECODE),
                             prefix=f"[{gpu}] kernel path, ")

  kernels = []
  # K1 at the tower's shape; 4 input sets (75 MB) exceed the L2.
  b, t, h, d = BATCH, IMG_TOKENS, 16, 72
  sets = [k1_inputs(b, t, h, d, seed=10 + i) for i in range(4)]
  sdpa_sets = [tuple(x.transpose(1, 2).contiguous() for x in s) for s in sets]
  ms = time_ms(fa.flash_attention, sets)
  plain_ms = time_ms(fa.flash_attention_reference, sets, iters=10)
  lib_ms = time_ms(F.scaled_dot_product_attention, sdpa_sets)
  bms, by = bound(*k1_work(b, t, h, d))
  kernels.append(dict(
      name="flash_fwd", route="cuda",
      source="big_vision_torch/csrc/flash_fwd.cu",
      replaces="big_vision_tpu/ops/flash_attention.py:306",
      launches=counts["K1"], max_abs_err=k1_abs, max_rel_err=k1_rel,
      rel_tolerance=K1_BAR, ms=ms, plain_ms=plain_ms, bound_ms=bms,
      bound_by=by, library_ms=lib_ms))
  # K6 at gemma_2b's AR shape over the serving run's cache.
  b, kh, g, s, hd = BATCH, 1, 8, CACHE, 256
  sets = [k6_inputs(b, kh, g, s, hd, seed=20 + i)[:4] for i in range(24)]
  sdpa_sets = [(q.reshape(b, kh * g, 1, hd).to(torch.bfloat16),
                k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
                m[:, None, None, :]) for q, k, v, m in sets]
  ms = time_ms(da.decode_attention, sets)
  plain_ms = time_ms(da.decode_attention_reference, sets, iters=10)
  lib_ms = time_ms(lambda q, k, v, m: F.scaled_dot_product_attention(
      q, k, v, attn_mask=m, scale=1.0), sdpa_sets)
  bms, by = bound(*k6_work(b, kh, g, s, hd))
  kernels.append(dict(
      name="decode_attention", route="cuda",
      source="big_vision_torch/csrc/decode_attention.cu",
      replaces="big_vision_tpu/ops/decode_attention.py:113",
      launches=counts["K6"], max_abs_err=k6_abs, max_rel_err=k6_rel,
      rel_tolerance=K6_BAR, ms=ms, plain_ms=plain_ms, bound_ms=bms,
      bound_by=by, library_ms=lib_ms))
  for kern in kernels:
    print(f"[{gpu}] {kern['name']}: {kern['ms']:.4f} ms (bound "
          f"{kern['bound_ms']:.4f} ms by {kern['bound_by']}), plain "
          f"{kern['plain_ms']:.4f} ms, SDPA {kern['library_ms']:.4f} ms, "
          f"{kern['launches']} launches per request batch")

  print(nvidia_smi())  # the card's name and power limit, as nvidia-smi reads
  print(json.dumps({"kernels": kernels}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())

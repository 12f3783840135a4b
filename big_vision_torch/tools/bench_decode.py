"""Serving benchmark: PaliGemma prefill + greedy decode throughput (port).

Twin of big_vision_tpu/tools/bench_decode.py for the PyTorch port. Builds
PaliGemma from an image-tower and an LLM variant with random bf16 weights
from `--seed` (the image tower computes in bf16, the LLM in f32 as in the
JAX package), runs `predict_fns` decode with the port's kernels (K1 in the
image tower, K6 at every AR step), and prints one JSON line:
  prefill_ms          - embed image + prompt and fill the KV cache
  value               - generated tokens/s across the batch (steady AR)
  ar_step_ms          - one AR step: (e2e - prefill) / decode_len
  e2e_ms_per_batch    - prefill + full decode, per batch
Prefill and the whole decode are timed directly (CUDA events on the GPU);
eager PyTorch can time the prefill alone, where the JAX bench fitted
t(L) = prefill + L*step over two decode lengths. `profile` reads the
device time by kernel name (torch.profiler; chip_smoke.py prints it).

Usage:
  python -m big_vision_torch.tools.bench_decode                # tiny models
  python -m big_vision_torch.tools.bench_decode --variant gemma_2b \
      --img_variant So400m/14 --res 224 --batch 8 --decode_len 64 \
      [--cache_dtype int8] [--quant int8] [--profile]

`--quant int8` serves the LLM with int8 weights: the random weights are
quantized with `gemma.quantize_params`, as the JAX bench does. The JAX
bench's `--scan` is not ported: the port's model has one layer layout.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from big_vision_torch.models import common
from big_vision_torch.models.ppp import gemma
from big_vision_torch.models.proj.paligemma import paligemma
from big_vision_torch.models.proj.paligemma import predict_fns
from big_vision_torch.tools import kernel_timing
from big_vision_torch.utils import convert


def build_model(variant, img_variant, res, *, cache_dtype="bfloat16",
                quant=None, kernels=True, device="cuda", seed=0,
                like=None):
  """PaliGemma with random bf16 weights from `seed`, or with the weights of
  the model `like` (shared, not copied).

  kernels=True is the serving path: the tower's attention "auto" (K1) and
  the LLM's decode_impl="flash" (K6). kernels=False is the plain path
  (math attention, einsum decode). quant="int8" quantizes the LLM's random
  weights (`gemma.quantize_params`) into a `quant=True` LLM; with `like`,
  `like` sets it.
  """
  def make(quant_llm, on):
    return paligemma.Model(
        img=dict(variant=img_variant, pool_type="none", dtype_mm="bfloat16",
                 image_size=res, attn_impl="auto" if kernels else "xla"),
        llm=dict(variant=variant, cache_dtype=cache_dtype, quant=quant_llm,
                 decode_impl="flash" if kernels else "xla"),
        device=on, param_dtype=torch.bfloat16)

  if like is not None:
    quant_llm = like.llm.model.embedder.quant
    model = make(quant_llm, "meta")
    model.load_state_dict(like.state_dict(), assign=True)
    return model.eval()
  model = common.init_random_(make(False, device), seed)
  if quant == "int8":
    state = convert.gemma(gemma.quantize_params(
        convert.gemma_params(model.llm.model)))
    qmodel = make(True, "meta")
    qmodel.img.load_state_dict(model.img.state_dict(), assign=True)
    convert.load(qmodel.llm.model, state, device=device)
    model = qmodel
  elif quant is not None:
    raise ValueError(f"Unknown quant {quant!r}")
  return model.eval()


def make_batch(batch, res, prefill_len, vocab, device, seed=0):
  """Random images in [-1, 1] and prompts whose lengths differ a little."""
  gen = torch.Generator(device="cpu").manual_seed(seed)
  image = torch.rand((batch, res, res, 3), generator=gen) * 2 - 1
  text = torch.randint(2, vocab, (batch, prefill_len), generator=gen)
  lengths = prefill_len - 2 * (torch.arange(batch) % 3)
  mask = torch.arange(prefill_len)[None, :] < lengths[:, None]
  return {"image": image.to(device), "text": text.to(device),
          "mask_input": mask.to(device),
          "mask_ar": torch.zeros_like(text).to(device)}


class Timer:
  """Wall time of a region; on a GPU, CUDA events around it."""

  def __init__(self, device):
    self.cuda = torch.device(device).type == "cuda"

  def __call__(self, fn, iters):
    if self.cuda:
      torch.cuda.synchronize()
      start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
      start.record()
      for _ in range(iters):
        fn()
      end.record()
      end.synchronize()
      return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
      fn()
    return (time.perf_counter() - t0) / iters


def _prefill_fn(model, batch, decode_len):
  input_mask, mask_ar = predict_fns.default_masks(batch)

  @torch.inference_mode()
  def prefill():
    (x, m, ar), _ = model.embed_image_and_text(
        batch["image"], batch["text"], input_mask=input_mask,
        mask_ar=mask_ar)
    return model.prefill_cache(x, m, ar,
                               cache_size=x.shape[1] + decode_len)
  return prefill


def _decode_fn(model, batch, decode_len):
  fns = predict_fns.make_predict_fns(model, max_decode_len=decode_len,
                                     eos_token=-1)  # unreachable: full length
  return lambda: fns["decode"](batch)


def measure(model, batch, decode_len, iters, device):
  """Times prefill alone and the whole decode; the AR step is the rest."""
  timer = Timer(device)
  decode = _decode_fn(model, batch, decode_len)
  decode()  # warm up
  t_full = timer(decode, iters)
  prefill_s = timer(_prefill_fn(model, batch, decode_len), iters)
  return dict(t_full=t_full, prefill_s=prefill_s,
              step_s=(t_full - prefill_s) / decode_len)


def profile(model, batch, decode_len, top=10):
  """Device time by kernel name for the prefill alone and for a decode.

  Returns {"prefill": ..., "decode": ...}, each (rows [(name, total_ms,
  count)] of the `top` kernels and of K6's, device busy ms, wall ms), both
  under the profiler.
  """
  return kernel_timing.device_profile(
      {"prefill": _prefill_fn(model, batch, decode_len),
       "decode": _decode_fn(model, batch, decode_len)}, top=top,
      keep=("decode",))


def print_profile(prof, prefix=""):
  for name, (rows, busy_ms, wall_ms) in prof.items():
    print(f"{prefix}profiled {name}: device busy {busy_ms:.3f} of "
          f"{wall_ms:.3f} ms wall; top kernels by device time:")
    for kernel, ms, n in rows:
      print(f"  {ms:10.3f} ms {n:6d}x  {kernel[:90]}")


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--variant", default="gemma_test",
                 help="llm variant (gemma_test, gemma_2b, gemma2_2b, ...)")
  p.add_argument("--img_variant", default="S/16")
  p.add_argument("--res", type=int, default=224)
  p.add_argument("--batch", type=int, default=8)
  p.add_argument("--prefill_len", type=int, default=32,
                 help="prompt tokens after the image prefix")
  p.add_argument("--decode_len", type=int, default=64)
  p.add_argument("--iters", type=int, default=5)
  p.add_argument("--quant", choices=["int8"], default=None,
                 help="int8 weights (+ per-channel scales) for the LLM")
  p.add_argument("--cache_dtype", default="bfloat16",
                 choices=["bfloat16", "float32", "int8"])
  p.add_argument("--profile", action="store_true",
                 help="also print the device time by kernel (GPU only)")
  p.add_argument("--device", default="cuda")
  p.add_argument("--seed", type=int, default=0)
  args = p.parse_args(argv)
  on_gpu = torch.device(args.device).type == "cuda"
  if on_gpu and not torch.cuda.is_available():
    raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")

  t0 = time.perf_counter()
  model = build_model(args.variant, args.img_variant, args.res,
                      cache_dtype=args.cache_dtype, quant=args.quant,
                      device=args.device, seed=args.seed)
  vocab = model.llm.model.embedder.input_embedding.shape[0]
  batch = make_batch(args.batch, args.res, args.prefill_len, vocab,
                     args.device, args.seed)
  init_s = time.perf_counter() - t0
  n_params = sum(p.numel() for p in model.parameters())
  param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())

  r = measure(model, batch, args.decode_len, args.iters, args.device)
  if args.profile and on_gpu:
    print_profile(profile(model, batch, args.decode_len),
                  prefix=f"[{torch.cuda.get_device_name()}] ")
  step_s = r["step_s"]
  tok_rate = args.batch / step_s if step_s > 0 else None
  device = (torch.cuda.get_device_name(torch.device(args.device))
            if on_gpu else "cpu")
  print(json.dumps({
      "metric": "paligemma_decode_tok_per_sec",
      "value": tok_rate,
      "unit": "tok/s (batch-aggregate, steady AR)",
      "per_example_tok_per_sec": tok_rate / args.batch if tok_rate else None,
      "prefill_ms": r["prefill_s"] * 1e3,
      "ar_step_ms": step_s * 1e3,
      "e2e_ms_per_batch": r["t_full"] * 1e3,
      "llm_variant": args.variant,
      "cache_dtype": args.cache_dtype,
      "quant": args.quant,
      "img_variant": args.img_variant,
      "res": args.res,
      "batch": args.batch,
      "prefill_len": args.prefill_len,
      "decode_len": args.decode_len,
      "n_params": n_params,
      "implied_weight_stream_gbps": (param_bytes / 1e9 / step_s
                                     if step_s > 0 else None),
      "init_s": init_s,
      "device": device,
  }))


if __name__ == "__main__":
  main()

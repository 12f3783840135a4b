"""Times the port's CUDA attention kernels on the GPU.

K1 is two kernels: bf16 inputs take the tensor-core kernel
(csrc/flash_fwd_tc.cu), f32 inputs the 3xTF32 one (csrc/flash_fwd.cu).
For K1's bf16 kernel and K6, for each shape, it prints the time per call
measured two ways:
  events - CUDA events around 50 calls through the Python wrapper, inputs
           rotated through more than the 50 MB L2 (what a caller sees,
           host launch cost included when it exceeds the kernel's);
  graph  - the same calls captured in a CUDA graph and replayed (device
           time only);
beside the least time the card could take (bytes over 3.35 TB/s, or bf16
operations over 989 TFLOP/s on the tensor cores, the H100 SXM data sheet)
and the SM clock that nvidia-smi reads right after the timing.

K2's f32 kernel (csrc/flash_bwd.cu) at FlexiViT-B's seqhw 15 and 24 and K5
(csrc/flash_blocked_bwd_fused.cu) at seqhw 40 and 30 (B=32, H=12, D=64,
f32), both on 3xTF32 products, are timed with CUDA events at a few key
tiles per block, in turns (each setting once in order, then once in
reverse), beside the default setting (`key_tiles_per_block`), the plain
version, SDPA's autograd backward on the same f32 inputs and the bound at
the 3xTF32 rate; K5 also beside K4a + K4b. Then K4a and K4b
(csrc/flash_blocked_bwd.cu, 3xTF32 products too) at seqhw 40 and 30, each
in turns with the other, and K4a + K4b and K5, beside their plain
versions, SDPA's backward and their bounds (`time_blocked_bwd`). Then the
two f32 forwards on the same 3xTF32 products (csrc/flash_tf32_fwd.cuh):
K1's f32 kernel at seqhw 15 and 24 and K3 (csrc/flash_blocked_fwd.cu) at
seqhw 40 and 30, beside their plain versions, SDPA's forward on the same
f32 inputs and their bounds (`time_fwd`).

With `--k6` it times K6 alone (`time_k6`) at the shapes of `K6_SHAPES`:
CUDA events, a CUDA graph, the kernels' device time under torch.profiler
and the wrapper's host time per call, beside the plain version, SDPA and
the bound; then its design variants there (`k6_variants`).

Usage (GPU only):  python -m big_vision_torch.tools.kernel_timing [--k6]

Its helpers (inputs at given shapes, the timers, the bound) are also used
by chip_smoke.py.
"""

from __future__ import annotations

import math
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from big_vision_torch.models.ppp.gemma import _quant_kv

# H100 SXM data sheet: memory rate, dense bf16 tensor-core rate, and the f32
# rate outside the tensor cores (the blocked kernels' f32 semantics).
HBM_BYTES_PER_S, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
# f32 products on the tensor cores as three TF32 products (hi.hi + hi.lo +
# lo.hi): the dense TF32 rate, 495 TFLOP/s, over three.
TF32X3_FLOPS = 495e12 / 3


def nvidia_smi(query="name,power.limit"):
  """First line of `nvidia-smi --query-gpu=<query>` (the card's values)."""
  out = subprocess.run(
      ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
      check=True, capture_output=True, text=True, timeout=60).stdout
  return out.strip().splitlines()[0]


def bound(nbytes, flops, flops_per_s=BF16_FLOPS):
  """(least ms for the work, "bytes" or "operations"), the operations at
  `flops_per_s` (the peak rate for the inputs' type)."""
  t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
  return (max(t_bytes, t_ops) * 1e3,
          "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, arg_sets, iters=50):
  """Mean ms per call between CUDA events, cycling through arg_sets."""
  for args in arg_sets:
    fn(*args)
  torch.cuda.synchronize()
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  for i in range(iters):
    fn(*arg_sets[i % len(arg_sets)])
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / iters


def graph_ms(fn, arg_sets, iters=50):
  """Mean device ms per call: the calls captured in a CUDA graph."""
  for args in arg_sets:
    fn(*args)
  torch.cuda.synchronize()
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for i in range(iters):
      fn(*arg_sets[i % len(arg_sets)])
  graph.replay()
  torch.cuda.synchronize()
  return time_ms(graph.replay, [()], iters=5) / iters


def device_profile(named_fns, top=10, keep=(), warm=True):
  """Device time by kernel name of one call of each fn, under torch.profiler.

  `named_fns` is {name: fn}; each fn is called once to warm (unless not
  `warm`: a fn that has run already), then once profiled. Returns {name: (rows [(kernel, total ms, count)] of the `top`
  kernels and of any other kernel whose name holds a string of `keep`,
  device busy ms, wall ms)}. Only the card's activity is traced: nothing
  here reads the host's operators, and tracing them too made the profiles
  most of the time of chip_smoke.py's serving with bf16 weights.
  """
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile as torch_profile
  out = {}
  for name, fn in named_fns.items():
    if warm:
      fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
      t0 = time.perf_counter()
      fn()
      torch.cuda.synchronize()
      wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for evt in prof.events():
      if evt.device_type == torch.autograd.DeviceType.CUDA:
        ms, n = by_name.get(evt.name, (0.0, 0))
        by_name[evt.name] = (ms + evt.time_range.elapsed_us() / 1e3, n + 1)
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()),
                  key=lambda r: -r[1])
    kept = rows[:top] + [r for r in rows[top:]
                         if any(k in r[0] for k in keep)]
    out[name] = (kept, sum(ms for _, ms, _ in rows), wall_ms)
  return out


def sdpa_layout(sets, dtype=None):
  """Each tuple of `sets` in the port's [B, T, H, D] layout as SDPA takes
  it: [B, H, T, D], contiguous, cast to `dtype` if given."""
  return [tuple(x.transpose(1, 2).to(dtype or x.dtype).contiguous()
                for x in s) for s in sets]


def sdpa_fwd_ms(sets, dtype=None):
  """ms of SDPA's forward on the (q, k, v, ...) of `sets`."""
  return time_ms(F.scaled_dot_product_attention,
                 [s[:3] for s in sdpa_layout(sets, dtype)])


def sdpa_bwd_ms(sets, dtype=None):
  """ms of SDPA's autograd backward (dq, dk and dv together) alone on the
  (q, k, v, do) of `sets`: its forward is recorded once per set, outside
  the timing."""
  graphs = []
  for q, k, v, do in sdpa_layout(sets, dtype):
    ins = [x.requires_grad_() for x in (q, k, v)]
    graphs.append((F.scaled_dot_product_attention(*ins), ins, do))
  return time_ms(lambda out, ins, do: torch.autograd.grad(
      out, ins, do, retain_graph=True), graphs)


def k1_inputs(b, tq, h, d, tkv=None, seed=0, dtype=torch.bfloat16):
  """q [b, tq, h, d] and k, v [b, tkv, h, d] in `dtype` on the GPU."""
  g = torch.Generator(device="cuda").manual_seed(seed)
  mk = lambda t: torch.randn((b, t, h, d), generator=g, device="cuda").to(
      dtype)
  return mk(tq), mk(tkv or tq), mk(tkv or tq)


def k1_work(b, tq, h, d, tkv=None, itemsize=2):
  """(bytes, flops) of one K1 call: q, k, v read and o written once in
  `itemsize`-byte elements."""
  tkv = tkv or tq
  return (itemsize * (2 * b * tq * h * d + 2 * b * tkv * h * d),
          4 * b * h * tq * tkv * d)


def k2_work(b, tq, h, d, tkv=None, itemsize=2):
  """(bytes, flops) of one K2 call: q, k, v, do read and dq, dk, dv written
  once in `itemsize`-byte elements; five products of 2*Tq*Tkv*D each."""
  tkv = tkv or tq
  return itemsize * (3 * b * tq * h * d + 4 * b * tkv * h * d), \
      10 * b * h * tq * tkv * d


def k3_work(b, t, h, d, itemsize=4):
  """(bytes, flops) of one K3 call: q, k, v read and o written once in the
  inputs' dtype, the f32 LSE written; two products of 2*T^2*D each."""
  return 4 * b * t * h * d * itemsize + 4 * b * h * t, 4 * b * h * t * t * d


def k4a_work(b, t, h, d, itemsize=4):
  """(bytes, flops) of one K4a call: q, k, v, do, LSE and delta read and dq
  written once; three products (s, dp, ds.k)."""
  return 5 * b * t * h * d * itemsize + 8 * b * h * t, 6 * b * h * t * t * d


def k4b_work(b, t, h, d, itemsize=4):
  """(bytes, flops) of one K4b call: q, k, v, do, LSE and delta read and dk,
  dv written once; four products (s, dp, p^T.do, ds^T.q)."""
  return 6 * b * t * h * d * itemsize + 8 * b * h * t, 8 * b * h * t * t * d


def k5_work(b, t, h, d, itemsize=4):
  """(bytes, flops) of one K5 call: q, k, v, do, LSE and delta read and dq,
  dk, dv written once; five products (s, dp, p^T.do, ds^T.q, ds.k)."""
  return 7 * b * t * h * d * itemsize + 8 * b * h * t, 10 * b * h * t * t * d


def blocked_inputs(b, t, h, d, tkv=None, seed=0, dtype=torch.float32):
  """(q, k, v, do): `k1_inputs` in `dtype` (default f32, the FlexiViT
  path's) and an output gradient do shaped like q."""
  q, k, v = k1_inputs(b, t, h, d, tkv=tkv, seed=seed, dtype=dtype)
  g = torch.Generator(device="cuda").manual_seed(seed + 1)
  return q, k, v, torch.randn(q.shape, generator=g, device="cuda").to(dtype)


def k6_inputs(b, kh, g, s, h, cache="bf16", masked_row=False, seed=0,
              spans=None, q_dtype=torch.float32):
  """(q, k, v, mask, scale kwargs): q pre-scaled in `q_dtype`, the cache
  stored as `cache` (int8 through the model's `_quant_kv`); example i sees
  the slots [lo_i, hi_i) of `spans`, by default [0, S - 5 i)."""
  gen = torch.Generator(device="cuda").manual_seed(seed)
  rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
  q = (rnd(b, kh, g, h) / math.sqrt(h)).to(q_dtype)  # arrives pre-scaled
  kf, vf = rnd(b, kh, s, h), rnd(b, kh, s, h)
  spans = spans or [(0, s - 5 * i) for i in range(b)]
  lo, hi = (torch.tensor(x, device="cuda")[:, None] for x in zip(*spans))
  slots = torch.arange(s, device="cuda")[None, :]
  mask = (slots >= lo) & (slots < hi)
  if masked_row:
    mask[-1] = False
  if cache == "int8":
    (k, ks), (v, vs) = _quant_kv(kf), _quant_kv(vf)
    return q, k, v, mask, dict(k_scale=ks, v_scale=vs)
  dtype = torch.bfloat16 if cache == "bf16" else torch.float32
  return q, kf.to(dtype), vf.to(dtype), mask, {}


CACHE_BYTES = {"int8": 1, "bf16": 2, "f32": 4}


def k6_work(b, kh, g, s, h, cache="bf16"):
  """(bytes, flops) of one K6 call with f32 q: q read and o written once,
  the cache's k and v (and, for an int8 cache, their f32 per-slot scales)
  and the [B, S] mask read once."""
  scales = 2 * b * kh * s * 4 if cache == "int8" else 0
  return (b * kh * g * h * 4 * 2 + 2 * b * kh * s * h * CACHE_BYTES[cache]
          + scales + b * s), 4 * b * kh * g * s * h


def host_us(fn, arg_sets, calls=1000):
  """Host us per call: a host clock around `calls` calls with no
  synchronise inside (what the caller's thread spends; the device may
  still be running when the clock stops)."""
  for args in arg_sets:
    fn(*args)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for i in range(calls):
    fn(*arg_sets[i % len(arg_sets)])
  host = (time.perf_counter() - t0) / calls * 1e6
  torch.cuda.synchronize()
  return host


def k6_sets(b, s, cache, g=8, h=256, seed=300):
  """K6 input sets at one KV head: enough of them to pass 100 MB (past the
  L2)."""
  per_set = k6_work(b, 1, g, s, h, cache)[0]
  return [k6_inputs(b, 1, g, s, h, cache=cache, seed=seed + i)
          for i in range(max(2, math.ceil(100e6 / per_set)))]


def time_k6(da, card, b, s, cache="bf16", g=8, h=256, seed=300):
  """Times K6 at one KV head, G query rows of head dim H (gemma_2b's
  shape), over a cache of B x S slots stored as `cache`, with enough
  input sets to pass 100 MB (past the L2): CUDA events around 50 calls of
  the wrapper, the same calls in a CUDA graph, the kernels' device time per
  call under torch.profiler, the wrapper's host time per call, the plain
  version, SDPA on the same bf16 inputs (none for int8: no PyTorch call
  takes an int8 cache) and the bound. Prints one line; returns the
  numbers."""
  sets = k6_sets(b, s, cache, g, h, seed)
  fn = lambda q, k, v, m, sc: da.decode_attention(q, k, v, m, **sc)
  out = dict(ms=time_ms(fn, sets), graph_ms=graph_ms(fn, sets))
  # At least 24 calls: with two, chip_smoke once got no kernel rows back.
  calls = max(len(sets), 24)
  rows, _, _ = device_profile(
      {"K6": lambda: [fn(*sets[i % len(sets)]) for i in range(calls)]},
      top=4, keep=("decode",))["K6"]
  by_kernel = {}
  for n, ms, _ in rows:
    if "decode" in n:
      name = n[n.index("decode"):].split("<")[0].split("(")[0]
      by_kernel[name] = by_kernel.get(name, 0.0) + ms / calls
  out["profiled_ms"] = sum(by_kernel.values())
  out["kernels"] = [f"{n} {ms:.4f}" for n, ms in sorted(by_kernel.items())]
  out["host_us"] = host_us(fn, sets)
  out["plain_ms"] = time_ms(
      lambda q, k, v, m, sc: da.decode_attention_reference(q, k, v, m, **sc),
      sets, iters=10)
  out["library_ms"] = None
  if cache == "bf16":
    sdpa_sets = [(q.reshape(b, g, 1, h).to(torch.bfloat16),
                  k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
                  m[:, None, None, :]) for q, k, v, m, _ in sets]
    out["library_ms"] = time_ms(
        lambda q, k, v, m: F.scaled_dot_product_attention(
            q, k, v, attn_mask=m, scale=1.0), sdpa_sets)
    del sdpa_sets
  out["bound_ms"], out["bound_by"] = bound(*k6_work(b, 1, g, s, h, cache))
  lib = ("none" if out["library_ms"] is None
         else f"{out['library_ms']:.4f} ms")
  print(f"[{card}] K6 decode_attention B={b} K=1 G={g} S={s} H={h} {cache} "
        f"cache ({len(sets)} sets): events {out['ms']:.4f} ms, graph "
        f"{out['graph_ms']:.4f} ms, profiled {out['profiled_ms']:.4f} ms a "
        f"call ({', '.join(out['kernels'])}), host {out['host_us']:.2f} us a "
        f"call (1000 calls, no synchronise); plain {out['plain_ms']:.4f} ms, "
        f"SDPA {lib}; bound {out['bound_ms']:.4f} ms ({out['bound_by']}); "
        f"SM clock {nvidia_smi('clocks.sm')}", flush=True)
  del sets
  torch.cuda.empty_cache()
  return out


def k6_variants(da, card, b, s, cache="bf16", g=8, h=256):
  """K6 at one KV head of B x S slots on other grids than `plan`'s: one
  split per tile of 16, 32 or 64 slots, in turns with the planned grid
  (first and last): CUDA events, CUDA graph, host us a call."""
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  planned = da.plan(b, s, sms)
  grids = {f"as planned {planned}": planned}
  for tile in (16, 32, 64):
    grid = (tile, tile, -(-s // tile))
    if grid[2] <= da.MAX_SPLITS and grid != planned:
      grids[f"tiles of {tile}"] = grid
  sets = k6_sets(b, s, cache, g, h)
  for name in list(grids) + [next(iter(grids))]:
    fn = lambda q, k, v, m, sc, grid=grids[name]: da._launch(
        q, k, v, m, sc.get("k_scale"), sc.get("v_scale"), 0.0, grid)
    print(f"[{card}] K6 variant B={b} S={s} {cache}, {name}: events "
          f"{time_ms(fn, sets):.4f} ms, graph {graph_ms(fn, sets):.4f} ms, "
          f"host {host_us(fn, sets):.2f} us", flush=True)
  del sets
  torch.cuda.empty_cache()


def k6_host_parts(da, card, b=8, s=352, calls=2000):
  """Host us a call of the parts of K6's wrapper at the serving shape (a
  host clock around `calls` calls each, no synchronise inside)."""
  from big_vision_torch.ops import _build
  q, k, v, m, _ = k6_inputs(b, 1, 8, s, 256)
  grid = da.plan(b, s, torch.cuda.get_device_properties(0).multi_processor_count)
  n = da.scratch_floats(b, 8, 256, grid[2])
  out, scratch = torch.empty_like(q), torch.empty(n, device=q.device)
  args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, m.data_ptr(),
          out.data_ptr(), scratch.data_ptr(), 0, 1, b, 1, 8, s, 256, 0.0,
          *grid, _build.stream_ptr(q.device)]
  refused = list(args)
  refused[12] = 0  # G = 0: the C entry returns before any CUDA call
  entry = da._lib()
  parts = {
      "input checks": lambda: da._check_inputs(q, k, v, m, None, None),
      "torch.empty_like(q)": lambda: torch.empty_like(q),
      "torch.empty(scratch)": lambda: torch.empty(n, device=q.device),
      "_build.stream_ptr": lambda: _build.stream_ptr(q.device),
      "torch._C._cuda_getCurrentRawStream": (
          lambda: torch._C._cuda_getCurrentRawStream(q.device.index)),
      "plan": lambda: da.plan(b, s, 132),
      "C entry, refused": lambda: entry(*refused),
      "C entry, two launches": lambda: entry(*args),
      "_launch": lambda: da._launch(q, k, v, m, None, None, 0.0, grid),
      "decode_attention": lambda: da.decode_attention(q, k, v, m),
  }
  out = {}
  for name, fn in parts.items():
    out[name] = host_us(lambda: fn(), [()], calls=calls)
  print(f"[{card}] K6 wrapper host us a call: " + ", ".join(
      f"{name} {us:.2f}" for name, us in out.items()), flush=True)
  return out


# K6's timed shapes: (B, S, cache). The serving shape (PaliGemma-3B at 224px,
# batch 8: 256 image + 32 prompt + 64 decoded slots), and a bandwidth-sized
# one: PaliGemma at 448px (1024 image tokens) + 32 + 64 slots for 64
# requests, a 73.4 MB bf16 cache, past the L2.
K6_SHAPES = [(8, 352, "bf16"), (8, 352, "int8"), (64, 1120, "bf16"),
             (64, 1120, "int8")]


def flexi_bwd_sets(fa, seqhw, fused, n=2, seed=110):
  """`n` input sets of K2's f32 kernel (q, k, v, lse, do; `fused` False)
  or of K5 (q, k, v, o, lse, do) at FlexiViT-B's `seqhw` in f32, with K1's
  or K3's forward; 2 sets exceed the L2 from seqhw 15 on."""
  b, t, h, d = 32, seqhw * seqhw + 1, 12, 64
  out = []
  for i in range(n):
    q, k, v, do = blocked_inputs(b, t, h, d, seed=seed + 2 * i)
    if fused:
      out.append((q, k, v, *fa.flash_attention_blocked_forward(q, k, v), do))
    else:
      out.append((q, k, v, fa.flash_attention_forward(q, k, v)[1], do))
  return out


def k4_work(b, t, h, d, itemsize=4):
  """(bytes, flops) of K4a and K4b together."""
  return tuple(x + y for x, y in zip(k4a_work(b, t, h, d, itemsize),
                                     k4b_work(b, t, h, d, itemsize)))


def time_blocked_bwd(fa, card, seqhw, seed=130):
  """Prints K4a, K4b (in turns: K4a, K4b, K4b, K4a), K4a + K4b (delta
  included) and K5 at FlexiViT-B's `seqhw` in f32 (B=32, T=seqhw^2+1, H=12,
  D=64), each beside its plain version and its bound at the 3xTF32 rate
  (and at the f32 rate outside the tensor cores), and SDPA's autograd
  backward on the same inputs."""
  b, t, h, d = 32, seqhw * seqhw + 1, 12, 64
  k5_sets = flexi_bwd_sets(fa, seqhw, fused=True, seed=seed)
  k4_sets = [(q, k, v, do, lse, fa.blocked_delta(o, do))
             for q, k, v, o, lse, do in k5_sets]
  dq, dkv = fa.flash_attention_blocked_dq, fa.flash_attention_blocked_dkv
  turns = [time_ms(fn, k4_sets, iters=10) for fn in (dq, dkv, dkv, dq)]
  print(f"[{card}] blocked backward at seqhw {seqhw} B={b} T={t} H={h} "
        f"D={d} f32: SDPA backward "
        f"{sdpa_bwd_ms([s[:3] + s[5:] for s in k5_sets]):.4f} ms; K4a, K4b "
        "in turns (K4a, K4b, K4b, K4a): "
        + ", ".join(f"{x:.4f}" for x in turns) + " ms")
  timed = [("K4a flash_blocked_dq", dq, fa.flash_attention_blocked_dq_reference,
            k4_sets, k4a_work, (turns[0] + turns[3]) / 2),
           ("K4b flash_blocked_dkv", dkv,
            fa.flash_attention_blocked_dkv_reference, k4_sets, k4b_work,
            (turns[1] + turns[2]) / 2),
           ("K4a + K4b", fa.flash_attention_blocked_bwd,
            fa.flash_attention_blocked_bwd_reference, k5_sets, k4_work, None),
           ("K5 flash_blocked_bwd_fused", fa.flash_attention_blocked_bwd_fused,
            fa.flash_attention_blocked_bwd_fused_reference, k5_sets, k5_work,
            None)]
  for name, fn, plain, sets, work, ms in timed:
    ms = ms if ms is not None else time_ms(fn, sets, iters=10)
    work = work(b, t, h, d)
    print(f"[{card}] {name} at seqhw {seqhw}: {ms:.4f} ms, plain "
          f"{time_ms(plain, sets, iters=3):.4f} ms; bound "
          f"{bound(*work, TF32X3_FLOPS)[0]:.4f} ms at the 3xTF32 rate, "
          f"{bound(*work, F32_FLOPS)[0]:.4f} ms at the f32 rate")
  del k5_sets, k4_sets
  torch.cuda.empty_cache()


def time_fwd(fa, card, kernel, seqhw, seed=140):
  """Times K1's f32 kernel (`kernel` "K1f", csrc/flash_fwd.cu) or K3
  ("K3", csrc/flash_blocked_fwd.cu), both on 3xTF32 products, at
  FlexiViT-B's `seqhw` in f32 (B=32, T=seqhw^2+1, H=12, D=64; two input
  sets, past the L2 from seqhw 15 on) beside its plain version (K1's: o
  alone), SDPA's forward on the same f32 inputs and its bound at the 3xTF32
  rate (and at the f32 rate outside the tensor cores). Prints one line;
  returns {ms, plain_ms, library_ms, bound_ms, bound_by, max_abs_err,
  max_rel_err}, the errors the largest of o's and the LSE's against the
  plain version on the first set."""
  b, t, h, d = 32, seqhw * seqhw + 1, 12, 64
  sets = [k1_inputs(b, t, h, d, seed=seed + i, dtype=torch.float32)
          for i in range(2)]
  if kernel == "K1f":
    assert fa.fwd_kernel(torch.float32) == "flash_fwd"
    name, fn = "K1 flash_fwd (f32)", lambda q, k, v: fa.flash_attention_forward(
        q, k, v)
    plain = fa.flash_attention_reference
    want = (plain(*sets[0]), fa.flash_attention_lse_reference(*sets[0]))
    work = k1_work(b, t, h, d, itemsize=4)
  else:
    name, fn = "K3 flash_blocked_fwd", fa.flash_attention_blocked_forward
    plain = fa.flash_attention_blocked_reference
    want = plain(*sets[0])
    work = k3_work(b, t, h, d)
  got = fn(*sets[0])
  abs_err = max((x - y).abs().max().item() for x, y in zip(got, want))
  rel = max(((x - y).abs().max() / y.abs().max()).item()
            for x, y in zip(got, want))
  del got, want
  bms, by = bound(*work, TF32X3_FLOPS)
  out = dict(ms=time_ms(fn, sets), plain_ms=time_ms(plain, sets, iters=3),
             library_ms=sdpa_fwd_ms(sets), bound_ms=bms, bound_by=by,
             max_abs_err=abs_err, max_rel_err=rel)
  print(f"[{card}] {name} at seqhw {seqhw} B={b} T={t} H={h} D={d} f32: "
        f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, SDPA "
        f"{out['library_ms']:.4f} ms; bound {bms:.4f} ms ({by}) at the "
        f"3xTF32 rate, {bound(*work, F32_FLOPS)[0]:.4f} ms at the f32 rate; "
        f"rel err (o, LSE) {rel:.3e}")
  del sets
  torch.cuda.empty_cache()
  return out


def time_tf32_bwd(fa, card):
  """Prints the 3xTF32 backward kernels' times (module docstring)."""
  cases = [("K2 flash_bwd (f32)", 15, False, (1, 2, 4), k2_work),
           ("K2 flash_bwd (f32)", 24, False, (1, 2, 5, 10), k2_work),
           ("K5 flash_blocked_bwd_fused", 40, True, (1, 2, 4, 13), k5_work),
           ("K5 flash_blocked_bwd_fused", 30, True, (1, 2, 4, 15), k5_work)]
  for name, seqhw, fused, tiles, work in cases:
    sets = flexi_bwd_sets(fa, seqhw, fused)
    fn = fa.flash_attention_blocked_bwd_fused if fused else fa.flash_attention_bwd
    iters = 10 if fused else 50
    order = list(tiles) + list(tiles)[::-1]
    ms = {kt: [] for kt in tiles}
    for kt in order:
      ms[kt].append(time_ms(lambda *a, kt=kt: fn(*a, key_tiles=kt), sets,
                            iters=iters))
    t = seqhw * seqhw + 1
    default = fa.key_tiles_per_block(32 * 12, t, t, 64)
    if fused:
      plain = fa.flash_attention_blocked_bwd_fused_reference
      sdpa = [(q, k, v, do) for q, k, v, _, _, do in sets]
    else:
      plain = lambda q, k, v, lse, do: fa.flash_attention_bwd_reference(
          q, k, v, do)
      sdpa = [(q, k, v, do) for q, k, v, _, do in sets]
    print(f"[{card}] {name} seqhw {seqhw} B=32 T={t} H=12 D=64 f32, key "
          f"tiles per block in turns: " + "; ".join(
              f"{kt}: {a:.4f}, {b:.4f} ms" for kt, (a, b) in ms.items())
          + f" (default {default}: {time_ms(fn, sets, iters=iters):.4f} ms); "
          f"plain {time_ms(plain, sets, iters=3):.4f} ms; SDPA backward "
          f"{sdpa_bwd_ms(sdpa):.4f} ms; bound "
          f"{bound(*work(32, t, 12, 64, itemsize=4), TF32X3_FLOPS)[0]:.4f} ms "
          f"at the 3xTF32 rate")
    if fused and seqhw == 40:
      turns = [time_ms(fn, sets, iters=10),
               time_ms(fa.flash_attention_blocked_bwd, sets, iters=10),
               time_ms(fa.flash_attention_blocked_bwd, sets, iters=10),
               time_ms(fn, sets, iters=10)]
      print(f"[{card}] blocked backward seqhw 40, delta included, in turns "
            "(K5, K4a + K4b, K4a + K4b, K5): "
            + ", ".join(f"{x:.4f}" for x in turns) + " ms")
    del sets, sdpa
    torch.cuda.empty_cache()


def main(argv):
  if argv not in ([], ["--k6"]):
    raise SystemExit(f"usage: kernel_timing [--k6]; got {argv}")
  if not torch.cuda.is_available():
    raise SystemExit("kernel_timing needs a CUDA device")
  from big_vision_torch.ops import _build
  from big_vision_torch.ops import decode_attention as da
  from big_vision_torch.ops import flash_attention as fa
  torch.backends.cuda.matmul.allow_tf32 = False
  if argv:
    _build.build_all(["decode_attention"])
    card = nvidia_smi()
    for b, s, cache in K6_SHAPES:
      time_k6(da, card, b, s, cache)
    k6_host_parts(da, card)
    for b, s, cache in K6_SHAPES:
      k6_variants(da, card, b, s, cache)
    return
  _build.build_all(["flash_fwd", "flash_fwd_tc", "decode_attention",
                    "flash_bwd", "flash_blocked_fwd", "flash_blocked_bwd",
                    "flash_blocked_bwd_fused"])
  card = nvidia_smi()
  time_tf32_bwd(fa, card)
  for seqhw in (40, 30):
    time_blocked_bwd(fa, card, seqhw)

  def report(name, fn, sets, work):
    ev, gr = time_ms(fn, sets), graph_ms(fn, sets)
    bms, by = bound(*work)
    print(f"[{card}] {name}: events {ev:.4f} ms, graph {gr:.4f} ms, bound "
          f"{bms:.4f} ms ({by}), SM clock {nvidia_smi('clocks.sm')}")

  for b, t, h, d in [(1, 256, 16, 72), (8, 256, 16, 72), (32, 256, 16, 72),
                     (8, 196, 12, 64), (256, 196, 12, 64), (8, 64, 16, 72)]:
    n = max(4, math.ceil(100e6 / (6 * b * t * h * d)))  # past the L2
    sets = [k1_inputs(b, t, h, d, seed=i) for i in range(n)]
    report(f"K1 flash_fwd_tc B={b} T={t} H={h} D={d}", fa.flash_attention,
           sets, k1_work(b, t, h, d))
  for kernel, seqhw in (("K1f", 15), ("K1f", 24), ("K3", 40), ("K3", 30)):
    time_fwd(fa, card, kernel, seqhw)
  for b, g, s, h in [(1, 8, 352, 256), (8, 8, 352, 256), (64, 8, 352, 256),
                     (132, 8, 352, 256), (8, 8, 64, 256), (8, 8, 1024, 256),
                     (8, 1, 352, 256), (8, 8, 352, 64)]:
    sets = [k6_inputs(b, 1, g, s, h, seed=i)[:4] for i in range(8)]
    report(f"K6 decode_attention B={b} K=1 G={g} S={s} H={h}",
           da.decode_attention, sets, k6_work(b, 1, g, s, h))


if __name__ == "__main__":
  main(sys.argv[1:])

"""Times design variants of the 3xTF32 attention kernels on the GPU.

K2's f32 kernel (csrc/flash_bwd.cu), K5 (csrc/flash_blocked_bwd_fused.cu)
and K4a, K4b (csrc/flash_blocked_bwd.cu) share csrc/flash_tf32_common.cuh;
K3 (csrc/flash_blocked_fwd.cu) and K1's f32 kernel (csrc/flash_fwd.cu)
share the forward of csrc/flash_tf32_fwd.cuh, built on it. Each variant
here is a copy of csrc/ with one choice of that design undone, built and
timed in its own process (so that the profiler's per-kernel breakdown
works in each), the sources as they are first and last:
  - the TF32 split with `cvt.rna.tf32.f32` for hi and for lo, in place of
    the integer rounding of hi and the unrounded lo;
  - query tiles of 64 rows in place of 32 in K2's, K5's and K4b's key-tile
    pass (`Tiles`);
  - K4a's query tiles of 32 rows (two warps per 16-row strip) in place of
    64 (one) at D <= 64;
  - K4a's and K4b's grids with the heads fastest, in place of their query
    or key tiles;
  - the key-tile pass (K2, K5, K4b) held to 168 registers a thread, so
    that three blocks fit an SM, in place of what the compiler takes (K4b
    and K2 at D = 64 take over 200, two blocks an SM);
  - no loads of the next tile while the current one computes (K2, K5,
    K4b; K4a loads each key tile in turn);
  - the forward's (K3, K1 f32) query tiles of 32 rows (two warps per
    16-row strip, each taking half of every key tile's keys) in place of
    64 (one);
  - the forward loading the next key tile into registers while the
    current one computes (up to D = 64), in place of each in turn;
  - the forward holding each warp's split q fragments in registers over
    the key tiles, in place of re-reading and re-splitting them per tile;
  - the forward adding each key tile's p . v to o in the tensor cores'
    sums (o rescaled by alpha first), in place of summing it from zero in
    registers of its own, added to o * alpha on the CUDA cores;
  - one TF32 product in place of three (not f32-accurate: its error is
    printed; a yardstick of what the products cost).
For each it prints K2's f32 kernel at FlexiViT-B's seqhw 15 and 24, K5 at
seqhw 40 and 30, K4a and K4b at seqhw 40, K1's f32 kernel at seqhw 15 and
24 and K3 at seqhw 40 and 30 (B=32, H=12, D=64, f32; CUDA events, inputs
rotated past the L2), the device time of each kernel of K2 at seqhw 15
and of K5 at seqhw 40 (torch.profiler), and the largest error against the
plain versions at seqhw 15 (K2, K1's o and LSE), 30 (K5, K4a + K4b) and
40 (K3's o and LSE).

Usage (GPU only):  python -m big_vision_torch.tools.tf32_variants [NAME ...]
(the variants named, each as a separate argument, the sources as they are
first and last; all by default).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HEADER, K4 = "flash_tf32_common.cuh", "flash_blocked_bwd.cu"
FWD = "flash_tf32_fwd.cuh"
# (file, text in the sources, its replacement) per variant.
VARIANTS = {
    "as committed": [],
    "split with cvt.rna for hi and lo": [(HEADER, """\
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));""", """\
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));""")],
    "query tiles of 64": [(HEADER, "static constexpr int BQ = 32;",
                           "static constexpr int BQ = 64;")],
    "K4a query tiles of 32": [
        (K4, "static constexpr int BQ = DP <= 64 ? 64 : 32;",
         "static constexpr int BQ = 32;")],
    "K4a, K4b heads fastest": [
        (K4, "q0 = blockIdx.x * BQ, bh = blockIdx.y,",
         "q0 = blockIdx.y * BQ, bh = blockIdx.x,"),
        (K4, "dim3(nq, a.B * a.H)", "dim3(a.B * a.H, nq)"),
        (HEADER, "const int bh = DQ ? blockIdx.x : blockIdx.y,",
         "const int bh = blockIdx.x,"),
        (HEADER, "const int chunk = DQ ? blockIdx.y : blockIdx.x;",
         "const int chunk = blockIdx.y;"),
        (HEADER, "SEM == Sem::kDkv ? dim3(chunks, a.B * a.H)",
         "SEM == Sem::kDkv ? dim3(a.B * a.H, chunks)")],
    "three blocks an SM": [
        (HEADER, "__launch_bounds__(NT) bwd_kv_kernel",
         "__launch_bounds__(NT, 3) bwd_kv_kernel")],
    "no loads ahead": [
        (HEADER, "constexpr bool PREFETCH = DP <= 64;",
         "constexpr bool PREFETCH = false;"),
        ("flash_bwd.cu", "static constexpr bool PREFETCH = DP <= 64;",
         "static constexpr bool PREFETCH = false;")],
    "forward query tiles of 32": [(FWD, "static constexpr int BQ = 64;",
                                   "static constexpr int BQ = 32;")],
    "forward loads ahead": [
        (FWD, "static constexpr bool PREFETCH = false;",
         "static constexpr bool PREFETCH = DP <= 64;")],
    "forward q fragments held": [
        (FWD, "static constexpr bool HOLD_Q = false;",
         "static constexpr bool HOLD_Q = DP <= 64;")],
    "forward p.v into o": [
        (FWD, "static constexpr bool PV_PER_TILE = true;",
         "static constexpr bool PV_PER_TILE = false;")],
    "one TF32 product (timing only)": [(HEADER, """\
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
""", "")],
}
ORDER = list(VARIANTS) + ["as committed"]


def variant_sources(name):
  """A copy of csrc/ with variant `name`'s replacements made."""
  from big_vision_torch.ops import _build
  tmp = Path(tempfile.mkdtemp(prefix="tf32_variant_"))
  for f in _build._CSRC.iterdir():
    shutil.copy(f, tmp / f.name)
  for fname, old, new in VARIANTS[name]:
    text = (tmp / fname).read_text()
    if old not in text:
      raise RuntimeError(f"variant {name!r}: text not found in {fname}")
    (tmp / fname).write_text(text.replace(old, new))
  return tmp


def run_variant(name):
  """Builds and times one variant in this process."""
  import torch
  from big_vision_torch.ops import _build
  _build._CSRC = Path(os.environ["TF32_VARIANT_CSRC"])
  from big_vision_torch.ops import flash_attention as fa
  from big_vision_torch.tools import kernel_timing as kt
  torch.backends.cuda.matmul.allow_tf32 = False
  logs = _build.build_all(["flash_bwd", "flash_blocked_bwd_fused",
                           "flash_fwd", "flash_blocked_fwd",
                           "flash_blocked_bwd"])
  # ptxas's registers and spills of the f32 forward at D = 64 (K3, K1).
  regs = []
  for src in ("flash_blocked_fwd", "flash_fwd"):
    lines = logs[src].splitlines()
    for i, line in enumerate(lines):
      if "fwd_kernelIfLi64E" in line and "Compiling entry" in line:
        regs.append(f"{src}: " + "; ".join(
            x.split(":")[-1].strip() for x in lines[i + 1:i + 4]
            if "spill" in x or "registers" in x))
  k2 = {s: kt.flexi_bwd_sets(fa, s, False) for s in (15, 24)}
  k5 = {s: kt.flexi_bwd_sets(fa, s, True) for s in (40, 30)}
  k4 = {s: [(q, k, v, do, lse, fa.blocked_delta(o, do))
            for q, k, v, o, lse, do in k5[s]] for s in k5}
  rel = lambda got, want: max(((x - y).abs().max() / y.abs().max()).item()
                              for x, y in zip(got, want))
  q, k, v, lse, do = k2[15][0]
  err2 = rel(fa.flash_attention_bwd(q, k, v, lse, do),
             fa.flash_attention_bwd_reference(q, k, v, do))
  err1 = rel(fa.flash_attention_forward(q, k, v),
             (fa.flash_attention_reference(q, k, v),
              fa.flash_attention_lse_reference(q, k, v)))
  q, k, v = k5[40][0][:3]
  err3 = rel(fa.flash_attention_blocked_forward(q, k, v),
             fa.flash_attention_blocked_reference(q, k, v))
  err5 = rel(fa.flash_attention_blocked_bwd_fused(*k5[30][0]),
             fa.flash_attention_blocked_bwd_fused_reference(*k5[30][0]))
  err4 = rel(fa.flash_attention_blocked_bwd(*k5[30][0]),
             fa.flash_attention_blocked_bwd_reference(*k5[30][0]))
  ms = {f"K2 seqhw {s}": kt.time_ms(fa.flash_attention_bwd, k2[s])
        for s in k2}
  ms.update({f"K5 seqhw {s}": kt.time_ms(fa.flash_attention_blocked_bwd_fused,
                                         k5[s], iters=10) for s in k5})
  ms["K4a seqhw 40"] = kt.time_ms(fa.flash_attention_blocked_dq, k4[40],
                                  iters=10)
  ms["K4b seqhw 40"] = kt.time_ms(fa.flash_attention_blocked_dkv, k4[40],
                                  iters=10)
  k1 = lambda q, k, v, lse, do: fa.flash_attention_forward(q, k, v)
  ms.update({f"K1 f32 seqhw {s}": kt.time_ms(k1, k2[s]) for s in k2})
  k3 = lambda q, k, v, o, lse, do: fa.flash_attention_blocked_forward(q, k, v)
  ms.update({f"K3 seqhw {s}": kt.time_ms(k3, k5[s], iters=10) for s in k5})
  prof = kt.device_profile({
      "K2 seqhw 15": lambda: fa.flash_attention_bwd(*k2[15][0]),
      "K5 seqhw 40": lambda: fa.flash_attention_blocked_bwd_fused(*k5[40][0])},
      top=3)
  parts = "; ".join(
      f"{what}: " + ", ".join(f"{n.split('<')[0].split('::')[-1]} {t:.4f}"
                              for n, t, _ in rows)
      for what, (rows, _, _) in prof.items())
  print(f"[{kt.nvidia_smi()}] {name}: " + ", ".join(
      f"{what} {t:.4f} ms" for what, t in ms.items())
        + f"; device ms by kernel: {parts}; rel err K2 {err2:.3e}, K5 "
        f"{err5:.3e}, K4a + K4b {err4:.3e}, K1 f32 {err1:.3e}, K3 "
        f"{err3:.3e}; ptxas, f32 forward at D = 64: {' | '.join(regs)}",
        flush=True)


def main(argv):
  name = os.environ.get("TF32_VARIANT")
  if name is not None:
    run_variant(name)
    return
  unknown = sorted(set(argv) - set(VARIANTS))
  if unknown:
    raise SystemExit(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
  import torch
  if not torch.cuda.is_available():
    raise SystemExit("tf32_variants needs a CUDA device")
  order = ORDER if not argv else ["as committed", *argv, "as committed"]
  for name in order:
    src = variant_sources(name)
    env = dict(os.environ, TF32_VARIANT=name, TF32_VARIANT_CSRC=str(src))
    try:
      subprocess.run([sys.executable, "-m", "big_vision_torch.tools."
                      "tf32_variants"], env=env, check=True)
    finally:
      shutil.rmtree(src, ignore_errors=True)


if __name__ == "__main__":
  main(sys.argv[1:])

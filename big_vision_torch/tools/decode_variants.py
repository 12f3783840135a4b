"""Times design variants of K6 (csrc/decode_attention.cu) on the GPU.

Each variant is a copy of csrc/ with one choice of K6's design undone,
built and timed in its own process, the sources as they are first and
last:
  - loads only: each tile's copies are issued and waited for, and nothing
    is computed (not a result: a yardstick of what the loads alone take);
  - compute only: the K and V copies left out (a yardstick too);
  - no scores, no softmax, no p . v: one phase of each tile left out (not
    results either: what each phase adds to the loads);
  - the combine launched after the split kernel has finished, in place of
    as its programmatic dependent.
For each it prints, at the serving shape (B=8, S=352) and at B=64,
S=1120, in bf16 and int8 (one KV head, G=8, H=256): the CUDA-graph time
of the wrapper's calls and the device time of each of its two kernels
(`kernel_timing.time_k6`), and the largest error against the plain
version.

Usage (GPU only):  python -m big_vision_torch.tools.decode_variants [NAME ...]
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

SRC = "decode_attention.cu"
# (text in csrc/decode_attention.cu, its replacement) per variant.
VARIANTS = {
    "as committed": [],
    "loads only (timing only)": [(
        "    // Scores: warp w takes the 16-slot column pair",
        "    if (a.softcap >= 0.f) {  // never false when timed\n"
        "      cp_async_wait<0>();\n"
        "      continue;\n"
        "    }\n"
        "    // Scores: warp w takes the 16-slot column pair")],
    "compute only (timing only)": [
        ("    load_rows<CT>(sK, rb,", "    if (a.softcap < 0.f)\n"
         "    load_rows<CT>(sK, rb,"),
        ("    load_rows<CT>(sV, rb,", "    if (a.softcap < 0.f)\n"
         "    load_rows<CT>(sV, rb,")],
    "no scores (timing only)": [(
        "    if (warp < pairs * slices) {",
        "    if (a.softcap < 0.f && warp < pairs * slices) {")],
    "no softmax (timing only)": [(
        "    if (warp < G) {\n      const int g = warp;",
        "    if (a.softcap < 0.f && warp < G) {\n      const int g = warp;")],
    "no p . v (timing only)": [(
        "    for (int k0 = 0; k0 < np; k0 += 16) {\n      const unsigned char* prow",
        "    for (int k0 = 0; a.softcap < 0.f && k0 < np; k0 += 16) {\n"
        "      const unsigned char* prow")],
    "combine not a dependent launch": [(
        "attr[0].val.programmaticStreamSerializationAllowed = 1;",
        "attr[0].val.programmaticStreamSerializationAllowed = 0;")],
}
ORDER = list(VARIANTS) + ["as committed"]
SHAPES = [(8, 352, "bf16"), (8, 352, "int8"), (64, 1120, "bf16"),
          (64, 1120, "int8")]


def variant_sources(name):
  """A copy of csrc/ with variant `name`'s replacements made."""
  from big_vision_torch.ops import _build
  tmp = Path(tempfile.mkdtemp(prefix="decode_variant_"))
  for f in _build._CSRC.iterdir():
    shutil.copy(f, tmp / f.name)
  for old, new in VARIANTS[name]:
    text = (tmp / SRC).read_text()
    if old not in text:
      raise RuntimeError(f"variant {name!r}: text not found in {SRC}")
    (tmp / SRC).write_text(text.replace(old, new))
  return tmp


def run_variant(name):
  """Builds and times one variant in this process."""
  import torch
  from big_vision_torch.ops import _build
  _build._CSRC = Path(os.environ["DECODE_VARIANT_CSRC"])
  from big_vision_torch.ops import decode_attention as da
  from big_vision_torch.tools import kernel_timing as kt
  _build.build_all(["decode_attention"])
  card = kt.nvidia_smi()
  parts = []
  for b, s, cache in SHAPES:
    q, k, v, m, sc = kt.k6_inputs(b, 1, 8, s, 256, cache=cache)
    err = (da.decode_attention(q, k, v, m, **sc)
           - da.decode_attention_reference(q, k, v, m, **sc)).abs().max()
    r = kt.time_k6(da, card, b, s, cache)
    parts.append(f"B={b} S={s} {cache}: graph {r['graph_ms']:.4f} ms ("
                 f"{', '.join(r['kernels'])}), max abs err {err.item():.3e}")
  print(f"[{card}] K6 variant {name}: " + "; ".join(parts), flush=True)


def main(argv):
  name = os.environ.get("DECODE_VARIANT")
  if name is not None:
    run_variant(name)
    return
  unknown = sorted(set(argv) - set(VARIANTS))
  if unknown:
    raise SystemExit(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
  import torch
  if not torch.cuda.is_available():
    raise SystemExit("decode_variants needs a CUDA device")
  order = ORDER if not argv else ["as committed", *argv, "as committed"]
  for name in order:
    src = variant_sources(name)
    env = dict(os.environ, DECODE_VARIANT=name, DECODE_VARIANT_CSRC=str(src))
    try:
      subprocess.run([sys.executable, "-m",
                      "big_vision_torch.tools.decode_variants"], env=env,
                     check=True)
    finally:
      shutil.rmtree(src, ignore_errors=True)


if __name__ == "__main__":
  main(sys.argv[1:])

"""Offline int8 quantization of a Gemma (or PaliGemma) `.npz` checkpoint.

Port of big_vision_tpu/tools/quantize_ckpt.py, with the same flags. It
writes the int8 + per-output-channel-scale tree of `gemma.quantize_params`
in exactly the layout that the JAX tool writes and that both packages'
`gemma.load` read, so a model built with `quant=True` serves from it.

Usage:
  python -m big_vision_torch.tools.quantize_ckpt \
      --ckpt gemma2b.npz --out gemma2b-int8.npz --layout unrolled
  # PaliGemma: the LLM subtree only, the image tower as it is.
  python -m big_vision_torch.tools.quantize_ckpt \
      --ckpt paligemma.npz --subtree llm --out paligemma-int8.npz

The JAX tool also reads the orbax directories of the Gemma releases; the
port reads `.npz` files only.
"""

from __future__ import annotations

import argparse

import numpy as np

from big_vision_torch.models.ppp import gemma
from big_vision_torch.utils import checkpoints
from big_vision_torch.utils import trees


def quantize_tree(params, layout="unrolled"):
  """Float gemma param tree (either layer layout) -> int8 serving tree."""
  if layout not in ("unrolled", "scan", "keep"):
    raise ValueError(f"layout must be unrolled|scan|keep, got {layout!r}")
  if layout != "keep":
    want_pyloop = layout == "unrolled"
    if gemma._is_pyloop(params) != want_pyloop:  # pylint: disable=protected-access
      params = (gemma.scan_to_pyloop(params) if want_pyloop
                else gemma.pyloop_to_scan(params))
  return gemma.quantize_params(params)


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--ckpt", required=True,
                 help="input checkpoint: .npz (optionally 'f.npz:sub')")
  p.add_argument("--out", required=True, help="output .npz path")
  p.add_argument("--subtree", default=None,
                 help="quantize only this subtree (e.g. 'llm' for "
                      "PaliGemma), pass the rest through unchanged")
  p.add_argument("--layout", default="unrolled",
                 choices=["unrolled", "scan", "keep"],
                 help="layer layout of the output: unrolled (per layer), "
                      "scan (stacked, the training layout), keep")
  args = p.parse_args(argv)

  if not (args.ckpt.endswith(".npz") or ".npz:" in args.ckpt):
    raise SystemExit(f"--ckpt {args.ckpt!r}: the port reads .npz "
                     "checkpoints only (no orbax directories)")
  params = checkpoints.load_params(args.ckpt)
  if args.subtree and args.subtree not in params:
    raise SystemExit(
        f"--subtree {args.subtree!r} not in the checkpoint's top-level "
        f"keys {sorted(params)}")
  target = params[args.subtree] if args.subtree else params
  quantized = quantize_tree(target, args.layout)
  if args.subtree:
    params = dict(params, **{args.subtree: quantized})
  else:
    params = quantized

  checkpoints.npz_save(params, args.out)
  leaves = [np.asarray(x) for x in trees.flatten(params).values()]
  n_int8 = sum(x.size for x in leaves if x.dtype == np.int8)
  n_bytes = sum(x.nbytes for x in leaves)
  print(f"wrote {args.out}: {n_int8:,} int8 weights, "
        f"{n_bytes / 1e9:.3f} GB total")


if __name__ == "__main__":
  main()

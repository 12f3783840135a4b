"""Interactive PaliGemma runner: a checkpoint and an image in, answers out.

Port of big_vision_tpu/trainers/proj/paligemma/run.py, with its flags, its
pp string and its `Session.answer` flow (pp, decode, `to_str`). Reads
prompts from stdin, one a line, and prints each decoded answer.

The model config and the tokenizer are the module constants `MODEL_CFG`
and `TOKENIZER`, as in the JAX runner; assign them to serve another model
(e.g. `quant=True` for a checkpoint whose LLM `tools/quantize_ckpt.py`
wrote in int8) or to read another vocab. The port's config adds its
serving kernels: K1 in the image tower (`attn_impl="auto"`) and K6 at every
decode step (`decode_impl="flash"`).

The parameters live on the one card (`device`, an argument of `main`: the
CPU only where the caller asks). The JAX runner shards them over all local
devices (FSDP); that waits for the port's multi-device work.

Usage:
  python -m big_vision_torch.trainers.proj.paligemma.run \
      --ckpt /path/to/paligemma.npz --image /path/to/img.jpg
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from big_vision_torch.models.proj.paligemma import paligemma as model_mod
from big_vision_torch.pp import builder
from big_vision_torch.pp import tokenizer
import big_vision_torch.pp.ops_general  # noqa: F401
import big_vision_torch.pp.ops_image  # noqa: F401
import big_vision_torch.pp.proj.paligemma.ops  # noqa: F401
from big_vision_torch.trainers.proj.paligemma import predict_fns
from big_vision_torch.utils import convert
from big_vision_torch.utils.writers import write_note

TOKENIZER = "gemma(tokensets=['loc', 'seg'])"
MODEL_CFG = dict(
    img=dict(variant="So400m/14", pool_type="none", scan=True),
    llm=dict(vocab_size=256_000 + 1024 + 128, decode_impl="flash"),
)


def parse_args(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument("--ckpt", required=True, help="Checkpoint path.")
  p.add_argument("--image", required=True, help="Input image.")
  p.add_argument("--sampler", default="greedy",
                 help="Decoding strategy, e.g. nucleus(0.1)")
  p.add_argument("--res", type=int, default=224, help="Image resolution.")
  p.add_argument("--max_decode_len", type=int, default=128,
                 help="Max total generation steps.")
  p.add_argument("--prefill_len", type=int, default=32,
                 help="Prompt prefill size.")
  p.add_argument("--ckpt_dtype", default=None,
                 help="Cast ckpt to dtype (e.g. float16).")
  return p.parse_args(argv)


class Session:
  """A PaliGemma on one device with its preprocessing and decode."""

  def __init__(self, args, device="cuda"):
    self.args = args
    self.device = torch.device(device)
    write_note("Loading model...")
    img_cfg = dict(MODEL_CFG["img"])
    img_cfg.setdefault("image_size", args.res)
    self.model = model_mod.Model(img=img_cfg, llm=MODEL_CFG["llm"],
                                 device="meta").eval()
    params = model_mod.load(None, args.ckpt, MODEL_CFG)
    dtype = getattr(torch, args.ckpt_dtype) if args.ckpt_dtype else None
    convert.load(self.model, convert.paligemma(params), device=self.device,
                 dtype=dtype)
    del params

    write_note("Loading tokenizer...")
    self.tokzr = tokenizer.get_tokenizer(TOKENIZER)

    self.decode = predict_fns.get_all(
        self.model, max_decode_len=args.max_decode_len,
        sampler=args.sampler)["decode"]
    self.pp_fn = builder.get_preprocess_fn("|".join([
        f"decode|resize({args.res})|value_range(-1, 1)",
        f"tok(key='prefix', bos='yes', model={TOKENIZER!r})",
        f"tok(key='septok', text='\\n', model={TOKENIZER!r})",
        "masked_concat(['prefix', 'septok'], mask_ar=[0, 0],"
        " mask_input=[1, 1])",
        f"tolen({args.prefill_len}, pad_value=0, key='text')",
        f"tolen({args.prefill_len}, pad_value=1, key='mask_ar')",
        f"tolen({args.prefill_len}, pad_value=0, key='mask_input')",
        "keep('image', 'text', 'mask_ar', 'mask_input')",
    ]))

  def answer(self, image_bytes, prompt):
    example = self.pp_fn({"image": image_bytes,
                          "prefix": np.array(prompt)})
    batch = {k: torch.from_numpy(v[None]).to(self.device)
             for k, v in example.items()}
    tokens = self.decode(batch)
    return self.tokzr.to_str(tokens[0].cpu().numpy())


def main(argv=None, device="cuda"):
  args = parse_args(argv)
  if torch.device(device).type == "cuda" and not torch.cuda.is_available():
    raise SystemExit("no CUDA device; pass device='cpu' to run on the CPU")
  session = Session(args, device)
  with open(args.image, "rb") as f:
    image_bytes = f.read()

  write_note("Warming up the inference function...")
  session.answer(image_bytes, "caption en")

  write_note("Type a prompt and press enter, e.g. 'caption en': ")
  for line in map(str.strip, sys.stdin):
    print(session.answer(image_bytes, line), flush=True)


if __name__ == "__main__":
  main()

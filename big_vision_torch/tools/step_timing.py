"""Times a trainer's update on one fixed batch, without the input pipeline.

  python -m big_vision_torch.tools.step_timing \
      --config big_vision_torch/configs/quality_digits.py:npz_dir=<dir> \
      [--trainer big_vision_torch.trainers.proj.gsam.gsam] [--steps 30]

Builds the config's trainer on the card (`--trainer`: the module whose
`Trainer` to use; `big_vision_torch.train` by default), takes one batch of
its input pipeline, runs `--warmup` updates, then `--steps` updates between
CUDA events and prints the ms a step by the events and by the host clock,
with the card's name and power limit. Run it from two checkouts in one
call, in turns, to compare two versions of the step.
"""

from __future__ import annotations

import argparse
import importlib
import time

import torch

from big_vision_torch import train
from big_vision_torch.tools import kernel_timing


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--config", required=True)
  parser.add_argument("--trainer", default="big_vision_torch.train")
  parser.add_argument("--steps", type=int, default=30)
  parser.add_argument("--warmup", type=int, default=5)
  parser.add_argument("--tag", default="")
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    raise SystemExit("step_timing: no CUDA device")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  config = train.load_config(args.config)
  config["evals"] = {}
  trainer = importlib.import_module(args.trainer).Trainer(config)
  it = trainer.input_iter()
  batch = next(it)
  it.close()
  for _ in range(args.warmup):
    trainer.update(batch)
  torch.cuda.synchronize()
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  t0 = time.perf_counter()
  start.record()
  for _ in range(args.steps):
    trainer.update(batch)
  end.record()
  end.synchronize()
  host_ms = 1e3 * (time.perf_counter() - t0) / args.steps
  print(f"[{kernel_timing.nvidia_smi()}] {args.tag} {args.config}: "
        f"{start.elapsed_time(end) / args.steps:.3f} ms a step (CUDA events, "
        f"{args.steps} steps of batch {trainer.batch_size}), {host_ms:.3f} "
        f"ms by the host clock")


if __name__ == "__main__":
  main()

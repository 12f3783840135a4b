"""Classification trainer: port of big_vision_tpu/train.py on one GPU.

  python -m big_vision_torch.train --config <file>.py[:args] --workdir <dir>
  python -m big_vision_torch.train --config <file>.py:runlocal \
      --workdir <dir> --device cpu

The config is a `get_config(arg)` file returning a dict with the JAX
trainer's keys. The update step is `train.py:191-226`: loss and gradients
of the config's loss, the optimizer of `optim.make` over the params named
as the JAX model names them, and the measurements `training_loss`,
`l2_grads`, `l2_params` and `l2_updates`, written every
`log_training_steps` with `global_schedule` and the throughput of the
window since the last row. A non-finite loss aborts the run.

Keys whose feature is not ported yet are refused, not ignored: `mixup`
with p > 0, `evals`, checkpoints (`ckpt_*`), `resume`, `model_init`, and
models other than "vit". The FlexiViT trainer
(`trainers/proj/flexi/train.py`) reuses this loop and `Trainer` through
its hooks: `build_model`, `step_kwargs` and `update(batch, **kw)`.
"""

from __future__ import annotations

import argparse
import importlib.util
import math
import time

import torch

from big_vision_torch import input_pipeline
from big_vision_torch import optim
from big_vision_torch.models import vit
from big_vision_torch.utils import convert
from big_vision_torch.utils import losses
from big_vision_torch.utils import schedules
from big_vision_torch.utils import writers

_UNPORTED = ("evals", "resume", "model_init", "ckpt_steps", "ckpt_examples",
             "ckpt_epochs", "ckpt_percent")


def check_ported(config, *, model_name="vit", mixup=False):
  """Raises ValueError naming the first config key that is not ported by a
  trainer of `model_name` (that takes `mixup` with p > 0 if `mixup`)."""
  for key in _UNPORTED:
    if config.get(key):
      raise ValueError(f"config key {key!r} is not ported yet")
  if not mixup and dict(config.get("mixup") or {}).get("p"):
    raise ValueError("config key 'mixup' (p > 0) is not ported yet")
  if config.get("model_name", model_name) != model_name:
    raise ValueError(f"config key 'model_name'={config['model_name']!r} is "
                     f"not ported yet by this trainer; only {model_name!r} "
                     "is")


def _jax_name_params(model):
  """{JAX param name: parameter} (what the config's regexes match)."""
  named = dict(model.named_parameters())
  return {jax: named[port] for port, jax in convert.vit_names(model).items()}


def l2(tensors):
  """Global L2 norm of f32 tensors (one multi-tensor kernel for the norms)."""
  return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
      list(tensors))))


class Trainer:
  """The model, its params by JAX name, the optimizer and its state."""
  MODEL_NAME = "vit"  # the config's model_name that `build_model` builds
  MIXUP = False  # whether `update` ports the config's mixup

  def __init__(self, config, *, device="cuda"):
    config = dict(config)
    check_ported(config, model_name=self.MODEL_NAME, mixup=self.MIXUP)
    self.device = torch.device(device)
    if self.device.type == "cuda" and not torch.cuda.is_available():
      raise RuntimeError("no CUDA device; pass --device cpu to train on the "
                         "CPU")
    self.config = config
    self.seed = config.get("seed", 0)
    self.batch_size = config["input"]["batch_size"]
    ntrain = input_pipeline.total_training_examples(config["input"])
    self.total_steps = schedules.steps("total", config, ntrain,
                                       self.batch_size)
    res, _, channels = input_pipeline.element_spec(
        config["input"])["image"][0]
    self.model = self.build_model(res, channels)
    gen = torch.Generator(device=self.device).manual_seed(self.seed)
    self.model.initialize(gen, head_bias=config.get("init_head_bias"))
    self.params = _jax_name_params(self.model)
    self.tx, self.sched_fns = optim.make(
        config, self.params, sched_kw=dict(
            total_steps=self.total_steps, batch_size=self.batch_size,
            data_size=ntrain))
    self.opt_state = self.tx.init(self.params)
    self.loss_fn = getattr(losses, config.get("loss", "sigmoid_xent"))

  def build_model(self, res, channels):
    """The config's model, for images of res x res x channels."""
    return vit.Model(num_classes=self.config["num_classes"], image_size=res,
                     channels=channels, device=self.device,
                     **self.config.get("model", {}))

  def step_kwargs(self, step):
    """Keyword arguments of `update` at `step` (none for this trainer)."""
    del step
    return {}

  def input_iter(self):
    """The training iterator of config["input"] on this trainer's device."""
    return input_pipeline.training(self.config["input"], device=self.device,
                                   seed=self.seed)[0]

  def loss_and_grads(self, batch):
    """(loss, {JAX name: gradient}) of the config's loss on `batch`."""
    rng = None
    if self.model.dropout:  # one generator per step, from (seed, count)
      rng = input_pipeline.step_generator(
          self.seed + 1, optim.get_count(self.opt_state), self.device)
    for p in self.params.values():
      p.grad = None
    logits, _ = self.model(batch["image"], train=True, rng=rng)
    loss = self.loss_fn(logits=logits, labels=batch["labels"])
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in self.params.items()}

  def update(self, batch):
    """One training step; returns its measurements (device scalars)."""
    loss, grads = self.loss_and_grads(batch)
    updates, self.opt_state = self.tx.apply_(self.params, grads,
                                             self.opt_state)
    with torch.no_grad():
      return {"training_loss": loss, "l2_grads": l2(grads.values()),
              "l2_params": l2(self.params.values()),
              "l2_updates": l2(updates.values())}


def train(config, workdir=None, *, device="cuda", trainer_cls=Trainer):
  """Runs the training loop of `config` with a `trainer_cls`; returns the
  trainer."""
  trainer = trainer_cls(config, device=device)
  mw = writers.MetricWriter(workdir)
  n_params = sum(p.numel() for p in trainer.params.values())
  writers.write_note(f"Model has {n_params:,} parameters; training for "
                     f"{trainer.total_steps} steps on {trainer.device}")
  mw.measure("num_params", n_params)
  mw.step_end()
  total = trainer.total_steps
  log_steps = schedules.steps("log_training", config, default=50)
  stop = config.get("stop_after_steps")
  it = trainer.input_iter()
  sync = (torch.cuda.synchronize if trainer.device.type == "cuda"
          else lambda: None)
  t_window, stall, n_window = time.perf_counter(), 0.0, 0
  try:
    for step in range(1, total + 1):
      mw.step_start(step)
      t0 = time.perf_counter()
      batch = next(it)
      stall += time.perf_counter() - t0
      measurements = trainer.update(batch, **trainer.step_kwargs(step))
      n_window += 1
      if (log_steps and step % log_steps == 0) or step == total or (
          stop and step >= stop):
        for name, value in measurements.items():
          v = mw.measure(name, value)
          if name == "training_loss" and not math.isfinite(v):
            raise RuntimeError(f"Train loss became {v} at step {step}; "
                               "aborting.")
        for i, fn in enumerate(trainer.sched_fns):
          mw.measure(f"global_schedule{i if i else ''}", fn(step - 1))
        sync()
        dt = time.perf_counter() - t_window
        mw.measure("img/sec", trainer.batch_size * n_window / dt)
        mw.measure("step_ms", 1e3 * dt / n_window)
        mw.measure("input_stall_pct", 100.0 * stall / dt)
        t_window, stall, n_window = time.perf_counter(), 0.0, 0
      mw.step_end()
      if stop and step >= stop:
        writers.write_note(f"stop_after_steps={stop}: stopping early.")
        break
  finally:
    it.close()
    mw.close()
  return trainer


def load_config(spec):
  """"path/to/config.py:arg" -> the dict its get_config(arg) returns."""
  path, _, arg = spec.partition(":")
  module_spec = importlib.util.spec_from_file_location("_bv_config", path)
  module = importlib.util.module_from_spec(module_spec)
  module_spec.loader.exec_module(module)
  return module.get_config(arg or None)


def main(argv=None, trainer_cls=Trainer, description=__doc__):
  """Parses the command line and trains with `trainer_cls`."""
  parser = argparse.ArgumentParser(description=description.splitlines()[0])
  parser.add_argument("--config", required=True,
                      help="config file, optionally with ':args'")
  parser.add_argument("--workdir", default=None,
                      help="directory for big_vision_metrics.txt")
  parser.add_argument("--device", default="cuda",
                      help="cuda (default) or cpu")
  args = parser.parse_args(argv)
  return train(load_config(args.config), args.workdir, device=args.device,
               trainer_cls=trainer_cls)


if __name__ == "__main__":
  main()

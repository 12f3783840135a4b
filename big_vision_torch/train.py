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

Checkpoints and initialization follow the JAX trainer's resume ladder
(`train.py:229-268`): the workdir's `ckpt.bv-LAST`, else `resume`, restores
params, optimizer state and the step (`utils/checkpoints.py`), and the
input stream seeks to that step (`input_pipeline.training_from_step`);
else `model_init` loads params through the model's `load` (with
`model_load` as its keyword arguments). A checkpoint is written every
`ckpt_steps` (or `ckpt_{examples,epochs,percent}`) and at the last step,
kept for good every `keep_ckpt_steps`.

With `mixup.p` > 0 each step first mixes the batch's images and labels
with themselves rolled by one (`schedules.mixup`, as JAX `train.py:194-200`
does), with a ~ Beta(p, p) drawn from a CPU generator seeded from the
seed and the optimizer step.

Evaluators (`config["evals"]`, JAX `train.py:277-323`) are built by
`evaluators.common.from_config` over the predict fns "predict" (logits)
and "represent" (`pre_logits`), and run every `log_steps` (or
`log_{epochs,examples,percent}`) of their spec; a fresh run evaluates at
step 0 (except evals with `skip_first`), and the last step is evaluated
unless `stop_after_steps` ended the run early.

Time is kept by a `utils.chrono.Chrono`, as in the JAX trainers: at each
log step it writes `uptime`, `examples_seen`, `epoch`, `img/sec/core` and
`core_hours[_<device kind>]`; evals and checkpoints pause it, and their
times are written as `z/secs/eval/<name>` and `z/secs/ckpt`; its totals are
saved in every checkpoint under "chrono" and restored on resume. The
window measures `img/sec`, `step_ms` and `input_stall_pct` cover the steps
since the last log row, without those pauses. Each log row also gets the
host's and the card's memory (`utils/chrono.log_memory`), as in JAX.

The model is the config's `model_name`, as in the JAX trainer: "vit",
"mlp_mixer", "bit" or "bit_paper" (`MODELS`); its params go by their JAX
names (`utils/convert.names`), and `model_init` is read by that model's
`load`.
Keys whose feature is not ported yet are refused, not ignored: evals of
a type the port lacks, and other models. The FlexiViT trainers
(`trainers/proj/flexi/train.py`, `distill.py`) and the generic distill
trainer (`trainers/proj/distill/distill.py`) reuse this loop and
`Trainer` through its hooks: `check_config`, `build_model`,
`load_weights`, `state`/`restore_state`, `step_kwargs`, `predict_fns`
and `update(batch, **kw)`.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import importlib.util
import math
import os
import time

import torch

from big_vision_torch import input_pipeline
from big_vision_torch import optim
from big_vision_torch.evaluators import common as eval_common
from big_vision_torch.models import bit
from big_vision_torch.models import bit_paper
from big_vision_torch.models import mlp_mixer
from big_vision_torch.models import vit
from big_vision_torch.utils import checkpoints
from big_vision_torch.utils import chrono as chrono_lib
from big_vision_torch.utils import convert
from big_vision_torch.utils import losses
from big_vision_torch.utils import schedules
from big_vision_torch.utils import writers

# config["model_name"] -> the port's model module, as the JAX trainer
# imports big_vision_tpu.models.<model_name>.
MODELS = {"vit": vit, "mlp_mixer": mlp_mixer, "bit": bit,
          "bit_paper": bit_paper}
# The models built on convolutions, which take any image size (and no
# `image_size` argument).
CONVNETS = (bit, bit_paper)


def check_ported(config, *, model_name=tuple(MODELS),
                 predict_fns=("predict", "represent")):
  """Raises ValueError naming the first config key that is not ported by a
  trainer of `model_name` (a name, or the names it builds; the first is
  the default) with `predict_fns` (their names)."""
  for name, spec in (config.get("evals") or {}).items():
    spec = dict(spec)
    try:
      eval_common.evaluator_module(spec.get("type", name))
    except ValueError as e:
      raise ValueError(f"config key 'evals': {name}: {e}") from None
    if spec.get("pred", "predict") not in predict_fns:
      raise ValueError(f"config key 'evals': {name}: predict fn "
                       f"{spec.get('pred', 'predict')!r} is not ported by "
                       f"this trainer (it has {list(predict_fns)})")
  if not dict(config.get("input") or {}).get("resume_seek", True):
    raise ValueError("config key 'input.resume_seek'=False is not ported; "
                     "a resumed run always seeks the input stream")
  names = (model_name,) if isinstance(model_name, str) else model_name
  if config.get("model_name", names[0]) not in names:
    raise ValueError(f"config key 'model_name'={config['model_name']!r} is "
                     f"not ported yet by this trainer; it builds "
                     f"{list(names)}")


def jax_name_params(model):
  """{JAX param name: parameter} (what the config's regexes match)."""
  named = dict(model.named_parameters())
  return {jax: named[port] for port, jax in convert.names(model).items()}


def l2(tensors):
  """Global L2 norm of f32 tensors (one multi-tensor kernel for the norms)."""
  return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
      list(tensors))))


def load_into(model, model_mod, init_file, model_cfg, load_kw=None):
  """Loads `init_file` into `model` through `model_mod.load` (the JAX
  package's `load` of that model, on the model's own params as the init
  tree), replacing its parameters. A checkpoint file of the port's
  trainers (`{prefix}-{step}`) gives its params by name instead."""
  if (isinstance(init_file, str) and os.path.isfile(init_file)
      and not init_file.endswith(".npz")):
    params = checkpoints.load_checkpoint(init_file)["params"]
    with torch.no_grad():
      for name, p in jax_name_params(model).items():
        p.copy_(params[name])
    return
  loaded = model_mod.load(convert.params(model), init_file,
                          dict(model_cfg or {}), **dict(load_kw or {}))
  convert.load(model, convert.state(model, loaded))


def image_size(input_config):
  """(res, channels) of the input's [res, res, c] images; (None, None)
  for an image given as a tuple (a NaFlex patch sequence), whose model
  takes no image size."""
  spec = input_pipeline.element_spec(input_config)["image"]
  if not isinstance(spec[1], torch.dtype):
    return None, None
  res, _, channels = spec[0]
  return res, channels


def _draws_in_training(model):
  """Whether the model draws random masks in training (dropout, or the
  Mixer's stochastic depth)."""
  return bool(getattr(model, "dropout", 0) or getattr(model, "stoch_depth",
                                                       0))


def _to_device(tree, device):
  if isinstance(tree, dict):
    return {k: _to_device(v, device) for k, v in tree.items()}
  return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class Trainer:
  """The model, its params by JAX name, the optimizer and its state.

  With a `workdir`, checkpoints go to `{workdir}/ckpt.bv-*`; the
  constructor resumes from the workdir's last one, else from the config's
  `resume`, and sets `first_step`.
  """
  # The config model_names that `build_model` builds, and the module of
  # each (its `Model`, and the `load` that reads `model_init`); a trainer
  # of one model names it and sets MODEL_MODULE.
  MODEL_NAME = tuple(MODELS)
  MODEL_MODULE = None

  def __init__(self, config, *, device="cuda", workdir=None):
    self.config = config = dict(config)
    self.check_config(config)
    self.device = torch.device(device)
    if self.device.type == "cuda" and not torch.cuda.is_available():
      raise RuntimeError("no CUDA device; pass --device cpu to train on the "
                         "CPU")
    self.seed = config.get("seed", 0)
    self.batch_size = config["input"]["batch_size"]
    ntrain = input_pipeline.total_training_examples(config["input"])
    self.total_steps = schedules.steps("total", config, ntrain,
                                       self.batch_size)
    self.model = self.build_model(*image_size(config["input"]))
    gen = torch.Generator(device=self.device).manual_seed(self.seed)
    self.model.initialize(gen, head_bias=config.get("init_head_bias"))
    self.ckpt_prefix = os.path.join(workdir, "ckpt.bv") if workdir else None
    resume = (self.ckpt_prefix
              and checkpoints.last_checkpoint_dir(self.ckpt_prefix)
              ) or config.get("resume")
    self.load_weights(resumed=bool(resume))
    self.params = jax_name_params(self.model)
    self.tx, self.sched_fns = optim.make(
        config, self.params, sched_kw=dict(
            total_steps=self.total_steps, batch_size=self.batch_size,
            data_size=ntrain), jax_shapes=convert.jax_shapes(self.model))
    self.opt_state = self.tx.init(self.params)
    self.first_step = 0
    self.chrono_state = None  # Chrono's totals from the checkpoint
    if resume:
      writers.write_note(f"Resuming from {resume}...")
      loaded = checkpoints.load_checkpoint(resume)
      self.chrono_state = loaded.pop("chrono", None)
      self.restore_state(loaded)
      self.first_step = optim.get_count(self.opt_state)
    self.loss_fn = getattr(losses, config.get("loss", "sigmoid_xent"))

  def check_config(self, config):
    """Raises on a config key this trainer does not port."""
    check_ported(config, model_name=self.MODEL_NAME,
                 predict_fns=self.predict_fns())

  def model_module(self):
    """The module of the model this trainer builds for its config."""
    return self.MODEL_MODULE or MODELS[self.config.get("model_name",
                                                       self.MODEL_NAME[0])]

  def load_weights(self, resumed):
    """Loads `model_init` into the model unless the run resumes."""
    if not resumed and self.config.get("model_init"):
      writers.write_note(f"Initializing from {self.config['model_init']}...")
      load_into(self.model, self.model_module(), self.config["model_init"],
                self.config.get("model"), self.config.get("model_load"))

  def state(self):
    """What a checkpoint holds: {"params": {JAX name: tensor}, "opt": the
    optimizer state}."""
    return {"params": self.params, "opt": self.opt_state}

  def restore_state(self, loaded):
    """Copies a loaded `state()` into the params (in place) and the
    optimizer state."""
    with torch.no_grad():
      for name, p in self.params.items():
        p.copy_(loaded["params"][name])
    self.opt_state = _to_device(loaded["opt"], self.device)

  def build_model(self, res, channels):
    """The config's model, for images of res x res x channels."""
    module = self.model_module()
    kw = {} if module in CONVNETS else dict(image_size=res)
    return module.Model(num_classes=self.config["num_classes"],
                        channels=channels, device=self.device, **kw,
                        **self.config.get("model", {}))

  def step_kwargs(self, step):
    """Keyword arguments of `update` at `step` (none for this trainer)."""
    del step
    return {}

  def input_iter(self, first_step=0):
    """The training iterator of config["input"] on this trainer's device,
    positioned at `first_step`."""
    return input_pipeline.training_from_step(
        self.config["input"], first_step, device=self.device, seed=self.seed)

  def mixup_generator(self):
    """The CPU generator of this step's mixup draw, seeded from (seed + 2,
    optimizer step)."""
    return input_pipeline.step_generator(
        self.seed + 2, optim.get_count(self.opt_state), "cpu")

  def loss_and_grads(self, batch):
    """(loss, {JAX name: gradient}) of the config's loss on `batch`, mixed
    up first where the config's mixup.p > 0."""
    images, labels = batch["image"], batch["labels"]
    mixup_p = dict(self.config.get("mixup") or {}).get("p")
    if mixup_p:
      (images, labels), _ = schedules.mixup(self.mixup_generator(), images,
                                            labels, p=mixup_p)
    rng = None
    if _draws_in_training(self.model):  # a generator per step
      rng = input_pipeline.step_generator(
          self.seed + 1, optim.get_count(self.opt_state), self.device)
    for p in self.params.values():
      p.grad = None
    logits, _ = self.model(images, train=True, rng=rng)
    loss = self.loss_fn(logits=logits, labels=labels)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in self.params.items()}

  def predict_fns(self):
    """{name: fn(train_state, batch) -> tuple} for the evaluators, as the
    JAX trainer names them: "predict" gives (logits, {}), "represent"
    (pre_logits,)."""
    def predict(train_state, batch):
      del train_state  # the model holds the params
      return self.model(batch["image"])[0], {}

    def represent(train_state, batch):
      del train_state
      return (self.model(batch["image"])[1]["pre_logits"],)

    return {"predict": predict, "represent": represent}

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
  trainer = trainer_cls(config, device=device, workdir=workdir)
  mw = writers.MetricWriter(workdir)
  n_params = sum(p.numel() for p in trainer.params.values())
  writers.write_note(f"Model has {n_params:,} parameters; training for "
                     f"{trainer.total_steps} steps on {trainer.device}")
  mw.measure("num_params", n_params)
  total = trainer.total_steps
  log_steps = schedules.steps("log_training", config, default=50)
  stop = config.get("stop_after_steps")
  ntrain = input_pipeline.total_training_examples(config["input"])
  ckpt_steps = schedules.steps("ckpt", config, ntrain, trainer.batch_size,
                               total, default=None)
  keep_steps = schedules.steps("keep_ckpt", config, ntrain,
                               trainer.batch_size, total, default=None)
  ckpt_mgr = (checkpoints.CheckpointManager()
              if trainer.ckpt_prefix and ckpt_steps else None)
  chrono = chrono_lib.Chrono(trainer.device)
  chrono.inform(first_step=trainer.first_step, total_steps=total,
                global_bs=trainer.batch_size,
                steps_per_epoch=ntrain / trainer.batch_size,
                measure=mw.measure, write_note=writers.write_note)
  if trainer.chrono_state is not None:
    chrono.load(trainer.chrono_state.numpy())
  it = trainer.input_iter(trainer.first_step)
  sync = (torch.cuda.synchronize if trainer.device.type == "cuda"
          else lambda: None)

  @functools.cache
  def evaluators():
    return eval_common.from_config(
        config, trainer.predict_fns(), write_note=writers.write_note,
        get_steps=lambda key, cfg: schedules.steps(
            key, cfg, ntrain, trainer.batch_size, total, default=None),
        device=trainer.device)

  last_eval_step = {}

  def run_evals(step, final=False, initial=False):
    """Runs the evaluators due at `step`, with the clock paused."""
    for name, evaluator, every, prefix in evaluators():
      if initial and dict(config["evals"][name]).get("skip_first"):
        continue
      due = final or (every and step % every == 0)
      if not due or last_eval_step.get(name) == step:
        continue
      last_eval_step[name] = step
      chrono.pause(wait_for=trainer.params.values())
      with chrono.log_timing(f"z/secs/eval/{name}"):
        for key, value in evaluator.run(trainer.state()):
          mw.measure(f"{prefix}{key}", value)
        sync()
      chrono.resume()

  def window_start():
    """(wall clock, paused seconds so far, input stall, steps): a new
    window of the throughput measures."""
    return time.perf_counter(), chrono.paused_time, 0.0, 0

  try:
    if trainer.first_step in (total, 0):
      # A fresh run evaluates at step 0 (but for `skip_first` evals); a
      # resumed run that had finished its steps runs the final evals.
      run_evals(trainer.first_step, final=True,
                initial=trainer.first_step != total)
    mw.step_end()
    t_window, paused, stall, n_window = window_start()
    step = trainer.first_step
    for step in range(trainer.first_step + 1, total + 1):
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
        # Evals and checkpoints since the window began stay out of it.
        dt = time.perf_counter() - t_window - (chrono.paused_time - paused)
        mw.measure("img/sec", trainer.batch_size * n_window / dt)
        mw.measure("step_ms", 1e3 * dt / n_window)
        mw.measure("input_stall_pct", 100.0 * stall / dt)
        chrono.tick(step)
        chrono_lib.log_memory(mw.measure, trainer.device)
        t_window, paused, stall, n_window = window_start()
      if ckpt_mgr and (step % ckpt_steps == 0 or step == total):
        chrono.pause(wait_for=trainer.params.values())
        with chrono.log_timing("z/secs/ckpt"):
          ckpt_mgr.save(
              {**trainer.state(), "chrono": torch.from_numpy(chrono.save())},
              trainer.ckpt_prefix, step,
              keep=bool(keep_steps and step % keep_steps == 0))
        chrono.resume()
      run_evals(step)
      mw.step_end()
      if stop and step >= stop:
        writers.write_note(f"stop_after_steps={stop}: stopping early.")
        break
    if total > 0 and not (stop and step < total):  # a `stop` skips them
      mw.step_start(step)
      run_evals(step, final=True)
      mw.step_end()
  finally:
    it.close()
    mw.close()
    if ckpt_mgr:
      ckpt_mgr.close()
  return trainer


def import_pp_modules(config, default=("ops_general", "ops_image")):
  """Imports `big_vision_torch.pp.<m>` for the config's `pp_modules` (the
  registry's side effects), as the JAX trainers do."""
  for m in config.get("pp_modules", default):
    importlib.import_module(f"big_vision_torch.pp.{m}")


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

"""Chrono, the training loop's wall-clock accounting: port of
big_vision_tpu/utils/chrono.py on one device.

Tracks examples seen, img/sec/core, core-hours by device kind and the ETA,
and keeps pauses (evals, checkpoints) apart from training time. Its four
totals ride in checkpoints, so that the accounting survives a resume.

One device, so the JAX package's `jax.device_count()` is 1 here; the
device kind is the card's name (`torch.cuda.get_device_name`, spaces made
underscores), or "cpu". A `pause` waits for the CUDA devices of the
tensors it is given (the JAX package's `block_until_ready`). The trainers
make one `Chrono` per run where the JAX package keeps one per process.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

__all__ = ["Chrono", "log_memory"]


def log_memory(measure, device="cuda"):
  """Measures host memory (with `psutil`, where it is installed) and the
  card's, under the JAX package's names: `y/hostmem/total`,
  `y/hostmem/available`, and `y/devmem/dev0/{bytes_in_use,
  peak_bytes_in_use, bytes_limit}` from `torch.cuda.memory_stats` and the
  card's total memory (nothing for a CPU device)."""
  try:
    import psutil  # pylint: disable=g-import-not-at-top
    vmem = psutil.virtual_memory()
    measure("y/hostmem/total", vmem.total)
    measure("y/hostmem/available", vmem.available)
  except ImportError:
    pass
  device = torch.device(device)
  if device.type != "cuda":
    return
  stats = torch.cuda.memory_stats(device)
  measure("y/devmem/dev0/bytes_in_use",
          stats.get("allocated_bytes.all.current", 0))
  measure("y/devmem/dev0/peak_bytes_in_use",
          stats.get("allocated_bytes.all.peak", 0))
  measure("y/devmem/dev0/bytes_limit",
          torch.cuda.get_device_properties(device).total_memory)


def _hms(s):
  """Seconds -> '1h2m3s' style string."""
  s = int(round(s))
  h, s = divmod(s, 3600)
  m, s = divmod(s, 60)
  parts = ([f"{h}h"] if h else []) + ([f"{m}m"] if (h or m) else []) + [f"{s}s"]
  return "".join(parts)


def device_kind(device):
  """The kind of `device` as the core-hours measure names it."""
  device = torch.device(device)
  if device.type != "cuda":
    return device.type
  return torch.cuda.get_device_name(device).replace(" ", "_")


class Chrono:
  """Measures time taken by the program, training, and pauses."""

  def __init__(self, device="cpu"):
    self.device_count = 1
    self.device_kind = device_kind(device)
    self.program_start_time = time.monotonic()
    self.train_start_time = None
    self.train_start_step = None  # the step timing started at (resumes too)
    self.prev_time = None
    self.prev_step = None
    self.pause_start = None
    self.paused_time = 0.0
    self.total_steps = None
    self.global_bs = None
    self.steps_per_epoch = None
    self.warmup = 2  # The first measurements include warm-up; discard them.
    self.note = "Chrono n/a"
    # Totals (secs) of earlier runs of this training (from a checkpoint).
    self.accum_program_time = 0.0
    self.accum_train_time = 0.0
    self.accum_pause_time = 0.0
    self.accum_examples_seen = 0
    self._measure = None
    self._write_note = None

  def inform(self, *, first_step=None, total_steps=None, global_bs=None,
             steps_per_epoch=None, measure=None, write_note=None):
    """Provide run metadata; may be called multiple times with partial info."""
    self.prev_step = first_step if first_step is not None else self.prev_step
    self.total_steps = total_steps if total_steps is not None else self.total_steps
    self.global_bs = global_bs if global_bs is not None else self.global_bs
    self.steps_per_epoch = (
        steps_per_epoch if steps_per_epoch is not None else self.steps_per_epoch)
    if self.total_steps and self.prev_step is not None:
      self.note = (f"Steps:{self.prev_step}/{self.total_steps} "
                   f"[{self.prev_step / self.total_steps:.1%}]")
    self._measure = measure or self._measure
    self._write_note = write_note or self._write_note

  def tick(self, step, measure=None, write_note=None):
    """Call once per (logged) step to emit timing metrics."""
    measure = measure or self._measure
    write_note = write_note or self._write_note
    now = time.monotonic()
    measure("uptime", now - self.program_start_time)

    if self.warmup > 1:
      self.warmup -= 1
      write_note(self.note)
      return
    if self.warmup == 1:  # Steady state begins: set the t=0 reference.
      self.train_start_time = self.prev_time = now
      self.train_start_step = self.prev_step
      self.warmup = 0
      write_note(self.note)
      return

    examples = step * self.global_bs
    self.accum_examples_seen = examples
    measure("examples_seen", examples)
    if self.steps_per_epoch:
      measure("epoch", step / self.steps_per_epoch)

    dstep = step - self.prev_step
    dtime = now - self.prev_time
    if dstep:
      measure("img/sec/core",
              self.global_bs * dstep / dtime / self.device_count)
      steps_timed = step - self.train_start_step
      core_hours = (now - self.train_start_time) * self.device_count / 3600
      measure(f"core_hours_{self.device_kind}", core_hours)
      measure("core_hours", core_hours)
      eta = (self.total_steps - step) * (now - self.train_start_time) / steps_timed
      self.note = (
          f"Steps:{step}/{self.total_steps} [{step / self.total_steps:.1%}] "
          f"ETA:{_hms(eta)}")
    self.prev_time = now
    self.prev_step = step
    write_note(self.note)

  def pause(self, wait_for=()):
    """Stops the train-time clock (evals, checkpoints), once the CUDA
    devices of the tensors `wait_for` are done with their work."""
    assert self.pause_start is None, "Chrono already paused"
    for device in {t.device for t in wait_for if t.is_cuda}:
      torch.cuda.synchronize(device)
    self.pause_start = time.monotonic()

  def resume(self):
    assert self.pause_start is not None, "Chrono not paused"
    pause = time.monotonic() - self.pause_start
    self.paused_time += pause
    self.accum_pause_time += pause
    self.pause_start = None
    # Shift the timing reference so the pause doesn't count as train time.
    if self.train_start_time is not None:
      self.train_start_time += pause
    if self.prev_time is not None:
      self.prev_time += pause

  @contextlib.contextmanager
  def log_timing(self, name, *, noop=False):
    """Measures wall-time of a block into the metrics stream."""
    t0 = time.monotonic()
    yield
    if not noop and self._measure:
      self._measure(name, time.monotonic() - t0)

  def save(self):
    """The four totals, for a checkpoint: program, train and pause seconds
    and examples seen, float64."""
    now = time.monotonic()
    return np.asarray([
        self.accum_program_time + now - self.program_start_time,
        self.accum_train_time + (
            (now - self.train_start_time) if self.train_start_time else 0.0),
        self.accum_pause_time,
        float(self.accum_examples_seen),
    ], np.float64)

  def load(self, state):
    state = np.asarray(state, np.float64)
    self.accum_program_time = float(state[0])
    self.accum_train_time = float(state[1])
    self.accum_pause_time = float(state[2])
    self.accum_examples_seen = int(state[3])

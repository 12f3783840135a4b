"""Port's Chrono vs the JAX package's, on one fake clock.

Both read `time.monotonic`, which the tests replace by a clock that
advances only when told; JAX's device count is pinned to 1, the port's
(one device). The same calls (inform, ticks through the two warm-up
ticks, pause/resume around an eval, log_timing, save and load) give the
same measures, names and values, and the same notes and saved totals.
Also: the trainer's loop writes the chrono measures and carries the
totals through a checkpoint into a resumed run.
"""

import importlib
import json
import time

import jax
import numpy as np
import pytest

from big_vision_torch import train as t_train
from big_vision_torch.configs import smoke as t_smoke
from big_vision_torch.utils import checkpoints as t_ckpt
from big_vision_torch.utils import chrono as t_chrono

j_chrono = importlib.import_module("big_vision_tpu.utils.chrono")


class FakeClock:

  def __init__(self):
    self.now = 1000.0

  def __call__(self):
    return self.now


def _drive(chrono_cls, clock, first_step, steps_per_epoch):
  """Runs one scripted training through a new Chrono; returns (the
  measures, the notes, its saved totals, a Chrono that loaded them)."""
  measures, notes = [], []
  c = chrono_cls()
  c.inform(measure=lambda k, v: measures.append((k, float(v))),
           write_note=notes.append)
  c.inform(first_step=0, total_steps=20, global_bs=8,
           steps_per_epoch=steps_per_epoch)
  if first_step:
    c.load(np.asarray([50.0, 40.0, 5.0, 8.0 * first_step]))
    c.inform(first_step=first_step)
  for step in range(first_step + 1, first_step + 8):
    clock.now += 0.25 * step
    c.tick(step)
    if step % 3 == 0:  # an eval
      c.pause(wait_for=())
      with c.log_timing(f"z/secs/eval/{step}"):
        clock.now += 2.0
      c.resume()
  clock.now += 1.5
  saved = c.save()
  loaded = chrono_cls()
  loaded.load(saved)
  return measures, notes, saved, loaded


@pytest.mark.parametrize("first_step,steps_per_epoch", [
    (0, 4.0), (0, None), (6, 2.5),
])
def test_chrono_matches_jax(monkeypatch, first_step, steps_per_epoch):
  clock = FakeClock()
  monkeypatch.setattr(time, "monotonic", clock)
  monkeypatch.setattr(jax, "device_count", lambda *a: 1)
  got = _drive(t_chrono.Chrono, clock, first_step, steps_per_epoch)
  clock.now = 1000.0
  want = _drive(j_chrono.Chrono, clock, first_step, steps_per_epoch)
  assert jax.devices()[0].device_kind == "cpu"
  names = {k for k, _ in got[0]}
  assert {"uptime", "examples_seen", "img/sec/core", "core_hours",
          "core_hours_cpu"} <= names
  assert any(k.startswith("z/secs/eval/") for k in names)
  assert ("epoch" in names) == bool(steps_per_epoch)
  assert got[0] == want[0]
  assert got[1] == want[1] and got[1][-1].startswith("Steps:")
  np.testing.assert_array_equal(got[2], want[2])
  assert got[2].dtype == np.float64 and got[2].shape == (4,)
  for attr in ("accum_program_time", "accum_train_time", "accum_pause_time",
               "accum_examples_seen"):
    assert getattr(got[3], attr) == getattr(want[3], attr), attr


def test_pause_twice_and_resume_unpaused_raise():
  c = t_chrono.Chrono()
  c.pause()
  with pytest.raises(AssertionError):
    c.pause()
  c.resume()
  with pytest.raises(AssertionError):
    c.resume()


def _rows(path):
  return [json.loads(line) for line in path.read_text().splitlines()]


def test_trainer_writes_the_measures_and_resumes_the_clock(tmp_path):
  config = t_smoke.get_config("total_steps=6,log=1,ckpt=3,stop=3")
  t_train.train(config, str(tmp_path), device="cpu")
  first = t_ckpt.load_checkpoint(t_ckpt.last_checkpoint_dir(
      str(tmp_path / "ckpt.bv")))["chrono"]
  # Ticks at steps 1 and 2 warm up, step 3's counts 3 batches of 16.
  assert first.dtype.is_floating_point and tuple(first.shape) == (4,)
  assert first[0] > 0 and first[2] > 0 and first[3] == 48
  del config["stop_after_steps"]
  resumed = t_train.train(config, str(tmp_path), device="cpu")
  assert resumed.first_step == 3
  np.testing.assert_array_equal(resumed.chrono_state.numpy(),
                                first.numpy())
  last = t_ckpt.load_checkpoint(t_ckpt.last_checkpoint_dir(
      str(tmp_path / "ckpt.bv")))["chrono"]
  # No pause of the resumed run ended before its checkpoint was written.
  assert last[0] > first[0] and last[2] == first[2]
  rows = _rows(tmp_path / "big_vision_metrics.txt")
  ticks = [r for r in rows if "uptime" in r]
  assert [r["step"] for r in ticks] == [1, 2, 3, 4, 5, 6]
  # The resumed run warms up again; its third tick measures.
  assert ticks[-1]["examples_seen"] == 96 and ticks[-1]["img/sec/core"] > 0
  assert all("z/secs/ckpt" in r for r in rows if r["step"] in (3, 6)
             and "training_loss" in r)
  evals = [r for r in rows if "z/secs/eval/val" in r]
  assert [r["step"] for r in evals] == [0, 6]

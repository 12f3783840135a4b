"""Input pipelines: port of `training` and `make_for_inference` in
big_vision_tpu/input_pipeline.py. The training pipeline:

  raw example stream (DataSource, reshuffled each epoch)
    -> shuffle buffer over raw records
    -> host pp phase on a thread pool, in order
    -> local batch collate (numpy)
    -> pinned host memory, non-blocking copy to the device
    -> device pp phase: batched torch ops, randomness from a generator
       seeded from (seed, step)
    -> prefetch queue, so host work overlaps device compute

The numpy rng keys are the JAX package's: the shuffle buffer draws from
`default_rng((seed, 17))` and example i of the stream from
`default_rng((seed, i))`, so for one seed and pp string the host batches
equal the JAX pipeline's bit for bit. On the GPU the copies and the device
phase run on a side stream; the consumer's stream waits on an event.
`make_for_inference` feeds the evaluators the same way, in order and
padded (see its docstring).
"""

from __future__ import annotations

import collections
import concurrent.futures
import os
import queue as queue_lib
import threading
import warnings

import numpy as np
import torch

from big_vision_torch.datasets import core as ds_core
from big_vision_torch.pp import builder as pp_builder
# Registry side effects: the pp ops the configs name.
from big_vision_torch.pp import autoaugment  # noqa: F401
from big_vision_torch.pp import ops_general  # noqa: F401
from big_vision_torch.pp import ops_image  # noqa: F401
from big_vision_torch.pp import ops_text  # noqa: F401


def _shuffled(stream, buffer_size, rng):
  """Streaming shuffle with a reservoir buffer (tf.data shuffle semantics)."""
  buf = []
  for ex in stream:
    if len(buf) < buffer_size:
      buf.append(ex)
      continue
    j = rng.integers(0, len(buf))
    yield buf[j]
    buf[j] = ex
  rng.shuffle(buf)
  yield from buf


def _repeated(source, seed):
  """Infinite raw-example stream, reshuffled each epoch."""
  epoch = 0
  while True:
    yield from source.get_examples(ordered=False, seed=seed, epoch=epoch)
    epoch += 1


def _skipped(stream, n):
  """Drops the first n raw examples (before any pp): a resumed run's stream
  is the uninterrupted one's from that position on."""
  for _ in range(n):
    next(stream)
  return stream


def _pp_threaded(stream, pfn, num_threads, seed, chunk_size=16,
                 index_offset=0):
  """Ordered, bounded map of the host pp phase over a thread pool; example
  i of the stream gets the rng `default_rng((seed, index_offset + i))`
  whatever thread or chunk runs it."""
  if num_threads <= 1:
    for i, ex in enumerate(stream):
      yield pfn.host(ex, np.random.default_rng((seed, index_offset + i)))
    return

  def work(chunk, start):
    return [pfn.host(ex, np.random.default_rng((seed, index_offset + start
                                                + j)))
            for j, ex in enumerate(chunk)]

  def chunks():
    buf, start = [], 0
    for i, ex in enumerate(stream):
      buf.append(ex)
      if len(buf) == chunk_size:
        yield buf, start
        buf, start = [], i + 1
    if buf:
      yield buf, start

  pool = concurrent.futures.ThreadPoolExecutor(num_threads)
  window = collections.deque()
  try:
    for chunk, start in chunks():
      window.append(pool.submit(work, chunk, start))
      if len(window) >= 2 * num_threads:
        yield from window.popleft().result()
    while window:
      yield from window.popleft().result()
  finally:
    pool.shutdown(wait=False, cancel_futures=True)


def _default_threads():
  """Host pp threads where the config names none: 4 a core, 4 to 16."""
  return min(16, max(4, (os.cpu_count() or 1) * 4))


def _stack(values):
  """Stacks one key's values; a tuple value (a NaFlex image's `tuplify`)
  stacks element by element into a tuple."""
  if isinstance(values[0], tuple):
    return tuple(_stack([v[i] for v in values])
                 for i in range(len(values[0])))
  return np.stack([np.asarray(v) for v in values])


def _collate(examples):
  """Stacks a list of example dicts into numpy arrays (tuples of them for
  tuple values)."""
  return {k: _stack([e[k] for e in examples]) for k in examples[0]}


def _batched(stream, batch_size):
  buf = []
  for ex in stream:
    buf.append(ex)
    if len(buf) == batch_size:
      yield _collate(buf)
      buf = []


def _prefetched(it, depth):
  """Background-thread prefetch queue of `depth` ready items.

  Closing the returned generator stops the thread and closes `it` there.
  """
  q = queue_lib.Queue(maxsize=depth)
  stop = threading.Event()
  done = object()

  def put(x):
    while not stop.is_set():
      try:
        q.put(x, timeout=0.1)
        return True
      except queue_lib.Full:
        pass
    return False

  def run():
    try:
      for x in it:
        if not put(x):
          break
      else:
        put(done)
    except Exception as e:  # surfaced to the consumer
      put(e)
    finally:
      it.close()

  t = threading.Thread(target=run, daemon=True)
  t.start()
  try:
    while True:
      x = q.get()
      if x is done:
        return
      if isinstance(x, Exception):
        raise x
      yield x
  finally:
    stop.set()
    t.join(timeout=10)


def step_generator(seed, step, device):
  """The device phase's generator for one step, seeded from (seed, step)."""
  g = torch.Generator(device=device)
  g.manual_seed(int(np.random.SeedSequence((seed, step)).generate_state(1)[0]))
  return g


def _on_host(x):
  """Whether a batch array stays on the host (strings and bytes: the JAX
  package's `keep_on_cpu` fields, such as an eval's captions)."""
  return x.dtype.kind in "OSU"


def _to_device(batch, device, stream):
  """Numeric numpy arrays -> tensors on `device` (pinned, non-blocking),
  a tuple of them to a tuple of tensors; string arrays stay numpy arrays
  on the host."""
  def move(v):
    if isinstance(v, tuple):
      return tuple(move(x) for x in v)
    if _on_host(v):
      return v
    if device.type == "cpu":
      return torch.from_numpy(v)
    return torch.from_numpy(v).pin_memory().to(device, non_blocking=True)

  if device.type == "cpu":
    return {k: move(v) for k, v in batch.items()}
  with torch.cuda.stream(stream):
    return {k: move(v) for k, v in batch.items()}


def _device_feed(batches, pfn, device, seed, n_prefetch, step_offset=0,
                 preserve=()):
  """Local numpy batches -> device batches after the device pp phase, batch
  i with the generator of step `step_offset + i`. Keys in `preserve`, and
  the string arrays that stay on the host, skip the device pp phase."""
  stream = torch.cuda.Stream(device) if device.type == "cuda" else None

  def produce():
    try:
      for step, batch in enumerate(batches):
        batch = _to_device(batch, device, stream)
        kept = {k: batch.pop(k) for k in list(batch)
                if k in preserve or not isinstance(batch[k], torch.Tensor)}
        gen = step_generator(seed, step_offset + step, device)
        if stream is None:
          yield {**pfn.device(batch, gen), **kept}, None
          continue
        with torch.cuda.stream(stream):
          batch = {**pfn.device(batch, gen), **kept}
          ready = torch.cuda.Event()
          ready.record(stream)
        yield batch, ready
    finally:
      batches.close()

  feed = _prefetched(produce(), n_prefetch)
  try:
    for batch, ready in feed:
      if ready is not None:
        current = torch.cuda.current_stream(device)
        current.wait_event(ready)
        for v in batch.values():
          for x in v if isinstance(v, tuple) else (v,):
            if isinstance(x, torch.Tensor):
              x.record_stream(current)
      yield batch
  finally:
    feed.close()


def total_training_examples(input_config):
  """Total examples of input_config's data source."""
  return ds_core.get(**dict(input_config)["data"]).total_examples


def training(input_config, *, device="cuda", seed=0, skip_examples=0):
  """Builds the training iterator from config["input"].

  `skip_examples` drops that many raw examples from the start of the
  stream, keeping the per-example and per-batch rng keys of the
  uninterrupted stream (a resumed run's batches equal those of a run that
  was never stopped). Returns (iterator of device batches, total train
  examples).
  """
  device = torch.device(device)
  cfg = dict(input_config)
  for key in ("pack", "keep_on_cpu"):
    if cfg.get(key):
      raise ValueError(f"input.{key} is not ported")
  if isinstance(cfg["data"], (list, tuple)):
    raise ValueError("data mixtures are not ported")
  pfn = pp_builder.get_preprocess_fn(cfg.get("pp"))
  num_threads = cfg.get("num_threads")
  if num_threads is None:  # explicit 0 = inline single-threaded path
    num_threads = _default_threads()
  shuffle_buffer = cfg.get("shuffle_buffer_size")
  if not shuffle_buffer:
    warnings.warn(
        "input.shuffle_buffer_size is unset: the training stream will NOT "
        "be shuffled. Set shuffle_buffer_size, or 1 to acknowledge "
        "sequential reads.", stacklevel=2)
    shuffle_buffer = 1
  source = ds_core.get(**cfg["data"])
  raw = _shuffled(_repeated(source, seed), shuffle_buffer,
                  np.random.default_rng((seed, 17)))
  raw = _skipped(raw, skip_examples)
  examples = _pp_threaded(raw, pfn, num_threads, seed=seed,
                          index_offset=skip_examples)
  batches = _prefetched(_batched(examples, cfg["batch_size"]),
                        max(cfg.get("prefetch", 2), 1))
  it = _device_feed(batches, pfn, device, seed,
                    max(cfg.get("prefetch", 2), 1),
                    step_offset=skip_examples // cfg["batch_size"])
  return it, source.total_examples


def training_from_step(input_config, first_step, *, device="cuda", seed=0):
  """The training iterator positioned at `first_step` (sample-exact
  resume): skips first_step * batch_size raw examples."""
  skip = first_step * input_config["batch_size"]
  return training(input_config, device=device, seed=seed,
                  skip_examples=skip)[0]


def element_spec(input_config, *, seed=0):
  """{key: (shape without the batch axis, dtype)} after the full pp chain,
  from one example run through both phases on the CPU; a tuple value
  gives a tuple of those pairs."""
  cfg = dict(input_config)
  pfn = pp_builder.get_preprocess_fn(cfg.get("pp"))
  source = ds_core.get(**cfg["data"])
  ex = next(iter(source.get_examples(ordered=True)))
  ex = pfn.host(dict(ex), np.random.default_rng(seed))
  batch = _to_device(_collate([ex]), torch.device("cpu"), None)
  batch = pfn.device(batch, step_generator(seed, 0, "cpu"))
  def spec(v):
    if isinstance(v, tuple):
      return tuple(spec(x) for x in v)
    return tuple(v.shape[1:]), v.dtype
  return {k: spec(v) for k, v in batch.items()}


def _zeros_like(v):
  """Zeros of an example value's shape and dtype (a tuple: of each)."""
  if isinstance(v, tuple):
    return tuple(_zeros_like(x) for x in v)
  return np.zeros_like(np.asarray(v))


def make_for_inference(data_cfg, pp, batch_size, *, device="cuda",
                       cache_raw=False):
  """The evaluation pipeline: every example once, in order, then padding.

  Port of `make_for_inference` in big_vision_tpu/input_pipeline.py on one
  process and one device, where its per-process splits and its rounding of
  the batch to the local device count have nothing to do. The host pp
  phase runs on the training pipeline's default threads; each example
  gets `_mask` = 1, and after the last one the stream is padded with
  examples of zeros with `_mask` = 0 and `_id` = -1 up to ceil(n /
  batch_size) batches. `_mask` and `_id` skip the device pp phase (whose
  `keep` would drop them). `cache_raw` keeps the raw (pre-pp) examples in
  host memory on first use, so that later evaluations skip the source's
  IO but run the pp again. Returns (a function that makes a new iterator
  of device batches, the number of batches).
  """
  device = torch.device(device)
  source = ds_core.get(**data_cfg)
  pfn = pp_builder.get_preprocess_fn(pp)
  num_batches = -(-source.total_examples // batch_size)  # ceil

  raw_cache = []

  def raw_examples():
    if not cache_raw:
      return source.get_examples(ordered=True)
    if not raw_cache:
      raw_cache.extend(source.get_examples(ordered=True))
    return iter(raw_cache)

  def example_stream():
    capacity = num_batches * batch_size
    count, proto = 0, None
    stream = _pp_threaded(raw_examples(), pfn, _default_threads(), seed=0)
    try:
      for ex in stream:
        if count >= capacity:
          break
        ex = dict(ex, _mask=np.int32(1))
        proto = proto or {k: _zeros_like(v) for k, v in ex.items()}
        count += 1
        yield ex
    finally:
      stream.close()
    if proto is None:
      raise ValueError("the evaluation's data source is empty")
    pad = dict(proto, _mask=np.int32(0), _id=np.int64(-1))
    while count < capacity:
      count += 1
      yield dict(pad)

  def make_iter():
    batches = _batched(example_stream(), batch_size)
    return _device_feed(batches, pfn, device, 0, n_prefetch=1,
                        preserve=("_mask", "_id"))

  return make_iter, num_batches

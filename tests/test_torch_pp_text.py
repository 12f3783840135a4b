"""The port's general and text pp ops against the JAX package's, bit for
bit, on the CPU.

Each op is instantiated in both registries from one spec and run on the
same example with the same numpy rng: the host form (`run_host`; for an op
that JAX runs only on the device, its eager host run, with the key drawn
from the example's rng) and, where the op has one, the device form (the
port's batched op on a batch of one against the JAX op's per-example
function). Then the host phase of siglip_lit_coco's pp up to the
tokenizer (`decode|resize|flip_lr|value_range|flatten|choice`) on the COCO
stand-in's examples, where `flip_lr` and `value_range` run on the host
because a later op is host-only: pixels and captions equal JAX's for every
example, flips included.
"""

import numpy as np
import pytest
import torch

from big_vision_torch.datasets import core as ds_core
from big_vision_torch.pp import builder as t_builder
from big_vision_torch.pp import ops_general  # noqa: F401
from big_vision_torch.pp import ops_image  # noqa: F401
from big_vision_torch.pp import ops_text  # noqa: F401
from big_vision_torch.registry import Registry as TRegistry
from big_vision_tpu.pp import builder as j_builder
from big_vision_tpu.pp import ops_general as j_general  # noqa: F401
from big_vision_tpu.pp import ops_image as j_image  # noqa: F401
from big_vision_tpu.pp import ops_text as j_text  # noqa: F401
from big_vision_tpu.registry import Registry as JRegistry

RNG = np.random.default_rng(0)
EX = {
    "image": RNG.integers(0, 255, (4, 6, 3)).astype(np.uint8),
    "label": np.int32(3),
    "text": "A Photo of The Cat",
    "texts": np.asarray(["one fish", "two fish", "red fish", "blue fish"]),
    "boxes": RNG.uniform(size=(4, 2)).astype(np.float32),
    "vec": np.arange(6, dtype=np.float32),
    "col": np.arange(5, dtype=np.int32)[:, None],
    "empty": np.zeros((0,), np.int32),
    "nested": {"a": np.int32(1), "b": {"c": np.float32(2.0)}},
    "captions": {"text": np.asarray(["x y", "z"]), "id": np.arange(2)},
    "name": b"bird",
    "texts_id": np.asarray([1, 4, 4], np.int32),
    "_id": np.int64(7),
}


def _equal(got, want):
  if isinstance(want, dict):
    assert isinstance(got, dict) and sorted(got) == sorted(want), (got, want)
    for k in want:
      _equal(got[k], want[k])
    return
  if isinstance(want, (str, bytes)):
    assert got == want
    return
  want, got = np.asarray(want), np.asarray(got)
  assert got.dtype == want.dtype, (got.dtype, want.dtype)
  assert got.shape == want.shape and np.array_equal(got, want), (got, want)


def _both(spec):
  return (TRegistry.lookup(f"preprocess_ops.{spec}")(),
          JRegistry.lookup(f"preprocess_ops.{spec}")())


HOST_SPECS = [
    "keep('image', 'label')", "drop('image', 'texts')",
    "copy('nested', 'nested2')", "copy('label', 'image/id')",
    "setdefault('empty', 5)", "setdefault('missing', [1, 2])",
    "setdefault('label', 9)", "flatten", "flatten(keys=['captions'])",
    "rag_tensor('texts')", "reshape((3, 2), key='vec')",
    "tile((2,), key='vec')", "tile((2, 1, 3), key='vec')",
    "squeeze_last_dim(key='col')", "concat(['vec', 'vec'], outkey='v2')",
    "pad_to_shape((6, 8, 3))", "pad_to_shape((5, None, 3), where='before')",
    "pad_to_shape((7, 7, 3), pad_value=9, where='both')",
    "value_range(-1, 1)", "value_range(0, 1, 10, 200, clip_values=True)",
    "value_range(-1, 1, in_min=[0, 10, 20], in_max=[255, 200, 100])",
    "flip_lr", "onehot(10, key='label', key_result='labels')",
    "onehot(10, key='texts_id', on=0.9, off=0.1)",
    "choice(inkey='texts', outkey='text')",
    "choice(n=2, key=['texts', 'boxes'])",
    "choice(n=(1, 3), key='texts')",
    "choice(n=9, key='texts', fewer_ok=True)",
    "lower", "lower(key='name', outkey='low')",
    "strfmt('{text} number {label}', outkey='caption')", "coco_captions",
    "coco_captions(outkey='caps')",
]


@pytest.mark.parametrize("spec", HOST_SPECS)
def test_host_form_equals_jax(spec):
  t_op, j_op = _both(spec)
  for seed in range(3):
    want = j_op.run_host(dict(EX), np.random.default_rng(seed))
    got = t_op.run_host(dict(EX), np.random.default_rng(seed))
    _equal(got, dict(want))


DEVICE_SPECS = [
    "reshape((3, 2), key='vec')", "tile((2,), key='vec')",
    "tile((2, 1, 3), key='vec')", "squeeze_last_dim(key='col')",
    "concat(['vec', 'vec'], outkey='v2')", "value_range(-1, 1)",
    "value_range(-1, 1, in_min=[0, 10, 20], in_max=[255, 200, 100])",
    "onehot(10, key='label', key_result='labels')",
]
NUMERIC = ("image", "vec", "col", "label")


@pytest.mark.parametrize("spec", DEVICE_SPECS)
def test_device_form_equals_jax(spec):
  t_op, j_op = _both(spec)
  ex = {k: EX[k] for k in NUMERIC}
  want = j_op.fn(dict(ex))
  got = t_op.run_device({k: torch.from_numpy(np.asarray(v)[None])
                         for k, v in ex.items()}, None)
  _equal({k: v[0].numpy() for k, v in got.items()},
         {k: np.asarray(v) for k, v in want.items()})


@pytest.mark.parametrize("mode", [
    "eos='none'", "eos='yes'", "eos='sticky'", "eos='yes', add_bos=True",
    "eos='sticky', pad_value=1", "eos='none', lower=False",
    "eos='yes', sample_if_multi=False"])
@pytest.mark.parametrize("key", ["text", "texts"])
def test_tokenize_equals_jax(mode, key):
  spec = f"tokenize(5, {mode}, model='test(64)', inkey='{key}')"
  t_op, j_op = _both(spec)
  long = dict(EX, text="a b c d e f g h", texts=np.asarray(["a b", "c"]))
  for ex in (EX, long):
    for seed in range(3):
      _equal(t_op.run_host(dict(ex), np.random.default_rng(seed)),
             dict(j_op.run_host(dict(ex), np.random.default_rng(seed))))


def test_lookup_equals_jax(tmp_path):
  txt = tmp_path / "names.txt"
  txt.write_text("cat\nbird\ndog\n")
  sep = tmp_path / "pairs.txt"
  sep.write_text("cat:4\nbird:7\n")
  npz = tmp_path / "names.npz"
  np.savez(npz, fnames=np.asarray(["dog", "bird"]))
  for spec in (f"lookup('{txt}', key='name', outkey='id')",
               f"lookup('{sep}', sep=':', inkey='name', outkey='id')",
               f"lookup('{npz}', inkey='name', outkey='id')",
               f"lookup('{txt}', inkey='text', outkey='id')"):
    t_op, j_op = _both(spec)
    _equal(t_op.run_host(dict(EX), None), dict(j_op.run_host(dict(EX),
                                                             None)))


def test_choice_no_replacement_equals_jax(monkeypatch):
  class Fixed:
    entropy = 12345

  monkeypatch.setattr(np.random, "SeedSequence", lambda *a: Fixed())
  t_op, j_op = _both("choice_no_replacement(key='texts')")
  for i in range(9):
    ex = dict(EX, _id=np.int64(i % 2))
    _equal(t_op.run_host(dict(ex), None), dict(j_op.run_host(dict(ex),
                                                             None)))


def test_label_name_ops_are_refused():
  """No longer refused: since the class-name tables are ported, both ops
  map a class id to the JAX op's name."""
  for name in ("clip_i1k_label_names", "i21k_label_names"):
    t_op, j_op = _both(name)
    for label in (0, 3, 999):
      ex = dict(EX, label=np.int32(label))
      _equal(t_op.run_host(dict(ex), None), dict(j_op.run_host(dict(ex),
                                                               None)))


def test_lit_coco_host_phase_equals_jax():
  spec = ("decode|resize(32)|flip_lr|value_range(-1, 1)|flatten"
          "|choice(inkey='captions/text', outkey='text')"
          "|lower(key='text')|keep('image', 'text', 'image/id')")
  t_fn, j_fn = t_builder.get_preprocess_fn(spec), j_builder.get_preprocess_fn(
      spec)
  assert len(t_fn.host_ops) == len(j_fn.host_ops) == len(spec.split("|"))
  source = ds_core.get(name="synthetic", n=16, num_classes=80, h=40, w=48,
                       unique_images=16, captions=5)
  flips = 0
  for i, ex in enumerate(source.get_examples(ordered=True)):
    want = j_fn.host(dict(ex), np.random.default_rng((0, i)))
    got = t_fn.host(dict(ex), np.random.default_rng((0, i)))
    _equal(got, {k: np.asarray(v) if k != "text" else v
                 for k, v in want.items()})
    plain = t_fn.host(dict(ex), np.random.default_rng((1, i)))
    flips += not np.array_equal(plain["image"], got["image"])
  assert flips  # some examples were flipped by one rng and not the other

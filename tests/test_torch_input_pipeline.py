"""Port's input pipeline and pp ops vs the JAX package's.

Host batches: for one seed and a pp that stays on the host, the port's
training batches equal `big_vision_tpu.input_pipeline.training`'s bit for
bit (same shuffle and per-example numpy rng keys, same synthetic images).
With the device ops value_range and onehot after it, labels are equal and
images within one f32 rounding step.
`flip_lr` draws from a torch generator where JAX draws from its own keys,
so it is held against the JAX op with the port's flip decisions injected.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from big_vision_torch import input_pipeline as t_ip
from big_vision_torch.datasets import core as t_core
from big_vision_torch.pp import builder as t_builder
from big_vision_torch.pp import ops_image as t_ops_image
from big_vision_tpu import input_pipeline as j_ip
from big_vision_tpu import registry as j_registry
from big_vision_tpu.datasets import synthetic as j_synthetic
import big_vision_tpu.pp.ops_general  # noqa: F401  (JAX registrations)
import big_vision_tpu.pp.ops_image  # noqa: F401

DATA = dict(name="synthetic", n=40, num_classes=10, h=30, w=36,
            unique_images=7, encoded=False)


def _batches(module, pp, n=3, **kw):
  cfg = dict(data=DATA, batch_size=8, shuffle_buffer_size=16, num_threads=2,
             prefetch=1, pp=pp)
  it, total = module.training(cfg, seed=3, **kw)
  out = [{k: np.asarray(v) for k, v in next(it).items()} for _ in range(n)]
  it.close()
  return out, total


def test_host_batches_equal_jax_bit_for_bit():
  pp = "random_crop(24)|keep('image', 'label', '_id')"  # all on the host
  want, total = _batches(j_ip, pp)
  got, got_total = _batches(t_ip, pp, device="cpu")
  assert got_total == total == DATA["n"]
  for g, w in zip(got, want):
    assert sorted(g) == sorted(w)
    for k in w:
      # JAX holds the int64 ids as int32 (64-bit types are off in JAX).
      assert g[k].dtype == (np.int64 if k == "_id" else w[k].dtype), k
      assert g[k].shape == w[k].shape, k
      np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_device_phase_matches_jax():
  pp = ("random_crop(20)|value_range(-1, 1)"
        "|onehot(10, key='label', key_result='labels')|keep('image', 'labels')")
  want, _ = _batches(j_ip, pp)
  got, _ = _batches(t_ip, pp, device="cpu")
  for g, w in zip(got, want):
    assert sorted(g) == sorted(w) == ["image", "labels"]
    np.testing.assert_array_equal(g["labels"], w["labels"])
    assert g["image"].dtype == w["image"].dtype == np.float32
    # (x - 0) / 255 * 2 - 1 in f32: XLA may round the division differently
    # (by a reciprocal), so the bar is one f32 rounding step near 1.
    np.testing.assert_allclose(g["image"], w["image"], rtol=0, atol=2.4e-7)


def test_synthetic_source_equals_jax():
  src = t_core.get(**DATA)
  jsrc = j_synthetic.DataSource(**{k: v for k, v in DATA.items()
                                   if k != "name"})
  for g, w in zip(src.get_examples(ordered=False, seed=1, epoch=2),
                  jsrc.get_examples(ordered=False, seed=1, epoch=2)):
    for k in w:
      np.testing.assert_array_equal(g[k], w[k])
  # encoded=True (the default): the same JPEG bytes.
  src = t_core.get(**{**DATA, "encoded": True})
  jsrc = j_synthetic.DataSource(**{k: v for k, v in DATA.items()
                                   if k not in ("name", "encoded")})
  n = 0
  for g, w in zip(src.get_examples(ordered=True), jsrc.get_examples(
      ordered=True), strict=True):
    assert isinstance(g["image"], bytes) and g["image"] == w["image"]
    assert g["label"] == w["label"] and g["_id"] == w["_id"]
    n += 1
  assert n == DATA["n"]


def test_pp_splits_like_jax():
  pp = ("random_crop(24)|flip_lr|value_range(-1, 1)"
        "|onehot(10, key='label', key_result='labels')|keep('image', 'labels')")
  from big_vision_tpu.pp import builder as j_builder
  got, want = t_builder.get_preprocess_fn(pp), j_builder.get_preprocess_fn(pp)
  assert got.host_end == want.host_end == 0
  assert [o.name for o in got.device_ops] == [o.name for o in want.device_ops]


def test_flip_lr_matches_jax_with_injected_decisions(monkeypatch):
  rs = np.random.RandomState(0)
  images = rs.randint(0, 255, (6, 5, 7, 3)).astype(np.uint8)
  op = t_builder.get_preprocess_fn("flip_lr").device_ops[0]
  gen = torch.Generator().manual_seed(11)
  flips = torch.rand(6, generator=torch.Generator().manual_seed(11)) < 0.5
  assert 0 < int(flips.sum()) < 6
  got = op.run_device({"image": torch.from_numpy(images)}, gen)["image"]
  torch.testing.assert_close(
      got, t_ops_image.flip_images(torch.from_numpy(images), flips))
  jop = j_registry.Registry.lookup("preprocess_ops.flip_lr")()
  for i in range(6):
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, f=bool(flips[i]): jnp.asarray(f))
    want = jop.run_device({"image": jnp.asarray(images[i])},
                          jax.random.PRNGKey(0))["image"]
    np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_closing_the_iterator_stops_its_threads():
  before = threading.active_count()
  cfg = dict(data=DATA, batch_size=8, shuffle_buffer_size=16, num_threads=2,
             prefetch=2, pp="random_crop(24)|flip_lr|value_range(-1, 1)")
  it, _ = t_ip.training(cfg, device="cpu", seed=0)
  for _ in range(2):
    next(it)
  it.close()
  deadline = time.time() + 10
  while threading.active_count() > before and time.time() < deadline:
    time.sleep(0.05)
  assert threading.active_count() <= before

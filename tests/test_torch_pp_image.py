"""Port's image pp ops vs the JAX package's, on the same examples and rngs.

Host ops are held bit for bit (uint8 outputs) against the JAX ops run on
the same example with the same `np.random.default_rng`: `decode` (JPEG,
PNG, one channel), `decode_jpeg_and_inception_crop` (the native fused
resize, the PIL resize of other methods and of `antialias`, a PNG through
PIL, no size), `decode_jpeg_and_inception_crop_yuv` (4:2:0 and 4:4:4
planes, and the host conversion of a 4:2:2 JPEG), `resize_small` (area and
bilinear on uint8), `central_crop` (sized and largest square) and
`inception_crop` (the transfer config's crop of a decoded image); the
inception box draws alone over many shapes and seeds. Float outputs are
held within 1e-4: `yuv420_to_rgb` (the port's batched op against the JAX
op vmapped over the batch), its chroma upsample alone against
`jax.image.resize(uv, (2, s, s), "linear")`, edge pixels included, and
`resize_small(area)` of a float image. The YUV path against the RGB path
meets the JAX package's own bar (tests/test_native.py). `resize`: its host
form bit for bit on uint8 (PIL, as in JAX) and within 1e-3 on floats
(`jax.image.resize`), and its device form (after a staticizer, batched)
against the JAX op vmapped over the batch, for every method, with and
without `antialias`, up and down: floats within 1e-3 (of values up to
255), uint8 within 1 (f32 sums in another order may cross an integer
before the cast truncates).
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from big_vision_torch.pp import builder as t_builder
from big_vision_torch.pp import ops_image as t_ops
from big_vision_tpu.pp import builder as j_builder
from big_vision_tpu.pp import ops_image as j_ops
import big_vision_tpu.pp.ops_general  # noqa: F401  (JAX registrations)


def encode(arr, fmt="JPEG", **kw):
  buf = io.BytesIO()
  Image.fromarray(arr).save(buf, format=fmt, **kw)
  return buf.getvalue()


def image(h, w, seed=0, smooth=False):
  rng = np.random.default_rng(seed)
  arr = rng.integers(0, 255, (h, w, 3), np.uint8)
  if smooth:  # chroma subsampling then loses little
    arr = np.asarray(Image.fromarray(arr[:8, :10]).resize((w, h),
                                                          Image.BILINEAR))
  return arr


JPEG = encode(image(48, 60), quality=90)
JPEG_444 = encode(image(41, 37, 1), quality=90, subsampling=0)
JPEG_422 = encode(image(40, 52, 2), quality=90, subsampling=1)
PNG = encode(image(30, 44, 3), fmt="PNG")
GRAY = encode(image(30, 34, 4)[..., 0])


def host_both(spec, data, seed=0):
  """(port, JAX) host-phase outputs of `spec` on `data` with one rng."""
  ex = {"image": data, "label": np.int32(3)}
  got = t_builder.get_preprocess_fn(spec).host(
      dict(ex), np.random.default_rng(seed))
  want = j_builder.get_preprocess_fn(spec).host(
      dict(ex), np.random.default_rng(seed))
  assert sorted(got) == sorted(want)
  return got, want


def assert_equal(got, want):
  for k in want:
    np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                  err_msg=k)
    assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


@pytest.mark.parametrize("spec,data", [
    ("decode", JPEG), ("decode", JPEG_444), ("decode", PNG),
    ("decode(channels=1)", GRAY), ("decode(channels=1)", JPEG),
    ("decode(channels=4)", PNG),
])
def test_decode_equals_jax(spec, data):
  assert_equal(*host_both(spec, data))


@pytest.mark.parametrize("spec", [
    "decode_jpeg_and_inception_crop(24)",
    "decode_jpeg_and_inception_crop((20, 28), area_min=30)",
    "decode_jpeg_and_inception_crop(24, method='bicubic')",
    "decode_jpeg_and_inception_crop(24, antialias=True)",
    "decode_jpeg_and_inception_crop(24, method='area')",
    "decode_jpeg_and_inception_crop",
])
@pytest.mark.parametrize("data", [JPEG, JPEG_444, PNG],
                         ids=["jpeg", "jpeg444", "png"])
def test_decode_jpeg_and_inception_crop_equals_jax(spec, data):
  for seed in range(4):
    assert_equal(*host_both(spec, data, seed))


@pytest.mark.parametrize("data", [JPEG, JPEG_444, JPEG_422],
                         ids=["420", "444", "422"])
def test_decode_jpeg_and_inception_crop_yuv_equals_jax(data):
  for seed in range(4):
    got, want = host_both("decode_jpeg_and_inception_crop_yuv(16)", data,
                          seed)
    assert got["image_y"].shape == (16, 16)
    assert got["image_uv"].shape == (2, 8, 8)
    assert_equal(got, want)


def test_inception_box_draws_equal_jax():
  for seed in range(50):
    for h, w in ((48, 60), (256, 320), (17, 200), (301, 7)):
      args = (h, w, 0.05, 1.0, 0.75, 1.33)
      got = t_ops._sample_inception_box(np.random.default_rng(seed), *args)
      want = j_ops._sample_inception_box(np.random.default_rng(seed), *args)
      assert got == want, (seed, h, w)


@pytest.mark.parametrize("spec", [
    "decode|resize_small(20)", "decode|resize_small(37)",
    "decode|resize_small(30, method='bilinear')",
    "decode|central_crop(16)", "decode|central_crop((10, 21))",
    "decode|central_crop", "decode|resize_small(36)|central_crop(32)",
])
def test_eval_host_ops_equal_jax(spec):
  for data in (JPEG, JPEG_444, PNG):
    assert_equal(*host_both(spec, data))


@pytest.mark.parametrize("spec", [
    "decode|inception_crop(24)", "decode|inception_crop",
    "decode|inception_crop(20, area_min=50, method='nearest')",
])
def test_inception_crop_equals_jax(spec):
  for seed, data in enumerate((JPEG, JPEG_444, PNG)):
    assert_equal(*host_both(spec, data, seed))


def test_resize_small_area_of_floats_equals_jax():
  img = np.random.default_rng(5).normal(size=(23, 31, 2)).astype(np.float32)
  for size in (9, 16, 40):
    got = t_builder.get_preprocess_fn(f"resize_small({size})").host(
        {"image": img}, None)["image"]
    want = j_builder.get_preprocess_fn(f"resize_small({size})").host(
        {"image": img}, None)["image"]
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)


def test_central_crop_on_the_device_equals_jax():
  imgs = np.random.default_rng(6).normal(size=(3, 20, 26, 3)).astype(
      np.float32)
  pp = "random_crop(20)|central_crop((12, 15))"  # the crop after a crop
  t_pfn = t_builder.get_preprocess_fn(pp)
  assert [op.name for op in t_pfn.device_ops] == ["central_crop((12, 15))"]
  got = t_pfn.device({"image": torch.from_numpy(imgs)}, None)["image"]
  j_pfn = j_builder.get_preprocess_fn(pp)
  assert len(j_pfn.device_ops) == 1
  want = j_pfn.device({"image": jnp.asarray(imgs)},
                      jax.random.PRNGKey(0))["image"]
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chroma_upsample_equals_jax_image_resize():
  """F.interpolate(bilinear, align_corners=False) is jax.image.resize's
  "linear" at an exact 2x upsample, the edges included."""
  uv = np.random.default_rng(7).uniform(0, 255, (2, 2, 7, 7)).astype(
      np.float32)
  got = F.interpolate(torch.from_numpy(uv), size=(14, 14), mode="bilinear",
                      align_corners=False).numpy()
  for i in range(2):
    want = jax.image.resize(jnp.asarray(uv[i]), (2, 14, 14), "linear")
    np.testing.assert_allclose(got[i], np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[i][:, [0, -1]],
                               np.asarray(want)[:, [0, -1]], atol=1e-4)


def test_yuv420_to_rgb_equals_jax():
  rng = np.random.default_rng(8)
  y = rng.integers(0, 256, (3, 16, 16), np.uint8)
  uv = rng.integers(0, 256, (3, 2, 8, 8), np.uint8)
  got = t_builder.get_preprocess_fn("yuv420_to_rgb").device(
      {"image_y": torch.from_numpy(y), "image_uv": torch.from_numpy(uv)},
      None)
  want = j_builder.get_preprocess_fn("yuv420_to_rgb").device(
      {"image_y": jnp.asarray(y), "image_uv": jnp.asarray(uv)},
      jax.random.PRNGKey(0))
  assert sorted(got) == ["image"] and got["image"].dtype == torch.float32
  assert got["image"].shape == (3, 16, 16, 3)
  np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]),
                             atol=1e-4, rtol=0)


def test_yuv_path_is_close_to_the_rgb_path():
  """The JAX package's bar for the YUV path against the RGB decode of a
  smooth image, one box for both (area and ratio pinned)."""
  raw = encode(image(256, 320, 9, smooth=True), quality=95)
  box = "area_min=100, area_max=100, ratio_min=1.0, ratio_max=1.0"
  yuv = t_builder.get_preprocess_fn(
      f"decode_jpeg_and_inception_crop_yuv(128, {box})|yuv420_to_rgb")
  ex = yuv.host({"image": raw}, np.random.default_rng(3))
  got = yuv.device({k: torch.from_numpy(v[None]) for k, v in ex.items()},
                   None)["image"][0].numpy()
  want = t_builder.get_preprocess_fn(
      f"decode_jpeg_and_inception_crop(128, {box})").host(
          {"image": raw}, np.random.default_rng(3))["image"]
  diff = np.abs(got - want.astype(np.float32))
  assert got.shape == want.shape == (128, 128, 3)
  assert diff.mean() < 3.0 and np.percentile(diff, 99) < 12.0


RESIZE_METHODS = ["bilinear", "bicubic", "nearest", "lanczos3", "lanczos5",
                  "area"]


@pytest.mark.parametrize("method", RESIZE_METHODS)
def test_resize_on_the_host_equals_jax(method):
  for size in ("(20, 27)", "(61, 50)"):
    spec = f"decode|resize({size}, method='{method}')"
    assert_equal(*host_both(spec, JPEG))
    assert_equal(*host_both(spec, PNG))
  img = np.random.default_rng(7).uniform(0, 255, (23, 31, 2)).astype(
      np.float32)
  for size in (9, 40):
    spec = f"resize({size}, method='{method}', antialias=True)"
    got = t_builder.get_preprocess_fn(spec).host({"image": img}, None)
    want = j_builder.get_preprocess_fn(spec).host({"image": img}, None)
    assert got["image"].shape == (size, size, 2)
    np.testing.assert_allclose(got["image"], np.asarray(want["image"]),
                               atol=1e-3, rtol=0)


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("method", RESIZE_METHODS)
def test_resize_on_the_device_equals_jax(method, antialias):
  rng = np.random.default_rng(8)
  for dtype, tol in ((np.float32, 1e-3), (np.uint8, 1)):
    imgs = (rng.uniform(0, 255, (2, 26, 30, 3))).astype(dtype)
    for size in ((17, 21), (40, 33)):
      pp = f"random_crop(24)|resize({size}, '{method}', {antialias})"
      t_pfn = t_builder.get_preprocess_fn(pp)
      j_pfn = j_builder.get_preprocess_fn(pp)
      assert [op.name for op in t_pfn.device_ops] == [pp.split("|")[1]]
      assert len(j_pfn.device_ops) == 1
      crop = imgs[:, 1:25, 3:27]
      got = t_pfn.device({"image": torch.from_numpy(crop)}, None)["image"]
      want = j_pfn.device({"image": jnp.asarray(crop)},
                          jax.random.PRNGKey(0))["image"]
      assert got.shape == (2, *size, 3) and got.numpy().dtype == dtype
      np.testing.assert_allclose(got.numpy().astype(np.float64),
                                 np.asarray(want).astype(np.float64),
                                 atol=tol, rtol=0)


def test_small_host_resizes_are_computed_once():
  """A small image's host resize is kept (read-only, the same values as
  the PIL resize); a large one's is computed anew each time."""
  pfn = t_builder.get_preprocess_fn("resize(36)")
  rng = np.random.RandomState(0)
  small = rng.randint(0, 255, (8, 8, 3)).astype(np.uint8)
  large = rng.randint(0, 255, (80, 80, 3)).astype(np.uint8)
  a, b = (pfn.host({"image": small.copy()}, None)["image"] for _ in "ab")
  assert a is b and not a.flags.writeable
  np.testing.assert_array_equal(
      a, t_ops._pil_resize(small, (36, 36), "bilinear", False))
  c, d = (pfn.host({"image": large}, None)["image"] for _ in "cd")
  assert c is not d
  np.testing.assert_array_equal(c, d)

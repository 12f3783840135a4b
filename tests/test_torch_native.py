"""Port's JPEG decoder (big_vision_torch/native) vs the JAX package's.

Both compile the same dataio.cc arithmetic and link a libjpeg of ABI 62,
so every output must be equal bit for bit: the full decode (also equal to
PIL's), crops, crops with the fused resize (and the IDCT downscale), the
YUV 4:2:0 planes (of 4:2:0 and 4:4:4 JPEGs), `jpeg_size` and the threaded
batch. A corrupt JPEG raises in both; a JPEG that is neither 4:2:0 nor
4:4:4 raises `NotYuv420`. The decoder also builds against Pillow's bundled
libjpeg and decodes the same bytes, and a machine with no libjpeg gets an
error that says so.
"""

import ctypes
import io

import numpy as np
import pytest
from PIL import Image

from big_vision_torch import native as t_native
from big_vision_tpu import native as j_native


def jpeg(h=48, w=56, seed=0, subsampling=-1, mode="RGB"):
  arr = np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)
  buf = io.BytesIO()
  Image.fromarray(arr).convert(mode).save(buf, format="JPEG", quality=90,
                                          subsampling=subsampling)
  return buf.getvalue()


IMAGES = {
    "420": jpeg(48, 56),
    "420_odd": jpeg(37, 53, seed=1),
    "444": jpeg(40, 48, seed=2, subsampling=0),
    "422": jpeg(40, 48, seed=3, subsampling=1),
    "gray": jpeg(33, 41, seed=4, mode="L"),
}
# (y0, x0, h, w) crop boxes and output sizes: inside, on the edges,
# overhanging (clamped), a one-pixel box, and the whole image.
CROPS = [(5, 7, 20, 24), (0, 0, 33, 40), (30, 40, 20, 30), (3, 3, 1, 1),
         None]
SIZES = [None, (16, 16), (24, 10), (8, 8)]


def test_linked_library_is_found():
  assert t_native.linked_library() == t_native.find_libjpeg()


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_jpeg_size_and_full_decode_equal_jax_and_pil(name):
  data = IMAGES[name]
  assert t_native.jpeg_size(data) == j_native.jpeg_size(data)
  got = t_native.decode_crop_resize(data)
  np.testing.assert_array_equal(got, j_native.decode_crop_resize(data))
  pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
  np.testing.assert_array_equal(got, pil)


@pytest.mark.parametrize("name", ["420", "420_odd", "444", "gray"])
def test_crop_and_resize_equal_jax(name):
  data = IMAGES[name]
  for crop in CROPS:
    for size in SIZES:
      if crop is None and size is None:
        continue
      got = t_native.decode_crop_resize(data, crop=crop, out_size=size)
      want = j_native.decode_crop_resize(data, crop=crop, out_size=size)
      np.testing.assert_array_equal(got, want, err_msg=f"{crop} {size}")


def test_idct_downscale_equals_jax():
  data = jpeg(256, 320, seed=5)
  for crop, size in (((0, 0, 256, 320), (56, 56)),
                     ((10, 20, 200, 180), (24, 24)),
                     ((0, 0, 256, 320), (30, 16))):
    np.testing.assert_array_equal(
        t_native.decode_crop_resize(data, crop=crop, out_size=size),
        j_native.decode_crop_resize(data, crop=crop, out_size=size))


@pytest.mark.parametrize("name", ["420", "420_odd", "444"])
def test_yuv420_planes_equal_jax(name):
  data = IMAGES[name]
  for crop in CROPS:
    for out in (16, 8, 2):
      gy, guv = t_native.decode_crop_resize_yuv420(data, crop, out)
      wy, wuv = j_native.decode_crop_resize_yuv420(data, crop, out)
      assert gy.shape == (out, out) and guv.shape == (2, out // 2, out // 2)
      np.testing.assert_array_equal(gy, wy, err_msg=f"{crop} {out}")
      np.testing.assert_array_equal(guv, wuv, err_msg=f"{crop} {out}")


@pytest.mark.parametrize("name", ["422", "gray"])
def test_yuv420_refuses_other_layouts(name):
  with pytest.raises(t_native.NotYuv420):
    t_native.decode_crop_resize_yuv420(IMAGES[name], None, 8)
  with pytest.raises(ValueError):
    j_native.decode_crop_resize_yuv420(IMAGES[name], None, 8)


def test_batch_equals_jax_and_single_decodes():
  datas = [jpeg(40 + s, 50, seed=s) for s in range(6)]
  crops = np.asarray([[s, 2 * s, 30, 40] for s in range(6)], np.int32)
  for c in (crops, None):
    got = t_native.decode_crop_resize_batch(datas, c, (20, 24), nthreads=3)
    np.testing.assert_array_equal(
        got, j_native.decode_crop_resize_batch(datas, c, (20, 24),
                                               nthreads=3))
  np.testing.assert_array_equal(
      got[4], t_native.decode_crop_resize(datas[4], out_size=(20, 24)))


@pytest.mark.parametrize("data", [b"\xff\xd8\xffgarbage", b"",
                                  IMAGES["420"][:60]])
def test_corrupt_jpeg_raises(data):
  with pytest.raises(ValueError):
    t_native.decode_crop_resize(data, crop=(0, 0, 10, 10), out_size=(8, 8))
  with pytest.raises(ValueError):
    j_native.decode_crop_resize(data, crop=(0, 0, 10, 10), out_size=(8, 8))
  with pytest.raises(ValueError, match="Corrupt JPEG header"):
    t_native.jpeg_size(data)
  with pytest.raises(ValueError):
    t_native.decode_crop_resize_batch([IMAGES["420"], data], None, (8, 8))


def test_builds_against_pillows_libjpeg(tmp_path):
  """The second library of the search, linked by full path with an rpath,
  decodes the same bytes as the library the port links here."""
  libjpeg = t_native._pillow_libjpeg()  # pylint: disable=protected-access
  if libjpeg is None:
    pytest.skip("this Pillow bundles no libjpeg")
  out = tmp_path / "dataio.so"
  t_native._build(libjpeg, out)  # pylint: disable=protected-access
  lib = ctypes.CDLL(str(out))
  fn = lib.bvt_decode_crop_resize
  fn.argtypes = t_native._SIGNATURES["bvt_decode_crop_resize"]
  data = IMAGES["420_odd"]
  got = np.empty((37, 53, 3), np.uint8)
  assert fn(data, len(data), 0, 0, 0, 0, 37, 53, t_native._u8(got)) == 0
  np.testing.assert_array_equal(got, t_native.decode_crop_resize(data))


def test_no_libjpeg_is_an_error(monkeypatch):
  monkeypatch.setattr(t_native, "_system_libjpeg", lambda: None)
  monkeypatch.setattr(t_native, "_pillow_libjpeg", lambda: None)
  with pytest.raises(RuntimeError, match="no libjpeg"):
    t_native.find_libjpeg()

"""Image preprocessing ops: port of big_vision_tpu/pp/ops_image.py.

Host ops (per example, numpy, in loader threads): `decode`,
`decode_jpeg_and_inception_crop`, `decode_jpeg_and_inception_crop_yuv`,
`resize_small`, `resize`, `random_crop` and `central_crop`. JPEGs are decoded by the
port's native decoder (`big_vision_torch/native`, GIL-free, bit-equal to
PIL's full decode); PIL decodes only what the JAX package never sends to
its native code: other formats, and `decode` with `channels != 3`. Crop
boxes and corners are drawn from the example's numpy rng exactly as the
JAX host implementations draw them.

Device ops (batched torch on the batch's device): `yuv420_to_rgb`,
`flip_lr`, and `resize` and `central_crop` where an earlier op already made
shapes static. The device `resize` computes `jax.image.resize` (or, for
"area", the JAX package's exact area resize) as two products with per-axis
weight matrices built in numpy.
"""

from __future__ import annotations

import io

import numpy as np
import torch
import torch.nn.functional as F

from big_vision_torch import native
from big_vision_torch.pp.utils import InKeyOutKey, PPOp, as_pp_op, maybe_repeat
from big_vision_torch.pp.utils import host_uniform
from big_vision_torch.registry import Registry

# TF resize method name -> PIL filter name ("area" has its own exact
# implementation, _area_resize).
_PIL_FILTERS = {
    "bilinear": "BILINEAR",
    "bicubic": "BICUBIC",
    "nearest": "NEAREST",
    "lanczos3": "LANCZOS",
    "lanczos5": "LANCZOS",
}


def _area_window(isize, osize):
  """Fractional-coverage box-filter window for one axis, as TF's
  `resize(method="area")` weighs it: input pixels averaged with their
  exact coverage of each output cell [i*scale, (i+1)*scale). Returns (idx
  [o, k], w [o, k]) with out[i] = sum_k w[i, k] * in[idx[i, k]]."""
  scale = isize / osize
  kmax = int(np.ceil(scale)) + 1
  i = np.arange(osize)
  a, b = i * scale, (i + 1) * scale
  ks = np.floor(a).astype(np.int64)[:, None] + np.arange(kmax)[None, :]
  w = np.minimum(ks + 1.0, b[:, None]) - np.maximum(ks, a[:, None])
  w = np.clip(w, 0.0, None).astype(np.float32)
  w /= w.sum(1, keepdims=True)
  return np.clip(ks, 0, isize - 1), w


def _area_resize(image, size):
  """Exact area resize over the first two axes, in f32."""
  out = np.asarray(image, np.float32)
  for axis, osize in enumerate(size):
    idx, w = _area_window(image.shape[axis], osize)
    moved = np.moveaxis(out, axis, 0)
    # [o, k, ...rest] gather, then contract the window axis.
    out = np.moveaxis(np.einsum("ok,ok...->o...", w, moved[idx]), 0, axis)
  return out


def _clip_cast(img_f32, ref_dtype):
  """TF-resize semantics: clip to the range of an integer dtype, cast."""
  if np.issubdtype(ref_dtype, np.integer):
    info = np.iinfo(ref_dtype)
    img_f32 = np.clip(img_f32, info.min, info.max)
  return img_f32.astype(ref_dtype)


# jax.image.resize's kernels, of the distance |x| in input pixels.
def _triangle(x):
  return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x):
  out = ((1.5 * x - 2.5) * x) * x + 1.0
  out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
  return np.where(x >= 2.0, 0.0, out)


def _lanczos(radius):
  def kernel(x):
    y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
    safe = np.where(x != 0, np.pi ** 2 * x ** 2, 1.0)
    out = np.where(x > 1e-3, y / safe, 1.0)
    return np.where(x > radius, 0.0, out)
  return kernel


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic,
            "lanczos3": _lanczos(3.0), "lanczos5": _lanczos(5.0)}


def _resize_matrix(isize, osize, method, antialias):
  """[osize, isize] f32: one axis of a resize, out = matrix @ in. "area" is
  the exact windowed mean (`_area_window`); the other methods weigh as
  `jax.image.resize` does (its `compute_weight_mat`, with the kernel widened
  by the scale when `antialias` and downsampling, and the weights of each
  output normalized)."""
  if method == "area":
    idx, w = _area_window(isize, osize)
    mat = np.zeros((osize, isize), np.float32)
    np.add.at(mat, (np.arange(osize)[:, None], idx), w)
    return mat
  inv_scale = isize / osize
  kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
  sample = ((np.arange(osize, dtype=np.float32) + 0.5) * np.float32(inv_scale)
            - 0.5)
  dist = np.abs(sample[:, None] - np.arange(isize, dtype=np.float32)[None])
  weights = _KERNELS[method](dist / np.float32(kernel_scale)).astype(
      np.float32)
  total = weights.sum(axis=1, keepdims=True)
  weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                     weights / np.where(total != 0, total, 1.0), 0.0)
  inside = (sample >= -0.5) & (sample <= isize - 0.5)
  return np.where(inside[:, None], weights, 0.0).astype(np.float32)


def _nearest_index(isize, osize):
  """The input row of each output row in jax.image.resize("nearest"), in
  f32 with the ratio folded into one factor, as XLA computes it."""
  ratio = np.float32(isize) * np.float32(1 / osize)
  offsets = (np.arange(osize, dtype=np.float32) + np.float32(0.5)) * ratio
  return np.floor(offsets).astype(np.int64)


def _clip_cast_torch(img_f32, dtype):
  """`_clip_cast` of a tensor."""
  if not dtype.is_floating_point:
    info = torch.iinfo(dtype)
    img_f32 = img_f32.clamp(info.min, info.max)
  return img_f32.to(dtype)


def resize_batch(images, size, method="bilinear", antialias=False):
  """images [N, H, W, C] resized to `size` (h, w) on their device, as the
  JAX package's device `resize` computes each image: in f32, then clipped
  to the range of an integer dtype and cast back."""
  dtype = images.dtype
  if method == "nearest":
    for axis, osize in zip((1, 2), size):
      index = torch.from_numpy(_nearest_index(images.shape[axis], osize))
      images = images.index_select(axis, index.to(images.device))
    return images
  out = images.to(torch.float32)
  for axis, osize in zip((1, 2), size):
    if out.shape[axis] == osize:
      continue  # the identity, which jax.image.resize skips
    mat = torch.from_numpy(_resize_matrix(out.shape[axis], osize, method,
                                          antialias)).to(out.device)
    out = torch.movedim(torch.tensordot(mat, out, dims=([1], [axis])), 0,
                        axis)
  return _clip_cast_torch(out, dtype)


def _pil_resize(image, size, method, antialias):
  """Host resize of an HWC image, as the JAX package's: "area" by the exact
  windowed sum, uint8 images of the other methods through PIL, of any
  channel count (PIL's filters antialias where they downscale, whatever
  `antialias` says), and other dtypes as `jax.image.resize` computes
  them."""
  from PIL import Image
  image = np.asarray(image)
  dtype = image.dtype
  if method == "area":
    return _clip_cast(_area_resize(image, size), dtype)
  if dtype != np.uint8:
    return resize_batch(torch.from_numpy(image[None]), size, method,
                        antialias)[0].numpy()
  pil_filter = getattr(Image.Resampling, _PIL_FILTERS[method])
  h, w = size
  if image.shape[-1] == 3:  # one RGB resize
    return np.asarray(
        Image.fromarray(image).resize((w, h), pil_filter), dtype)
  chans = [
      np.asarray(Image.fromarray(image[..., c]).resize((w, h), pil_filter))
      for c in range(image.shape[-1])
  ]
  return np.stack(chans, axis=-1).astype(dtype)


def _is_jpeg(b):
  return isinstance(b, bytes) and b[:3] == b"\xff\xd8\xff"


@Registry.register("preprocess_ops.decode")
def get_decode(channels=3, precise=False, key="image", inkey=None,
               outkey=None):
  """Decodes JPEG/PNG bytes to uint8 HWC (host): JPEGs with 3 channels by
  the native decoder, anything else by PIL."""
  del precise  # Both paths use libjpeg's accurate integer IDCT.
  from PIL import Image
  ik, ok = inkey or key, outkey or key

  def _decode(data):
    raw = data[ik]
    if channels == 3 and _is_jpeg(raw):
      arr = native.decode_crop_resize(raw)
    else:
      img = Image.open(io.BytesIO(raw))
      img = img.convert({1: "L", 3: "RGB", 4: "RGBA"}[channels])
      arr = np.asarray(img, np.uint8)
      if arr.ndim == 2:
        arr = arr[:, :, None]
    data = dict(data)
    data[ok] = arr
    return data

  return PPOp(host_fn=_decode, phase="host", name="decode")


# Host resizes of images up to this size are kept (`_SmallResizes`).
SMALL_IMAGE_BYTES, SMALL_CACHE_BYTES = 16 * 1024, 64 * 2**20


@Registry.register("preprocess_ops.resize")
def get_resize(size, method="bilinear", antialias=False, key="image",
               inkey=None, outkey=None):
  """Resizes to `size` ([h, w], or one number for both): on the host as the
  JAX package's host form (`_pil_resize`), or batched on the device as its
  device form (`resize_batch`); a staticizer."""
  size = tuple(maybe_repeat(size, 2))
  ik, ok = inkey or key, outkey or key
  small = _SmallResizes()

  def _dev(batch):
    batch = dict(batch)
    batch[ok] = resize_batch(batch[ik], size, method, antialias)
    return batch

  def _host(data):
    data = dict(data)
    image = np.asarray(data[ik])
    data[ok] = small.get(image)
    if data[ok] is None:
      data[ok] = small.keep(image, _pil_resize(image, size, method,
                                               antialias))
    return data

  return PPOp(fn=_dev, host_fn=_host, staticizer=True, name="resize")


class _SmallResizes:
  """The host resizes of small images (SMALL_IMAGE_BYTES at most in and
  out), each computed once: a dataset of small images, such as 8x8 digit
  scans, repeats them every epoch, and the PIL call costs a loader thread
  some 100 us of the interpreter lock for each. At most SMALL_CACHE_BYTES
  of results are kept, read-only."""

  def __init__(self):
    self.cache, self.bytes = {}, 0

  @staticmethod
  def _key(image):
    return image.shape, image.dtype.str, image.tobytes()

  def get(self, image):
    if image.nbytes > SMALL_IMAGE_BYTES:
      return None
    return self.cache.get(self._key(image))

  def keep(self, image, out):
    if (image.nbytes <= SMALL_IMAGE_BYTES and out.nbytes <= SMALL_IMAGE_BYTES
        and self.bytes + out.nbytes <= SMALL_CACHE_BYTES):
      out = np.array(out)
      out.flags.writeable = False
      self.cache[self._key(image)] = out
      self.bytes += out.nbytes
    return out


def _host_resize_factor(image, factor, method, antialias):
  h, w = image.shape[0], image.shape[1]
  nh, nw = int(round(h * factor)), int(round(w * factor))
  return _pil_resize(image, (nh, nw), method, antialias)


@Registry.register("preprocess_ops.resize_small")
def get_resize_small(smaller_size, method="area", antialias=False, key="image",
                     inkey=None, outkey=None):
  """Resizes so that the smaller side is `smaller_size`, keeping the
  aspect (host)."""
  ik, ok = inkey or key, outkey or key

  def _op(data):
    img = np.asarray(data[ik])
    factor = smaller_size / min(img.shape[0], img.shape[1])
    data = dict(data)
    data[ok] = _host_resize_factor(img, factor, method, antialias)
    return data

  return PPOp(host_fn=_op, phase="host", name="resize_small")


def _sample_inception_box(np_rng, h, w, area_min, area_max, ratio_min,
                          ratio_max, max_tries=100):
  """Samples a crop box (y0, x0, h, w) whose area and aspect lie in range,
  with the JAX package's draws from `np_rng`.

  tf.image.sample_distorted_bounding_box's GenerateRandomCrop
  (min_object_covered=0): per attempt, the aspect ratio uniform, the crop
  height uniform between the heights that the area range allows, the
  width rounded from the aspect, one row added or taken to stay inside
  the area bounds; the position uniform. The full image after `max_tries`.
  """
  min_area = area_min * h * w
  max_area = area_max * h * w
  for _ in range(max_tries):
    aspect = np_rng.uniform(ratio_min, ratio_max)
    ch = int(round(np.sqrt(min_area / aspect)))
    max_h = int(round(np.sqrt(max_area / aspect)))
    if round(max_h * aspect) > w:
      # Largest height whose rounded width still fits.
      max_h = int((w + 0.5 - 1e-7) / aspect)
    max_h = min(max_h, h)
    if ch >= max_h:
      ch = max_h
    else:
      ch += int(np_rng.integers(0, max_h - ch + 1))
    cw = int(round(ch * aspect))
    area = cw * ch
    if area < min_area:
      ch += 1
      cw = int(round(ch * aspect))
      area = cw * ch
    if area > max_area:
      ch -= 1
      cw = int(round(ch * aspect))
      area = cw * ch
    if (area < min_area or area > max_area or cw > w or ch > h
        or cw <= 0 or ch <= 0):
      continue
    y0 = int(np_rng.integers(0, h - ch + 1)) if ch < h else 0
    x0 = int(np_rng.integers(0, w - cw + 1)) if cw < w else 0
    return y0, x0, ch, cw
  return 0, 0, h, w


@Registry.register("preprocess_ops.decode_jpeg_and_inception_crop")
def get_decode_jpeg_and_inception_crop(
    size=None, area_min=5, area_max=100, ratio_min=0.75, ratio_max=1.33,
    method="bilinear", antialias=False, key="image", inkey=None, outkey=None):
  """Fused decode and inception crop (host), then an optional resize.

  A JPEG is decoded by the native decoder in its crop window only (with
  the IDCT downscale and the bilinear resize fused in, where `size` is set
  with method "bilinear" and no `antialias`; else the crop is resized on
  the host by `_pil_resize`). Other formats go through PIL.
  """
  from PIL import Image
  ik, ok = inkey or key, outkey or key
  use_native_resize = size and method == "bilinear" and not antialias

  def _op(data, np_rng):
    raw = data[ik]
    if _is_jpeg(raw):
      h, w = native.jpeg_size(raw)
      y0, x0, ch, cw = _sample_inception_box(
          np_rng, h, w, area_min / 100, area_max / 100, ratio_min, ratio_max)
      out_size = maybe_repeat(size, 2) if use_native_resize else None
      crop = native.decode_crop_resize(raw, crop=(y0, x0, ch, cw),
                                       out_size=out_size)
      if size and not use_native_resize:
        crop = _pil_resize(crop, maybe_repeat(size, 2), method, antialias)
    else:
      img = Image.open(io.BytesIO(raw))
      w, h = img.size  # PIL reads the header only at this point.
      y0, x0, ch, cw = _sample_inception_box(
          np_rng, h, w, area_min / 100, area_max / 100, ratio_min, ratio_max)
      img = img.convert("RGB").crop((x0, y0, x0 + cw, y0 + ch))
      crop = np.asarray(img, np.uint8)
      if size:
        crop = _pil_resize(crop, maybe_repeat(size, 2), method, antialias)
    data = dict(data)
    data[ok] = crop
    return data

  return PPOp(host_fn=_op, phase="host", random=True,
              staticizer=bool(size), name="decode_jpeg_and_inception_crop")


@Registry.register("preprocess_ops.inception_crop")
def get_inception_crop(size=None, area_min=5, area_max=100, method="bilinear",
                       antialias=False, key="image", inkey=None, outkey=None):
  """Random area and aspect crop of a decoded image (host), then an
  optional resize: the box of `decode_jpeg_and_inception_crop` with the
  aspect in [3/4, 4/3]."""
  ik, ok = inkey or key, outkey or key

  def _op(data, np_rng):
    img = np.asarray(data[ik])
    y0, x0, ch, cw = _sample_inception_box(
        np_rng, img.shape[0], img.shape[1], area_min / 100, area_max / 100,
        3. / 4, 4. / 3)
    crop = img[y0:y0 + ch, x0:x0 + cw]
    if size:
      crop = _pil_resize(crop, maybe_repeat(size, 2), method, antialias)
    data = dict(data)
    data[ok] = crop
    return data

  return PPOp(host_fn=_op, phase="host", random=True,
              staticizer=bool(size), name="inception_crop")


def _rgb_to_yuv420(rgb):
  """(y [S, S], uv [2, S/2, S/2]) uint8 from an RGB crop, with the JAX
  op's arithmetic: BT.601 luma, chroma from every second pixel."""
  y = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
       + 0.114 * rgb[..., 2]).astype(np.uint8)
  small = rgb[::2, ::2].astype(np.float32)
  luma = 0.299 * small[..., 0] + 0.587 * small[..., 1] + 0.114 * small[..., 2]
  cb = 128 + (small[..., 2] - luma) * 0.564
  cr = 128 + (small[..., 0] - luma) * 0.713
  return y, np.stack([np.clip(cb, 0, 255), np.clip(cr, 0, 255)]).astype(
      np.uint8)


@Registry.register("preprocess_ops.decode_jpeg_and_inception_crop_yuv")
def get_decode_jpeg_and_inception_crop_yuv(
    size, area_min=5, area_max=100, ratio_min=0.75, ratio_max=1.33,
    key="image", inkey=None, outkey=None):
  """decode_jpeg_and_inception_crop on the JPEG's raw YCbCr planes (host).

  Skips libjpeg's chroma upsampling and colour conversion, crops and
  resizes the planes, and emits `{key}_y` [S, S] and `{key}_uv`
  [2, S/2, S/2] uint8: half the bytes of RGB to copy to the device, where
  `yuv420_to_rgb` makes RGB. A JPEG that is not YCbCr 4:2:0 or 4:4:4 is
  decoded to RGB and converted on the host.
  """
  ik = inkey or key
  ok = outkey or key
  assert size % 2 == 0, size

  def _op(data, np_rng):
    raw = data[ik]
    h, w = native.jpeg_size(raw)
    box = _sample_inception_box(
        np_rng, h, w, area_min / 100, area_max / 100, ratio_min, ratio_max)
    data = dict(data)
    try:
      y, uv = native.decode_crop_resize_yuv420(raw, box, size)
    except native.NotYuv420:
      y, uv = _rgb_to_yuv420(native.decode_crop_resize(
          raw, crop=box, out_size=(size, size)))
    data.pop(ik, None)
    data[f"{ok}_y"], data[f"{ok}_uv"] = y, uv
    return data

  return PPOp(host_fn=_op, phase="host", random=True, staticizer=True,
              name="decode_jpeg_and_inception_crop_yuv")


def yuv420_to_rgb(y, uv):
  """y [N, S, S] and uv [N, 2, S/2, S/2] (uint8) -> RGB [N, S, S, 3] f32 in
  [0, 255]: BT.601 full range (what JPEG stores), the chroma upsampled 2x
  bilinearly with half-pixel centres, as `jax.image.resize(uv, (2, S, S),
  "linear")` upsamples it."""
  y = y.to(torch.float32)
  up = F.interpolate(uv.to(torch.float32), size=y.shape[1:], mode="bilinear",
                     align_corners=False)
  cb, cr = up[:, 0] - 128.0, up[:, 1] - 128.0
  r = y + 1.402 * cr
  g = y - 0.344136 * cb - 0.714136 * cr
  b = y + 1.772 * cb
  return torch.stack([r, g, b], -1).clamp(0.0, 255.0)


@Registry.register("preprocess_ops.yuv420_to_rgb")
def get_yuv420_to_rgb(key="image"):
  """Device op: `{key}_y` and `{key}_uv` -> `{key}`, RGB f32 in [0, 255]."""
  def _op(batch):
    batch = dict(batch)
    batch[key] = yuv420_to_rgb(batch.pop(f"{key}_y"), batch.pop(f"{key}_uv"))
    return batch

  return PPOp(fn=_op, name="yuv420_to_rgb")


@Registry.register("preprocess_ops.random_crop")
def get_random_crop(crop_size, key="image", inkey=None, outkey=None):
  """Random fixed-size crop (host; a staticizer), drawing the corner from
  the example's numpy rng exactly as the JAX host implementation does."""
  ch, cw = maybe_repeat(crop_size, 2)
  ik, ok = inkey or key, outkey or key

  def _host(data, np_rng):
    img = np.asarray(data[ik])
    y0 = int(np_rng.integers(0, img.shape[0] - ch + 1))
    x0 = int(np_rng.integers(0, img.shape[1] - cw + 1))
    data = dict(data)
    data[ok] = img[y0:y0 + ch, x0:x0 + cw]
    return data

  return PPOp(host_fn=_host, random=True, staticizer=True,
              name="random_crop")


@Registry.register("preprocess_ops.central_crop")
def get_central_crop(crop_size=None, key="image", inkey=None, outkey=None):
  """Centre crop of crop_size (host, or batched on the device where shapes
  are already static; a staticizer), or without a size the largest
  centred square (host only)."""
  ik, ok = inkey or key, outkey or key

  def crop(img, ch, cw, axis):
    dy = (img.shape[axis] - ch) // 2
    dx = (img.shape[axis + 1] - cw) // 2
    return img[(slice(None),) * axis + (slice(dy, dy + ch),
                                        slice(dx, dx + cw))]

  def op(fn, data):
    data = dict(data)
    data[ok] = fn(data[ik])
    return data

  if crop_size:
    ch, cw = maybe_repeat(crop_size, 2)
    return PPOp(fn=lambda b: op(lambda x: crop(x, ch, cw, 1), b),
                host_fn=lambda d: op(
                    lambda x: crop(np.asarray(x), ch, cw, 0), d),
                staticizer=True, name="central_crop")

  def square(img):
    img = np.asarray(img)
    s = min(img.shape[0], img.shape[1])
    return crop(img, s, s, 0)

  return PPOp(host_fn=lambda d: op(square, d), phase="host",
              name="central_crop")


def flip_images(images, flips):
  """images [N, H, W, C] with example i mirrored left-right iff flips[i]."""
  return torch.where(flips[:, None, None, None], images.flip(2), images)


@InKeyOutKey(random=True)
def _host_flip_lr():
  """The host form: the flip that the JAX package's eager host run of its
  device op draws from the example's rng (`pp.utils.host_uniform`)."""
  def _flip(image, np_rng):
    image = np.asarray(image)
    return image[:, ::-1] if host_uniform(np_rng) < 0.5 else image
  return _flip


@Registry.register("preprocess_ops.flip_lr")
@as_pp_op(random=True, host_factory=_host_flip_lr)
@InKeyOutKey(random=True)
def get_random_flip_lr():
  """Mirrors each image left-right with probability 1/2 (device; on the
  host where a later op is host-only, as in the JAX package)."""
  def _flip(images, generator):
    u = torch.rand(images.shape[0], generator=generator,
                   device=images.device)
    return flip_images(images, u < 0.5)
  return _flip

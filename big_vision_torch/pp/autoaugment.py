"""RandAugment: port of big_vision_tpu/pp/autoaugment.py.

The 16 image ops of the JAX module, on batches of uint8 NHWC images, and
the registered device op `randaug(num_layers, magnitude)`. Where the JAX
package vmaps one image at a time and picks each image's op with
`lax.switch`, the port draws, in each of `num_layers` rounds and for every
example of the batch, its op, its sign (`_maybe_negate`) and its cutout
centre from the device phase's `torch.Generator`; it then groups the
examples by the op they drew, gathers each group, applies that op to it
alone and scatters the results back.

Each op is a deterministic core that takes the drawn values: `apply_op(
images, op, magnitude, negate=, cy=, cx=)`. The arithmetic is the JAX
module's, in f32 where it computes in f32 and in the same order, so that
the results are equal bit for bit: `blend` truncates after its clip,
`_to_gray` rounds half to even, `contrast` takes the mean of the gray
image and truncates it, `equalize` divides integers with the LUT shifted
by one bin, `autocontrast` leaves a flat channel as it is, `sharpness`
keeps the border pixels, the geometric ops sample the nearest pixel
(rounding half away from zero) and fill with 128, and `solarize`'s
threshold wraps modulo 256 as a uint8 does (magnitude 10 gives 256, which
inverts every pixel). The smoothing of `sharpness` sums its nine taps in
one fixed order, so that it gives the same bits on the CPU and on the
card; the JAX package's convolution sums in its own order, which moves a
few pixels by one level. The rotation's coefficients are computed in f32
on the CPU, whatever the images' device.
"""

from __future__ import annotations

import numpy as np
import torch

from big_vision_torch.registry import Registry
from big_vision_torch.pp.utils import PPOp

_MAX_LEVEL = 10.0
_REPLACE = 128

# The reference's op order (`_make_ops`); `apply_op` takes an index in it.
OP_NAMES = ("AutoContrast", "Equalize", "Invert", "Rotate", "Posterize",
            "Solarize", "Color", "Contrast", "Brightness", "Sharpness",
            "ShearX", "ShearY", "TranslateX", "TranslateY", "Cutout",
            "SolarizeAdd")


# ---------------------------------------------------------------------------
# Pixel ops, on uint8 [N, H, W, 3].
# ---------------------------------------------------------------------------


def blend(image1, image2, factor):
  """image1*(1-f) + image2*f, extrapolation clipped, truncated to uint8."""
  image1 = image1.float()
  out = image1 + factor * (image2.float() - image1)
  return out.clamp(0.0, 255.0).to(torch.uint8)


def invert(images):
  return 255 - images


def solarize(images, threshold=128):
  """Inverts the pixels at or above `threshold`, taken modulo 256."""
  return torch.where(images < int(threshold) % 256, images, 255 - images)


def solarize_add(images, addition=0, threshold=128):
  added = (images.int() + addition).clamp(0, 255).to(torch.uint8)
  return torch.where(images < threshold, added, images)


def posterize(images, bits):
  """Keeps the top `bits` bits (none at 0 bits: a uint8 shifted by 8)."""
  shift = 8 - bits
  if shift >= 8:
    return torch.zeros_like(images)
  return (images >> shift) << shift


def to_gray(images):
  """ITU-R 601 luma [N, H, W], rounded half to even."""
  rgb = images.float()
  gray = rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114
  return torch.round(gray).to(torch.uint8)


def color(images, factor):
  return blend(to_gray(images)[..., None].expand_as(images), images, factor)


def brightness(images, factor):
  return blend(torch.zeros_like(images), images, factor)


def contrast(images, factor):
  """Blends with each image's mean gray level, truncated. The JAX module
  sums a 256-bin histogram in f32, which is exact below 2^24, as the
  integer sum here is."""
  gray = to_gray(images)
  total = gray.flatten(1).sum(1, dtype=torch.int64).float()
  mean = (total / torch.full_like(total, gray[0].numel())).clamp(0, 255)
  mean = mean.to(torch.uint8)
  return blend(mean[:, None, None, None].expand_as(images), images, factor)


def autocontrast(images):
  """Stretches each channel to [0, 255]; a flat channel stays as it is."""
  x = images.float()
  lo = x.amin(dim=(1, 2), keepdim=True)
  hi = x.amax(dim=(1, 2), keepdim=True)
  denom = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
  scale = torch.full_like(denom, 255.0) / denom
  scaled = (x * scale - lo * scale).clamp(0, 255)
  return torch.where(hi > lo, scaled, x).to(torch.uint8)


def equalize(images):
  """PIL-style histogram equalization of each channel, in integers."""
  n, h, w, c = images.shape
  ch = images.permute(0, 3, 1, 2).reshape(n * c, h * w).long()
  histo = torch.zeros(n * c, 256, dtype=torch.int64, device=images.device)
  histo.scatter_add_(1, ch, torch.ones_like(ch))
  bins = torch.arange(256, device=images.device)
  # The count of the brightest value present (the last nonzero bin):
  max_val = torch.where(histo > 0, bins, 0).amax(1, keepdim=True)
  step = (histo.sum(1, keepdim=True) - histo.gather(1, max_val)) // 255
  lut = (histo.cumsum(1) + step // 2) // step.clamp_min(1)
  lut = torch.cat([torch.zeros_like(lut[:, :1]), lut[:, :-1]], 1)
  out = torch.where(step == 0, ch, lut.clamp(0, 255).gather(1, ch))
  return out.to(torch.uint8).reshape(n, c, h, w).permute(0, 2, 3, 1)


_SMOOTH = ((1, 1, 1), (1, 5, 1), (1, 1, 1))


def sharpness(images, factor):
  """Blends with a 3x3 smoothing (taps summed row by row) that keeps the
  border pixels."""
  img = images.float()
  _, h, w, _ = images.shape
  taps = np.asarray(_SMOOTH, np.float32) / np.float32(13.0)
  smoothed = None
  for dy in range(3):
    for dx in range(3):
      tap = img[:, dy:dy + h - 2, dx:dx + w - 2] * float(taps[dy, dx])
      smoothed = tap if smoothed is None else smoothed + tap
  degenerate = images.clone()
  degenerate[:, 1:-1, 1:-1] = smoothed.clamp(0, 255).to(torch.uint8)
  return blend(degenerate, images, factor)


def cutout(images, cy, cx, pad_size, replace=_REPLACE):
  """Fills [cy - pad, cy + pad) x [cx - pad, cx + pad) of each image with
  `replace`; cy, cx: [N] integer centres."""
  _, h, w, _ = images.shape
  dev = images.device
  cy = torch.as_tensor(cy, device=dev).long()[:, None, None]
  cx = torch.as_tensor(cx, device=dev).long()[:, None, None]
  rows = torch.arange(h, device=dev)[None, :, None]
  cols = torch.arange(w, device=dev)[None, None, :]
  mask = ((rows >= cy - pad_size) & (rows < cy + pad_size)
          & (cols >= cx - pad_size) & (cols < cx + pad_size))
  return torch.where(mask[..., None], replace, images).to(torch.uint8)


# ---------------------------------------------------------------------------
# Geometric ops: output -> input affine with NEAREST sampling, 128 fill.
# ---------------------------------------------------------------------------


def affine_nearest(images, coeffs, replace=_REPLACE):
  """x_in = a*x + b*y + c, y_in = d*x + e*y + f (x = column, y = row) per
  image; coeffs: f32 [N, 6] of (a, b, c, d, e, f)."""
  n, h, w, _ = images.shape
  dev = images.device
  a, b, c, d, e, f = (k[:, None, None] for k in
                      coeffs.to(dev, torch.float32).unbind(1))
  y_out = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
  x_out = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
  x_in = a * x_out + b * y_out + c
  y_in = d * x_out + e * y_out + f
  # TF's NEAREST sampling rounds half away from zero (std::round).
  round_away = lambda v: (torch.sign(v) * torch.floor(v.abs() + 0.5)).long()
  xi, yi = round_away(x_in), round_away(y_in)
  valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
  idx = torch.arange(n, device=dev)[:, None, None]
  sampled = images[idx, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
  return torch.where(valid[..., None], sampled, replace).to(torch.uint8)


def _coeffs(*columns):
  """[N, 6] f32 from six columns, each a float or an f32 [N] tensor."""
  n = max(c.numel() for c in columns if isinstance(c, torch.Tensor))
  return torch.stack([c.float() if isinstance(c, torch.Tensor)
                      else torch.full((n,), c, dtype=torch.float32)
                      for c in columns], 1)


def translate_x(images, pixels, replace=_REPLACE):
  """Shifts each image's content left by pixels[i] (f32 [N])."""
  return affine_nearest(images, _coeffs(1.0, 0.0, pixels, 0.0, 1.0, 0.0),
                        replace)


def translate_y(images, pixels, replace=_REPLACE):
  return affine_nearest(images, _coeffs(1.0, 0.0, 0.0, 0.0, 1.0, pixels),
                        replace)


def shear_x(images, level, replace=_REPLACE):
  return affine_nearest(images, _coeffs(1.0, level, 0.0, 0.0, 1.0, 0.0),
                        replace)


def shear_y(images, level, replace=_REPLACE):
  return affine_nearest(images, _coeffs(1.0, 0.0, 0.0, level, 1.0, 0.0),
                        replace)


def rotate(images, degrees, replace=_REPLACE):
  """Counter-clockwise rotation of each image by degrees[i] (f32 [N])
  around its centre; the coefficients in f32 on the CPU."""
  _, h, w, _ = images.shape
  radians = degrees.cpu().float() * torch.tensor(np.pi / 180,
                                                 dtype=torch.float32)
  cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
  cos, sin = torch.cos(radians), torch.sin(radians)
  a, b, d, e = cos, -sin, sin, cos
  c = cx - a * cx - b * cy
  f = cy - d * cx - e * cy
  return affine_nearest(images, torch.stack([a, b, c, d, e, f], 1), replace)


# ---------------------------------------------------------------------------
# Level tables (the JAX module's `_make_ops`) and the RandAugment driver.
# ---------------------------------------------------------------------------


def levels(magnitude, cutout_const=40, translate_const=100):
  """The ops' arguments at `magnitude`, computed as the JAX module does."""
  level = float(magnitude)
  return dict(
      enhance=(level / _MAX_LEVEL) * 1.8 + 0.1,
      shear=(level / _MAX_LEVEL) * 0.3,
      translate=(level / _MAX_LEVEL) * translate_const,
      rotate=(level / _MAX_LEVEL) * 30.0,
      posterize_bits=int((level / _MAX_LEVEL) * 4),
      solarize_threshold=int((level / _MAX_LEVEL) * 256),
      solarize_add=int((level / _MAX_LEVEL) * 110),
      cutout_pad=int((level / _MAX_LEVEL) * cutout_const))


def _signed(value, negate):
  """f32 [N]: -value where negate[i], else value (`_maybe_negate`)."""
  v = torch.full(negate.shape, value, dtype=torch.float32)
  return torch.where(negate.cpu().bool(), -v, v)


def apply_op(images, op, magnitude, *, negate=None, cy=None, cx=None):
  """The deterministic core: op `op` (an index in OP_NAMES, or its name)
  at `magnitude` on uint8 [N, H, W, 3] images, with the values each image
  drew: `negate` ([N] bool) for the signed ops, the cutout centres `cy`,
  `cx` ([N] int)."""
  name = OP_NAMES[op] if isinstance(op, int) else op
  lv = levels(magnitude)
  if name == "AutoContrast":
    return autocontrast(images)
  if name == "Equalize":
    return equalize(images)
  if name == "Invert":
    return invert(images)
  if name == "Rotate":
    return rotate(images, _signed(lv["rotate"], negate))
  if name == "Posterize":
    return posterize(images, lv["posterize_bits"])
  if name == "Solarize":
    return solarize(images, lv["solarize_threshold"])
  if name in ("Color", "Contrast", "Brightness", "Sharpness"):
    fn = {"Color": color, "Contrast": contrast, "Brightness": brightness,
          "Sharpness": sharpness}[name]
    return fn(images, lv["enhance"])
  if name in ("ShearX", "ShearY"):
    fn = shear_x if name == "ShearX" else shear_y
    return fn(images, _signed(lv["shear"], negate))
  if name in ("TranslateX", "TranslateY"):
    fn = translate_x if name == "TranslateX" else translate_y
    return fn(images, _signed(lv["translate"], negate))
  if name == "Cutout":
    return cutout(images, cy, cx, lv["cutout_pad"])
  if name == "SolarizeAdd":
    return solarize_add(images, lv["solarize_add"])
  raise ValueError(f"Unknown op {op!r}")


def draw(n, h, w, num_layers, generator, device):
  """Each example's draws for `num_layers` rounds, on the CPU: {"op",
  "negate", "cy", "cx"}, each int64 [num_layers, n]. Drawn on `device`
  from `generator` and copied to the host once."""
  shape = (num_layers, n)
  kw = dict(generator=generator, device=device)
  drawn = torch.stack([
      torch.randint(len(OP_NAMES), shape, **kw),
      torch.randint(2, shape, **kw),
      torch.randint(h, shape, **kw),
      torch.randint(w, shape, **kw)]).cpu()
  return dict(zip(("op", "negate", "cy", "cx"), drawn))


def randaugment(images, num_layers, magnitude, generator):
  """RandAugment (arxiv.org/abs/1909.13719) on uint8 [N, H, W, 3]: in each
  round every example applies the op it drew; the examples are grouped by
  op, each group gathered, transformed and scattered back."""
  n, h, w, _ = images.shape
  drawn = draw(n, h, w, num_layers, generator, images.device)
  for r in range(num_layers):
    ops = drawn["op"][r]
    order = torch.argsort(ops, stable=True)
    counts = torch.bincount(ops, minlength=len(OP_NAMES)).tolist()
    gathered = images[order.to(images.device)]
    outs, start = [], 0
    for op, count in enumerate(counts):
      if count:
        sel = order[start:start + count]
        outs.append(apply_op(
            gathered[start:start + count], op, magnitude,
            negate=drawn["negate"][r][sel], cy=drawn["cy"][r][sel],
            cx=drawn["cx"][r][sel]))
      start += count
    images = torch.empty_like(images).index_copy_(
        0, order.to(images.device), torch.cat(outs))
  return images


@Registry.register("preprocess_ops.randaug")
def get_randaug(num_layers=2, magnitude=10, key="image", inkey=None,
                outkey=None):
  """Device op: RandAugment on the batch's uint8 images."""
  ik, ok = inkey or key, outkey or key

  def _op(batch, generator):
    batch = dict(batch)
    batch[ok] = randaugment(batch[ik].to(torch.uint8), num_layers,
                            magnitude, generator)
    return batch

  return PPOp(fn=_op, random=True, name="randaug")

"""Port's RandAugment vs the JAX package's `pp/autoaugment.py`.

Each of the 16 ops runs on the same seeded 32x32 uint8 images on both
sides, at magnitudes 0, 10 and 15: the JAX op with a key per image, the
port's deterministic core (`apply_op`) with the values that key draws
there (the sign of `_maybe_negate`, the cutout centre). The results are
equal bit for bit, except that the smoothing of `sharpness` sums its taps
in another order than XLA's convolution (SHARPNESS_SHARE of the pixels
may differ: by one level in the smoothed image, which the blend scales
by |1 - factor|, so by 2 levels at magnitude 15) and the rotation's
coefficients come from another f32 cos and sin (ROTATE_SHARE of the
pixels may sample a neighbouring pixel).

The registered op `randaug` runs through the port's pp builder: every
example draws its own op in every round (not one op per batch), the 16
ops are drawn evenly, and at magnitude 0 the ops that ignore the
magnitude (invert, equalize, autocontrast) still act, as in the JAX op.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch.pp import autoaugment as t_aa
from big_vision_torch.pp import builder as t_builder
from big_vision_tpu.pp import autoaugment as j_aa

SHARPNESS_SHARE = 0.01  # of the pixels
ROTATE_SHARE = 0.01  # of the pixels


def _images(n=8, size=32):
  """Images of several kinds: full-range noise, narrow ranges (for the
  contrast ops), smooth ramps, and one with a flat channel."""
  rs = np.random.RandomState(0)
  out = []
  for i in range(n):
    lo, hi = [(0, 256), (60, 140), (100, 110), (0, 40)][i % 4]
    img = rs.randint(lo, hi, (size, size, 3))
    if i % 3 == 2:  # a smooth ramp plus noise
      ramp = np.add.outer(np.arange(size), np.arange(size)) * 3
      img = (ramp[..., None] + rs.randint(0, 20, (size, size, 3))) % 256
    out.append(img)
  out[-1][..., 1] = 77  # a flat channel
  return np.stack(out).astype(np.uint8)


def _jax_draws(keys, h, w):
  """The values each key draws inside the JAX ops."""
  negate = np.array([bool(jax.random.bernoulli(k)) for k in keys])
  cy, cx = [], []
  for k in keys:
    ky, kx = jax.random.split(k)
    cy.append(int(jax.random.randint(ky, (), 0, h)))
    cx.append(int(jax.random.randint(kx, (), 0, w)))
  return torch.from_numpy(negate), torch.tensor(cy), torch.tensor(cx)


@pytest.mark.parametrize("op", t_aa.OP_NAMES)
def test_op_matches_jax(op):
  images = _images()
  n, h, w, _ = images.shape
  for magnitude in (0, 10, 15):
    ops = dict(j_aa._make_ops(magnitude))
    keys = jax.random.split(jax.random.PRNGKey(magnitude), n)
    want = np.stack([np.asarray(ops[op](jnp.asarray(im), k))
                     for im, k in zip(images, keys)])
    negate, cy, cx = _jax_draws(keys, h, w)
    got = t_aa.apply_op(torch.from_numpy(images), op, magnitude,
                        negate=negate, cy=cy, cx=cx).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    share = np.mean(diff > 0)
    if op == "Sharpness":
      levels = math.ceil(abs(1 - t_aa.levels(magnitude)["enhance"]))
      assert diff.max() <= max(1, levels), (magnitude, diff.max())
      assert share <= SHARPNESS_SHARE, (magnitude, share)
    elif op == "Rotate":
      assert share <= ROTATE_SHARE, (magnitude, share)
    else:
      np.testing.assert_array_equal(got, want, err_msg=f"{op} {magnitude}")
    if op in ("Invert", "Equalize", "AutoContrast", "Posterize",
              "Solarize") or magnitude:
      assert share < 1 and not np.array_equal(got, images), (op, magnitude)


def test_randaug_draws_an_op_per_example():
  """Through the builder on a batch: each example's result is the core's
  for the op it drew, the draws vary within a batch, and 4096 draws cover
  the 16 ops evenly."""
  pfn = t_builder.get_preprocess_fn("randaug(2, 10)")
  images = torch.from_numpy(np.concatenate([_images()] * 4))
  gen = lambda: torch.Generator().manual_seed(3)
  got = pfn.device({"image": images}, gen())["image"]
  drawn = t_aa.draw(len(images), 32, 32, 2, gen(), "cpu")
  assert len(set(drawn["op"][0].tolist())) > 8  # not one op per batch
  want = images
  for r in range(2):
    want = torch.cat([
        t_aa.apply_op(want[i:i + 1], int(drawn["op"][r, i]), 10,
                      negate=drawn["negate"][r, i:i + 1],
                      cy=drawn["cy"][r, i:i + 1], cx=drawn["cx"][r, i:i + 1])
        for i in range(len(images))])
  torch.testing.assert_close(got, want, rtol=0, atol=0)
  ops = t_aa.draw(4096, 32, 32, 1, gen(), "cpu")["op"][0]
  counts = torch.bincount(ops, minlength=16).numpy()
  assert counts.min() > 256 * 0.8 and counts.max() < 256 * 1.2, counts


def test_randaug_at_magnitude_zero_keeps_the_level_free_ops():
  """randaug(2, 0), AugReg's `light1`: invert, equalize and autocontrast
  act as at any magnitude; posterize keeps 0 bits; the geometric ops and
  cutout leave the image as it is, as the JAX ops do."""
  images = torch.from_numpy(_images())
  lv = t_aa.levels(0)
  assert lv["posterize_bits"] == 0 and lv["cutout_pad"] == 0
  for op in ("Invert", "Equalize", "AutoContrast"):
    zero = t_aa.apply_op(images, op, 0)
    torch.testing.assert_close(zero, t_aa.apply_op(images, op, 10))
    assert not torch.equal(zero, images), op
  assert not t_aa.apply_op(images, "Posterize", 0).any()
  negate = torch.tensor([True, False] * 4)
  centre = torch.full((8,), 16)
  for op in ("Rotate", "ShearX", "ShearY", "TranslateX", "TranslateY",
             "Cutout", "SolarizeAdd"):
    torch.testing.assert_close(
        t_aa.apply_op(images, op, 0, negate=negate, cy=centre, cx=centre),
        images, rtol=0, atol=0, msg=op)

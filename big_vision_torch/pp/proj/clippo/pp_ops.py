"""CLIPPO's preprocessing: port of big_vision_tpu/pp/proj/clippo/pp_ops.py
(`render_unifont`, text rendered into an image, on the host).

Two paths, as in JAX: with `unifont_path`, the glyphs of that GNU Unifont
`.hex` file (16x16 bitmaps; 8x16 glyphs padded to 16 wide) laid out in
rows of 16 pixels, proportional (each glyph cropped to its inked columns,
at least `min_width`, then `spacing` columns) unless `monospace`; without
it, PIL's built-in bitmap font (`ImageFont.load_default()`, which depends
on the Pillow version: the two packages render alike on one machine),
words wrapped into lines of 12 pixels. Either gives a [S, S, 3] uint8
image: `text_brightness` on the glyphs' pixels, `background_brightness`
elsewhere.
"""

from __future__ import annotations

import functools

import numpy as np

from big_vision_torch.pp.utils import PPOp
from big_vision_torch.registry import Registry


@functools.lru_cache(maxsize=4)
def _load_unifont(path):
  """Parses a Unifont .hex file into {codepoint: [16, 16] bitmap}."""
  glyphs = {}
  with open(path) as f:
    for line in f:
      code_hex, _, bits = line.strip().partition(":")
      code = int(code_hex, 16)
      raw = bytes.fromhex(bits)
      if len(raw) == 32:  # 16x16 glyph
        g = np.unpackbits(np.frombuffer(raw, np.uint8)).reshape(16, 16)
      elif len(raw) == 16:  # 8x16 glyph, padded to 16 wide
        g8 = np.unpackbits(np.frombuffer(raw, np.uint8)).reshape(16, 8)
        g = np.pad(g8, ((0, 0), (0, 8)))
      else:
        continue
      glyphs[code] = g.astype(np.uint8)
  return glyphs


def _render_unifont_np(text, image_size, glyphs, monospace, spacing,
                       min_width):
  canvas = np.zeros((image_size, image_size), np.uint8)
  x, y = 0, 0
  for ch in text:
    g = glyphs.get(ord(ch))
    if g is None:
      g = np.zeros((16, 16), np.uint8)
    if not monospace:
      cols = np.nonzero(g.max(axis=0))[0]
      if len(cols):
        g = g[:, cols[0]:cols[-1] + 1]
      else:
        g = g[:, :min_width]
      if g.shape[1] < min_width:
        g = np.pad(g, ((0, 0), (0, min_width - g.shape[1])))
      g = np.pad(g, ((0, 0), (0, spacing)))
    w = g.shape[1]
    if x + w > image_size:
      x, y = 0, y + 16
    if y + 16 > image_size:
      break
    canvas[y:y + 16, x:x + w] = np.maximum(canvas[y:y + 16, x:x + w], g)
    x += w
  return canvas


def _render_pil(text, image_size):
  from PIL import Image, ImageDraw, ImageFont  # pylint: disable=import-outside-toplevel
  img = Image.new("L", (image_size, image_size), 0)
  draw = ImageDraw.Draw(img)
  font = ImageFont.load_default()
  # Greedy wrap into lines that fit.
  lines, cur = [], ""
  for w in text.split():
    trial = (cur + " " + w).strip()
    if draw.textlength(trial, font=font) <= image_size - 2:
      cur = trial
    else:
      lines.append(cur)
      cur = w
  lines.append(cur)
  for i, line in enumerate(lines):
    if (i + 1) * 12 > image_size:
      break
    draw.text((1, i * 12), line, fill=255, font=font)
  return (np.asarray(img) > 0).astype(np.uint8)


@Registry.register("preprocess_ops.render_unifont")
def get_pp_render_text(image_size, font_size=16, max_chars=768,
                       background_brightness=127, text_brightness=0,
                       lower=True, monospace=False, spacing=1, min_width=4,
                       resize_method="area", unifont_path=None,
                       key=None, inkey="texts", outkey="image"):
  """Renders data[inkey] (a string, or the first of a list) into a [S, S,
  3] uint8 image at data[outkey]."""
  del font_size, resize_method
  ik, ok = key or inkey, key or outkey
  glyphs = _load_unifont(unifont_path) if unifont_path else None

  def _op(data):
    data = dict(data)
    txt = data[ik]
    if isinstance(txt, (list, tuple, np.ndarray)):
      txt = txt[0] if len(txt) else ""
    if isinstance(txt, bytes):
      txt = txt.decode()
    txt = str(txt)[:max_chars]
    if lower:
      txt = txt.lower()
    if glyphs is not None:
      mask = _render_unifont_np(txt, image_size, glyphs, monospace, spacing,
                                min_width)
    else:
      mask = _render_pil(txt, image_size)
    img = np.where(mask > 0, np.uint8(text_brightness),
                   np.uint8(background_brightness))
    data[ok] = np.repeat(img[:, :, None], 3, axis=-1)
    return data

  return PPOp(host_fn=_op, phase="host", staticizer=True,
              name="render_unifont")

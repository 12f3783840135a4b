"""PaliGemma: image tower + Gemma LLM with prefix-LM attention.

Port of big_vision_tpu/models/proj/paligemma/paligemma.py: the attention
mask, image/text embedding, the training forward and the prefill/extend
delegation. Left for later: video input and the slow full-recompute decode
oracle.
"""

from __future__ import annotations

import importlib
from typing import Optional

import torch
from torch import nn


def _tower(family, cfg, **defaults):
  """Resolves a sub-model family name to a configured module."""
  mod = importlib.import_module(f"big_vision_torch.models.{family}")
  return mod.Model(**{**defaults, **(cfg or {})})


def make_attn_mask(input_mask, mask_ar):
  """bool[B, N, N] attention from a block-causal spec.

  mask_ar int[B, N] is 1 where previous tokens may NOT attend to this
  token and 0 where the token shares its block with the previous one; a
  query attends every key whose block index is at most its own. Padding
  (input_mask False) is never attended and attends nothing.
  """
  block = torch.cumsum(mask_ar, dim=1)
  visible = block[:, :, None] >= block[:, None, :]
  live = input_mask[:, :, None] & input_mask[:, None, :]
  return visible & live


class Model(nn.Module):
  """Image tower (`self.img`) + LLM (`self.llm`)."""

  def __init__(self, img_model="vit", img: Optional[dict] = None,
               llm_model="proj.paligemma.gemma_bv",
               llm: Optional[dict] = None, *, device="cuda",
               param_dtype=torch.float32):
    super().__init__()
    kw = dict(device=device, param_dtype=param_dtype)
    self.llm = _tower(llm_model, llm, **kw)
    self.img = _tower(img_model, img, num_classes=self.llm.embdim, **kw)

  def embed_image(self, image):
    if image.dim() != 4:
      raise NotImplementedError("video input is not ported yet")
    zimg, aux = self.img(image)
    return zimg, {"img/zimg": zimg, **{f"img/{k}": v for k, v in aux.items()}}

  def embed_text(self, tokens):
    ztxt = self.llm.embed_tokens(tokens)
    return ztxt, {"llm/ztxt": ztxt}

  def embed_image_and_text(self, image, text, *, input_mask=None,
                           mask_ar=None):
    """(x [B,N,E], input_mask [B,N], mask_ar [B,N]), aux. Image tokens form
    a full-attention prefix (always live, mask_ar 0)."""
    zimg, img_aux = self.embed_image(image)
    ztxt, txt_aux = self.embed_text(text)
    if input_mask is None:
      input_mask = torch.ones(text.shape, dtype=torch.bool,
                              device=text.device)
    if mask_ar is None:
      mask_ar = torch.ones(text.shape, dtype=torch.int32, device=text.device)

    n_img = zimg.shape[1]

    def with_prefix(fill, m):
      prefix = torch.full((m.shape[0], n_img), fill, dtype=m.dtype,
                          device=m.device)
      return torch.cat([prefix, m], dim=1)

    dtype = torch.promote_types(zimg.dtype, ztxt.dtype)
    seq = torch.cat([zimg.to(dtype), ztxt.to(dtype)], dim=1)
    return ((seq, with_prefix(True, input_mask), with_prefix(0, mask_ar)),
            {**img_aux, **txt_aux})

  def forward(self, image, text, mask_ar):
    """Returns float[B, T, V] logits for the text tokens, and aux."""
    (seq, input_mask, mask_ar), out = self.embed_image_and_text(
        image, text, mask_ar=mask_ar)
    attn_mask = out["attn_mask"] = make_attn_mask(input_mask, mask_ar)
    _, llm_aux = self.llm(seq, mask=attn_mask)
    out.update({f"llm/{k}": v for k, v in llm_aux.items()})
    n_img = out["img/zimg"].shape[1]
    text_logits = self.llm.compute_logits(out["llm/pre_logits"][:, n_img:])
    out["text_logits"] = text_logits
    out["text_tokens"] = text_logits.argmax(dim=-1)
    return text_logits, out

  def prefill_cache(self, x, input_mask, mask_ar, *, cache_size):
    attn_mask = make_attn_mask(input_mask, mask_ar)
    return self.llm.prefill_cache(x, input_mask, attn_mask,
                                  cache_size=cache_size)

  def extend_cache(self, x, cache):
    return self.llm.extend_cache(x, cache)

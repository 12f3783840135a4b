"""PaliGemma: image tower + Gemma LLM with prefix-LM attention.

Port of big_vision_tpu/models/proj/paligemma/paligemma.py: the attention
mask, image/text embedding (a video [B, F, H, W, C] goes through the tower
as B*F images, its tokens joined along the sequence), the training forward,
the prefill/extend delegation with the slow full-recompute decode oracle
where the LLM has no `prefill_cache`, and the two-part `load`.

The training forward `forward(image, text, mask_ar, train=True)` builds
the prefix-LM segment ids seg = where(input_mask, 1 + cumsum(mask_ar), 0)
as the JAX model does and hands them to the LLM, whose fused attention
path (`attn_impl="flash"`) reads the mask from them. `initialize(generator)`
draws both towers from scratch with the JAX models' initializers.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
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

  @torch.no_grad()
  def initialize(self, generator, head_bias=None):
    """Draws every parameter of both towers from scratch (`vit` and
    `gemma` initializers). Returns the module."""
    if head_bias is not None:
      raise ValueError("PaliGemma has no classification head to bias")
    self.img.initialize(generator)
    self.llm.initialize(generator)
    return self

  def embed_image(self, image, train=False, rng=None):
    """`rng` draws the image tower's dropout masks in training."""
    frames = image.shape[1] if image.dim() == 5 else None
    if frames:  # video: each frame goes through the tower on its own...
      image = image.reshape(-1, *image.shape[2:])
    zimg, aux = self.img(image, train=train, rng=rng)
    if frames:  # ...and the frames' tokens join along the sequence.
      zimg = zimg.reshape(-1, frames * zimg.shape[1], zimg.shape[2])
    return zimg, {"img/zimg": zimg, **{f"img/{k}": v for k, v in aux.items()}}

  def embed_text(self, tokens, train=False):
    ztxt = self.llm.embed_tokens(tokens, train=train)
    return ztxt, {"llm/ztxt": ztxt}

  def embed_image_and_text(self, image, text, *, input_mask=None,
                           mask_ar=None, train=False, rng=None):
    """(x [B,N,E], input_mask [B,N], mask_ar [B,N]), aux. Image tokens form
    a full-attention prefix (always live, mask_ar 0)."""
    zimg, img_aux = self.embed_image(image, train=train, rng=rng)
    ztxt, txt_aux = self.embed_text(text, train=train)
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

  def forward(self, image, text, mask_ar, train=False, rng=None):
    """Returns float[B, T, V] logits for the text tokens, and aux. `rng`
    (a torch.Generator) draws the image tower's and the LLM's dropout in
    training."""
    (seq, input_mask, mask_ar), out = self.embed_image_and_text(
        image, text, mask_ar=mask_ar, train=train, rng=rng)
    attn_mask = out["attn_mask"] = make_attn_mask(input_mask, mask_ar)
    # The same prefix-LM mask as segment ids, for the fused flash path.
    seg = torch.where(input_mask, 1 + torch.cumsum(mask_ar, dim=1), 0)
    # Only the pre-logits are read: the JAX model's LLM logits of every
    # position are dropped by XLA, and here not computed ([B, T, V] f32 is
    # 19 GB for cococap's batch of 64).
    _, llm_aux = self.llm(seq, mask=attn_mask, train=train, seg=seg,
                          logits=False, rng=rng)
    out.update({f"llm/{k}": v for k, v in llm_aux.items()})
    n_img = out["img/zimg"].shape[1]
    text_logits = self.llm.compute_logits(out["llm/pre_logits"][:, n_img:],
                                          train=train)
    out["text_logits"] = text_logits
    out["text_tokens"] = text_logits.argmax(dim=-1)
    return text_logits, out

  def prefill_cache(self, x, input_mask, mask_ar, *, cache_size):
    """(last live token's logits [B, 1, V], decode cache)."""
    if hasattr(self.llm, "prefill_cache"):
      attn_mask = make_attn_mask(input_mask, mask_ar)
      return self.llm.prefill_cache(x, input_mask, attn_mask,
                                    cache_size=cache_size)
    return self._fallback_prefill_cache(x, input_mask, mask_ar, cache_size)

  def extend_cache(self, x, cache):
    if hasattr(self.llm, "prefill_cache"):
      return self.llm.extend_cache(x, cache)
    return self._fallback_extend_cache(x, cache)

  # The decode oracle, for an LLM without a KV cache, and for tests: the
  # logits of a new token are those of a full prefix-LM forward over the
  # growing sequence, read at the last live position. Its cache holds the
  # embedded sequence, mask_ar and the live length per example; each step
  # writes one slot and recomputes everything (O(T^2) per token).
  def _last_live_logits(self, cache):
    live = (torch.arange(cache.x.shape[1], device=cache.x.device)[None, :]
            < cache.length[:, None])
    logits, _ = self.llm(cache.x, mask=make_attn_mask(live, cache.mask_ar))
    idx = (cache.length - 1)[:, None, None].expand(-1, 1, logits.shape[-1])
    return torch.gather(logits, 1, idx)

  def _fallback_prefill_cache(self, x, input_mask, mask_ar, cache_size):
    grow = cache_size - x.shape[1]
    cache = OracleCache(
        x=nn.functional.pad(torch.where(input_mask[..., None], x, 0),
                            (0, 0, 0, grow)),
        mask_ar=nn.functional.pad(torch.where(input_mask, mask_ar, 0),
                                  (0, grow)),
        length=input_mask.sum(dim=1))
    return self._last_live_logits(cache), cache

  def _fallback_extend_cache(self, x, cache):
    if x.shape[1] != 1:
      raise ValueError("extend_cache is one token at a time")
    # The token goes in at each example's length; generated tokens are
    # causal (mask_ar 1).
    rows = torch.arange(x.shape[0], device=x.device)
    cx, car = cache.x.clone(), cache.mask_ar.clone()
    cx[rows, cache.length] = x[:, 0].to(cx.dtype)
    car[rows, cache.length] = 1
    cache = OracleCache(x=cx, mask_ar=car, length=cache.length + 1)
    return self._last_live_logits(cache), cache


@dataclasses.dataclass
class OracleCache:
  """The decode oracle's state: the embedded sequence [B, S, D], its
  mask_ar [B, S] and the live length per example [B]."""
  x: torch.Tensor
  mask_ar: torch.Tensor
  length: torch.Tensor


GEMMA_DIR = os.environ.get("BV_GEMMA_DIR", "PLEASE_SET_BV_GEMMA_DIR")
VANITY_NAMES = {
    name: os.path.join(GEMMA_DIR, fname) for name, fname in {
        "pt_224": "pt_224.npz", "pt_224.bf16": "pt_224.bf16.npz",
        "pt_448": "pt_448.npz", "pt_448.bf16": "pt_448.bf16.npz",
        "pt_896": "pt_896.npz", "pt_896.bf16": "pt_896.bf16.npz",
        "pt_3b_224": "pt_3b_224.bf16.npz",
        "pt_3b_448": "pt_3b_448.bf16.npz",
        "pt_10b_224": "pt_10b_224.bf16.npz",
    }.items()
}


def load(init_params, init_files, model_cfg, img_load_kw=None,
         llm_load_kw=None):
  """Two-part loader: {"img": ckpt, "llm": ckpt}, or one combined `.npz`
  (its `img` and `llm` subtrees), or a name of `VANITY_NAMES` (files under
  $BV_GEMMA_DIR). Returns {"img": tree, "llm": tree} in the JAX layout
  (numpy), for `utils.convert.paligemma`; `init_params`, where given, is
  the target's tree in the same layout (`{"img": ..., "llm": ...}`)."""
  if isinstance(init_files, str):
    base = VANITY_NAMES.get(init_files, init_files)
    init_files = {part: f"{base}:{part}" for part in ("img", "llm")}
  init_files = {**init_files}
  cfg = dict(model_cfg)
  restored = {**(init_params or {"img": None, "llm": None})}

  parts = [("img", "vit", img_load_kw),
           ("llm", "proj.paligemma.gemma_bv", llm_load_kw)]
  for part, default_family, load_kw in parts:
    ckpt = init_files.pop(part, None)
    if ckpt is None:
      continue
    family = cfg.get(f"{part}_model", default_family)
    tower_mod = importlib.import_module(f"big_vision_torch.models.{family}")
    restored[part] = tower_mod.load(
        restored[part], ckpt, cfg.get(part, {}), **(load_kw or {}))
  if init_files:
    raise ValueError(f"Unused model_init entries: {init_files}")
  return restored

"""JetFormer's codecs and samplers: port of
big_vision_tpu/trainers/proj/jetformer/predict_fns.py.

`encode_images` maps images to soft tokens (the patch "PCA" then the Jet
adaptor), `decode_images` back (the adaptor's inverse, then the patches
put back). `sample_image_latents` samples image soft tokens after a text
prompt: the prompt prefilled into the KV cache, then one token per step,
each from the image head's mixture at the given temperatures, or with
classifier-free guidance (`cfg_weight`): the batch doubled into
(conditional, label-dropped) rows, the mixture component drawn from the
conditional row and the guided density `GaussianCFG` sampled per channel
(`_gmm_cfg_sample`). `sample_text` samples text after image latents. The
draws come from a `torch.Generator`, so they are not JAX's; everything
around them is the JAX functions' arithmetic.
"""

from __future__ import annotations

import torch

from big_vision_torch.models.proj.givt import distributions


def unflatten_latents(x):
  """[B, h*w, C] -> [B, h, w, C] (a square grid)."""
  b, n, c = x.shape
  hw = int(n ** 0.5)
  return x.reshape(b, hw, hw, c)


def flatten_latents(x):
  """[B, h, w, C] -> [B, h*w, C]."""
  return x.reshape(x.shape[0], -1, x.shape[-1])


def encode_images(images, *, adaptor, patch_pca, generator=None,
                  reparametrize=False):
  """images -> soft tokens [B, N, C]: the patches, then the adaptor."""
  x, logvar = patch_pca.encode(images, generator=generator)
  if reparametrize:
    x = patch_pca.reparametrize(x, logvar, generator)
  if adaptor is not None:
    x, _ = adaptor(unflatten_latents(x))
    x = flatten_latents(x)
  return x


def decode_images(x, *, adaptor, patch_pca):
  """soft tokens -> images: the adaptor's inverse, then the patches."""
  if adaptor is not None:
    x, _ = adaptor.inverse(unflatten_latents(x))
    x = flatten_latents(x)
  return patch_pca.decode(x)


def _gmm_cfg_sample(model, logits_c, logits_u, generator, *, cfg_weight,
                    temperature, temperature_probs):
  """Guided soft tokens from the (conditional, unconditional) head outputs:
  the component from the conditional mixture, then `GaussianCFG` per
  channel. Returns (samples [B, N, C], their unnormalized log-density
  [B, N])."""
  pdf_c = model.get_pdf(logits_c, temperature_scales=temperature,
                        temperature_probs=temperature_probs)
  pdf_u = model.get_pdf(logits_u, temperature_scales=temperature,
                        temperature_probs=temperature_probs)
  comp = distributions.categorical(pdf_c.logits, generator)
  loc_c, scale_c = pdf_c.pick(comp)
  loc_u, scale_u = pdf_u.pick(comp)
  cfg = distributions.GaussianCFG(loc_c.float(), scale_c.float(),
                                  loc_u.float(), scale_u.float(),
                                  w=cfg_weight)
  samples = cfg.sample(generator)
  return samples, cfg.log_prob(samples).sum(-1)


@torch.no_grad()
def sample_image_latents(batch, *, model, decode_len=256, temperature=1.0,
                         temperature_probs=1.0, cfg_weight=None,
                         generator=None):
  """Image soft tokens after the prompt `batch["text"]` [B, L] (and
  `text_mask`): {"out_tokens" [B, decode_len, C], "out_logp" [B,
  decode_len]}."""
  do_cfg = ((cfg_weight != 0) if isinstance(cfg_weight, (int, float))
            else cfg_weight is not None)
  text = batch["text"]
  text_mask = batch.get("text_mask")
  if text_mask is None:
    text_mask = torch.ones(text.shape, dtype=torch.bool, device=text.device)
  text_mask = text_mask.bool()
  drop_prefix = None
  if do_cfg:
    drop_prefix = torch.tensor([False, True], device=text.device).repeat(
        text.shape[0])
    text = text.repeat_interleave(2, dim=0)
    text_mask = text_mask.repeat_interleave(2, dim=0)
  b = text.shape[0]
  images0 = torch.zeros((b, 0, model.out_dim), device=text.device)
  text_first = torch.ones((b,), dtype=torch.bool, device=text.device)
  x, attn_mask, input_mask = model.embed_image_and_text(
      text, images0, text_first_mask=text_first, text_input_mask=text_mask,
      drop_prefix=drop_prefix, shift=False)
  prelogits, cache = model.prefill_cache(
      x, attn_mask, input_mask, cache_size=x.shape[1] + decode_len - 1)

  def sample_tokens(prelogits):
    logits = model.img_logits(prelogits)
    if do_cfg:
      tokens, logp = _gmm_cfg_sample(
          model, logits[0::2], logits[1::2], generator,
          cfg_weight=cfg_weight, temperature=temperature,
          temperature_probs=temperature_probs)
      return (tokens.repeat_interleave(2, dim=0),
              logp.repeat_interleave(2, dim=0))
    pdf = model.get_pdf(logits, temperature_scales=temperature,
                        temperature_probs=temperature_probs)
    tokens = pdf.sample(generator)
    return tokens, pdf.log_prob(tokens)

  tokens, logp = sample_tokens(prelogits[:, -1:])
  out_tokens, out_logp = [tokens], [logp]
  for _ in range(1, decode_len):
    prelogits = model.extend_cache(model.img_emb(tokens.float()), cache)
    tokens, logp = sample_tokens(prelogits)
    out_tokens.append(tokens)
    out_logp.append(logp)
  out = {"out_tokens": torch.cat(out_tokens, 1),
         "out_logp": torch.cat(out_logp, 1)}
  if do_cfg:
    out = {k: v[0::2] for k, v in out.items()}
  return out


@torch.no_grad()
def sample_text(batch, *, model, decode_len=64, temperature=1.0,
                generator=None):
  """Text tokens after image latents `batch["image_latents"]` [B, N, C]
  (and an optional `text` prompt): {"out_tokens" [B, decode_len] int,
  "out_logp" [B, decode_len]}."""
  images = batch["image_latents"]
  b = images.shape[0]
  dev = images.device
  text_first = torch.zeros((b,), dtype=torch.bool, device=dev)
  if batch.get("text") is None:
    text = torch.zeros((b, 0), dtype=torch.long, device=dev)
    text_mask = torch.ones((b, 0), dtype=torch.bool, device=dev)
  else:
    text = batch["text"]
    text_mask = batch.get("text_mask")
    if text_mask is None:
      text_mask = torch.ones(text.shape, dtype=torch.bool, device=dev)
  x, attn_mask, input_mask = model.embed_image_and_text(
      text, images, text_first_mask=text_first, text_input_mask=text_mask,
      shift=False)
  prelogits, cache = model.prefill_cache(
      x, attn_mask, input_mask, cache_size=x.shape[1] + decode_len - 1)

  def sample_tokens(prelogits):
    logits = model.text_logits(prelogits)
    samples = model.get_pmf(logits / temperature).sample(generator)
    return samples, model.get_pmf(logits).log_prob(samples)

  tokens, logp = sample_tokens(prelogits[:, -1:])
  out_tokens, out_logp = [tokens], [logp]
  for _ in range(1, decode_len):
    prelogits = model.extend_cache(model.embed_text(tokens), cache)
    tokens, logp = sample_tokens(prelogits)
    out_tokens.append(tokens)
    out_logp.append(logp)
  return {"out_tokens": torch.cat(out_tokens, 1),
          "out_logp": torch.cat(out_logp, 1)}

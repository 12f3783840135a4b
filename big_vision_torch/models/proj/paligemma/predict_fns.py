"""PaliGemma prediction functions: logits and greedy/sampled decode.

Port of big_vision_tpu/models/proj/paligemma/predict_fns.py. The JAX
package jits the whole decode into one `lax.while_loop`; PyTorch runs
eagerly, so here the decode is a Python loop over `extend_cache` that
records tokens and log-probabilities and stops once every example has
emitted EOS. The weights live in the model, so the returned functions take
`(batch, generator=None, **settings)` instead of `(train_state, batch,
rng)`. Samplers draw from a `torch.Generator` instead of a `jax.random`
key. Left for later: beam decode and best-of-n.
"""

from __future__ import annotations

import torch

from big_vision_torch.registry import Registry


def _categorical(logits, generator):
  probs = torch.softmax(logits.float(), dim=-1)
  return torch.multinomial(probs, 1, generator=generator)[..., 0]


@Registry.register("decode_samplers.greedy", replace=True)
def _greedy():
  def sample(logits, generator):
    del generator
    return logits.argmax(dim=-1)
  return sample


@Registry.register("decode_samplers.temperature", replace=True)
def _temperature(t=1.0):
  def sample(logits, generator):
    return _categorical(logits / t, generator)
  return sample


@Registry.register("decode_samplers.nucleus", replace=True)
def _nucleus(p=0.2, t=1.0):
  def sample(logits, generator):
    logits = logits / t
    sorted_logits = logits.sort(dim=-1, descending=True).values
    cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
    # Smallest set of tokens with cumulative prob >= p; always >= 1 token.
    cutoff_idx = (cum < p).sum(dim=-1, keepdim=True)
    cutoff_logit = sorted_logits.gather(-1, cutoff_idx)
    logits = torch.where(logits < cutoff_logit,
                         torch.full_like(logits, -1e10), logits)
    return _categorical(logits, generator)
  return sample


@Registry.register("decode_samplers.topk", replace=True)
def _topk(k=5, t=1.0):
  def sample(logits, generator):
    logits = logits / t
    kth = logits.sort(dim=-1).values[..., -k][..., None]
    logits = torch.where(logits < kth, torch.full_like(logits, -1e10),
                         logits)
    return _categorical(logits, generator)
  return sample


def get_sampler(spec):
  if callable(spec):
    return spec
  return Registry.lookup(f"decode_samplers.{spec}")()


def default_masks(batch, mask_key="mask_input"):
  """(input_mask, mask_ar) of a batch, defaulting to all-live, prefix-only."""
  text = batch["text"]
  input_mask = batch.get(mask_key)
  if input_mask is None:
    input_mask = torch.ones(text.shape, dtype=torch.bool, device=text.device)
  mask_ar = batch.get("mask_ar")
  if mask_ar is None:
    mask_ar = torch.zeros_like(text)
  return input_mask.bool(), mask_ar


@torch.inference_mode()
def decode_with_logp(model, batch, generator=None, *, max_decode_len,
                     eos_token, sampler="greedy", cache_extra=0,
                     mask_key="mask_input"):
  """Prefill, then one `extend_cache` per new token.

  Returns (tokens int[B, max_decode_len], logp f32[B]); positions after an
  example's EOS hold 0 and add nothing to its logp. `cache_extra` adds
  masked cache slots (the cache then holds
  prefix + max_decode_len + cache_extra slots).
  """
  sample = get_sampler(sampler)
  input_mask, mask_ar = default_masks(batch, mask_key)
  (x, full_mask, full_ar), _ = model.embed_image_and_text(
      batch["image"], batch["text"], input_mask=input_mask, mask_ar=mask_ar)
  cache_size = x.shape[1] + max_decode_len + cache_extra
  logits, cache = model.prefill_cache(x, full_mask, full_ar,
                                      cache_size=cache_size)

  b = x.shape[0]
  tokens = torch.zeros((b, max_decode_len), dtype=torch.long,
                       device=x.device)
  logp = torch.zeros((b,), dtype=torch.float32, device=x.device)
  done = torch.zeros((b,), dtype=torch.bool, device=x.device)
  for i in range(max_decode_len):
    if bool(done.all()):
      break
    last = logits[:, -1, :]
    tok = sample(last, generator)
    tok_lp = torch.log_softmax(last.float(), dim=-1).gather(
        -1, tok[:, None])[:, 0]
    tokens[:, i] = torch.where(done, torch.zeros_like(tok), tok)
    logp += torch.where(done, torch.zeros_like(tok_lp), tok_lp)
    done |= tok == eos_token
    emb, _ = model.embed_text(tok[:, None])
    logits, cache = model.extend_cache(emb, cache)
  return tokens, logp


def _tensors_only(batch):
  """Drops host-kept values (strings, lists): only tensors go to the model."""
  return {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}


def make_predict_fns(model, *, max_decode_len=64, eos_token=1,
                     sampler="greedy", cache_extra=0):
  """Returns {"logits", "decode", "decode_with_logp"}.

  The keyword arguments are defaults that every decode function also
  accepts per call.
  """

  @torch.inference_mode()
  def logits_fn(batch):
    mask_ar = batch.get("mask_ar")
    if mask_ar is None:
      mask_ar = torch.zeros_like(batch["text"])
    return model(batch["image"], batch["text"], mask_ar)

  def decode_with_logp_fn(batch, generator=None, *,
                          max_decode_len=max_decode_len,
                          eos_token=eos_token, sampler=sampler,
                          cache_extra=cache_extra):
    return decode_with_logp(model, _tensors_only(batch), generator,
                            max_decode_len=max_decode_len,
                            eos_token=eos_token, sampler=sampler,
                            cache_extra=cache_extra)

  def decode(batch, generator=None, **kw):
    return decode_with_logp_fn(batch, generator, **kw)[0]

  return {"logits": logits_fn, "decode": decode,
          "decode_with_logp": decode_with_logp_fn}

"""PaliGemma prediction functions: logits, sampled, best-of-n and beam
decode.

Port of big_vision_tpu/models/proj/paligemma/predict_fns.py. The JAX
package jits each decode into one `lax.while_loop`; PyTorch runs eagerly,
so here a decode is a Python loop over `extend_cache` that stops once
every example (or beam) has emitted EOS. The weights live in the model, so
the returned functions take `(batch, generator=None, **settings)` instead
of `(train_state, batch, rng)`. Samplers draw from a `torch.Generator`
instead of a `jax.random` key.

Beam search follows `_beam_decode_jit` step by step: the top-k first
tokens, finished beams continued only by pad (id 0) at no cost, top-k over
the K*V candidates with ties to the lower flat index (as `lax.top_k`), the
histories and the cache reordered by parent beam, and the best beam kept.
"""

from __future__ import annotations

import dataclasses

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


def _prefill(model, batch, cache_size_extra, mask_key):
  """Embeds the batch and fills the cache with room for `cache_size_extra`
  more slots; returns (logits [B, 1, V], cache)."""
  input_mask, mask_ar = default_masks(batch, mask_key)
  (x, full_mask, full_ar), _ = model.embed_image_and_text(
      batch["image"], batch["text"], input_mask=input_mask, mask_ar=mask_ar)
  return model.prefill_cache(x, full_mask, full_ar,
                             cache_size=x.shape[1] + cache_size_extra)


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
  logits, cache = _prefill(model, batch, max_decode_len + cache_extra,
                           mask_key)
  b = logits.shape[0]
  device = logits.device

  tokens = torch.zeros((b, max_decode_len), dtype=torch.long, device=device)
  logp = torch.zeros((b,), dtype=torch.float32, device=device)
  done = torch.zeros((b,), dtype=torch.bool, device=device)
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


def best_of_n_decode(model, batch, generator=None, *, best_of_n,
                     **decode_kw):
  """Decodes each example `best_of_n` times (the batch repeated, rows
  b*n .. b*n+n-1 for example b) and keeps the candidate with the highest
  logp, the first on a tie (as `jnp.argmax`). Returns (tokens, logp)."""
  rep = {k: v.repeat_interleave(best_of_n, dim=0) for k, v in batch.items()}
  tokens, logp = decode_with_logp(model, rep, generator, **decode_kw)
  tokens = tokens.reshape(-1, best_of_n, tokens.shape[-1])
  logp = logp.reshape(-1, best_of_n)
  best = logp.argmax(dim=-1)
  rows = torch.arange(best.shape[0], device=best.device)
  return tokens[rows, best], logp[rows, best]


def _gather_beams(cache, idx):
  """Reorders every tensor of a decode cache along its leading (beam)
  axis: the KV storage and int8 scales of every layer, the per-example
  bookkeeping, or the oracle's sequence; the shared write slot stays."""
  if isinstance(cache, torch.Tensor):
    return cache.index_select(0, idx)
  if isinstance(cache, list):
    return [_gather_beams(x, idx) for x in cache]
  if dataclasses.is_dataclass(cache):
    return dataclasses.replace(cache, **{
        f.name: _gather_beams(getattr(cache, f.name), idx)
        for f in dataclasses.fields(cache)})
  return cache


def _top_k(x, k):
  """`lax.top_k` over the last axis: the k largest, ties to the lower
  index (a stable descending sort)."""
  values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
  return values[..., :k], idx[..., :k]


@torch.inference_mode()
def beam_decode_with_score(model, batch, *, max_decode_len, eos_token,
                           beam_size, mask_key="mask_input"):
  """Beam search, as the JAX package's `_beam_decode_jit`: returns the best
  beam's tokens int[B, max_decode_len] and its score (summed logp) f32[B].
  """
  logits, cache = _prefill(model, batch, max_decode_len, mask_key)
  b, k, vocab = logits.shape[0], beam_size, logits.shape[-1]
  device = logits.device

  # The top-k first tokens per example.
  scores, tok = _top_k(torch.log_softmax(logits[:, -1].float(), dim=-1), k)
  done = tok == eos_token
  tokens = torch.zeros((b, k, max_decode_len), dtype=torch.long,
                       device=device)
  tokens[:, :, 0] = torch.where(done, torch.zeros_like(tok), tok)
  # Row b of the cache becomes rows b*K .. b*K+K-1.
  cache = _gather_beams(cache, torch.arange(b, device=device)
                        .repeat_interleave(k))
  # Finished beams may only continue with pad (id 0), at no cost.
  done_row = torch.full((vocab,), -1e10, device=device)
  done_row[0] = 0.0
  rows = torch.arange(b, device=device)[:, None]
  for i in range(1, max_decode_len):
    if bool(done.all()):
      break
    emb, _ = model.embed_text(tok.reshape(b * k, 1))
    logits, cache = model.extend_cache(emb, cache)
    lp = torch.log_softmax(logits[:, -1].float(), dim=-1).reshape(b, k, vocab)
    lp = torch.where(done[:, :, None], done_row, lp)
    scores, flat = _top_k((scores[:, :, None] + lp).reshape(b, k * vocab), k)
    parent, tok = flat // vocab, flat % vocab
    tokens, done = tokens[rows, parent], done[rows, parent]
    cache = _gather_beams(cache, (rows * k + parent).reshape(-1))
    tokens[:, :, i] = torch.where(done, torch.zeros_like(tok), tok)
    done = done | (tok == eos_token)
  best = scores.argmax(dim=-1)
  return tokens[rows[:, 0], best], scores[rows[:, 0], best]


def _tensors_only(batch):
  """Drops host-kept values (strings, lists): only tensors go to the model."""
  return {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}


def make_predict_fns(model, *, max_decode_len=64, eos_token=1,
                     sampler="greedy", best_of_n=1, beam_size=2,
                     cache_extra=0):
  """Returns {"logits", "decode", "decode_with_logp", "beam_decode"}.

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
                          best_of_n=best_of_n, cache_extra=cache_extra):
    kw = dict(max_decode_len=max_decode_len, eos_token=eos_token,
              sampler=sampler, cache_extra=cache_extra)
    batch = _tensors_only(batch)
    if best_of_n == 1:
      return decode_with_logp(model, batch, generator, **kw)
    return best_of_n_decode(model, batch, generator, best_of_n=best_of_n,
                            **kw)

  def decode(batch, generator=None, **kw):
    return decode_with_logp_fn(batch, generator, **kw)[0]

  def beam_decode(batch, generator=None, *, max_decode_len=max_decode_len,
                  eos_token=eos_token, beam_size=beam_size):
    del generator  # beam search is deterministic
    return beam_decode_with_score(
        model, _tensors_only(batch), max_decode_len=max_decode_len,
        eos_token=eos_token, beam_size=beam_size)[0]

  return {"logits": logits_fn, "decode": decode,
          "decode_with_logp": decode_with_logp_fn,
          "beam_decode": beam_decode}

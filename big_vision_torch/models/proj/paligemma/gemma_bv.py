"""Gemma with the embed / compute_logits / prefill / extend protocol.

Port of big_vision_tpu/models/proj/paligemma/gemma_bv.py. Prompts are
right-aligned so that every example ends at the same cache slot; extending
the cache then writes one shared slot per step. The decode state is a
`DecodeCache` that `prefill_cache` returns and `extend_cache` takes and
returns, in place of Flax's mutable "cache" collection. `quant=True` serves
int8 weights (models/ppp/gemma.py); `load` is the LLM's loader. The JAX
wrapper's forwarded keys (`_FORWARDED`: scan, remat_policy, dropout,
dropout_bdims, cache_dtype, attn_impl, decode_impl, quant) go to the LLM
with the same defaults; a training forward given an `rng` draws the LLM's
dropout from it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from big_vision_torch.models.ppp import gemma


def _right_align(x, input_mask, attn_mask):
  """Shifts each example so its valid tokens end at the sequence end:
  out[i] = in[(i + len) % L], one gather per operand."""
  length = x.shape[1]
  shift = input_mask.sum(dim=-1)
  idx = (torch.arange(length, device=x.device)[None, :]
         + shift[:, None]) % length
  x = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
  input_mask = torch.gather(input_mask, 1, idx)
  attn_mask = torch.gather(attn_mask, 1,
                           idx[:, :, None].expand(-1, -1, length))
  attn_mask = torch.gather(attn_mask, 2,
                           idx[:, None, :].expand(-1, length, -1))
  return x, input_mask, attn_mask


@dataclasses.dataclass
class DecodeCache:
  """KV cache plus per-example bookkeeping ([B] int tensors)."""
  kv: gemma.KVCache
  seq_len: torch.Tensor      # position of the next token
  cache_begin: torch.Tensor  # first live slot
  cache_end: torch.Tensor    # one past the last written slot


class Model(nn.Module):
  """Gemma LM wrapper; its weights live in `self.model` (a gemma.Model)."""

  def __init__(self, variant="gemma_2b", *, vocab_size=None,
               final_logits_softcap=None, attn_logits_softcap=None,
               cache_dtype: Optional[str] = "bfloat16", attn_impl="xla",
               decode_impl="xla", quant=False, scan=True,
               remat_policy="nothing_saveable", dropout=0.0,
               dropout_bdims=(), device="cuda", param_dtype=torch.float32):
    super().__init__()
    cfg = gemma.get_config(variant)
    for name, value in (("vocab_size", vocab_size),
                        ("final_logits_softcap", final_logits_softcap),
                        ("attn_logits_softcap", attn_logits_softcap)):
      if value is not None:
        cfg[name] = value
    self.embdim = cfg["width"]
    self.model = gemma.Model(**cfg, cache_dtype=cache_dtype,
                             attn_impl=attn_impl, decode_impl=decode_impl,
                             quant=quant, scan=scan,
                             remat_policy=remat_policy, dropout=dropout,
                             dropout_bdims=dropout_bdims, device=device,
                             param_dtype=param_dtype)

  def initialize(self, generator):
    """Draws the LLM's parameters from scratch (`gemma.Model.initialize`)."""
    self.model.initialize(generator)
    return self

  def embed_tokens(self, tokens, train=False):
    """int[B, T] -> float[B, T, D] vocab embeddings."""
    del train
    return self.model(tokens, embed_only=True)

  def compute_logits(self, pre_logits, train=False):
    del train
    return self.model(None, pre_logits=pre_logits)[0]

  def forward(self, embs, mask=None, train=False, seg=None, logits=True,
              rng=None):
    """float[B, T, D] embeddings -> (logits, out); mask defaults causal;
    `seg` [B, T] the prefix-LM segment ids of the fused training path;
    `rng` draws the dropout masks where `train`.
    With `logits=False`, (None, out) without the vocab projection of every
    position (for a caller that reads only out["pre_logits"])."""
    rng = rng if train else None
    if embs.shape[-1] != self.embdim:
      raise ValueError(f"embedding width {embs.shape[-1]} != {self.embdim}")
    if not logits:
      return None, self.model.trunk(embedded_prefix=embs, mask=mask, seg=seg,
                                    rng=rng)
    return self.model(None, embedded_prefix=embs, mask=mask, seg=seg,
                      rng=rng)

  def prefill_cache(self, x, input_mask, attn_mask, *, cache_size):
    """Fills a new cache with left-aligned prompts x [B, N, D].

    input_mask bool[B, N] and attn_mask bool[B, N, N] (which must already
    deny attention to padding). Returns the last valid token's logits
    [B, 1, V] and the `DecodeCache`.
    """
    x, input_mask, attn_mask = _right_align(x, input_mask, attn_mask)
    batch, prefill_len, _ = x.shape
    nprompt = input_mask.sum(dim=-1)
    # Future slots are denied: widen the mask to the whole cache.
    deny = torch.zeros((batch, prefill_len, cache_size - prefill_len),
                       dtype=attn_mask.dtype, device=x.device)
    kv = gemma.KVCache()
    out = self.model.trunk(
        embedded_prefix=x, mask=torch.cat([attn_mask, deny], dim=-1),
        positions=torch.cumsum(input_mask.long(), dim=-1) - 1, cache=kv)
    cache = DecodeCache(
        kv=kv, seq_len=nprompt, cache_begin=prefill_len - nprompt,
        cache_end=torch.full((batch,), prefill_len, device=x.device))
    return self.compute_logits(out["pre_logits"][:, -1:]), cache

  def extend_cache(self, x, cache: DecodeCache):
    """Appends one token embedding x [B, 1, D]; returns ([B, 1, V] logits,
    the updated cache)."""
    if x.shape[1] != 1:
      raise ValueError("extend_cache is one token at a time")
    if not cache.kv.k:
      raise ValueError("extend_cache called before prefill_cache")
    cache_size = cache.kv.k[0].shape[-2]
    positions = cache.seq_len
    lo, hi = cache.cache_begin, cache.cache_end + 1
    # The new token may attend every in-use slot, itself included.
    slots = torch.arange(cache_size, device=x.device)[None, None, :]
    visible = (slots >= lo[:, None, None]) & (slots < hi[:, None, None])
    logits, _ = self.model(None, embedded_prefix=x, mask=visible,
                           positions=positions[:, None], cache=cache.kv)
    return logits, dataclasses.replace(cache, seq_len=positions + 1,
                                       cache_end=hi)


def load(init_params, init_file, model_cfg=None, dont_load=()):
  """Checkpoint loading is the LLM's (`gemma.load`, with its int8 paths)."""
  return gemma.load(init_params, init_file, model_cfg, dont_load)

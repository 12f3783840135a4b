"""CapPa's predict fns: port of
big_vision_tpu/trainers/proj/cappa/predict_fns.py on one device.

The trainer hands them to its evaluators by `pred`: "perplexity" (the
logits of the batch's captions, for `evaluators/proj/cappa/perplexity`),
"enc_rep" (the encoder's tokens and outputs, for probes) and "score" (the
log-likelihood of every class caption for every image, [B, n_labels], for
`evaluators/proj/cappa/scoring_classifier`).

`score` runs the encoder once per batch; the decoder then scores each
class caption against every image (PAD = 0 positions excluded). The JAX
fn maps over the captions one at a time; the port stacks several captions
into one decoder pass of about SCORE_ROWS rows (caption x image), where
each row computes the same function as alone.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from big_vision_torch.pp import tokenizer as bv_tokenizer
from big_vision_torch.utils import losses

SCORE_ROWS = 256  # decoder rows of one pass of `score`


@functools.cache
def make_prompt(prompt, tokenizer_spec, seq_len=None):
  """Tokenizes `prompt` (no bos, no eos), optionally zero-padded to
  seq_len; a tuple (hashable for the cache)."""
  tok = bv_tokenizer.get_tokenizer(tokenizer_spec)
  ids = np.asarray(tok.to_int(prompt, bos=False, eos=False), np.int32)
  if seq_len:
    ids = np.pad(ids, (0, seq_len - len(ids))).astype(np.int32)
  return tuple(ids.tolist())


def caption_log_likelihood(model, encoded, captions):
  """[n_captions, B]: the log-likelihood of each caption (its PAD = 0
  positions excluded) given each image's `encoded` tokens."""
  b = encoded.shape[0]
  per_pass = max(1, SCORE_ROWS // b)
  scores = []
  for i in range(0, captions.shape[0], per_pass):
    part = captions[i:i + per_pass]
    tokens = part.repeat_interleave(b, dim=0)  # caption-major rows
    logits = model.decode(encoded.repeat(part.shape[0], 1, 1), tokens)
    ll = -losses.weighted_softmax_xent(
        logits=logits, labels=tokens, weights=(tokens > 0).float(),
        reduction=False, normalize=False)
    scores.append(ll.reshape(part.shape[0], b))
  return torch.cat(scores)


def get_predict_fns(model):
  """The evaluator-facing fns around `model` (which holds the params;
  `train_state` is not read)."""

  def perplexity(train_state, batch):
    del train_state
    logits = model(batch["image"], batch["labels"], train=False)
    return logits, {"logits": logits}

  def enc_rep(train_state, batch):
    del train_state
    return model.encode(batch["image"], return_enc_features=True)

  def score(train_state, batch, prompt="", prompt_tokenizer=""):
    """Log-likelihood of each class caption per image: [B, n_labels]."""
    del train_state
    encoded = model.encode(batch["image"])
    # Put there by the scoring classifier: [n_labels, len] tokenized class
    # captions, optionally prefixed by one shared prompt.
    captions = batch["_label_tokens"]
    if prompt and prompt_tokenizer:
      prefix = torch.tensor(make_prompt(prompt, prompt_tokenizer),
                            dtype=captions.dtype, device=captions.device)
      captions = torch.cat([prefix.expand(captions.shape[0], -1), captions],
                           dim=-1)
    return caption_log_likelihood(model, encoded, captions).T

  return {"perplexity": perplexity, "score": score, "enc_rep": enc_rep}

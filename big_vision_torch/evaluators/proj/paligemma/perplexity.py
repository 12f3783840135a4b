"""Masked-CE perplexity evaluator for prefix-LM models: port of
big_vision_tpu/evaluators/proj/paligemma/perplexity.py on one device.

The `logits` predict fn's output becomes the per-example masked NLL of the
batch's `key` tokens ("sum", and "avg" over the kept tokens; `mask_loss`
keeps tokens where the batch has it, `pad_token` drops that id, and
`shift_labels` scores the logits at t against the token at t+1, as the
trainer's loss does), mean-reduced over the split by `evaluators/mean.py`.
A predict fn that returns a dict ("perplexity" of the PaliGemma trainer)
is mean-reduced as it is. Configs use it as `dict(type=
"proj.paligemma.perplexity", pred="logits", key="text",
shift_labels=True, ...)`.
"""

from __future__ import annotations

import torch

from big_vision_torch.evaluators import mean


def nll_fn(predict_fn, key, shift_labels, pad_token):
  """The per-example masked-NLL fn that `mean` reduces."""

  def per_example_nll(train_state, batch, **kw):
    pred = predict_fn(train_state, batch, **kw)
    if isinstance(pred, dict):
      return pred
    logits, labels = pred[0], batch[key]
    keep = batch.get("mask_loss")
    keep = torch.ones_like(labels) if keep is None else keep
    keep = keep.float()
    if pad_token is not None:
      keep = torch.where(labels == pad_token, 0.0, keep)
    if shift_labels:  # logits at i predict labels at i + 1
      logits, labels, keep = logits[:, :-1], labels[:, 1:], keep[:, 1:]
    # utils.weighted_softmax_xent(normalize=False, reduction=False): the
    # one-hot product leaves each token's log-probability.
    logp = torch.log_softmax(logits.float(), dim=-1)
    token_nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    nll = (token_nll * keep).sum(-1)
    return {"sum": nll, "avg": nll / keep.sum(-1).clamp_min(2e-38)}

  return per_example_nll


def Evaluator(predict_fn, *args, shift_labels=False, key="labels",  # pylint: disable=invalid-name
              pad_token=None, **kw):
  """Perplexity evaluator (mean-reduced masked CE)."""
  return mean.Evaluator(nll_fn(predict_fn, key, shift_labels, pad_token),
                        *args, **kw)

"""Caption perplexity: port of big_vision_tpu/evaluators/proj/cappa/
perplexity.py on `evaluators/mean.py`.

Per example: the softmax cross-entropy of the predict fn's logits against
"labels", PAD (`pad_token`) positions and, where the batch has them,
`label_masks`-suppressed positions excluded, optionally divided by the
kept length (`normalize_by_seqlen`); averaged over the split's valid rows
as "perplexity".
"""

from __future__ import annotations

from big_vision_torch.evaluators import mean
from big_vision_torch.utils import losses


class Evaluator(mean.Evaluator):
  """Mean per-example caption NLL."""

  def __init__(self, predict_fn, normalize_by_seqlen=False, **kw):

    def per_example_nll(train_state, batch, pad_token=0):
      logits, _ = predict_fn(train_state, batch)
      labels = batch["labels"]
      keep = (labels != pad_token).float()
      if (extra := batch.get("label_masks")) is not None:
        keep = keep * extra
      nll = losses.weighted_softmax_xent(
          logits=logits, labels=labels, weights=keep, reduction=False,
          label_smoothing=0.0, normalize=normalize_by_seqlen)
      return {"perplexity": nll}

    super().__init__(per_example_nll, **kw)

"""COCO captioning evaluator (CIDEr-D by default, BLEU-4, ROUGE-L,
METEOR): port of
big_vision_tpu/evaluators/proj/paligemma/transfers/coco_caption.py.

The decoded captions and each image's references (batches carry
"image/id" and "captions") are scored on the host by `textmetrics` after
its PTB-lite tokenization, as in the JAX package (which does not call
pycocoevalcap either). "spice" is refused: it needs the java scene-graph
parser.
"""

from __future__ import annotations

import collections

from big_vision_torch.evaluators.proj.paligemma.transfers import driver
from big_vision_torch.evaluators.proj.paligemma.transfers import textmetrics

SCORERS = {
    "cider": "cider_d",
    "bleu-4": "bleu4",
    "rouge": "rouge_l",
    "meteor": "meteor",
}


class Evaluator(driver.DecodeScorer):
  """Caption-generation metrics over decoded tokens."""

  def __init__(self, predict_fn, tokenizer=None, metrics=("cider",), *,
               data, **kw):
    super().__init__(predict_fn, tokenizer, data=data, **kw)
    for metric in metrics:
      if metric not in SCORERS:
        raise NotImplementedError(
            f"{metric!r}: available metrics are {sorted(SCORERS)}; 'spice' "
            "needs the java scene-graph parser of pycocoevalcap")
    self.metrics = metrics

  def run(self, train_state):
    predictions, references = [], []
    for caption, ex in self.examples(train_state):
      image_id = ex.id("image/id")
      predictions.append({"image_id": image_id, "caption": caption})
      references.extend({"image_id": image_id, "caption": ref}
                        for ref in ex.texts("captions"))
    yield from self.evaluate(references, predictions).items()

  def evaluate(self, gt_annotations, res_annotations):
    """Tokenizes once, then scores with each requested metric."""
    dense = collections.defaultdict(lambda: len(dense))  # ids -> 0, 1, ...
    res = {dense[p["image_id"]]: [textmetrics.ptb_lite_tokenize(p["caption"])]
           for p in res_annotations}
    gts = collections.defaultdict(list)
    for a in gt_annotations:
      gts[dense[a["image_id"]]].append(
          textmetrics.ptb_lite_tokenize(a["caption"]))
    if sorted(gts) != sorted(res):
      raise ValueError("every prediction needs references")
    return {metric: getattr(textmetrics, SCORERS[metric])(gts, res)
            for metric in self.metrics}

"""The decode-and-score skeleton of the PaliGemma transfer evaluators: port
of big_vision_tpu/evaluators/proj/paligemma/transfers/driver.py on one
process and one device.

Each evaluator runs the decode predict fn over its eval pipeline, drops
the padding examples (`_mask`), detokenizes, and scores on the host. The
pipeline keeps the string fields (captions, ids, answers) on the host, as
the JAX package's `keep_on_cpu`; on one process there is nothing to
gather across processes. The evaluators write no prediction files: the
JAX package writes them under the trainer's --workdir flag, which the
port's evaluators are not given.
"""

from __future__ import annotations

from big_vision_torch.evaluators import common
from big_vision_torch.pp import tokenizer as bv_tok


def text_of(value):
  """bytes or a numpy string -> str."""
  return value.decode() if isinstance(value, bytes) else str(value)


def scalar_of(value):
  """A numpy or torch scalar -> a Python scalar (json-serializable)."""
  return value.item() if hasattr(value, "item") else value


class Example:
  """One real (not padding) example of a host batch."""

  __slots__ = ("batch", "i")

  def __init__(self, batch, i):
    self.batch = batch
    self.i = i

  def texts(self, key):
    return [text_of(v) for v in self.batch[key][self.i]]

  def id(self, key="question_id"):
    return scalar_of(self.batch[key][self.i])


class DecodeScorer:
  """Base class owning the eval pipeline and the decode loop; subclasses
  consume `self.examples(train_state)`."""

  def __init__(self, predict_fn, tokenizer=None, *, data, device="cuda",
               **kw):
    self.get_data_iter, self.steps = common.eval_input_pipeline(
        data=data, device=device, **kw)
    self.tok = (bv_tok.get_tokenizer(tokenizer)
                if tokenizer is not None else None)
    self.decode = predict_fn

  def batches(self, train_state):
    """Yields (decoded tokens [B, L] on the host, keep bools, batch)."""
    for _, batch in zip(range(self.steps), self.get_data_iter()):
      decoded = self.decode(train_state, batch).cpu().numpy()
      keep = batch["_mask"].cpu().numpy().astype(bool)
      yield decoded, keep, batch

  def examples(self, train_state):
    """Yields (decoded text, Example) for every real example."""
    for decoded, keep, batch in self.batches(train_state):
      for i in range(len(decoded)):
        if keep[i]:
          yield self.tok.to_str(decoded[i], stop_at_eos=True), Example(batch,
                                                                       i)

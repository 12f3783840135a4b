"""Zero-shot classification by prompt-ensembled text embeddings: port of
big_vision_tpu/evaluators/proj/image_text/discriminative_classifier.py on
one device.

Each class name of `dataset_names[0]` (`prompt_engineering.
get_class_names`) is written into every prompt template
(`get_prompt_templates`), and each prompt goes through `pp_txt` on the
host (into "labels"). The tokens are embedded by the predict fn's text
half under `no_grad` on the evaluator's device, in chunks of 1024 rows
(the last chunk zero-padded, as in JAX); a class's embedding is the mean
over its templates, renormalized (`/ (||z|| + 1e-8)`). Each eval image's
embedding (the predict fn's image half) picks the class of the largest
dot product; `prec@1` is the share of hits over the split's valid rows,
counted in numpy.

`seconds` holds the last run's parts: "tokenize" (the host pp of every
prompt), "embed_texts" (the class embeddings on the device) and
"images" (the eval split).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from big_vision_torch.evaluators import common
from big_vision_torch.evaluators.proj.image_text import prompt_engineering
from big_vision_torch.pp import builder as pp_builder
from big_vision_torch.utils import writers

CHUNK = 1024  # prompts embedded per call


class Evaluator:
  """cfg keys: data, pp_fn, batch_size (the image side), dataset_names
  (the class names' dataset), class_name_source, prompt_templates, pp_txt
  (the prompts' pp, into "labels"), label_key, canonicalize."""

  def __init__(self, predict_fn, dataset_names=("imagenet2012",),
               class_name_source="clip", prompt_templates="clip_paper",
               pp_txt=None, label_key="label", canonicalize=True, **kw):
    self.get_data_iter, self.steps = common.eval_input_pipeline(**kw)
    self.device = torch.device(kw.get("device", "cuda"))
    self.predict_fn = predict_fn
    self.dataset_name = (dataset_names[0]
                         if isinstance(dataset_names, (list, tuple))
                         else dataset_names)
    self.class_names = prompt_engineering.get_class_names(
        self.dataset_name, source=class_name_source,
        canonicalize=canonicalize)
    self.templates = prompt_engineering.get_prompt_templates(
        prompt_templates, canonicalize=canonicalize)
    self.pp_txt = pp_builder.get_preprocess_fn(pp_txt)
    self.label_key = label_key
    self.seconds = {}

  def tokens(self):
    """[classes * templates, L]: every prompt through `pp_txt`, class
    major."""
    rng = np.random.default_rng(0)
    return np.stack([
        np.asarray(self.pp_txt.host({"text": tmpl.format(name)}, rng)[
            "labels"])
        for name in self.class_names for tmpl in self.templates])

  def class_embeddings(self, train_state, tokens):
    """[classes, D]: the prompt-ensembled, renormalized text embeddings."""
    embs = []
    with torch.no_grad():
      for i in range(0, len(tokens), CHUNK):
        part = tokens[i:i + CHUNK]
        n = len(part)
        if n < CHUNK:
          part = np.concatenate([part, np.zeros((CHUNK - n, part.shape[1]),
                                                part.dtype)])
        part = torch.from_numpy(part).to(self.device)
        _, ztxt, _ = self.predict_fn(train_state, {"labels": part})
        embs.append(ztxt[:n].float().cpu().numpy())
    z = np.concatenate(embs).reshape(len(self.class_names),
                                     len(self.templates), -1)
    z = z.mean(axis=1)
    z /= np.linalg.norm(z, axis=-1, keepdims=True) + 1e-8
    return z

  def run(self, train_state):
    t0 = time.perf_counter()
    tokens = self.tokens()
    t1 = time.perf_counter()
    zcls = self.class_embeddings(train_state, tokens)  # [C, D]
    t2 = time.perf_counter()
    ncorrect, nseen = 0, 0
    with torch.no_grad():
      for _, batch in zip(range(self.steps), self.get_data_iter()):
        batch, _ = common.split_batch(batch)
        mask = batch["_mask"].bool().cpu().numpy()
        zimg, _, _ = self.predict_fn(train_state, {"image": batch["image"]})
        zimg = zimg.float().cpu().numpy()
        labels = batch[self.label_key].cpu().numpy()
        preds = np.argmax(zimg @ zcls.T, axis=-1)
        ncorrect += int(np.sum((preds == labels) & mask))
        nseen += int(mask.sum())
    self.seconds = {"tokenize": t1 - t0, "embed_texts": t2 - t1,
                    "images": time.perf_counter() - t2}
    writers.write_note(
        f"discriminative classifier: {len(tokens)} prompts tokenized in "
        f"{self.seconds['tokenize']:.3f} s, embedded in "
        f"{self.seconds['embed_texts']:.3f} s; {nseen} images in "
        f"{self.seconds['images']:.3f} s")
    yield ("prec@1", ncorrect / max(nseen, 1))

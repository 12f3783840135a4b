"""Retrieval recall@k from a distance matrix: port of
big_vision_tpu/evaluators/proj/image_text/image_text_retrieval.py (numpy).

`dist_matrix` is [N_IMAGES, N_TEXTS]; `text_image_correspondence[t]` is
the image row that text column t belongs to (several texts may share an
image). The retrieval evaluator (`retrieval.py`) has its own rank math on
similarities; these functions are the JAX module's distance-matrix API.
"""

from __future__ import annotations

import numpy as np

RECALL_THRESHOLDS = (1, 5, 10)


def _recalls(hits):
  """hits: bool [n_queries, n_candidates], columns sorted by distance."""
  return {f"Recall@{k}": hits[:, :k].any(axis=1).mean()
          for k in RECALL_THRESHOLDS}


def text_to_image_retrieval_eval(dist_matrix, text_image_correspondence):
  """Recall@k of finding each text's image among its nearest images."""
  owner = np.asarray(text_image_correspondence)
  by_distance = np.argsort(dist_matrix, axis=0).T  # [texts, ranked images]
  return _recalls(by_distance == owner[:, None])


def image_to_text_retrieval_eval(dist_matrix, text_image_correspondence):
  """Recall@k of finding any of each image's texts among its nearest."""
  owner = np.asarray(text_image_correspondence)
  by_distance = np.argsort(dist_matrix, axis=1)  # [images, ranked texts]
  image_ids = np.arange(dist_matrix.shape[0])[:, None]
  return _recalls(owner[by_distance] == image_ids)

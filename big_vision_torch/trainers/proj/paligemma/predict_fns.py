"""PaliGemma prediction functions under the trainer's path.

Port of big_vision_tpu/trainers/proj/paligemma/predict_fns.py: the
functions live beside the model (models/proj/paligemma/predict_fns.py);
this module names them where the JAX trainer and runner import them.
"""

from __future__ import annotations

from big_vision_torch.models.proj.paligemma.predict_fns import (  # noqa: F401
    get_sampler, make_predict_fns)


def get_all(model, **kw):
  """Every predict fn of `model`: {"logits", "decode", "decode_with_logp",
  "beam_decode"}."""
  return make_predict_fns(model, **kw)

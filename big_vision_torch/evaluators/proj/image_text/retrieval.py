"""Image<->text retrieval (recall@K): port of
big_vision_tpu/evaluators/proj/image_text/retrieval.py on one device.

Every caption is one row that carries its image's id (`id_key`,
"image/id"). Images are embedded through the predict fn's image half,
captions through its text half; images are deduplicated by id, and the
ranks are taken on the host: text->image is correct where the retrieved
image is the caption's, image->text where any caption of the image is in
the top K. Metrics: `txt2img/recall@K` and `img2txt/recall@K`.

Two forms build the rows:

  * `pp_fn` (the JAX evaluator's form): one eval pipeline whose rows hold
    'image', 'labels' (tokenized text) and the id; every row's image is
    embedded, as in JAX.
  * `pp_img`, `pp_txt` and `txt_name` (the form of the JAX config
    `siglip_lit_coco`, which the JAX evaluator cannot take: it passes
    these keys on to its input pipeline, which refuses them). The source's
    examples are read in order; each image (decoded first where the source
    holds encoded bytes, as TFDS hands out decoded images) goes through
    `pp_img` once, and each caption at the nested key `txt_name` is one row
    of `pp_txt`, under the key `txt_name[-1]`, with its image's id. On the
    same rows it gives the recalls of the `pp_fn` form.
"""

from __future__ import annotations

import numpy as np
import torch

from big_vision_torch import input_pipeline
from big_vision_torch.datasets import core as ds_core
from big_vision_torch.evaluators import common


def recall_at(ranks, ks):
  return {f"recall@{k}": float(np.mean(ranks < k)) for k in ks}


def text_to_image_ranks(sims, txt2img):
  """sims: [n_txt, n_img]; the rank of the correct image per text."""
  order = np.argsort(-sims, axis=1)
  ranks = np.empty(sims.shape[0], np.int64)
  for i, correct in enumerate(txt2img):
    ranks[i] = int(np.nonzero(order[i] == correct)[0][0])
  return ranks


def image_to_text_ranks(sims, txt2img):
  """sims: [n_txt, n_img]; the best rank of any matching caption per
  image."""
  order = np.argsort(-sims.T, axis=1)  # [n_img, n_txt]
  n_img = sims.shape[1]
  ranks = np.full(n_img, sims.shape[0], np.int64)
  for img in range(n_img):
    matching = np.nonzero(txt2img == img)[0]
    if len(matching):
      ranks[img] = int(np.nonzero(np.isin(order[img], matching))[0][0])
  return ranks


def recalls(zimg, img_ids, ztxt, txt_ids, ks):
  """[(metric, value)] of image embeddings (deduplicated by id) against
  caption embeddings."""
  unique_ids, first_idx = np.unique(img_ids, return_index=True)
  id_to_pos = {i: p for p, i in enumerate(unique_ids)}
  txt2img = np.asarray([id_to_pos[i] for i in txt_ids])
  sims = ztxt @ zimg[first_idx].T  # [n_txt, n_img]
  out = [(f"txt2img/{k}", v) for k, v in recall_at(
      text_to_image_ranks(sims, txt2img), ks).items()]
  return out + [(f"img2txt/{k}", v) for k, v in recall_at(
      image_to_text_ranks(sims, txt2img), ks).items()]


class Evaluator:
  """See the module docstring for the two forms."""

  def __init__(self, predict_fn, data, batch_size, device="cuda",
               pp_fn=None, pp_img=None, pp_txt=None, txt_name=None,
               id_key="image/id", ks=(1, 5, 10), cache="pipeline"):
    if (pp_fn is None) == (None in (pp_img, pp_txt, txt_name)):
      raise ValueError("retrieval takes either pp_fn, or pp_img, pp_txt "
                       "and txt_name")
    self.predict_fn = predict_fn
    self.id_key = id_key
    self.ks = tuple(ks)
    self.data, self.batch_size, self.device = dict(data), batch_size, device
    self.pp_img, self.pp_txt = pp_img, pp_txt
    self.txt_name = (txt_name,) if isinstance(txt_name, str) else tuple(
        txt_name or ())
    if pp_fn is not None:
      self.get_data_iter, self.steps = common.eval_input_pipeline(
          data, pp_fn, batch_size, device, cache=cache)

  def _embed(self, train_state, make_iter, steps, halves):
    """({half: embeddings}, ids) of the valid rows of a pipeline, through
    the predict fn's "image" and/or "labels" half."""
    zs, ids = {h: [] for h in halves}, []
    with torch.no_grad():
      for _, batch in zip(range(steps), make_iter()):
        mask = batch["_mask"].bool().cpu().numpy()
        for half in halves:
          z = self.predict_fn(train_state, {half: batch[half]})[
              0 if half == "image" else 1]
          zs[half].append(z.float().cpu().numpy()[mask])
        ids.append(np.asarray(batch[self.id_key].cpu())[mask])
    return {h: np.concatenate(z) for h, z in zs.items()}, np.concatenate(ids)

  def _config_rows(self):
    """(image pipeline, text pipeline) over the source's images and
    captions (see the module docstring)."""
    images, img_ids, texts, txt_ids = [], [], [], []
    for ex in ds_core.get(**self.data).get_examples(ordered=True):
      images.append(ex["image"])
      img_ids.append(ex[self.id_key])
      caps = ex
      for k in self.txt_name:
        caps = caps[k]
      for cap in np.asarray(caps).reshape(-1):
        texts.append(cap)
        txt_ids.append(ex[self.id_key])
    obj = np.empty(len(images), object)
    obj[:] = images
    decode = "decode|" if isinstance(images[0], bytes) else ""
    key = self.txt_name[-1]
    img = input_pipeline.make_for_inference(
        dict(name="arrays", data={"image": obj, self.id_key: np.asarray(
            img_ids)}),
        f"{decode}{self.pp_img}|keep('image', '{self.id_key}')",
        self.batch_size, device=self.device)
    txt = input_pipeline.make_for_inference(
        dict(name="arrays", data={key: np.asarray(texts),
                                  self.id_key: np.asarray(txt_ids)}),
        f"{self.pp_txt}|keep('labels', '{self.id_key}')",
        self.batch_size, device=self.device)
    return img, txt

  def run(self, train_state):
    if self.pp_img is not None:
      (img_iter, img_steps), (txt_iter, txt_steps) = self._config_rows()
      zimg, img_ids = self._embed(train_state, img_iter, img_steps,
                                  ("image",))
      ztxt, txt_ids = self._embed(train_state, txt_iter, txt_steps,
                                  ("labels",))
      zimg, ztxt = zimg["image"], ztxt["labels"]
    else:
      z, img_ids = self._embed(train_state, self.get_data_iter, self.steps,
                               ("image", "labels"))
      zimg, ztxt, txt_ids = z["image"], z["labels"], img_ids
    yield from recalls(zimg, img_ids, ztxt, txt_ids, self.ks)

"""The port's zero-shot classification parts against the JAX package's, on
the CPU.

* `datasets/imagenet/label_data.json` is the JAX package's file, byte for
  byte, and the accessors read the same tables;
* `prompt_engineering`: `get_class_names` for every source (CLIP names of
  imagenet2012 and its _v2/_real sets, ImageNet-A and -R subsets,
  ImageNet-21k, a list), `get_prompt_templates`, `canonicalize_text`;
* the pp ops `clip_i1k_label_names` and `i21k_label_names`;
* the recall functions of `image_text_retrieval` on random distances;
* the discriminative classifier on siglip_smoke's two towers (a ViT-mu/16
  and the text transformer mu) with 4 classes given as a list and the
  CLIP-best templates: class embeddings within 1e-5, `prec@1` equal.
"""

import filecmp
import os

import jax
import numpy as np
import pytest
import torch

from big_vision_torch.configs.proj.image_text import siglip_smoke as t_smoke
from big_vision_torch.datasets import imagenet as t_imagenet
from big_vision_torch.evaluators.proj.image_text import (
    discriminative_classifier as t_dc)
from big_vision_torch.evaluators.proj.image_text import (
    image_text_retrieval as t_itr)
from big_vision_torch.evaluators.proj.image_text import (
    prompt_engineering as t_pe)
from big_vision_torch.models.proj.image_text import two_towers as t_tt
from big_vision_torch.pp import ops_general as t_ops_general  # noqa: F401
from big_vision_torch.pp import ops_image as t_ops_image  # noqa: F401
from big_vision_torch.pp import ops_text as t_ops_text  # noqa: F401
from big_vision_torch.registry import Registry as TRegistry
from big_vision_torch.trainers.proj.image_text import siglip as t_siglip
from big_vision_torch.utils import convert
from big_vision_tpu.datasets import imagenet as j_imagenet
from big_vision_tpu.evaluators.proj.image_text import (
    discriminative_classifier as j_dc)
from big_vision_tpu.evaluators.proj.image_text import (
    image_text_retrieval as j_itr)
from big_vision_tpu.evaluators.proj.image_text import (
    prompt_engineering as j_pe)
from big_vision_tpu.models.proj.image_text import two_towers as j_tt
from big_vision_tpu.ops import attention as j_attention
from big_vision_tpu.pp import ops_general as j_ops_general  # noqa: F401
from big_vision_tpu.pp import ops_image as j_ops_image  # noqa: F401
from big_vision_tpu.pp import ops_text as j_ops_text  # noqa: F401
from big_vision_tpu.registry import Registry as JRegistry

SOURCES = ["imagenet2012", "imagenet_v2", "imagenet2012_real", "imagenet_a",
           "imagenet_r", "imagenet21k", "imagenet-21k"]


def test_label_data_is_the_jax_file_byte_for_byte():
  port = os.path.join(os.path.dirname(t_imagenet.__file__), "label_data.json")
  jax_file = os.path.join(os.path.dirname(j_imagenet.__file__),
                          "label_data.json")
  assert filecmp.cmp(port, jax_file, shallow=False)
  assert t_imagenet.clip_imagenet_class_names() == (
      j_imagenet.clip_imagenet_class_names())
  assert t_imagenet.imagenet21k_class_names() == (
      j_imagenet.imagenet21k_class_names())
  assert t_imagenet.IMAGENET_A_LABELSET == j_imagenet.IMAGENET_A_LABELSET


@pytest.mark.parametrize("canonicalize", [True, False])
@pytest.mark.parametrize("dataset", SOURCES)
def test_class_names_equal_jax(dataset, canonicalize):
  got = t_pe.get_class_names(dataset, canonicalize=canonicalize)
  assert got == j_pe.get_class_names(dataset, canonicalize=canonicalize)
  assert len(got) == {"imagenet_a": 200, "imagenet_r": 200,
                      "imagenet21k": 21843, "imagenet-21k": 21843}.get(
                          dataset, 1000)


def test_class_names_from_a_list_and_refusals_equal_jax():
  names = ["Great_White shark!", "t-shirt", "  two   words "]
  assert t_pe.get_class_names("any", source=names) == j_pe.get_class_names(
      "any", source=names)
  for fn in (t_pe.get_class_names, j_pe.get_class_names):
    with pytest.raises(ValueError):
      fn("cifar10")
    with pytest.raises(ValueError):
      fn("imagenet2012", source="wordnet")


@pytest.mark.parametrize("canonicalize", [True, False])
@pytest.mark.parametrize("name", ["class_name_only", "clip_paper",
                                  "clip_best"])
def test_prompt_templates_equal_jax(name, canonicalize):
  got = t_pe.get_prompt_templates(name, canonicalize=canonicalize)
  assert got == j_pe.get_prompt_templates(name, canonicalize=canonicalize)
  assert all("{}" in t for t in got)


@pytest.mark.parametrize("text,keep", [
    ("A photo of a {}.", "{}"), ("It's_a  Photo, of: the (big) {}!", "{}"),
    ("jack-o'-lantern", None), ("  Tabs\tand\nlines  ", None),
    ("{} and {}, again {}.", "{}"), ("café – naïve", None)])
def test_canonicalize_text_equals_jax(text, keep):
  assert t_pe.canonicalize_text(
      text, keep_punctuation_exact_string=keep) == j_pe.canonicalize_text(
          text, keep_punctuation_exact_string=keep)


@pytest.mark.parametrize("op,labels", [
    ("clip_i1k_label_names", (0, 1, 500, 999)),
    ("i21k_label_names", (0, 7, 21842)),
    ("clip_i1k_label_names(key='y', outkey='name')", (3,))])
def test_label_name_ops_equal_jax(op, labels):
  t_op = TRegistry.lookup(f"preprocess_ops.{op}")()
  j_op = JRegistry.lookup(f"preprocess_ops.{op}")()
  key = "y" if "key='y'" in op else "label"
  for label in labels:
    ex = {key: np.int32(label), "image": np.zeros((2, 2, 3), np.uint8)}
    got, want = t_op.run_host(dict(ex), None), j_op.run_host(dict(ex), None)
    assert sorted(got) == sorted(want)
    out = "name" if "outkey" in op else "labels"
    assert got[out] == want[out] and isinstance(got[out], str)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_retrieval_recalls_equal_jax(seed):
  rs = np.random.RandomState(seed)
  n_img, n_txt = 7, 20
  dist = rs.rand(n_img, n_txt).astype(np.float32)
  owner = rs.randint(0, n_img, n_txt)
  for name in ("text_to_image_retrieval_eval",
               "image_to_text_retrieval_eval"):
    got = getattr(t_itr, name)(dist, owner)
    want = getattr(j_itr, name)(dist, owner)
    assert got.keys() == want.keys() == {"Recall@1", "Recall@5",
                                         "Recall@10"}
    for k in got:
      assert got[k] == pytest.approx(float(want[k]), abs=0), (name, k)


CLASSES = ["tench", "Great white shark", "kite (bird of prey)", "jay"]
PP_TXT = ("tokenize(8, eos='sticky', model='test(128)', pad_value=1, "
          "inkey='text', outkey='labels')")
DATA = dict(name="synthetic", n=12, num_classes=4, h=40, w=40,
            unique_images=12)
PP_IMG = "decode|resize(32)|value_range(-1, 1)|keep('image', 'label')"


def test_discriminative_classifier_equals_jax(monkeypatch):
  # The JAX ViT's attention through its plain reference (XLA), not its
  # Pallas kernel in interpret mode: the same function, compiled faster.
  monkeypatch.setattr(j_attention, "_kernel_ok", lambda *a, **kw: False)
  cfg = t_smoke.get_config()["model"]
  port = t_tt.Model(**cfg, image_size=32, text_len=8, device="cpu")
  port.initialize(torch.Generator().manual_seed(0))
  with torch.no_grad():  # a random text head, so the classes differ
    port.txt.head.weight.normal_(generator=torch.Generator().manual_seed(1))
    port.img.head.weight.normal_(generator=torch.Generator().manual_seed(2))
  params = convert.params(port)
  jax_model = j_tt.Model(**cfg)

  def jax_predict(train_state, batch, **kw):
    return jax_model.apply({"params": train_state["params"]},
                           batch.get("image"), batch.get("labels"), **kw)

  kw = dict(class_name_source=CLASSES, prompt_templates="clip_best",
            pp_txt=PP_TXT, data=DATA, pp_fn=PP_IMG, batch_size=8)
  j_ev = j_dc.Evaluator(jax_predict, devices=jax.devices(), **kw)
  t_ev = t_dc.Evaluator(t_siglip.predict_fns(port, None)["predict"],
                        device="cpu", **kw)
  assert t_ev.class_names == j_ev.class_names
  assert t_ev.templates == j_ev.templates and len(t_ev.templates) == 8
  want = j_ev._class_embeddings({"params": params}, None)  # pylint: disable=protected-access
  got = t_ev.class_embeddings(None, t_ev.tokens())
  assert got.shape == (4, 32)
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
  want = dict(j_ev.run({"params": params}))
  got = dict(t_ev.run(None))
  assert got == {"prec@1": pytest.approx(want["prec@1"], abs=0)}
  assert set(t_ev.seconds) == {"tokenize", "embed_texts", "images"}

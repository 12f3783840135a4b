"""The port's BERT and its WordPiece against the JAX package's, on the CPU.

  * BERT (the "test" config, a 64-token vocabulary) from one JAX init: the
    [CLS] output, the encoded tokens and the head within 1e-5, on captions
    of every length down to [CLS] alone (padding masked with
    `finfo(f32).min`, as flax does), in eval mode; `load` of an `.npz`,
    and its refusal of a TF checkpoint;
  * the WordPiece (`pp/proj/flaxformer/bert_ops.WordPiece`): the ids of
    `transformers.BertTokenizerFast` (uncased) on a corpus with
    punctuation, accents, CJK, control and odd whitespace characters,
    unknown words and a word of 101 characters; and `bert_tokenize` equal
    to the JAX op on the same examples and rngs, one caption drawn from a
    list.
"""

import os

import jax
import numpy as np
import pytest
import torch

from big_vision_torch.models.proj.flaxformer import bert as t_bert
from big_vision_torch.pp import builder as t_builder
from big_vision_torch.pp.proj.flaxformer import bert_ops as t_ops
from big_vision_torch.utils import checkpoints
from big_vision_torch.utils import convert
from big_vision_torch.utils import trees
from big_vision_tpu.models.proj.flaxformer import bert as j_bert
from big_vision_tpu.pp import builder as j_builder
from big_vision_tpu.pp.proj.flaxformer import bert_ops  # noqa: F401

WORDS = ["the", "a", "cat", "dog", "photo", "of", "on", "mat", "##s", "##ing",
         "run", "un", "##aff", "##able", "cafe", "naive", "resume", "elan",
         "!", ",", ".", "?", "'", "-", "(", ")", "中", "国", "人", "1", "2",
         "##3", "e", "##l", "##a", "##n", "i", "σ", "##α", "x", "##x",
         "running", "##ning", "mat", "über"]
CORPUS = [
    "The cat's on the mat!", "A photo of a DOG, running.", "unaffable cafés",
    "Café naïve résumé ÉLAN", "中国人 are people", "x" * 101, "x" * 100,
    "hello\tworld\xa0cats​dogs\x00?", "123 12 ΣΑΣ σα İi Über",
    "weird sep　cats", "(dog)-cat--", "   ", "", "cat�dog",
    "́accent", "Ω≈ç√∫ and ½ ‰ emoji 🐱 dog", "don't stop-running",
]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
  path = tmp_path_factory.mktemp("bert") / "vocab.txt"
  rows = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
  path.write_text("\n".join(rows) + "\n", encoding="utf-8")
  return str(path)


def test_wordpiece_equals_transformers(vocab):
  from transformers import BertTokenizerFast
  want = BertTokenizerFast(vocab_file=vocab, do_lower_case=True)
  got = t_ops.WordPiece(vocab)
  for text in CORPUS:
    assert got.encode(text) == want.encode(text, add_special_tokens=False), (
        text)


def test_bert_tokenize_equals_jax(vocab):
  spec = f"bert_tokenize('{vocab}', 6, inkey='text')"
  t_fn = t_builder.get_preprocess_fn(spec)
  j_fn = j_builder.get_preprocess_fn(spec)
  for i, text in enumerate(CORPUS + [np.asarray(CORPUS[:5])]):
    ex = {"text": text}
    want = j_fn.host(dict(ex), np.random.default_rng((0, i)))["labels"]
    got = t_fn.host(dict(ex), np.random.default_rng((0, i)))["labels"]
    assert got.dtype == want.dtype and np.array_equal(got, want), (text,
                                                                   got, want)


TXT = np.array([[2, 7, 8, 9, 10, 11, 12, 13],
                [2, 7, 8, 0, 0, 0, 0, 0],
                [2, 0, 0, 0, 0, 0, 0, 0],
                [2, 15, 16, 17, 18, 19, 20, 3]], np.int32)


def _models(head_zeroinit=False):
  kw = dict(config="test", num_classes=16, vocab_size=64,
            head_zeroinit=head_zeroinit)
  jm = j_bert.Model(**kw)
  params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                           TXT[:1])["params"])
  tm = t_bert.Model(**kw, device="cpu")
  convert.load(tm, convert.state(tm, params))
  return jm, params, tm


def test_bert_matches_jax():
  jm, params, tm = _models()
  want, jout = jm.apply({"params": params}, TXT)
  with torch.no_grad():
    got, tout = tm(torch.from_numpy(TXT))
  tol = dict(rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(got.numpy(), want, **tol)
  for k in ("pre_logits", "transformed", "logits"):
    np.testing.assert_allclose(tout[k].numpy(), jout[k], **tol)
  back = trees.flatten(convert.params(tm))
  assert sorted(back) == sorted(trees.flatten(params))
  assert all(np.array_equal(back[k], v)
             for k, v in trees.flatten(params).items())


def test_bert_load_matches_jax(tmp_path):
  _, params, tm = _models()
  src = jax.tree.map(lambda x: np.asarray(x) * 2.0, params)
  path = str(tmp_path / "bert.npz")
  checkpoints.npz_save(src, path)
  want = trees.flatten(jax.device_get(j_bert.load(
      params, path, {}, dont_load=["head/.*"])))
  got = trees.flatten(t_bert.load(convert.params(tm), path, {},
                                  dont_load=["head/.*"]))
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  os.makedirs(tmp_path / "release")
  (tmp_path / "release" / "bert_model.ckpt.index").write_bytes(b"")
  with pytest.raises(NotImplementedError, match="TensorFlow"):
    t_bert.load(convert.params(tm), str(tmp_path / "release"), {})


def test_bert_dropout_draws_from_the_generator():
  _, _, tm = _models()
  x = torch.from_numpy(TXT)
  a = tm(x, train=True, rng=torch.Generator().manual_seed(1))[0]
  b = tm(x, train=True, rng=torch.Generator().manual_seed(1))[0]
  c = tm(x)[0]
  torch.testing.assert_close(a, b)
  assert not torch.allclose(a, c)
  with pytest.raises(ValueError, match="generator"):
    tm(x, train=True)

"""The port's text pp vs the JAX package's, on a hand-written vocab.

A unigram SentencePiece `.model` in Gemma's special ids (pad 0, eos 1,
bos 2, unk 3), with byte pieces and a user-defined piece, is written by
`sentencepiece_native.serialize_model_proto` (byte-equal to the writer of
tests/test_sentencepiece_native.py). Both packages' tokenizers
(`tokenizers.sp`, `tokenizers.gemma` with the `loc` and `seg` tokensets,
`tokenizers.test`) must give the same ids, strings and special tokens, and
the PaliGemma pp ops (`tok`, `tolen`, `masked_concat`, `strjoin`,
`majority`, `getidx`) the same arrays. Ids are compared exactly.
"""

import numpy as np
import pytest

from big_vision_torch.pp import builder as t_builder
from big_vision_torch.pp import sentencepiece_native as t_spn
from big_vision_torch.pp import tokenizer as t_tok
import big_vision_torch.pp.proj.paligemma.ops  # noqa: F401
from big_vision_tpu.pp import builder as j_builder
from big_vision_tpu.pp import sentencepiece_native as j_spn
from big_vision_tpu.pp import tokenizer as j_tok
import big_vision_tpu.pp.proj.paligemma.ops  # noqa: F401

N, U, C, UD, B = (t_spn.NORMAL, t_spn.UNKNOWN, t_spn.CONTROL,
                  t_spn.USER_DEFINED, t_spn.BYTE)
VOCAB = [
    ("<pad>", 0.0, C), ("</s>", 0.0, C), ("<s>", 0.0, C), ("<unk>", 0.0, U),
    ("▁hello", -1.0, N), ("▁world", -1.5, N), ("▁", -3.0, N),
    ("hell", -4.0, N), ("o", -4.5, N), ("wor", -4.0, N), ("ld", -4.0, N),
    ("▁caption", -2.0, N), ("▁en", -2.5, N), ("▁what", -2.0, N),
    ("▁is", -2.0, N), ("▁this", -2.0, N), ("?", -3.0, N),
    ("\n", -3.0, UD), ("<0x41>", -20.0, B), ("<0x42>", -20.0, B),
]
TEXTS = ["hello world", "caption en", "  what   is this? ", "helloworld zzz",
         "AB hello", "", "caption en\n"]


@pytest.fixture(scope="module")
def vocab_path(tmp_path_factory):
  path = tmp_path_factory.mktemp("vocab") / "gemma_like.model"
  blob = t_spn.serialize_model_proto(VOCAB, unk_id=3, bos_id=2, eos_id=1,
                                     pad_id=0)
  path.write_bytes(blob)
  return str(path)


def test_native_reader_matches_jax(vocab_path):
  blob = open(vocab_path, "rb").read()
  assert j_spn.parse_model_proto(blob) == t_spn.parse_model_proto(blob)
  t, j = t_spn.SentencePieceNative(blob), j_spn.SentencePieceNative(blob)
  for text in TEXTS:
    assert t.EncodeAsPieces(text) == j.EncodeAsPieces(text), text
    assert t.EncodeAsIds(text) == j.EncodeAsIds(text), text
  ids = list(range(-1, len(VOCAB) + 2))
  assert t.DecodeIds(ids) == j.DecodeIds(ids)


@pytest.mark.parametrize("name", [
    "sp(model={path!r}, tokensets=('loc', 'seg'))",
    "sp(model={path!r}, add_bos=True, add_eos=False)",
    "gemma(tokensets=['loc', 'seg'], model={path!r})",
    "test(100, tokensets=('loc',))"])
def test_tokenizers_match_jax(vocab_path, name):
  name = name.format(path=vocab_path)
  t, j = t_tok.get_tokenizer(name), j_tok.get_tokenizer(name)
  for text in TEXTS:
    for kw in ({}, {"bos": True}, {"eos": True}):
      assert t.to_int(text, **kw) == j.to_int(text, **kw), (text, kw)
  assert t.to_int(TEXTS) == j.to_int(TEXTS)
  for ids in ([4, 5, 1, 6], [2, 11, 12, 17, 4], [0, 3, 18, 19, 7]):
    for stop in (True, False):
      assert t.to_str(ids, stop_at_eos=stop) == j.to_str(
          ids, stop_at_eos=stop)
  for attr in ("pad_token", "eos_token", "bos_token", "vocab_size"):
    assert getattr(t, attr) == getattr(j, attr), attr
  for s in ("<loc0005>", "<loc1023>", "<seg007>", "▁hello", "nope"):
    assert t.string_to_id(s) == j.string_to_id(s), s


def test_tokensets_match_jax():
  for sets in (["loc"], ["seg"], ["loc", "seg", "loc"]):
    assert t_tok.get_extra_tokens(sets) == j_tok.get_extra_tokens(sets)


PP_CASES = [
    "tok(key='prefix', bos='yes', model={tok!r})",
    "tok(key='prefix', length=4, eos='sticky', model={tok!r})",
    "tok(key='prefix', length=12, eos='yes', model={tok!r})",
    "tok(key='septok', text='\\n', model={tok!r})|"
    "tok(key='prefix', model={tok!r})|"
    "masked_concat(['prefix', 'septok'], mask_ar=[0, 1], mask_loss=[0, 1])",
    "tok(key='prefix', bos='yes', model={tok!r})|"
    "tok(key='septok', text='\\n', model={tok!r})|"
    "masked_concat(['prefix', 'septok'], mask_ar=[0, 0], mask_input=[1, 1])"
    "|tolen(10, pad_value=0, key='text')|tolen(10, pad_value=1, "
    "key='mask_ar')|tolen(3, sticky_end=True, pad_value=0, "
    "key='mask_input')",
    "tolen(3, pad_key='fill', inkey='ids', outkey='short')|"
    "tolen(9, pad_key='fill', key='ids')",
    "strjoin(', ', key='answers')",
    "majority(key='answers', outkey='top')",
    "getidx('answers', 'which', 'picked')",
]


@pytest.mark.parametrize("spec", PP_CASES)
def test_paligemma_pp_ops_match_jax(vocab_path, spec):
  tok = f"gemma(tokensets=['loc', 'seg'], model={vocab_path!r})"
  spec = spec.format(tok=tok)
  example = {"prefix": np.array("caption en what is this?"),
             "ids": np.array([5, 6, 7, 8], np.int32),
             "fill": np.array([9], np.int32),
             "answers": np.array([b"cat", b"dog", b"dog", b"cat", b"cow"]),
             "which": np.array(2)}
  want = j_builder.get_preprocess_fn(spec)(dict(example))
  got = t_builder.get_preprocess_fn(spec)(dict(example))
  assert sorted(got) == sorted(want)
  for k, w in want.items():
    w, g = np.asarray(w), np.asarray(got[k])
    if w.dtype.kind in "SUO":
      assert g.tolist() == w.tolist(), k
    else:
      assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
      np.testing.assert_array_equal(g, w, err_msg=k)


def test_pp_ops_refuse_bad_arguments(vocab_path):
  tok = f"gemma(model={vocab_path!r})"
  with pytest.raises(ValueError):
    t_builder.get_preprocess_fn(f"tok(key='a', bos='maybe', model={tok!r})")
  with pytest.raises(ValueError):
    t_builder.get_preprocess_fn("masked_concat(['a', 'b'], mask_ar=[0])")
  with pytest.raises(ValueError):
    t_builder.get_preprocess_fn("tolen(3, key='a')")({"a": np.arange(5)})

"""Tokenizer interface and registry: port of big_vision_tpu/pp/tokenizer.py.

`get_tokenizer("name(args)")` builds a registered tokenizer, importing
`big_vision_torch.pp.<name>` first when the name is not registered yet.
`tokensets` append extra tokens after a vocab (PaliGemma's `loc` and `seg`
tokens), as in the JAX package.

Implementations:
  tokenizers.sp(model)  - SentencePiece: the sentencepiece package where it
                          is installed, else the native unigram reader
                          (pp/sentencepiece_native.py) on the same file.
  tokenizers.test(n)    - a deterministic word-hash tokenizer for tests and
                          synthetic data (no file).

The JAX package's `tokenizers.hf` (HuggingFace tokenizer.json) is not
ported.
"""

from __future__ import annotations

import functools
import hashlib
import importlib
import threading
from typing import Protocol

import numpy as np

from big_vision_torch import registry as bvt_registry

Registry = bvt_registry.Registry


class Tokenizer(Protocol):
  def to_int(self, text, *, bos=False, eos=False):
    """Text (str or list[str]) -> list[int] (or list of lists)."""

  def to_str(self, tokens, *, stop_at_eos=True):
    """Inverse of to_int; strips control tokens."""

  @property
  def pad_token(self):
    ...

  @property
  def eos_token(self):
    ...

  @property
  def bos_token(self):
    ...

  @property
  def vocab_size(self):
    ...


@functools.cache
def get_tokenizer(name) -> Tokenizer:
  if not Registry.knows(f"tokenizers.{name}"):
    raw_name, *_ = bvt_registry.parse_name(name)
    importlib.import_module(f"big_vision_torch.pp.{raw_name}")
  return Registry.lookup(f"tokenizers.{name}")()


def get_extra_tokens(tokensets):
  """The tokens of the named tokensets, in order, each once."""
  extra = []
  for ts in tokensets:
    extra.extend(Registry.lookup(f"tokensets.{ts}")())
  return list(dict.fromkeys(extra))


@Registry.register("tokensets.loc")
def _get_loc1024(n=1024):
  """PaliGemma detection coordinate tokens."""
  return [f"<loc{i:04d}>" for i in range(n)]


@Registry.register("tokensets.seg")
def _get_seg(n=128):
  """PaliGemma segmentation VQ tokens."""
  return [f"<seg{i:03d}>" for i in range(n)]


class _ListOrOne:
  """Mixin handling str vs list[str] inputs uniformly."""

  def _one_to_int(self, text, bos, eos):
    raise NotImplementedError

  def to_int(self, text, *, bos=False, eos=False):
    if isinstance(text, (list, tuple, np.ndarray)):
      return [self._one_to_int(_as_str(t), bos, eos) for t in text]
    return self._one_to_int(_as_str(text), bos, eos)


def _as_str(t):
  return t.decode() if isinstance(t, bytes) else str(t)


@Registry.register("tokenizers.sp")
def get_sp_tokenizer(model="c4_en", add_bos=False, add_eos=True,
                     tokensets=()):
  """SentencePiece tokenizer over a local `.model` file (the JAX package's
  `gs://` vocab names are mapped, but nothing is fetched)."""
  known = {
      "c4_en": "gs://t5-data/vocabs/cc_en.32000/sentencepiece.model",
      "cc_all": "gs://t5-data/vocabs/cc_all.32000/sentencepiece.model",
      "mc4": "gs://t5-data/vocabs/mc4.250000.100extra/sentencepiece.model",
      "t5": "gs://t5-data/vocabs/cc_all.32000/sentencepiece.model",
  }
  model = known.get(model, model)

  class SPTokenizer(_ListOrOne):
    """Reads the vocab at first use, not when built: parsing a pp string
    that names a vocab touches no file."""

    def __init__(self):
      self._sp = None
      self._lock = threading.Lock()

    @property
    def sp(self):
      if self._sp is None:
        with self._lock:
          if self._sp is None:
            with open(model, "rb") as f:
              blob = f.read()
            try:
              import sentencepiece as spm  # pylint: disable=import-outside-toplevel
              sp = spm.SentencePieceProcessor(model_proto=blob)
            except ImportError:
              from big_vision_torch.pp import sentencepiece_native  # pylint: disable=import-outside-toplevel
              sp = sentencepiece_native.SentencePieceNative(blob)
            self._extra_tokens = {
                t: sp.GetPieceSize() + i
                for i, t in enumerate(get_extra_tokens(tokensets))}
            self._sp = sp
      return self._sp

    @property
    def _extra(self):
      self.sp  # pylint: disable=pointless-statement
      return self._extra_tokens

    def _one_to_int(self, text, bos, eos):
      ids = self.sp.EncodeAsIds(text)
      if bos or add_bos:
        ids = [self.sp.bos_id()] + ids
      if eos or add_eos:
        ids = ids + [self.sp.eos_id()]
      return ids

    def to_str(self, tokens, *, stop_at_eos=True):
      tokens = list(map(int, tokens))
      if stop_at_eos and self.sp.eos_id() in tokens:
        tokens = tokens[:tokens.index(self.sp.eos_id())]
      return self.sp.DecodeIds(tokens)

    @property
    def pad_token(self):
      return self.sp.pad_id()

    @property
    def eos_token(self):
      return self.sp.eos_id()

    @property
    def bos_token(self):
      return self.sp.bos_id()

    @property
    def vocab_size(self):
      return self.sp.GetPieceSize() + len(self._extra)

    def string_to_id(self, s):
      return self._extra.get(s, self.sp.PieceToId(s))

  return SPTokenizer()


@Registry.register("tokenizers.test")
def get_test_tokenizer(vocab_size=1000, tokensets=()):
  """Deterministic word-hash tokenizer: pad=0 eos=1 bos=2 unk=3.

  Invertibility is approximate (hash buckets), but ids are stable across
  runs and processes.
  """

  class TestTokenizer(_ListOrOne):
    def __init__(self):
      self._extra = {t: vocab_size + i
                     for i, t in enumerate(get_extra_tokens(tokensets))}
      self._cache = {}

    def _word_id(self, w):
      if w in self._extra:
        return self._extra[w]
      if w not in self._cache:
        h = int.from_bytes(hashlib.sha256(w.encode()).digest()[:4], "little")
        self._cache[w] = 4 + h % (vocab_size - 4)
      return self._cache[w]

    def _one_to_int(self, text, bos, eos):
      ids = [self._word_id(w) for w in text.split()]
      if bos:
        ids = [2] + ids
      if eos:
        ids = ids + [1]
      return ids

    def to_str(self, tokens, *, stop_at_eos=True):
      tokens = list(map(int, tokens))
      if stop_at_eos and 1 in tokens:
        tokens = tokens[:tokens.index(1)]
      return " ".join(f"tok{t}" for t in tokens if t > 3)

    pad_token = 0
    eos_token = 1
    bos_token = 2

    @property
    def vocab_size(self):
      return vocab_size + len(self._extra)

    def string_to_id(self, s):
      if s == "<pad>":
        return 0
      if s == "</s>":
        return 1
      return self._word_id(s)

  return TestTokenizer()

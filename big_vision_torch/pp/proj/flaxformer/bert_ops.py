"""BERT WordPiece tokenization: port of
big_vision_tpu/pp/proj/flaxformer/bert_ops.py with its own tokenizer.

The JAX op tokenizes through `transformers.BertTokenizerFast` (uncased);
the port does the same in plain Python (`WordPiece`), from the same
`vocab.txt` (one token a line, its id the line number):

  * BERT's basic tokenizer: control characters, NUL and U+FFFD are
    dropped and whitespace becomes a space; CJK ideographs are split off;
    accents are stripped (NFD, then the nonspacing marks dropped) and each
    character is lower-cased; the text is split on whitespace and every
    punctuation character is a word of its own;
  * WordPiece: greedy longest-match-first over the vocabulary, pieces after
    the first prefixed "##"; a word with no full cover, or over 100
    characters, is one "[UNK]".

`bert_tokenize` gives [CLS] and then the ids, cut to max_len, zero-padded;
a list of texts gives one drawn from the example's rng.
"""

from __future__ import annotations

import functools
import unicodedata

import numpy as np

from big_vision_torch.pp.utils import PPOp
from big_vision_torch.registry import Registry


def _is_control(ch):
  if ch in "\t\n\r":
    return False
  return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch):
  cp = ord(ch)
  if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
    return True
  return unicodedata.category(ch).startswith("P")


_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
        (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
        (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _is_cjk(ch):
  cp = ord(ch)
  return any(lo <= cp <= hi for lo, hi in _CJK)


def basic_tokenize(text):
  """BERT's uncased basic tokenizer: the list of words and punctuation."""
  chars = []
  for ch in text:
    if ch in ("\0", "�") or _is_control(ch):
      continue
    ch = " " if ch.isspace() else ch
    chars.append(f" {ch} " if _is_cjk(ch) else ch)
  text = unicodedata.normalize("NFD", "".join(chars))
  text = "".join(c.lower() for c in text
                 if unicodedata.category(c) != "Mn")
  words = []
  for token in text.split():
    word = ""
    for ch in token:
      if _is_punctuation(ch):
        words += [word, ch] if word else [ch]
        word = ""
      else:
        word += ch
    if word:
      words.append(word)
  return words


class WordPiece:
  """The uncased BERT tokenizer of a `vocab.txt`."""

  def __init__(self, vocab_path, unk="[UNK]", max_chars=100):
    with open(vocab_path, encoding="utf-8") as f:
      lines = f.read().split("\n")
    self.vocab = {}
    for i, line in enumerate(lines):
      if line.rstrip():
        self.vocab[line.rstrip()] = i
    self.cls_id = lines.index("[CLS]")
    self.unk_id = self.vocab[unk]
    self.max_chars = max_chars

  def word_ids(self, word):
    if len(word) > self.max_chars:
      return [self.unk_id]
    ids, start = [], 0
    while start < len(word):
      for end in range(len(word), start, -1):
        piece = word[start:end] if start == 0 else f"##{word[start:end]}"
        if piece in self.vocab:
          ids.append(self.vocab[piece])
          start = end
          break
      else:
        return [self.unk_id]
    return ids

  def encode(self, text):
    """The WordPiece ids of `text`, without special tokens."""
    return [i for w in basic_tokenize(text) for i in self.word_ids(w)]


@functools.lru_cache(maxsize=None)
def get_tokenizer(vocab_path):
  return WordPiece(vocab_path)


@Registry.register("preprocess_ops.bert_tokenize")
def get_pp_bert_tokenize(vocab_path, max_len, sample_if_multi=True,
                         key=None, inkey=None, outkey="labels"):
  """WordPiece-tokenizes one text: [CLS] + ids, zero-padded to max_len."""
  ik = inkey or key

  def _bert_tokenize(data, np_rng):
    tokenizer = get_tokenizer(vocab_path)
    data = dict(data)
    texts = np.asarray(data[ik]).reshape(-1)
    texts = [t.decode() if isinstance(t, bytes) else str(t) for t in texts]
    if sample_if_multi and len(texts) > 1:
      txt = texts[int(np_rng.integers(0, len(texts)))]
    else:
      txt = texts[0] if texts else ""
    ids = tokenizer.encode(txt)[:max_len - 1]
    out = np.zeros((max_len,), np.int32)
    out[0] = tokenizer.cls_id
    out[1:1 + len(ids)] = ids
    data[outkey] = out
    return data

  return PPOp(host_fn=_bert_tokenize, phase="host", random=True,
              staticizer=True, name="bert_tokenize")

"""Dependency-free SentencePiece inference: .model parsing + unigram Viterbi.

The port's copy of big_vision_tpu/pp/sentencepiece_native.py (the port
imports nothing of the JAX package). The reference tokenizes through the
sentencepiece C++ library; where that package is missing, this module
implements the inference half:

  * a minimal protobuf wire-format reader for ModelProto
    (sentencepiece_model.proto: pieces, trainer_spec ids, normalizer_spec),
  * SentencePiece's text normalization (NFKC family, whitespace escaping
    to U+2581, dummy prefix),
  * exact unigram-LM segmentation (Viterbi over piece scores) with
    byte-fallback and unk handling.

Covers unigram models (T5/mT5/Gemma vocabs). BPE-type models raise.
The sentencepiece package, when installed, takes priority in
pp/tokenizer.py.
"""

from __future__ import annotations

import struct
import unicodedata

_WS = "▁"  # SentencePiece's visible space.

# SentencePiece piece types (ModelProto.SentencePiece.Type).
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


# ---------------------------------------------------------------------------
# Protobuf wire-format reader (only what ModelProto needs)
# ---------------------------------------------------------------------------

def _read_varint(buf, i):
  out = shift = 0
  while True:
    b = buf[i]
    i += 1
    out |= (b & 0x7F) << shift
    if not b & 0x80:
      return out, i
    shift += 7


def _fields(buf):
  """Yields (field_number, wire_type, value) over one message."""
  i = 0
  while i < len(buf):
    tag, i = _read_varint(buf, i)
    field, wire = tag >> 3, tag & 7
    if wire == 0:  # varint
      val, i = _read_varint(buf, i)
    elif wire == 1:  # 64-bit
      val, i = buf[i:i + 8], i + 8
    elif wire == 2:  # length-delimited
      ln, i = _read_varint(buf, i)
      val, i = buf[i:i + ln], i + ln
    elif wire == 5:  # 32-bit
      val, i = buf[i:i + 4], i + 4
    else:
      raise ValueError(f"unsupported wire type {wire}")
    yield field, wire, val


def parse_model_proto(data: bytes):
  """Returns (pieces, trainer, normalizer) dicts from a .model blob.

  pieces: list of (piece_str, score, type). trainer: model_type and the
  special ids. normalizer: name/add_dummy_prefix/remove_extra_whitespaces/
  escape_whitespaces.
  """
  pieces = []
  trainer = {"model_type": 1, "unk_id": 0, "bos_id": 1, "eos_id": 2,
             "pad_id": -1}
  norm = {"name": "nmt_nfkc", "add_dummy_prefix": True,
          "remove_extra_whitespaces": True, "escape_whitespaces": True}
  for field, _, val in _fields(data):
    if field == 1:  # repeated SentencePiece
      piece, score, ptype = "", 0.0, NORMAL
      for f2, w2, v2 in _fields(val):
        if f2 == 1:
          piece = v2.decode("utf-8")
        elif f2 == 2:
          score = struct.unpack("<f", v2)[0]
        elif f2 == 3:
          ptype = v2
      pieces.append((piece, score, ptype))
    elif field == 2:  # TrainerSpec
      for f2, w2, v2 in _fields(val):
        if f2 == 3:
          trainer["model_type"] = v2  # 1=unigram, 2=bpe
        elif f2 == 40:
          trainer["unk_id"] = v2
        elif f2 == 41:
          trainer["bos_id"] = v2
        elif f2 == 42:
          trainer["eos_id"] = v2
        elif f2 == 43:
          trainer["pad_id"] = v2
    elif field == 3:  # NormalizerSpec
      for f2, w2, v2 in _fields(val):
        if f2 == 1:
          norm["name"] = v2.decode("utf-8")
        elif f2 == 3:
          norm["add_dummy_prefix"] = bool(v2)
        elif f2 == 4:
          norm["remove_extra_whitespaces"] = bool(v2)
        elif f2 == 5:
          norm["escape_whitespaces"] = bool(v2)
  # proto3 zigzag for negative ids is not used here: sentencepiece stores
  # pad_id=-1 as a 10-byte two's-complement varint.
  for k in ("unk_id", "bos_id", "eos_id", "pad_id"):
    if trainer[k] >= 2 ** 63:
      trainer[k] -= 2 ** 64
  return pieces, trainer, norm


def _varint(n):
  if n < 0:  # two's complement in 10 bytes, as protobuf writes int32 -1
    n += 2 ** 64
  out = b""
  while True:
    b, n = n & 0x7F, n >> 7
    if not n:
      return out + bytes([b])
    out += bytes([b | 0x80])


def _len_field(num, payload):
  return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _varint_field(num, val):
  return _varint(num << 3) + _varint(val)


def serialize_model_proto(pieces, *, unk_id=0, bos_id=1, eos_id=2,
                          pad_id=-1, add_dummy_prefix=True):
  """The inverse of `parse_model_proto` for a unigram model: pieces
  [(piece, score, type)] and the special ids -> a `.model` blob, which the
  sentencepiece package reads too. For vocabs written by hand (tests, runs
  with no published vocab at hand)."""
  blob = b"".join(
      _len_field(1, _len_field(1, p.encode()) + _varint(2 << 3 | 5)
                 + struct.pack("<f", score) + _varint_field(3, t))
      for p, score, t in pieces)
  trainer = (_varint_field(3, 1) + _varint_field(40, unk_id)
             + _varint_field(41, bos_id) + _varint_field(42, eos_id)
             + _varint_field(43, pad_id))
  norm = (_len_field(1, b"nmt_nfkc")
          + _varint_field(3, int(add_dummy_prefix))
          + _varint_field(4, 1) + _varint_field(5, 1))
  return blob + _len_field(2, trainer) + _len_field(3, norm)


# ---------------------------------------------------------------------------
# Unigram tokenizer
# ---------------------------------------------------------------------------

class SentencePieceNative:
  """Drop-in for the inference surface of SentencePieceProcessor."""

  def __init__(self, model_bytes: bytes):
    pieces, trainer, norm = parse_model_proto(model_bytes)
    if trainer["model_type"] != 1:
      raise NotImplementedError(
          "native SentencePiece backend supports unigram models only; "
          "install the sentencepiece package for BPE models")
    self._pieces = pieces
    self._trainer = trainer
    self._norm = norm
    self._piece_to_id = {}
    self._scores = {}
    self._byte_ids = {}
    self._max_piece_len = 1
    self._user_defined = set()
    for i, (p, score, t) in enumerate(pieces):
      if t == BYTE:
        # Pieces like "<0xAB>".
        self._byte_ids[int(p[1:-1], 16)] = i
        continue
      if t in (CONTROL, UNKNOWN, UNUSED):
        self._piece_to_id.setdefault(p, i)
        continue
      self._piece_to_id.setdefault(p, i)
      self._scores[p] = score
      self._max_piece_len = max(self._max_piece_len, len(p))
      if t == USER_DEFINED:
        self._user_defined.add(p)
    self._unk_penalty = min(self._scores.values(), default=0.0) - 10.0

  # -- normalization ------------------------------------------------------

  def normalize(self, text: str) -> str:
    if "nfkc" in self._norm["name"]:
      text = unicodedata.normalize("NFKC", text)
    if self._norm["remove_extra_whitespaces"]:
      text = " ".join(text.split())
    if self._norm["add_dummy_prefix"] and text:
      text = " " + text
    if self._norm["escape_whitespaces"]:
      text = text.replace(" ", _WS)
    return text

  # -- encoding -----------------------------------------------------------

  def EncodeAsPieces(self, text: str):
    text = self.normalize(text)
    n = len(text)
    if not n:
      return []
    # Viterbi: best[i] = (score, prev_index, piece). User-defined pieces
    # match greedily with +inf-like preference, matching sentencepiece's
    # behavior of always extracting user_defined symbols.
    NEG = float("-inf")
    best = [NEG] * (n + 1)
    back = [None] * (n + 1)
    best[0] = 0.0
    unk_penalty = self._unk_penalty
    for i in range(n):
      if best[i] == NEG:
        continue
      matched = False
      for ln in range(1, min(self._max_piece_len, n - i) + 1):
        cand = text[i:i + ln]
        sc = self._scores.get(cand)
        if sc is None:
          continue
        if cand in self._user_defined:
          sc = 1e6  # always win
        matched = True
        if best[i] + sc > best[i + ln]:
          best[i + ln] = best[i] + sc
          back[i + ln] = (i, cand)
      if not matched or best[i] + unk_penalty > best[i + 1]:
        # Single-char unk fallback keeps the lattice connected.
        cand = text[i]
        if cand not in self._scores:
          if best[i] + unk_penalty > best[i + 1]:
            best[i + 1] = best[i] + unk_penalty
            back[i + 1] = (i, cand)
    out = []
    i = n
    while i > 0:
      j, piece = back[i]
      out.append(piece)
      i = j
    return out[::-1]

  def EncodeAsIds(self, text: str):
    ids = []
    unk = self._trainer["unk_id"]
    for p in self.EncodeAsPieces(text):
      pid = self._piece_to_id.get(p)
      if pid is not None and p in self._scores:
        ids.append(pid)
        continue
      # Byte fallback, then unk.
      bs = p.encode("utf-8")
      if self._byte_ids and all(b in self._byte_ids for b in bs):
        ids.extend(self._byte_ids[b] for b in bs)
      else:
        ids.append(unk)
    return ids

  # -- decoding -----------------------------------------------------------

  def DecodeIds(self, ids):
    out, byte_buf = [], []

    def flush_bytes():
      if byte_buf:
        out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
        byte_buf.clear()

    for i in ids:
      if not 0 <= i < len(self._pieces):
        continue
      piece, _, t = self._pieces[i]
      if t == BYTE:
        byte_buf.append(int(piece[1:-1], 16))
        continue
      flush_bytes()
      if t in (CONTROL, UNUSED):
        continue
      if t == UNKNOWN:
        out.append(" ⁇ ")  # sentencepiece's default unk surface
        continue
      out.append(piece)
    flush_bytes()
    text = "".join(out).replace(_WS, " ")
    return text[1:] if text.startswith(" ") else text

  # -- SentencePieceProcessor surface used by pp/tokenizer.py -------------

  def GetPieceSize(self):
    return len(self._pieces)

  def PieceToId(self, piece):
    return self._piece_to_id.get(piece, self._trainer["unk_id"])

  def IdToPiece(self, i):
    return self._pieces[i][0]

  def bos_id(self):
    return self._trainer["bos_id"]

  def eos_id(self):
    return self._trainer["eos_id"]

  def pad_id(self):
    return self._trainer["pad_id"]

  def unk_id(self):
    return self._trainer["unk_id"]

"""BPE tokenizer backends for the text models whose directories ship no
``tokenizer.json``.

Counterpart of the JAX package's ``data/bpe_backends.py``. With
``use_native`` (the default) each encodes in the port's C++ library
(``csrc/tokenizer.cpp``, ``data/native.py``) when it builds, with the ids of
the Python path, which runs otherwise:

* ``SentencePieceBPE``: Bernice / XLM-R layout, a ``sentencepiece.bpe.model``
  protobuf. ``read_spm_pieces`` decodes the ModelProto's wire format itself
  (repeated field 1, SentencePiece: piece = 1, string; score = 2, float;
  type = 3, enum), so neither ``sentencepiece`` nor ``transformers`` is
  needed. Encoding is SentencePiece's BPE merge loop (the greedy
  highest-score adjacent merge); ids use the fairseq alignment of
  ``XLMRobertaTokenizer``: ``{<s>:0, <pad>:1, </s>:2, <unk>:3}`` then
  ``sp_id + 1``.
* ``FastBPE``: BERTweet layout, a fairseq ``vocab.txt`` (token and count per
  line) and ``bpe.codes`` merges with ``</w>`` end-of-word markers and ``@@``
  continuation suffixes, as ``transformers.BertweetTokenizer``; ids are
  ``{<s>:0, <pad>:1, </s>:2, <unk>:3}`` then vocab order.

Both emit the fixed-shape (ids, mask, token_type_ids or None) triple with
the RoBERTa-style ``<s> x </s>`` layout.
"""

from __future__ import annotations

import os
import struct
import unicodedata
from typing import Iterator, List, Optional, Tuple

import numpy as np

from . import native

SPM_NORMAL = 1
SPM_UNKNOWN = 2
SPM_CONTROL = 3


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of each field of a protobuf message:
    an int for a varint, bytes for the other wire types."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"protobuf wire type {wire} of field {field} is not taken")
        yield field, wire, value


def read_spm_pieces(model_path: str) -> List[Tuple[str, float, int]]:
    """A sentencepiece ModelProto -> [(piece, score, type)], in id order."""
    with open(model_path, "rb") as f:
        buf = f.read()
    pieces = []
    for field, wire, value in _fields(buf):
        if field != 1 or wire != 2:
            continue  # trainer, normalizer and other specs
        piece, score, typ = "", 0.0, SPM_NORMAL
        for f2, w2, v2 in _fields(value):
            if f2 == 1 and w2 == 2:
                piece = v2.decode("utf-8")
            elif f2 == 2 and w2 == 5:
                (score,) = struct.unpack("<f", v2)
            elif f2 == 3 and w2 == 0:
                typ = v2
        pieces.append((piece, score, typ))
    return pieces


def _token_types(n: int, max_length: int, use_token_types: bool):
    return np.zeros((n, max_length), np.int32) if use_token_types else None


def _pad_rows(rows: List[List[int]], max_length: int, pad_id: int, use_token_types: bool):
    n = len(rows)
    ids = np.full((n, max_length), pad_id, np.int32)
    mask = np.zeros((n, max_length), np.int32)
    for i, row in enumerate(rows):
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    return ids, mask, _token_types(n, max_length, use_token_types)


class SentencePieceBPE:
    """SentencePiece-BPE encoder over a parsed ModelProto (XLM-R family)."""

    def __init__(self, model_path: str, max_length: int, use_token_types: bool = False,
                 use_native: bool = True):
        pieces = read_spm_pieces(model_path)
        self.scores = {}
        self.sp_ids = {}
        for i, (piece, score, typ) in enumerate(pieces):
            self.sp_ids[piece] = i
            if typ == SPM_NORMAL:
                self.scores[piece] = score
        self.max_length = max_length
        self.use_token_types = use_token_types
        # fairseq alignment (XLMRobertaTokenizer): sp ids shift by +1, specials pinned
        self.bos_id, self.pad_token_id, self.eos_id, self.unk_id = 0, 1, 2, 3
        self.offset = 1
        lib = native.TOKENIZER.get() if use_native else None
        self._native = None if lib is None else native.NativeSpBpe(
            lib, [p for p, _, _ in pieces], np.float32([s for _, s, _ in pieces]),
            np.uint8([t == SPM_NORMAL for _, _, t in pieces]))

    def _normalize(self, text: str) -> str:
        # The JAX package's approximation of the nmt_nfkc normalizer: NFKC,
        # control characters to spaces, runs of whitespace collapsed
        text = unicodedata.normalize("NFKC", text)
        out = []
        for ch in text:
            if ch in ("\t", "\n", "\r") or unicodedata.category(ch) in ("Cc", "Cf"):
                ch = " "
            out.append(ch)
        return " ".join("".join(out).split())

    def _bpe(self, text: str) -> List[str]:
        """Greedy highest-score adjacent merge (sentencepiece bpe_model.cc)."""
        symbols = list(text)
        if not symbols:
            return []
        while True:
            best_score, best_i = None, -1
            for i in range(len(symbols) - 1):
                s = self.scores.get(symbols[i] + symbols[i + 1])
                if s is not None and (best_score is None or s > best_score):
                    best_score, best_i = s, i
            if best_i < 0:
                break
            symbols[best_i:best_i + 2] = [symbols[best_i] + symbols[best_i + 1]]
        return symbols

    def _marked(self, text: str) -> str:
        """Normalized, with the dummy prefix and the word markers."""
        text = self._normalize(text)
        return "▁" + text.replace(" ", "▁") if text else ""

    def tokenize(self, text: str) -> List[str]:
        marked = self._marked(text)
        return self._bpe(marked) if marked else []

    def _token_id(self, token: str) -> int:
        sp = self.sp_ids.get(token)
        if sp is None or sp == 0:  # absent, or the sp-level <unk>
            return self.unk_id
        return sp + self.offset

    def encode_batch(self, texts: List[str]):
        L = self.max_length
        if self._native is not None:
            ids, mask = self._native.encode_batch([self._marked(str(t)) for t in texts], L)
            return ids, mask, _token_types(len(texts), L, self.use_token_types)
        rows = [[self.bos_id] + [self._token_id(t) for t in self.tokenize(str(text))][:L - 2]
                + [self.eos_id] for text in texts]
        return _pad_rows(rows, L, self.pad_token_id, self.use_token_types)


class FastBPE:
    """fastBPE encoder over BERTweet's vocab.txt + bpe.codes."""

    def __init__(self, vocab_path: str, merges_path: str, max_length: int,
                 use_token_types: bool = False, use_native: bool = True):
        self.encoder = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
        with open(vocab_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                idx = line.rfind(" ")
                if idx == -1:
                    raise ValueError(
                        f"bad fairseq vocab line (expected '<token> <cnt>'): {line!r}")
                self.encoder[line[:idx]] = len(self.encoder)
        with open(merges_path, encoding="utf-8") as f:
            merges = f.read().split("\n")[:-1]
        # bpe.codes lines are "left right count"; rank = line order
        self.bpe_ranks = {tuple(m.split()[:-1]): r for r, m in enumerate(merges)}
        self.cache = {}
        self.max_length = max_length
        self.use_token_types = use_token_types
        self.bos_id, self.pad_token_id, self.eos_id, self.unk_id = 0, 1, 2, 3
        lib = native.TOKENIZER.get() if use_native else None
        self._native = None if lib is None else native.NativeFastBpe(lib, vocab_path, merges_path)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token)
        word = tuple(list(word[:-1]) + [word[-1] + "</w>"])
        pairs = {(a, b) for a, b in zip(word, word[1:])}
        if not pairs:
            return token  # single-character quirk of BertweetTokenizer.bpe, kept
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = {(a, b) for a, b in zip(word, word[1:])}
        out = "@@ ".join(word)[:-4]  # drop the trailing </w>
        self.cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        toks: List[str] = []
        for word in str(text).split():
            toks.extend(self._bpe(word).split(" "))
        return toks

    def encode_batch(self, texts: List[str]):
        L = self.max_length
        if self._native is not None:
            ids, mask = self._native.encode_batch([str(t) for t in texts], L)
            return ids, mask, _token_types(len(texts), L, self.use_token_types)
        rows = [[self.bos_id] + [self.encoder.get(t, self.unk_id)
                                 for t in self.tokenize(text)][:L - 2] + [self.eos_id]
                for text in texts]
        return _pad_rows(rows, L, self.pad_token_id, self.use_token_types)


def try_sp_bpe(model_dir: str, max_length: int,
               use_token_types: bool) -> Optional[SentencePieceBPE]:
    path = os.path.join(model_dir, "sentencepiece.bpe.model")
    if not os.path.isfile(path):
        return None
    return SentencePieceBPE(path, max_length, use_token_types)


def try_fast_bpe(model_dir: str, max_length: int,
                 use_token_types: bool) -> Optional[FastBPE]:
    merges = os.path.join(model_dir, "bpe.codes")
    vocab = os.path.join(model_dir, "vocab.txt")
    if not (os.path.isfile(merges) and os.path.isfile(vocab)):
        return None
    return FastBPE(vocab, merges, max_length, use_token_types)

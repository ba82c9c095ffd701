"""Hugging Face tokenizer layouts, read without the Rust ``tokenizers`` package.

Counterpart of the JAX package's ``data/tokenizers.py::_rust_backend``, which
reads three layouts through ``tokenizers``:

* a BERT ``vocab.txt``: ``BertWordPieceTokenizer(vocab.txt, lowercase=True)``
  (``BertWordPiece`` here);
* RoBERTa's ``vocab.json`` + ``merges.txt``: ``ByteLevelBPETokenizer`` with
  ``RobertaProcessing`` (``ByteLevelBPE``); the two files register no special
  token, so a literal ``<s>`` in a post is encoded as text;
* a ``tokenizer.json``: the pipeline the file describes (``TokenizerJson``).

One class per component of that pipeline, run in its order by
``HFTokenizer``:

    AddedTokens -> BertNormalizer -> BertPreTokenizer | ByteLevel
                -> WordPiece | BPE -> Template -> truncation, padding

A ``tokenizer.json`` component other than those (``Precompiled``,
``Metaspace``, ``Unigram``, ...) raises ``UnreadComponent`` naming it.

Character classes. ``tokenizers`` takes its nonspacing marks (``Mn``),
format characters (``Cf``) and punctuation from Unicode 9-era tables (the
``unicode_categories`` crate), and whitespace, letters, numbers and case
from a current Unicode; Python's ``unicodedata`` is Unicode 15.0. The port
classifies with Python's tables and carries the code points on which the
older tables differ (``_NOT_MN`` and the rest below), so every code point
assigned in Unicode 15.0 gets the class the Rust library gives it. Code
points assigned later are unassigned to Python and keep its classes.
"""

from __future__ import annotations

import heapq
import json
import string
import unicodedata
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np

# Unicode White_Space: Rust's char::is_whitespace, and \s of the Rust and
# Oniguruma regular expressions
WHITE_SPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
                        + "".join(map(chr, range(0x2000, 0x200B))))
# BertNormalizer's CJK blocks, padded with spaces
_CJK = ((0x3400, 0x4DBF), (0x4E00, 0x9FFF), (0xF900, 0xFAFF), (0x20000, 0x2A6DF),
        (0x2A700, 0x2B81F), (0x2B920, 0x2CEAF), (0x2F800, 0x2FA1F))
# Mn in Unicode 15.0 but not to the Rust library (added to Unicode after its tables)
_NOT_MN = (
    (0x7FD, 0x7FD), (0x898, 0x89F), (0x8CA, 0x8E1), (0x9FE, 0x9FE), (0xAFA, 0xAFF),
    (0xB55, 0xB55), (0xC04, 0xC04), (0xC3C, 0xC3C), (0xD00, 0xD00), (0xD3B, 0xD3C),
    (0xD81, 0xD81), (0xEBA, 0xEBA), (0xECE, 0xECE), (0x180F, 0x180F), (0x1885, 0x1886),
    (0x1ABF, 0x1ACE), (0x1DF6, 0x1DFB), (0xA82C, 0xA82C), (0xA8C5, 0xA8C5),
    (0xA8FF, 0xA8FF), (0xA9BD, 0xA9BD), (0x10D24, 0x10D27), (0x10EAB, 0x10EAC),
    (0x10EFD, 0x10EFF), (0x10F46, 0x10F50), (0x10F82, 0x10F85), (0x11070, 0x11070),
    (0x11073, 0x11074), (0x110C2, 0x110C2), (0x111C9, 0x111C9), (0x111CF, 0x111CF),
    (0x1123E, 0x1123E), (0x11241, 0x11241), (0x1133B, 0x1133B), (0x11438, 0x1143F),
    (0x11442, 0x11444), (0x11446, 0x11446), (0x1145E, 0x1145E), (0x1182F, 0x11837),
    (0x11839, 0x1183A), (0x1193B, 0x1193C), (0x1193E, 0x1193E), (0x11943, 0x11943),
    (0x119D4, 0x119D7), (0x119DA, 0x119DB), (0x119E0, 0x119E0), (0x11A01, 0x11A0A),
    (0x11A33, 0x11A38), (0x11A3B, 0x11A3E), (0x11A47, 0x11A47), (0x11A51, 0x11A56),
    (0x11A59, 0x11A5B), (0x11A8A, 0x11A96), (0x11A98, 0x11A99), (0x11C30, 0x11C36),
    (0x11C38, 0x11C3D), (0x11C3F, 0x11C3F), (0x11C92, 0x11CA7), (0x11CAA, 0x11CB0),
    (0x11CB2, 0x11CB3), (0x11CB5, 0x11CB6), (0x11D31, 0x11D36), (0x11D3A, 0x11D3A),
    (0x11D3C, 0x11D3D), (0x11D3F, 0x11D45), (0x11D47, 0x11D47), (0x11D90, 0x11D91),
    (0x11D95, 0x11D95), (0x11D97, 0x11D97), (0x11EF3, 0x11EF4), (0x11F00, 0x11F01),
    (0x11F36, 0x11F3A), (0x11F40, 0x11F40), (0x11F42, 0x11F42), (0x13440, 0x13440),
    (0x13447, 0x13455), (0x16F4F, 0x16F4F), (0x16FE4, 0x16FE4), (0x1CF00, 0x1CF2D),
    (0x1CF30, 0x1CF46), (0x1E000, 0x1E006), (0x1E008, 0x1E018), (0x1E01B, 0x1E021),
    (0x1E023, 0x1E024), (0x1E026, 0x1E02A), (0x1E08F, 0x1E08F), (0x1E130, 0x1E136),
    (0x1E2AE, 0x1E2AE), (0x1E2EC, 0x1E2EF), (0x1E4EC, 0x1E4EF), (0x1E944, 0x1E94A))
_EXTRA_MN = frozenset("\u1734")  # Mc in Unicode 15.0, Mn in the older tables
# Cf in Unicode 15.0 but not to the Rust library
_NOT_CF = ((0x890, 0x891), (0x8E2, 0x8E2), (0x110CD, 0x110CD), (0x13430, 0x1343F))
# P* in Unicode 15.0 but not punctuation to the Rust library, and the reverse
_NOT_P = (
    (0x61D, 0x61D), (0x9FD, 0x9FD), (0xA76, 0xA76), (0xC77, 0xC77), (0xC84, 0xC84),
    (0x1B7D, 0x1B7E), (0x2E43, 0x2E4F), (0x2E52, 0x2E5D), (0x10EAD, 0x10EAD),
    (0x10F55, 0x10F59), (0x10F86, 0x10F89), (0x1144B, 0x1144F), (0x1145A, 0x1145B),
    (0x1145D, 0x1145D), (0x11660, 0x1166C), (0x116B9, 0x116B9), (0x1183B, 0x1183B),
    (0x11944, 0x11946), (0x119E2, 0x119E2), (0x11A3F, 0x11A46), (0x11A9A, 0x11A9C),
    (0x11A9E, 0x11AA2), (0x11B00, 0x11B09), (0x11C41, 0x11C45), (0x11C70, 0x11C71),
    (0x11EF7, 0x11EF8), (0x11F43, 0x11F4F), (0x11FFF, 0x11FFF), (0x12FF1, 0x12FF2),
    (0x16E97, 0x16E9A), (0x16FE2, 0x16FE2), (0x1E95E, 0x1E95F))
_EXTRA_P = frozenset("\u166d\U000111c9")
# Other_Alphabetic symbols (circled, parenthesized and squared Latin letters):
# word characters to the added tokens' single_word test
_ALPHA_SYMBOLS = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169),
                  (0x1F170, 0x1F189))


def _within(c: str, ranges) -> bool:
    o = ord(c)
    return any(a <= o <= b for a, b in ranges)


def _is_control(c: str) -> bool:
    """BertNormalizer's control characters: Cc, Co and the older tables' Cf,
    but tab, newline and carriage return."""
    cat = unicodedata.category(c)
    return (c not in "\t\n\r" and (cat in ("Cc", "Co")
                                   or (cat == "Cf" and not _within(c, _NOT_CF))))


def _is_mn(c: str) -> bool:
    if c in _EXTRA_MN:
        return True
    return unicodedata.category(c) == "Mn" and not _within(c, _NOT_MN)


def _is_bert_punct(c: str) -> bool:
    """ASCII punctuation, or Unicode punctuation in the older tables."""
    if c in string.punctuation or c in _EXTRA_P:
        return True
    return unicodedata.category(c)[0] == "P" and not _within(c, _NOT_P)


def _is_word_char(c: str) -> bool:
    """``\\w`` of Rust's regex crate: Alphabetic, marks, Nd, Pc, Join_Control."""
    cat = unicodedata.category(c)
    return (cat[0] in "LM" or cat in ("Nd", "Nl", "Pc") or c in "\u200c\u200d"
            or _within(c, _ALPHA_SYMBOLS))


class UnreadComponent(ValueError):
    """A ``tokenizer.json`` component the port does not read; ``component``
    names it (``"normalizer Precompiled"``)."""

    def __init__(self, component: str):
        super().__init__(f"tokenizer.json: {component} is not read by the port")
        self.component = component


class MissingToken(ValueError):
    """A layout lacks a token its template needs (``[CLS]``, ``</s>``, ...)."""


# -- normalizer, pre-tokenizers ---------------------------------------------


class BertNormalizer:
    """``tokenizers``' BertNormalizer: ``clean_text`` drops NUL, U+FFFD and
    control characters and makes whitespace a space; ``handle_chinese_chars``
    pads each CJK ideograph with spaces; ``strip_accents`` (by default as
    ``lowercase``) is NFD without Mn; ``lowercase`` lowercases each character
    alone (no final-sigma rule)."""

    def __init__(self, clean_text: bool = True, handle_chinese_chars: bool = True,
                 strip_accents: Optional[bool] = None, lowercase: bool = True):
        self.clean_text = clean_text
        self.handle_chinese_chars = handle_chinese_chars
        self.strip_accents = lowercase if strip_accents is None else strip_accents
        self.lowercase = lowercase

    def __call__(self, text: str) -> str:
        if self.clean_text:
            text = "".join(" " if c in WHITE_SPACE else c for c in text
                           if c not in "\x00\ufffd" and not _is_control(c))
        if self.handle_chinese_chars:
            text = "".join(f" {c} " if _within(c, _CJK) else c for c in text)
        if self.strip_accents:
            text = "".join(c for c in unicodedata.normalize("NFD", text) if not _is_mn(c))
        if self.lowercase:
            text = "".join(c.lower() for c in text)
        return text


class BertPreTokenizer:
    """Words split at whitespace; each punctuation character a word of its own."""

    def __call__(self, text: str) -> List[str]:
        words, start = [], 0
        for i, c in enumerate(text):
            if c in WHITE_SPACE or _is_bert_punct(c):
                if start < i:
                    words.append(text[start:i])
                if c not in WHITE_SPACE:
                    words.append(c)
                start = i + 1
        if start < len(text):
            words.append(text[start:])
        return words


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character table of the byte-level BPE: the
    printable Latin-1 bytes stand for themselves, the others for 256 + n."""
    bs = [b for b in range(256) if 0x21 <= b <= 0x7E or 0xA1 <= b <= 0xAC or 0xAE <= b]
    table = {b: chr(b) for b in bs}
    for n, b in enumerate(b for b in range(256) if b not in table):
        table[b] = chr(256 + n)
    return table


def _gpt2_class(c: str) -> str:
    """'S' whitespace, 'L' letter, 'N' number, 'X' anything else."""
    if c in WHITE_SPACE:
        return "S"
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "X"


_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def gpt2_split(text: str) -> List[str]:
    """The ByteLevel pre-tokenizer's split, a scanner for
    ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``:
    at each position the first alternative that matches, each run greedy."""
    kinds = [_gpt2_class(c) for c in text]
    n, i, out = len(text), 0, []
    while i < n:
        j = 0
        if text[i] == "'":
            for suffix in _CONTRACTIONS:
                if text.startswith(suffix, i + 1):
                    j = i + 1 + len(suffix)
                    break
        if not j:
            # ' ?' takes the space only when the run it leads can start after it
            start = i + 1 if text[i] == " " and i + 1 < n and kinds[i + 1] != "S" else i
            kind = kinds[start]
            if kind != "S":
                j = start + 1
                while j < n and kinds[j] == kind:
                    j += 1
            else:
                j = i + 1
                while j < n and kinds[j] == "S":
                    j += 1
                if j < n and j - i > 1:
                    j -= 1  # \s+(?!\S): leave the last space to the word after it
        out.append(text[i:j])
        i = j
    return out


class ByteLevel:
    """The ByteLevel pre-tokenizer: an optional leading space, the GPT-2
    split, then each piece's UTF-8 bytes as ``bytes_to_unicode`` characters."""

    def __init__(self, add_prefix_space: bool = False, use_regex: bool = True):
        self.add_prefix_space = add_prefix_space
        self.use_regex = use_regex
        self.table = bytes_to_unicode()

    def __call__(self, text: str) -> List[str]:
        if self.add_prefix_space and not text.startswith(" "):
            text = " " + text
        pieces = gpt2_split(text) if self.use_regex else [text]
        return ["".join(self.table[b] for b in p.encode("utf-8")) for p in pieces]


# -- models --------------------------------------------------------------------


class WordPiece:
    """Greedy longest-match WordPiece: ``##`` continuations, the unknown token
    for a word that does not split or is longer than ``max_input_chars_per_word``."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 continuing_subword_prefix: str = "##", max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.prefix = continuing_subword_prefix
        self.max_chars = max_input_chars_per_word

    def _unk(self) -> List[int]:
        if self.unk_token not in self.vocab:
            raise MissingToken(f"WordPiece: {self.unk_token!r} is not in the vocabulary")
        return [self.vocab[self.unk_token]]

    def __call__(self, word: str) -> List[int]:
        if len(word) > self.max_chars:
            return self._unk()
        ids, start = [], 0
        while start < len(word):
            for end in range(len(word), start, -1):
                sub = word[start:end] if start == 0 else self.prefix + word[start:end]
                if sub in self.vocab:
                    ids.append(self.vocab[sub])
                    start = end
                    break
            else:
                return self._unk()
        return ids


class BPE:
    """Byte-pair encoding by merge rank, as ``tokenizers``' ``Word::merge_all``:
    the lowest (rank, position) pair merges first, from a heap of candidate
    pairs whose stale entries are skipped. A character outside the vocabulary
    becomes the unknown token (fused with its neighbours under ``fuse_unk``),
    or is dropped when there is none. Each word's ids are cached."""

    CACHE = 100_000  # words kept before the cache starts over

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 unk_token: Optional[str] = None, continuing_subword_prefix: Optional[str] = None,
                 end_of_word_suffix: Optional[str] = None, fuse_unk: bool = False,
                 ignore_merges: bool = False):
        self.vocab = vocab
        self.unk_token = unk_token
        self.prefix = continuing_subword_prefix or ""
        self.suffix = end_of_word_suffix or ""
        self.fuse_unk = fuse_unk
        self.ignore_merges = ignore_merges
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, (a, b) in enumerate(merges):
            merged = a + b[len(self.prefix):]
            for token in (a, b, merged):
                if token not in vocab:
                    raise ValueError(f"BPE merge {a!r} {b!r}: {token!r} is not in the vocabulary")
            self.merges[(vocab[a], vocab[b])] = (rank, vocab[merged])
        self.cache: Dict[str, List[int]] = {}

    def __call__(self, word: str) -> List[int]:
        ids = self.cache.get(word)
        if ids is None:
            if len(self.cache) >= self.CACHE:
                self.cache.clear()
            ids = self.cache[word] = self._encode(word)
        return ids

    def _encode(self, word: str) -> List[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        symbols, unk = [], None
        for i, c in enumerate(word):
            s = (self.prefix if i else "") + c + (self.suffix if i == len(word) - 1 else "")
            if s in self.vocab:
                if unk is not None:
                    symbols.append(unk)
                    unk = None
                symbols.append(self.vocab[s])
            elif self.unk_token is not None:
                if self.unk_token not in self.vocab:
                    raise MissingToken(f"BPE: {self.unk_token!r} is not in the vocabulary")
                if unk is not None and not self.fuse_unk:
                    symbols.append(unk)
                unk = self.vocab[self.unk_token]
        if unk is not None:
            symbols.append(unk)
        return self._merge(symbols)

    def _merge(self, symbols: List[int]) -> List[int]:
        n = len(symbols)
        nxt, prv, alive = list(range(1, n + 1)), list(range(-1, n - 1)), [True] * n
        heap = [(m[0], i, m[1]) for i in range(n - 1)
                if (m := self.merges.get((symbols[i], symbols[i + 1]))) is not None]
        heapq.heapify(heap)
        while heap:
            _, i, new = heapq.heappop(heap)
            j = nxt[i]
            if not alive[i] or j >= n:
                continue
            m = self.merges.get((symbols[i], symbols[j]))
            if m is None or m[1] != new:
                continue  # a stale entry: one side merged since
            symbols[i], alive[j] = new, False
            nxt[i] = nxt[j]
            if nxt[i] < n:
                prv[nxt[i]] = i
            for pos, left, right in ((prv[i], prv[i], i), (i, i, nxt[i])):
                if 0 <= left and right < n:
                    m = self.merges.get((symbols[left], symbols[right]))
                    if m is not None:
                        heapq.heappush(heap, (m[0], pos, m[1]))
        return [s for s, keep in zip(symbols, alive) if keep]


# -- added tokens, post-processor ------------------------------------------------


class AddedToken(NamedTuple):
    content: str
    id: int
    single_word: bool = False
    lstrip: bool = False
    rstrip: bool = False
    normalized: bool = False


class AddedTokens:
    """Text split at added tokens, as ``tokenizers``' AddedVocabulary: the
    tokens with ``normalized`` false are found in the raw text, then each
    other piece is normalized and the ``normalized`` tokens (their content
    normalized too) are found in it. Matches are leftmost-longest and do not
    overlap; ``single_word`` drops a match with a word character beside it,
    ``lstrip`` / ``rstrip`` take the whitespace beside it into the token."""

    def __init__(self, tokens: Sequence[AddedToken], normalizer=None):
        self.normalizer = normalizer
        self.raw = {t.content: t for t in tokens if not t.normalized and t.content}
        self.normalized = {}
        for t in tokens:
            content = normalizer(t.content) if normalizer and t.normalized else t.content
            if t.normalized and content:
                self.normalized.setdefault(content, t)
        self.ids = {t.content: t.id for t in tokens}

    @staticmethod
    def _find(text: str, table: Dict[str, AddedToken]) -> List[Tuple[str, Optional[int]]]:
        out, done, pos = [], 0, 0
        while table:
            found = [(text.find(p, pos), -len(p), p) for p in table]
            found = [f for f in found if f[0] >= 0]
            if not found:
                break
            start, _, content = min(found)
            stop, token = start + len(content), table[content]
            pos = stop
            if token.single_word and ((start > 0 and _is_word_char(text[start - 1]))
                                      or (stop < len(text) and _is_word_char(text[stop]))):
                continue
            if token.lstrip:
                while start > done and text[start - 1] in WHITE_SPACE:
                    start -= 1
            if token.rstrip:
                while stop < len(text) and text[stop] in WHITE_SPACE:
                    stop += 1
            pos = stop
            if done < start:
                out.append((text[done:start], None))
            out.append((text[start:stop], token.id))
            done = stop
        if done < len(text):
            out.append((text[done:], None))
        return out

    def split(self, text: str) -> List[Tuple[str, Optional[int]]]:
        """(piece, token id) pairs; a piece with id None is normalized text
        for the pre-tokenizer, never empty."""
        out = []
        for piece, tid in self._find(text, self.raw):
            if tid is not None:
                out.append((piece, tid))
                continue
            if self.normalizer is not None:
                piece = self.normalizer(piece)
            out.extend(p for p in self._find(piece, self.normalized) if p[0] or p[1] is not None)
        return out


class Template:
    """A post-processor's single-sequence template: ``items`` of ``(ids,
    type_id)`` for special tokens and ``("A", type_id)`` for the sequence."""

    def __init__(self, items: Sequence[Tuple[Union[str, List[int]], int]]):
        self.items = list(items)
        self.added = sum(len(ids) for ids, _ in self.items if ids != "A")

    def apply(self, content: List[int]) -> Tuple[List[int], List[int]]:
        ids, types = [], []
        for part, type_id in self.items:
            part = content if part == "A" else part
            ids += part
            types += [type_id] * len(part)
        return ids, types

    @classmethod
    def around(cls, first: int, last: int) -> "Template":
        """``first $A last``, all of type 0 (BertProcessing, RobertaProcessing)."""
        return cls([([first], 0), ("A", 0), ([last], 0)])


# -- the pipeline and the three layouts -----------------------------------------


class HFTokenizer:
    """Added tokens, normalizer, pre-tokenizer and model, then the template,
    the content truncated to ``max_length`` less the template's tokens, and
    right padding with ``pad_token_id`` (type 0, mask 0), as the JAX
    package's ``RustTokenizer`` sets the Rust tokenizer up."""

    def __init__(self, model, max_length: int, use_token_types: bool, pad_token_id: int,
                 normalizer=None, pre_tokenizer=None, added: Sequence[AddedToken] = (),
                 template: Optional[Template] = None):
        self.model = model
        self.max_length = max_length
        self.use_token_types = use_token_types
        self.pad_token_id = pad_token_id
        self.normalizer = normalizer
        self.pre_tokenizer = pre_tokenizer
        self.added = AddedTokens(added, normalizer)
        self.template = template

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self.added.ids:
            return self.added.ids[token]
        return self.model.vocab.get(token)

    def encode(self, text: str) -> Tuple[List[int], List[int]]:
        content: List[int] = []
        for piece, tid in self.added.split(text):
            if tid is not None:
                content.append(tid)
                continue
            for word in (self.pre_tokenizer(piece) if self.pre_tokenizer else [piece]):
                content += self.model(word)
        room = self.max_length - (self.template.added if self.template else 0)
        if room < 0:
            raise ValueError(f"max_length {self.max_length} is shorter than the "
                             f"{self.template.added} tokens of the template")
        content = content[:room]
        if self.template is None:
            return content, [0] * len(content)
        return self.template.apply(content)

    def encode_batch(self, texts: Sequence[str]):
        n, L = len(texts), self.max_length
        ids = np.full((n, L), self.pad_token_id, np.int32)
        mask = np.zeros((n, L), np.int32)
        tt = np.zeros((n, L), np.int32)
        for i, text in enumerate(texts):
            row, types = self.encode(str(text))
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
            tt[i, :len(row)] = types
        return ids, mask, (tt if self.use_token_types else None)


def _read_lines(path: str) -> List[str]:
    """Lines split at ``\\n`` only (a lone ``\\r`` stays in its line), as Rust's
    ``BufRead::lines``."""
    with open(path, encoding="utf-8", newline="") as f:
        lines = f.read().split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    return [line[:-1] if line.endswith("\r") else line for line in lines]


class BertWordPiece(HFTokenizer):
    """``BertWordPieceTokenizer(vocab.txt, lowercase=True)``: BertNormalizer,
    BertPreTokenizer, WordPiece, ``[CLS] $A [SEP]``; ``[UNK]``, ``[SEP]``,
    ``[CLS]``, ``[PAD]`` and ``[MASK]`` are special tokens where the
    vocabulary has them; the pad id is ``[PAD]``'s or 0."""

    SPECIALS = ("[UNK]", "[SEP]", "[CLS]", "[PAD]", "[MASK]")

    def __init__(self, vocab_path: str, max_length: int, use_token_types: bool):
        vocab = {}
        for i, line in enumerate(_read_lines(vocab_path)):
            vocab[line.rstrip("".join(WHITE_SPACE))] = i
        for token in ("[CLS]", "[SEP]"):
            if token not in vocab:
                raise MissingToken(f"{vocab_path} has no {token}")
        super().__init__(WordPiece(vocab), max_length, use_token_types, vocab.get("[PAD]") or 0,
                         normalizer=BertNormalizer(lowercase=True),
                         pre_tokenizer=BertPreTokenizer(),
                         added=[AddedToken(t, vocab[t]) for t in self.SPECIALS if t in vocab],
                         template=Template.around(vocab["[CLS]"], vocab["[SEP]"]))


def read_merges_txt(path: str) -> List[Tuple[str, str]]:
    """``merges.txt``: one ``a b`` pair a line, its rank the line's order,
    ``#version`` lines skipped."""
    merges = []
    for n, line in enumerate(_read_lines(path), 1):
        if line.startswith("#version"):
            continue
        parts = line.split(" ")
        if len(parts) != 2:
            raise ValueError(f"{path}:{n}: a merge is two tokens, not {line!r}")
        merges.append((parts[0], parts[1]))
    return merges


class ByteLevelBPE(HFTokenizer):
    """``ByteLevelBPETokenizer(vocab.json, merges.txt)`` with
    ``RobertaProcessing``: no normalizer, ByteLevel without a prefix space,
    BPE, ``<s> $A </s>`` and no added tokens; the pad id is ``<pad>``'s, or 1
    when that is absent or 0 (the JAX package's ``... or 1``)."""

    def __init__(self, vocab_path: str, merges_path: str, max_length: int,
                 use_token_types: bool):
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        for token in ("<s>", "</s>"):
            if token not in vocab:
                raise MissingToken(f"{vocab_path} has no {token}")
        super().__init__(BPE(vocab, read_merges_txt(merges_path)), max_length, use_token_types,
                         vocab.get("<pad>") or 1, pre_tokenizer=ByteLevel(),
                         template=Template.around(vocab["<s>"], vocab["</s>"]))


def _merge_pair(m) -> Tuple[str, str]:
    """A ``tokenizer.json`` merge: ``"a b"`` or ``["a", "b"]``."""
    parts = m.split(" ") if isinstance(m, str) else list(m)
    if len(parts) != 2:
        raise ValueError(f"tokenizer.json: a merge is two tokens, not {m!r}")
    return parts[0], parts[1]


class TokenizerJson(HFTokenizer):
    """A ``tokenizer.json``: normalizer ``BertNormalizer`` or none;
    pre-tokenizer ``BertPreTokenizer``, ``ByteLevel`` or none; model
    ``WordPiece`` or ``BPE`` (merges as ``"a b"`` or ``["a", "b"]``,
    ``ignore_merges`` honoured); post-processor ``TemplateProcessing``,
    ``BertProcessing``, ``RobertaProcessing``, ``ByteLevel`` (no token) or none,
    where ``[CLS] $A [SEP]`` is added when the vocabulary has both (the JAX
    package's ``_ensure_bert_postprocessor``); the added tokens with their
    flags. The pad id is ``[PAD]``'s, else ``<pad>``'s, else 0."""

    def __init__(self, path: str, max_length: int, use_token_types: bool):
        try:
            with open(path, encoding="utf-8") as f:
                spec = json.load(f)
        except ValueError as e:
            raise UnreadComponent(f"a file that is no JSON ({e})") from e
        normalizer = self._normalizer(spec.get("normalizer"))  # in the pipeline's order
        pre_tokenizer = self._pre_tokenizer(spec.get("pre_tokenizer"))
        model = self._model(spec.get("model") or {})
        added = [AddedToken(t["content"], t["id"], t.get("single_word", False),
                            t.get("lstrip", False), t.get("rstrip", False),
                            t.get("normalized", False))
                 for t in spec.get("added_tokens") or []]
        super().__init__(model, max_length, use_token_types, 0, normalizer=normalizer,
                         pre_tokenizer=pre_tokenizer, added=added)
        self.template = self._template(spec.get("post_processor"))
        pad = self.token_to_id("[PAD]")
        self.pad_token_id = pad if pad is not None else (self.token_to_id("<pad>") or 0)

    @staticmethod
    def _model(m):
        kind = m.get("type")
        if kind == "WordPiece":
            return WordPiece(m["vocab"], m.get("unk_token", "[UNK]"),
                             m.get("continuing_subword_prefix", "##"),
                             m.get("max_input_chars_per_word", 100))
        if kind == "BPE":
            if m.get("dropout"):
                raise UnreadComponent(f"model BPE with dropout {m['dropout']}")
            if m.get("byte_fallback"):
                raise UnreadComponent("model BPE with byte_fallback")
            return BPE(m["vocab"], [_merge_pair(p) for p in m.get("merges", [])],
                       m.get("unk_token"), m.get("continuing_subword_prefix"),
                       m.get("end_of_word_suffix"), m.get("fuse_unk", False),
                       m.get("ignore_merges", False))
        raise UnreadComponent(f"model {kind}")

    @staticmethod
    def _normalizer(n):
        if n is None:
            return None
        if n.get("type") == "BertNormalizer":
            return BertNormalizer(n.get("clean_text", True), n.get("handle_chinese_chars", True),
                                  n.get("strip_accents"), n.get("lowercase", True))
        raise UnreadComponent(f"normalizer {n.get('type')}")

    @staticmethod
    def _pre_tokenizer(p):
        if p is None:
            return None
        if p.get("type") == "BertPreTokenizer":
            return BertPreTokenizer()
        if p.get("type") == "ByteLevel":
            return ByteLevel(p.get("add_prefix_space", True), p.get("use_regex", True))
        raise UnreadComponent(f"pre_tokenizer {p.get('type')}")

    def _template(self, p) -> Optional[Template]:
        if p is None:
            cls_id, sep_id = self.token_to_id("[CLS]"), self.token_to_id("[SEP]")
            return None if cls_id is None or sep_id is None else Template.around(cls_id, sep_id)
        kind = p.get("type")
        if kind in ("BertProcessing", "RobertaProcessing"):
            return Template.around(p["cls"][1], p["sep"][1])
        if kind == "ByteLevel":
            return None
        if kind == "TemplateProcessing":
            items = []
            for item in p["single"]:
                if "Sequence" in item:
                    items.append(("A", item["Sequence"].get("type_id", 0)))
                else:
                    special = item["SpecialToken"]
                    items.append((list(p["special_tokens"][special["id"]]["ids"]),
                                  special.get("type_id", 0)))
            return Template(items)
        raise UnreadComponent(f"post_processor {kind}")

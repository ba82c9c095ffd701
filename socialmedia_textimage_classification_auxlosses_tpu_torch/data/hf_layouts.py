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

    AddedTokens -> normalizer -> pre-tokenizer -> model -> post-processor
                -> truncation, padding

with the normalizers ``BertNormalizer``, ``Precompiled``
(``data/spm_precompiled.py``), ``Replace``, ``Strip``, ``NFC`` / ``NFD`` /
``NFKC`` / ``NFKD``, ``Nmt``, ``Lowercase``, ``StripAccents``, ``Prepend``,
``ByteLevel`` and ``Sequence``; the pre-tokenizers ``BertPreTokenizer``,
``ByteLevel``, ``Metaspace``, ``Whitespace``, ``WhitespaceSplit``, ``Split``,
``Punctuation``, ``Digits``, ``CharDelimiterSplit`` and ``Sequence``; the
models ``WordPiece``, ``BPE`` (``byte_fallback``, ``dropout``), ``Unigram``
and ``WordLevel``; the post-processors ``TemplateProcessing``,
``BertProcessing``, ``RobertaProcessing``, ``ByteLevel`` and ``Sequence``. A
component other than those (the ``UnicodeScripts`` pre-tokenizer), a regular
expression that Python's ``re`` may read otherwise than Oniguruma, and a file
the Rust library refuses to load raise ``UnreadComponent`` naming it.

Character classes. ``tokenizers`` takes its nonspacing marks (``Mn``),
format characters (``Cf``) and punctuation from Unicode 9-era tables (the
``unicode_categories`` crate), its combining marks and Unicode normalization
from Unicode 12-era ones (``unicode-normalization-alignments``), and
whitespace, letters, numbers and case from a current Unicode; Python's
``unicodedata`` is Unicode 15.0. The port classifies with Python's tables and
carries the code points on which the older tables differ (``_NOT_MN`` and the
rest below), so every code point assigned in Unicode 15.0 gets the class the
Rust library gives it. Code points assigned later are unassigned to Python
and keep its classes.
"""

from __future__ import annotations

import base64
import heapq
import json
import re
import string
import unicodedata
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np

from .spm_precompiled import Precompiled

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

# Marks (M*) in Unicode 15.0 but not combining marks to the Rust library's
# StripAccents, and the reverse
_NOT_MARK = (
    (0x7FD, 0x7FD), (0x898, 0x89F), (0x8CA, 0x8D3), (0x9FE, 0x9FE), (0xAFA, 0xAFF),
    (0xB55, 0xB55), (0xC04, 0xC04), (0xC3C, 0xC3C), (0xCF3, 0xCF3), (0xD00, 0xD00),
    (0xD3B, 0xD3C), (0xD81, 0xD81), (0xEBA, 0xEBA), (0xECE, 0xECE), (0x1715, 0x1715),
    (0x180F, 0x180F), (0x1ABF, 0x1ACE), (0x1CF7, 0x1CF7), (0x1DF6, 0x1DFA), (0xA82C, 0xA82C),
    (0xA8FF, 0xA8FF), (0x10D24, 0x10D27), (0x10EAB, 0x10EAC), (0x10EFD, 0x10EFF),
    (0x10F46, 0x10F50), (0x10F82, 0x10F85), (0x11070, 0x11070), (0x11073, 0x11074),
    (0x110C2, 0x110C2), (0x11145, 0x11146), (0x111C9, 0x111C9), (0x111CE, 0x111CF),
    (0x11241, 0x11241), (0x1133B, 0x1133B), (0x1145E, 0x1145E), (0x1182C, 0x1183A),
    (0x11930, 0x11935), (0x11937, 0x11938), (0x1193B, 0x1193E), (0x11940, 0x11940),
    (0x11942, 0x11943), (0x119D1, 0x119D7), (0x119DA, 0x119E0), (0x119E4, 0x119E4),
    (0x11A01, 0x11A0A), (0x11A33, 0x11A39), (0x11A3B, 0x11A3E), (0x11A47, 0x11A47),
    (0x11A51, 0x11A5B), (0x11A8A, 0x11A99), (0x11D31, 0x11D36), (0x11D3A, 0x11D3A),
    (0x11D3C, 0x11D3D), (0x11D3F, 0x11D45), (0x11D47, 0x11D47), (0x11D8A, 0x11D8E),
    (0x11D90, 0x11D91), (0x11D93, 0x11D97), (0x11EF3, 0x11EF6), (0x11F00, 0x11F01),
    (0x11F03, 0x11F03), (0x11F34, 0x11F3A), (0x11F3E, 0x11F42), (0x13440, 0x13440),
    (0x13447, 0x13455), (0x16F4F, 0x16F4F), (0x16F7F, 0x16F87), (0x16FE4, 0x16FE4),
    (0x16FF0, 0x16FF1), (0x1CF00, 0x1CF2D), (0x1CF30, 0x1CF46), (0x1E08F, 0x1E08F),
    (0x1E130, 0x1E136), (0x1E2AE, 0x1E2AE), (0x1E2EC, 0x1E2EF), (0x1E4EC, 0x1E4EF))
_EXTRA_MARK = frozenset("\u1cf2\u1cf3")
# Code points with a decomposition in Unicode 15.0 that the Rust library's
# normalization tables lack: kept as they are by NFC, NFD, NFKC and NFKD
_NF_KEPT = frozenset(chr(c) for a, b in (
    (0x32FF, 0x32FF), (0xA7F2, 0xA7F4), (0xAB69, 0xAB69), (0x10781, 0x10785),
    (0x10787, 0x107B0), (0x107B2, 0x107BA), (0x11938, 0x11938), (0x1E030, 0x1E06D),
    (0x1F16C, 0x1F16C), (0x1FBF0, 0x1FBF9)) for c in range(a, b + 1))
# Nmt: ASCII controls dropped, and other code points made a space
_NMT = {c: None for c in (*range(1, 9), 0xB, *range(0xE, 0x20), 0x7F, 0x8F, 0x9F)}
_NMT.update({c: " " for c in (0x9, 0xA, 0xC, 0xD, 0x1680, *range(0x200B, 0x2010), 0x2028,
                              0x2029, 0x2581, 0xFEFF, 0xFFFD)})


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
    """``\\w`` of Rust's regex crate and of Oniguruma: Alphabetic, marks, Nd,
    Pc, Join_Control."""
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


def _is_combining_mark(c: str) -> bool:
    """StripAccents' marks: M* in the older tables."""
    if c in _EXTRA_MARK:
        return True
    return unicodedata.category(c)[0] == "M" and not _within(c, _NOT_MARK)


def _is_numeric(c: str) -> bool:
    """Rust's ``char::is_numeric``: Nd, Nl, No."""
    return unicodedata.category(c)[0] == "N"


def _onig_regex(pattern: str, what: str) -> "re.Pattern":
    """``pattern`` compiled by Python's ``re`` where it reads as Oniguruma
    reads it (``^`` and ``$`` at each line, as Ruby's syntax has them); else
    ``UnreadComponent``. Refused: classes whose Unicode sets differ (``\\w``,
    ``\\s``, ``\\b``, ``\\p{..}``, POSIX brackets, ``&&``), groups other than
    ``(?:``, and a pattern that matches the empty string."""
    if re.search(r"\\[wWsSbBpPhHXRKGgkzZ]|\(\?(?!:)|\[\[:|&&", pattern):
        raise UnreadComponent(f"{what} with the regular expression {pattern!r}")
    try:
        compiled = re.compile(pattern, re.MULTILINE)
    except re.error as e:
        raise UnreadComponent(f"{what} with the regular expression {pattern!r} ({e})") from e
    if compiled.search("") is not None:
        raise UnreadComponent(f"{what} with the regular expression {pattern!r}, which matches "
                              "the empty string")
    return compiled


def _pattern(spec, what: str) -> Optional["re.Pattern"]:
    """A ``{"String": s}`` or ``{"Regex": r}`` pattern; None for the empty
    string, which matches nothing."""
    if "String" in spec:
        return re.compile(re.escape(spec["String"])) if spec["String"] else None
    if "Regex" in spec:
        return _onig_regex(spec["Regex"], what)
    raise UnreadComponent(f"{what} with the pattern {spec!r}")


# -- normalizers ------------------------------------------------------------------


class Normalizer:
    """A ``tokenizers`` normalizer. ``normalize(text)`` gives the normalized
    text and whether its first character keeps the text's first offset:
    ``tokenizers`` moves that offset on when the normalizer removes the text's
    first characters (a ``Strip``, a filter) or replaces a run of several
    with a ``Replace``, and a ``Metaspace`` of ``prepend_scheme`` ``first``
    prepends only at offset 0."""

    def __call__(self, text: str) -> str:
        return self.normalize(text)[0]

    def normalize(self, text: str) -> Tuple[str, bool]:
        raise NotImplementedError


class BertNormalizer(Normalizer):
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

    def normalize(self, text: str) -> Tuple[str, bool]:
        keeps = True
        if self.clean_text:
            keeps = not text or not (text[0] in "\x00\ufffd" or _is_control(text[0]))
            text = "".join(" " if c in WHITE_SPACE else c for c in text
                           if c not in "\x00\ufffd" and not _is_control(c))
        if self.handle_chinese_chars:
            text = "".join(f" {c} " if _within(c, _CJK) else c for c in text)
        if self.strip_accents:
            text = unicodedata.normalize("NFD", text)
            keeps = keeps and not (text and _is_mn(text[0]))
            text = "".join(c for c in text if not _is_mn(c))
        if self.lowercase:
            text = "".join(c.lower() for c in text)
        return text, keeps


class NormalizerSequence(Normalizer):
    def __init__(self, parts: Sequence[Normalizer]):
        self.parts = list(parts)

    def normalize(self, text: str) -> Tuple[str, bool]:
        keeps = True
        for part in self.parts:
            text, kept = part.normalize(text)
            keeps = keeps and kept
        return text, keeps


class Replace(Normalizer):
    """Every non-overlapping match of ``pattern`` (None: none) becomes ``content``."""

    def __init__(self, pattern: Optional["re.Pattern"], content: str):
        self.pattern, self.content = pattern, content

    def normalize(self, text: str) -> Tuple[str, bool]:
        if self.pattern is None:
            return text, True
        m = self.pattern.match(text)
        keeps = m is None or (bool(self.content) and len(m.group()) == 1)
        return self.pattern.sub(lambda _: self.content, text), keeps


class Strip(Normalizer):
    _SPACES = "".join(sorted(WHITE_SPACE))

    def __init__(self, left: bool = True, right: bool = True):
        self.left, self.right = left, right

    def normalize(self, text: str) -> Tuple[str, bool]:
        keeps = not (self.left and text[:1] in WHITE_SPACE)
        if self.left:
            text = text.lstrip(self._SPACES)
        if self.right:
            text = text.rstrip(self._SPACES)
        return text, keeps


class UnicodeNormalization(Normalizer):
    """NFC, NFD, NFKC or NFKD; ``_NF_KEPT`` stays as it is, the text
    normalized in the runs between (each of those is a starter that composes
    with nothing in the Rust library's tables)."""

    def __init__(self, form: str):
        self.form = form

    def normalize(self, text: str) -> Tuple[str, bool]:
        if _NF_KEPT.isdisjoint(text):
            return unicodedata.normalize(self.form, text), True
        out, start = [], 0
        for i, c in enumerate(text):
            if c in _NF_KEPT:
                out += [unicodedata.normalize(self.form, text[start:i]), c]
                start = i + 1
        out.append(unicodedata.normalize(self.form, text[start:]))
        return "".join(out), True


class Nmt(Normalizer):
    """SentencePiece's ``nmt`` rules: ASCII controls dropped, other breaks
    and zero widths a space (``_NMT``)."""

    def normalize(self, text: str) -> Tuple[str, bool]:
        return text.translate(_NMT), not (text and _NMT.get(ord(text[0]), "") is None)


class Lowercase(Normalizer):
    """Each character lowercased alone: no final-sigma rule."""

    def normalize(self, text: str) -> Tuple[str, bool]:
        if "\u03a3" in text:
            return "".join(c.lower() for c in text), True
        return text.lower(), True


class StripAccents(Normalizer):
    def normalize(self, text: str) -> Tuple[str, bool]:
        return ("".join(c for c in text if not _is_combining_mark(c)),
                not (text and _is_combining_mark(text[0])))


class Prepend(Normalizer):
    def __init__(self, prepend: str):
        self.prepend = prepend

    def normalize(self, text: str) -> Tuple[str, bool]:
        return (self.prepend + text if text else text), True


class ByteLevelNormalizer(Normalizer):
    """Each UTF-8 byte as its ``bytes_to_unicode`` character."""

    def __init__(self):
        self.table = bytes_to_unicode()

    def normalize(self, text: str) -> Tuple[str, bool]:
        return "".join(self.table[b] for b in text.encode("utf-8")), True


# -- pre-tokenizers ----------------------------------------------------------------


class PreTokenizer:
    """A ``tokenizers`` pre-tokenizer. ``split(text, first)`` gives the
    pieces, each with whether it starts at the text's first offset while
    ``first`` holds (whether ``text`` itself starts at the input's)."""

    def __call__(self, text: str) -> List[str]:
        return [p for p, _ in self.split(text, True)]

    def split(self, text: str, first: bool) -> List[Tuple[str, bool]]:
        raise NotImplementedError


def _split_at(text: str, matches: Sequence[Tuple[int, int]], behavior: str, first: bool,
              invert: bool = False) -> List[Tuple[str, bool]]:
    """``text`` split at the sorted, non-overlapping ``matches`` ((start, end)
    pairs; with ``invert`` the text between them matches) as
    ``NormalizedString::split`` does under ``behavior``; empty pieces dropped."""
    segs, prev = [], 0
    for s, e in matches:
        if prev != s:
            segs.append((prev, s, invert))
        segs.append((s, e, not invert))
        prev = e
    if prev != len(text):
        segs.append((prev, len(text), invert))
    if behavior == "Removed":
        spans = [(s, e) for s, e, m in segs if not m]
    elif behavior == "Isolated":
        spans = [(s, e) for s, e, _ in segs]
    else:
        order = reversed(segs) if behavior == "MergedWithNext" else iter(segs)
        spans, prev_match = [], False
        for s, e, m in order:
            if spans and ((behavior == "Contiguous" and m == prev_match)
                          or (behavior != "Contiguous" and m and not prev_match)):
                a, b = spans[-1]
                spans[-1] = (s, b) if behavior == "MergedWithNext" else (a, e)
            else:
                spans.append((s, e))
            prev_match = m
        if behavior == "MergedWithNext":
            spans.reverse()
    return [(text[s:e], first and s == 0) for s, e in spans if e > s]


SPLIT_BEHAVIORS = ("Removed", "Isolated", "MergedWithPrevious", "MergedWithNext", "Contiguous")


def _char_matches(text: str, pred) -> List[Tuple[int, int]]:
    return [(i, i + 1) for i, c in enumerate(text) if pred(c)]


class BertPreTokenizer(PreTokenizer):
    """Words split at whitespace; each punctuation character a word of its own."""

    def split(self, text: str, first: bool) -> List[Tuple[str, bool]]:
        words, start = [], 0
        for i, c in enumerate(text):
            if c in WHITE_SPACE or _is_bert_punct(c):
                if start < i:
                    words.append((text[start:i], first and start == 0))
                if c not in WHITE_SPACE:
                    words.append((c, first and i == 0))
                start = i + 1
        if start < len(text):
            words.append((text[start:], first and start == 0))
        return words


class Whitespace(PreTokenizer):
    """The matches of ``\\w+|[^\\w\\s]+`` (Oniguruma's Unicode classes)."""

    def split(self, text: str, first: bool) -> List[Tuple[str, bool]]:
        kinds = ["S" if c in WHITE_SPACE else "W" if _is_word_char(c) else "O" for c in text]
        out, i = [], 0
        while i < len(text):
            j = i + 1
            while j < len(text) and kinds[j] == kinds[i]:
                j += 1
            if kinds[i] != "S":
                out.append((text[i:j], first and i == 0))
            i = j
        return out


class WhitespaceSplit(PreTokenizer):
    def split(self, text: str, first: bool) -> List[Tuple[str, bool]]:
        return _split_at(text, _char_matches(text, WHITE_SPACE.__contains__), "Removed", first)


class CharDelimiterSplit(PreTokenizer):
    def __init__(self, delimiter: str):
        self.delimiter = delimiter

    def split(self, text: str, first: bool) -> List[Tuple[str, bool]]:
        return _split_at(text, _char_matches(text, self.delimiter.__eq__), "Removed", first)


class Punctuation(PreTokenizer):
    """Each punctuation character (ASCII, or Unicode in the older tables) a
    delimiter under ``behavior``."""

    def __init__(self, behavior: str = "Isolated"):
        self.behavior = behavior

    def split(self, text: str, first: bool) -> List[Tuple[str, bool]]:
        return _split_at(text, _char_matches(text, _is_bert_punct), self.behavior, first)


class Digits(PreTokenizer):
    """Numeric characters isolated one by one, or in runs."""

    def __init__(self, individual_digits: bool = False):
        self.behavior = "Isolated" if individual_digits else "Contiguous"

    def split(self, text: str, first: bool) -> List[Tuple[str, bool]]:
        return _split_at(text, _char_matches(text, _is_numeric), self.behavior, first)


class Split(PreTokenizer):
    """The matches of a pattern (None: none) as delimiters under
    ``behavior``, or with ``invert`` the text between them."""

    def __init__(self, pattern: Optional["re.Pattern"], behavior: str, invert: bool = False):
        self.pattern, self.behavior, self.invert = pattern, behavior, invert

    def split(self, text: str, first: bool) -> List[Tuple[str, bool]]:
        matches = [] if self.pattern is None else [m.span() for m in self.pattern.finditer(text)]
        return _split_at(text, matches, self.behavior, first, self.invert)


class Metaspace(PreTokenizer):
    """Spaces become ``replacement``; ``prepend_scheme`` ``always`` puts one
    before a piece that does not start with it, ``first`` only before the
    piece at the input's first offset, ``never`` nowhere; with ``split``
    each ``replacement`` starts a new piece."""

    def __init__(self, replacement: str = "\u2581", prepend_scheme: str = "always",
                 split: bool = True):
        self.replacement, self.prepend_scheme, self.split_pieces = (replacement, prepend_scheme,
                                                                    split)

    def split(self, text: str, first: bool) -> List[Tuple[str, bool]]:
        if not text:
            return []
        text = text.replace(" ", self.replacement)
        if ((self.prepend_scheme == "always" or (self.prepend_scheme == "first" and first))
                and not text.startswith(self.replacement)):
            text = self.replacement + text
        if not self.split_pieces:
            return [(text, first)]
        cuts = [i for i, c in enumerate(text) if c == self.replacement and i] + [len(text)]
        out, start = [], 0
        for cut in cuts:
            if cut > start:
                out.append((text[start:cut], first and start == 0))
            start = cut
        return out


class PreTokenizerSequence(PreTokenizer):
    def __init__(self, parts: Sequence[PreTokenizer]):
        self.parts = list(parts)

    def split(self, text: str, first: bool) -> List[Tuple[str, bool]]:
        pieces = [(text, first)]
        for part in self.parts:
            pieces = [q for p, f in pieces for q in part.split(p, f)]
        return pieces


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


class ByteLevel(PreTokenizer):
    """The ByteLevel pre-tokenizer: an optional leading space, the GPT-2
    split, then each piece's UTF-8 bytes as ``bytes_to_unicode`` characters."""

    def __init__(self, add_prefix_space: bool = False, use_regex: bool = True):
        self.add_prefix_space = add_prefix_space
        self.use_regex = use_regex
        self.table = bytes_to_unicode()

    def split(self, text: str, first: bool) -> List[Tuple[str, bool]]:
        if not text:
            return []
        if self.add_prefix_space and not text.startswith(" "):
            text = " " + text
        pieces = gpt2_split(text) if self.use_regex else [text]
        return [("".join(self.table[b] for b in p.encode("utf-8")), first and not i)
                for i, p in enumerate(pieces)]


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


def _byte_ids(vocab: Dict[str, int], s: str) -> Optional[List[int]]:
    """``byte_fallback``: the ids of ``<0xAB>`` for each UTF-8 byte of ``s``,
    or None when one is missing."""
    ids = [vocab.get(f"<0x{b:02X}>") for b in s.encode("utf-8")]
    return None if None in ids else ids


class BPE:
    """Byte-pair encoding by merge rank, as ``tokenizers``' ``Word::merge_all``:
    the lowest (rank, position) pair merges first, from a heap of candidate
    pairs whose stale entries are skipped. A character outside the vocabulary
    becomes its ``<0xAB>`` byte tokens under ``byte_fallback`` where the
    vocabulary has them all (then an unknown token pending before it comes
    after them, as in Rust), else the unknown token (fused with its
    neighbours under ``fuse_unk``), or is dropped when there is none. With
    ``dropout`` p each merge popped is skipped with probability p, drawn from
    the tokenizer's own ``numpy`` generator (``rng``; Rust draws its own:
    equal at p = 0, and at p = 1, where nothing merges). Each word's ids are
    cached when there is no dropout."""

    CACHE = 100_000  # words kept before the cache starts over

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 unk_token: Optional[str] = None, continuing_subword_prefix: Optional[str] = None,
                 end_of_word_suffix: Optional[str] = None, fuse_unk: bool = False,
                 ignore_merges: bool = False, byte_fallback: bool = False,
                 dropout: Optional[float] = None, rng: Optional[np.random.Generator] = None):
        self.vocab = vocab
        self.unk_token = unk_token
        self.prefix = continuing_subword_prefix or ""
        self.suffix = end_of_word_suffix or ""
        self.fuse_unk = fuse_unk
        self.ignore_merges = ignore_merges
        self.byte_fallback = byte_fallback
        self.dropout = dropout or 0.0
        self.rng = rng if rng is not None else np.random.default_rng()
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, (a, b) in enumerate(merges):
            merged = a + b[len(self.prefix):]
            for token in (a, b, merged):
                if token not in vocab:
                    raise ValueError(f"BPE merge {a!r} {b!r}: {token!r} is not in the vocabulary")
            self.merges[(vocab[a], vocab[b])] = (rank, vocab[merged])
        self.cache: Dict[str, List[int]] = {}

    def __call__(self, word: str) -> List[int]:
        if self.dropout:
            return self._encode(word)
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
                continue
            if self.byte_fallback and (ids := _byte_ids(self.vocab, s)) is not None:
                symbols += ids
                continue
            if self.unk_token is not None:
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
        skipped = []
        while heap:
            top = heapq.heappop(heap)
            if self.dropout and self.rng.random() < self.dropout:
                skipped.append(top)
                continue
            for entry in skipped:
                heapq.heappush(heap, entry)
            skipped.clear()
            _, i, new = top
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


class Unigram:
    """The Unigram model as ``tokenizers``' ``encode_optimized``: Viterbi over
    the pieces' f64 scores, left to right, each end keeping the first path of
    the best score (a later path replaces it only when strictly better; over
    ``a b c ab bc abc`` at -1 / -2 / -3 the four ways to ``abc`` tie and
    ``abc`` wins); a character no piece starts with is the unknown piece,
    scored at the lowest score less 10; consecutive unknowns fused into one;
    a piece string outside the vocabulary (a fused unknown) becomes its
    ``<0xAB>`` byte tokens under ``byte_fallback`` where all are there, else
    ``unk_id``. Each word's ids are cached."""

    CACHE = 100_000  # words kept before the cache starts over
    UNK_PENALTY = 10.0

    def __init__(self, vocab: Sequence[Tuple[str, float]], unk_id: Optional[int] = None,
                 byte_fallback: bool = False):
        if unk_id is not None and not 0 <= unk_id < len(vocab):
            raise UnreadComponent(f"model Unigram with unk_id {unk_id} outside its "
                                  f"{len(vocab)} pieces")
        self.scores = [float(score) for _, score in vocab]
        self.vocab = {piece: i for i, (piece, _) in enumerate(vocab)}
        self.unk_id = unk_id
        self.byte_fallback = byte_fallback
        self.unk_score = min(self.scores, default=float("inf")) - self.UNK_PENALTY
        self.max_len = max((len(p) for p in self.vocab), default=0)
        self.cache: Dict[str, List[int]] = {}

    def _unk(self) -> int:
        if self.unk_id is None:
            raise MissingToken("Unigram: the model has no unk_id")
        return self.unk_id

    def pieces(self, word: str) -> List[str]:
        """The best segmentation's pieces, unknowns fused."""
        n, vocab, scores = len(word), self.vocab, self.scores
        best = [0.0] * (n + 1)
        start = [-1] * (n + 1)
        node = [0] * (n + 1)
        for i in range(n):
            till, single = best[i], False
            for j in range(i + 1, min(n, i + self.max_len) + 1):
                tid = vocab.get(word[i:j])
                if tid is None:
                    continue
                score = scores[tid] + till
                if start[j] < 0 or score > best[j]:
                    best[j], start[j], node[j] = score, i, tid
                single = single or j == i + 1
            if not single:
                score = self.unk_score + till
                if start[i + 1] < 0 or score > best[i + 1]:
                    best[i + 1], start[i + 1], node[i + 1] = score, i, self._unk()
        out, unknown, end = [], [], n
        while end > 0:
            begin = start[end]
            if node[end] == self.unk_id:
                unknown.append(word[begin:end])
            else:
                if unknown:
                    out.append("".join(reversed(unknown)))
                    unknown = []
                out.append(word[begin:end])
            end = begin
        if unknown:
            out.append("".join(reversed(unknown)))
        out.reverse()
        return out

    def _encode(self, word: str) -> List[int]:
        ids = []
        for piece in self.pieces(word):
            tid = self.vocab.get(piece)
            if tid is None:
                fallback = _byte_ids(self.vocab, piece) if self.byte_fallback else None
                if fallback is not None:
                    ids += fallback
                    continue
                tid = self._unk()
            ids.append(tid)
        return ids

    def __call__(self, word: str) -> List[int]:
        ids = self.cache.get(word)
        if ids is None:
            if len(self.cache) >= self.CACHE:
                self.cache.clear()
            ids = self.cache[word] = self._encode(word)
        return ids


class WordLevel:
    """Each word's id, or the unknown token's."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "<unk>"):
        self.vocab, self.unk_token = vocab, unk_token

    def __call__(self, word: str) -> List[int]:
        tid = self.vocab.get(word)
        if tid is None:
            tid = self.vocab.get(self.unk_token)
            if tid is None:
                raise MissingToken(f"WordLevel: {self.unk_token!r} is not in the vocabulary")
        return [tid]


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

    def __init__(self, tokens: Sequence[AddedToken], normalizer: Optional[Normalizer] = None):
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

    def split(self, text: str) -> List[Tuple[str, Optional[int], bool]]:
        """(piece, token id, first) triples; a piece with id None is
        normalized text for the pre-tokenizer, never empty, and ``first`` when
        it starts at the text's first offset."""
        out = []
        for piece, tid in self._find(text, self.raw):
            if tid is not None:
                out.append((piece, tid, False))
                continue
            at_start, keeps = not out, True
            if self.normalizer is not None:
                piece, keeps = self.normalizer.normalize(piece)
            for k, (p, t) in enumerate(self._find(piece, self.normalized)):
                if p or t is not None:
                    out.append((p, t, at_start and keeps and not k and t is None))
        return out


class Template:
    """A post-processor's single-sequence template: ``items`` of ``(ids,
    type_id)`` for special tokens and ``("A", type_id)`` for the sequence,
    whose type ids become ``type_id`` (``TemplateProcessing``) or stay
    (``keep_types``: ``BertProcessing``, ``RobertaProcessing``)."""

    def __init__(self, items: Sequence[Tuple[Union[str, List[int]], int]],
                 keep_types: bool = False):
        self.items = list(items)
        self.keep_types = keep_types
        self.added = sum(len(ids) for ids, _ in self.items if ids != "A")

    def apply(self, content: List[int],
              types: Optional[List[int]] = None) -> Tuple[List[int], List[int]]:
        ids, out = [], []
        for part, type_id in self.items:
            if part == "A":
                ids += content
                out += (list(types) if self.keep_types and types is not None
                        else [type_id] * len(content))
            else:
                ids += part
                out += [type_id] * len(part)
        return ids, out

    @classmethod
    def around(cls, first: int, last: int) -> "Template":
        """``first $A last``, all of type 0 (BertProcessing, RobertaProcessing)."""
        return cls([([first], 0), ("A", 0), ([last], 0)], keep_types=True)


class TemplateChain:
    """A ``Sequence`` post-processor's templates, each applied to the one before."""

    def __init__(self, templates: Sequence[Template]):
        self.templates = list(templates)
        self.added = sum(t.added for t in self.templates)

    def apply(self, content: List[int],
              types: Optional[List[int]] = None) -> Tuple[List[int], List[int]]:
        for t in self.templates:
            content, types = t.apply(content, types)
        return content, types


# -- the pipeline and the three layouts -----------------------------------------


class HFTokenizer:
    """Added tokens, normalizer, pre-tokenizer and model, then the template,
    the content truncated to ``max_length`` less the template's tokens, and
    right padding with ``pad_token_id`` (type 0, mask 0), as the JAX
    package's ``RustTokenizer`` sets the Rust tokenizer up."""

    def __init__(self, model, max_length: int, use_token_types: bool, pad_token_id: int,
                 normalizer: Optional[Normalizer] = None,
                 pre_tokenizer: Optional[PreTokenizer] = None,
                 added: Sequence[AddedToken] = (), template=None):
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
        for piece, tid, first in self.added.split(text):
            if tid is not None:
                content.append(tid)
                continue
            words = self.pre_tokenizer.split(piece, first) if self.pre_tokenizer else [(piece, first)]
            for word, _ in words:
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


def _behavior(spec, what: str) -> str:
    behavior = spec.get("behavior", "Isolated")
    if behavior not in SPLIT_BEHAVIORS:
        raise UnreadComponent(f"{what} with the behavior {behavior!r}")
    return behavior


class TokenizerJson(HFTokenizer):
    """A ``tokenizer.json``: its normalizer, pre-tokenizer, model and
    post-processor among those the module lists (``[CLS] $A [SEP]`` added
    where there is no post-processor and the vocabulary has both, the JAX
    package's ``_ensure_bert_postprocessor``), and its added tokens with their
    flags. The pad id is ``[PAD]``'s, else ``<pad>``'s, else 0. ``seed`` seeds
    the generator of a BPE's dropout."""

    def __init__(self, path: str, max_length: int, use_token_types: bool,
                 seed: Optional[int] = None):
        try:
            with open(path, encoding="utf-8") as f:
                spec = json.load(f)
        except ValueError as e:
            raise UnreadComponent(f"a file that is no JSON ({e})") from e
        self.seed = seed
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

    def _model(self, m):
        kind = m.get("type")
        if kind == "WordPiece":
            return WordPiece(m["vocab"], m.get("unk_token", "[UNK]"),
                             m.get("continuing_subword_prefix", "##"),
                             m.get("max_input_chars_per_word", 100))
        if kind == "BPE":
            dropout = m.get("dropout")
            if dropout is not None and not 0.0 <= dropout <= 1.0:
                raise UnreadComponent(f"model BPE with dropout {dropout} outside [0, 1], which "
                                      "the Rust library refuses")
            return BPE(m["vocab"], [_merge_pair(p) for p in m.get("merges", [])],
                       m.get("unk_token"), m.get("continuing_subword_prefix"),
                       m.get("end_of_word_suffix"), m.get("fuse_unk", False),
                       m.get("ignore_merges", False), m.get("byte_fallback", False),
                       dropout, np.random.default_rng(self.seed))
        if kind == "Unigram":
            return Unigram([(p, s) for p, s in m.get("vocab") or []], m.get("unk_id"),
                           m.get("byte_fallback", False))
        if kind == "WordLevel":
            return WordLevel(m["vocab"], m.get("unk_token", "<unk>"))
        raise UnreadComponent(f"model {kind}")

    @staticmethod
    def _normalizer(n) -> Optional[Normalizer]:
        if n is None:
            return None
        kind = n.get("type")
        if kind == "BertNormalizer":
            return BertNormalizer(n.get("clean_text", True), n.get("handle_chinese_chars", True),
                                  n.get("strip_accents"), n.get("lowercase", True))
        if kind == "Sequence":
            return NormalizerSequence([TokenizerJson._normalizer(p)
                                       for p in n.get("normalizers") or []])
        if kind == "Precompiled":
            try:
                return Precompiled(base64.b64decode(n["precompiled_charsmap"] or "",
                                                    validate=True))
            except (ValueError, TypeError, KeyError) as e:
                raise UnreadComponent(f"normalizer Precompiled whose charsmap does not parse "
                                      f"({e}), which the Rust library refuses") from e
        if kind == "Replace":
            return Replace(_pattern(n["pattern"], "normalizer Replace"), n["content"])
        if kind == "Strip":
            return Strip(n.get("strip_left", True), n.get("strip_right", True))
        if kind in ("NFC", "NFD", "NFKC", "NFKD"):
            return UnicodeNormalization(kind)
        simple = {"Nmt": Nmt, "Lowercase": Lowercase, "StripAccents": StripAccents,
                  "ByteLevel": ByteLevelNormalizer}
        if kind in simple:
            return simple[kind]()
        if kind == "Prepend":
            return Prepend(n["prepend"])
        raise UnreadComponent(f"normalizer {kind}")

    @staticmethod
    def _pre_tokenizer(p) -> Optional[PreTokenizer]:
        if p is None:
            return None
        kind = p.get("type")
        if kind == "BertPreTokenizer":
            return BertPreTokenizer()
        if kind == "ByteLevel":
            return ByteLevel(p.get("add_prefix_space", True), p.get("use_regex", True))
        if kind == "Metaspace":
            scheme = p.get("prepend_scheme", "always")
            if p.get("add_prefix_space") is False:
                scheme = "never"
            if scheme not in ("always", "first", "never"):
                raise UnreadComponent(f"pre_tokenizer Metaspace with prepend_scheme {scheme!r}")
            return Metaspace(p.get("replacement", "▁"), scheme, p.get("split", True))
        if kind == "Sequence":
            return PreTokenizerSequence([TokenizerJson._pre_tokenizer(q)
                                         for q in p.get("pretokenizers") or []])
        if kind == "Split":
            return Split(_pattern(p["pattern"], "pre_tokenizer Split"),
                         _behavior(p, "pre_tokenizer Split"), p.get("invert", False))
        if kind == "Punctuation":
            return Punctuation(_behavior(p, "pre_tokenizer Punctuation"))
        if kind == "Digits":
            return Digits(p.get("individual_digits", False))
        if kind == "CharDelimiterSplit":
            return CharDelimiterSplit(p["delimiter"])
        simple = {"Whitespace": Whitespace, "WhitespaceSplit": WhitespaceSplit}
        if kind in simple:
            return simple[kind]()
        raise UnreadComponent(f"pre_tokenizer {kind}")

    def _template(self, p):
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
        if kind == "Sequence":
            parts = [t for t in (self._template(q) for q in p.get("processors") or [])
                     if t is not None]
            return None if not parts else parts[0] if len(parts) == 1 else TemplateChain(parts)
        raise UnreadComponent(f"post_processor {kind}")

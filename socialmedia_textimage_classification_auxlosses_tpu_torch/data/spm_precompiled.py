"""SentencePiece's precompiled character map, as ``tokenizers`` reads it.

An XLM-R-family ``tokenizer.json`` normalizes with ``Precompiled``: the
``precompiled_charsmap`` of the model's ``sentencepiece.bpe.model`` (the
``nmt_nfkc`` rules), stored in base64. Its layout, as the ``spm_precompiled``
crate reads it:

* a little-endian u32, the trie's size in bytes;
* the Darts-clone double array, that many bytes of little-endian u32 units;
* the normalized strings, each ended by a NUL.

A key's bytes walk the double array from unit 0; the strings' byte offsets are
the leaves' values. ``tokenizers`` 0.22.2 normalizes with it in two steps that
the port copies as they are:

* the text is cut into extended grapheme clusters (the ``unicode-segmentation``
  crate, Unicode 16.0); a cluster under 6 bytes is looked up whole, and when a
  key is a prefix of it the *shortest* such key's string replaces the *whole*
  cluster (so ``a`` + U+0301 becomes the string of ``a`` where ``a`` is a key);
* a cluster that is longer, or has no key as a prefix, is looked up one
  character at a time, each character kept where no key is its prefix.

Python's ``unicodedata`` has no Grapheme_Cluster_Break, so ``graphemes`` here
segments with its own tables (``_grapheme_table.py``) by the rules of UAX #29.
"""

from __future__ import annotations

import struct
from bisect import bisect_right
from typing import Dict, List, Optional

from ._grapheme_table import EXTENDED_PICTOGRAPHIC, GCB_RANGES, INCB_RANGES

# Grapheme_Cluster_Break values
OTHER, CR, LF, CONTROL, EXTEND, ZWJ, RI, PREPEND, SPACING_MARK, L, V, T, LV, LVT = range(14)
# Indic_Conjunct_Break values
CONSONANT, LINKER, INCB_EXTEND = 1, 2, 3

_GCB_STARTS = [a for a, _, _ in GCB_RANGES]
_EP_STARTS = [a for a, _ in EXTENDED_PICTOGRAPHIC]
_INCB_STARTS = [a for a, _, _ in INCB_RANGES]
_CONTROLS = (CONTROL, CR, LF)


def _lookup(starts, ranges, cp: int, width: int) -> int:
    i = bisect_right(starts, cp) - 1
    if i >= 0 and cp <= ranges[i][1]:
        return ranges[i][2] if width == 3 else 1
    return 0


def grapheme_break(cp: int) -> int:
    """The code point's Grapheme_Cluster_Break."""
    if cp < 0x7F:
        return CR if cp == 13 else LF if cp == 10 else CONTROL if cp < 0x20 else OTHER
    if 0xAC00 <= cp <= 0xD7A3:  # Hangul syllables: LV at each 28th, else LVT
        return LV if (cp - 0xAC00) % 28 == 0 else LVT
    return _lookup(_GCB_STARTS, GCB_RANGES, cp, 3)


def _pictographic(cp: int) -> bool:
    return cp >= 0xA9 and bool(_lookup(_EP_STARTS, EXTENDED_PICTOGRAPHIC, cp, 2))


def _incb(cp: int) -> int:
    return 0 if cp < 0x300 else _lookup(_INCB_STARTS, INCB_RANGES, cp, 3)


def graphemes(text: str) -> List[str]:
    """``text`` cut into extended grapheme clusters (UAX #29, rules GB3-GB13
    with GB9c and GB11)."""
    if text.isascii():
        if "\r\n" not in text:
            return list(text)
        out: List[str] = []
        for i, c in enumerate(text):
            if c == "\n" and i and text[i - 1] == "\r":
                out[-1] += c
            else:
                out.append(c)
        return out
    out, start = [], 0
    prev = OTHER
    ri_run = 0  # regional indicators right before this character
    emoji = 0  # 1: after ExtPict Extend*, 2: after ExtPict Extend* ZWJ
    conjunct = 0  # 1: after Consonant [Extend Linker]*, 2: a Linker among them
    for i, ch in enumerate(text):
        cp = ord(ch)
        cur = grapheme_break(cp)
        incb = _incb(cp)
        if i:
            if prev == CR and cur == LF:
                join = True
            elif prev in _CONTROLS or cur in _CONTROLS:
                join = False
            elif prev == L and cur in (L, V, LV, LVT):
                join = True
            elif prev in (LV, V) and cur in (V, T):
                join = True
            elif prev in (LVT, T) and cur == T:
                join = True
            elif cur in (EXTEND, ZWJ, SPACING_MARK) or prev == PREPEND:
                join = True
            elif conjunct == 2 and incb == CONSONANT:
                join = True
            elif emoji == 2 and _pictographic(cp):
                join = True
            else:
                join = prev == RI and cur == RI and ri_run % 2 == 1
            if not join:
                out.append(text[start:i])
                start = i
        ri_run = ri_run + 1 if cur == RI else 0
        if _pictographic(cp):
            emoji = 1
        elif emoji == 1 and cur == EXTEND:
            pass
        else:
            emoji = 2 if emoji == 1 and cur == ZWJ else 0
        if incb == CONSONANT:
            conjunct = 1
        elif conjunct and incb == LINKER:
            conjunct = 2
        elif not (conjunct and incb == INCB_EXTEND):
            conjunct = 0
        prev = cur
    out.append(text[start:])
    return out


class CharsMap:
    """The double array and the normalized strings of a precompiled charsmap."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("a precompiled charsmap holds at least its trie's size")
        n = struct.unpack_from("<I", blob)[0] // 4
        if len(blob) < 4 + 4 * n:
            raise ValueError(f"a precompiled charsmap of {len(blob)} bytes holds no trie of "
                             f"{n} units")
        self.units = list(struct.unpack_from(f"<{n}I", blob, 4))
        self.normalized = bytes(blob[4 + 4 * n:])
        self.normalized.decode("utf-8")  # the crate refuses strings that are no UTF-8
        self._strings: Dict[int, str] = {}

    def _string(self, value: int) -> str:
        s = self._strings.get(value)
        if s is None:
            end = self.normalized.find(b"\0", value)
            s = self._strings[value] = self.normalized[value:end if end >= 0 else None].decode(
                "utf-8")
        return s

    def transform(self, chunk: str) -> Optional[str]:
        """The string of the shortest key that is a prefix of ``chunk``, or
        None (``common_prefix_search`` and its first result)."""
        units, n = self.units, len(self.units)
        u = units[0]
        pos = (u >> 10) << ((u & 0x200) >> 6)
        for b in chunk.encode("utf-8"):
            if b == 0:
                return None
            pos ^= b
            if pos >= n:
                return None
            u = units[pos]
            if u & 0x800000FF != b:
                return None
            pos ^= (u >> 10) << ((u & 0x200) >> 6)
            if u & 0x100:
                return self._string(units[pos] & 0x7FFFFFFF) if pos < n else None
        return None


class Precompiled:
    """The ``Precompiled`` normalizer over a charsmap (see the module's
    docstring), with ``data/hf_layouts.py::Normalizer``'s interface; each
    cluster's result is memoized."""

    MEMO = 100_000  # clusters kept before the memo starts over

    def __init__(self, blob: bytes):
        self.charsmap = CharsMap(blob)
        self._memo: Dict[str, str] = {}

    def _cluster(self, g: str) -> str:
        out = self._memo.get(g)
        if out is None:
            transform = self.charsmap.transform
            out = transform(g) if len(g.encode("utf-8")) < 6 else None
            if out is None:
                out = "".join(c if (t := transform(c)) is None else t for c in g)
            if len(self._memo) >= self.MEMO:
                self._memo.clear()
            self._memo[g] = out
        return out

    def __call__(self, text: str) -> str:
        return "".join(map(self._cluster, graphemes(text)))

    def normalize(self, text: str):
        """The normalized text, and True: its first character keeps the
        text's first offset (``tokenizers`` maps a deleted first cluster's
        offset onto the next character)."""
        return self(text), True

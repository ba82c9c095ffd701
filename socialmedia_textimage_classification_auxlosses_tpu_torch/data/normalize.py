"""Tweet normalization (L1).

BERTweet-style normalization with the same observable rules as the reference
(`preprocessing/text_processing.py:180-248` plus its vendored NLTK
TweetTokenizer at `:488-532`): casual tweet tokenization (URLs, phone numbers,
emoticons, HTML tags, arrows, @handles, #hashtags, emails, words), HTML-entity
unescaping, squeezing of >=4 repeated non-alphanumerics, then per-token
rewriting (`@...` -> `@USER`, URLs -> `HTTPURL`, single-char emoji ->
``:name:``) and contraction / a.m.-p.m. spacing fixups.

This is an independent implementation: one table of named sub-patterns is
compiled into a single alternation, and emoji demojization is built in
(Unicode names; no third-party ``emoji`` package) so the data layer works in
a hermetic environment.

Attribution: the token-grammar regex fragments below (URL, emoticon, phone
number, etc.) reproduce the NLTK ``nltk.tokenize.casual`` TweetTokenizer
grammar (Copyright (C) 2001-2023 NLTK Project; authors Christopher Potts,
Ewan Klein, Pierpaolo Pantone; Apache License 2.0), which the reference
vendors verbatim at ``preprocessing/text_processing.py:264-417``. Those
regex strings ARE the tokenization spec the byte-parity tests
(tests/test_normalize.py) hold this module to; the machinery around them is
original.
"""

from __future__ import annotations

import html
import re
import unicodedata
from functools import lru_cache
from typing import List

# --------------------------------------------------------------------------
# Token grammar. Order matters: the alternation tries patterns left to right,
# and the catch-all word/other pattern must come last.
# --------------------------------------------------------------------------

_URL = r"""
  (?:
    https?:(?:/{1,3}|[a-z0-9%])
    |
    [a-z0-9.\-]+[.](?:[a-z]{2,13})/
  )
  (?:
    [^\s()<>{}\[\]]+
    |
    \([^\s()]*?\([^\s()]+\)[^\s()]*?\)
    |
    \([^\s]+?\)
  )+
  (?:
    \([^\s()]*?\([^\s()]+\)[^\s()]*?\)
    |
    \([^\s]+?\)
    |
    [^\s`!()\[\]{};:'".,<>?«»“”‘’]
  )
  |
  (?:
    (?<!@)
    [a-z0-9]+
    (?:[.\-][a-z0-9]+)*
    [.]
    (?:[a-z]{2,13})
    \b
    /?
    (?!@)
  )
"""

_PHONE = r"""
  (?:
    (?:\+?[01][ *\-.\)]*)?
    (?:[\(]?\d{3}[ *\-.\)]*)?
    \d{3}[ *\-.\)]*\d{4}
  )
"""

# ASCII emoticons: eyes/nose/mouth in either orientation, plus <3.
_EMOTICON = r"""
  (?:
    [<>]?
    [:;=8]
    [\-o\*\']?
    [\)\]\(\[dDpP/\:\}\{@\|\\]
    |
    [\)\]\(\[dDpP/\:\}\{@\|\\]
    [\-o\*\']?
    [:;=8]
    [<>]?
    |
    <3
  )
"""

_HTML_TAG = r"<[^>\s]+>"
_ARROW = r"[\-]+>|<[\-]+"
_HANDLE = r"(?:@[\w_]+)"
_HASHTAG = r"(?:\#+[\w_]+[\w\'_\-]*[\w_]+)"
_EMAIL = r"[\w.+-]+@[\w-]+\.(?:[\w-]\.?)+[\w-]"
_WORDS = r"""
  (?:[^\W\d_](?:[^\W\d_]|['\-_])+[^\W\d_])   # words with internal ' or -
  |
  (?:[+\-]?\d+[,/.:-]\d+[+\-]?)              # numbers w/ separators
  |
  (?:[\w_]+)                                 # plain words
  |
  (?:\.(?:\s*\.){1,})                        # ellipsis runs
  |
  (?:\S)                                     # any other non-space char
"""

_GRAMMAR = (_URL, _PHONE, _EMOTICON, _HTML_TAG, _ARROW, _HANDLE, _HASHTAG, _EMAIL, _WORDS)

_TOKEN_RE = re.compile("(%s)" % "|".join(_GRAMMAR), re.VERBOSE | re.I | re.UNICODE)
_EMOTICON_RE = re.compile(_EMOTICON, re.VERBOSE | re.I | re.UNICODE)
# Runs of >=4 identical non-alphanumerics get squeezed to 3.
_LONG_PUNCT_RE = re.compile(r"([^a-zA-Z0-9])\1{3,}")
_ENTITY_RE = re.compile(r"&(#?(x?))([^&;\s]+);")
_TRIPLE_CHAR_RE = re.compile(r"(.)\1{2,}")


def _decode_entity(match: "re.Match[str]") -> str:
    body = match.group(3)
    if match.group(1):  # numeric: &#nn; or &#xhh;
        try:
            code = int(body, 16 if match.group(2) else 10)
        except ValueError:
            return ""
        # 0x80-0x9F are conventionally read as cp1252 (browser behaviour).
        if 0x80 <= code <= 0x9F:
            try:
                return bytes((code,)).decode("cp1252")
            except UnicodeDecodeError:
                return ""
        try:
            return chr(code)
        except (ValueError, OverflowError):
            return ""
    code = html.entities.name2codepoint.get(body)
    if code is None:
        return ""
    return chr(code)


def replace_html_entities(text) -> str:
    if isinstance(text, bytes):
        text = text.decode("utf-8")
    return _ENTITY_RE.sub(_decode_entity, text)


def reduce_lengthening(text: str) -> str:
    """Cap repeated character runs at length 3 (reference text_processing.py:540-545)."""
    return _TRIPLE_CHAR_RE.sub(r"\1\1\1", text)


def remove_handles(text: str) -> str:
    """Strip @handles (reference text_processing.py:548-556)."""
    pat = re.compile(
        r"(?<![A-Za-z0-9_!@#\$%&*])@(([A-Za-z0-9_]){20}(?!@))"
        r"|(?<![A-Za-z0-9_!@#\$%&*])@(([A-Za-z0-9_]){1,19})(?![A-Za-z0-9_]*@)"
    )
    return pat.sub(" ", text)


def tweet_tokenize(
    text: str,
    preserve_case: bool = True,
    reduce_len: bool = False,
    strip_handles: bool = False,
) -> List[str]:
    """Casual tweet tokenizer with the reference's observable behaviour
    (reference text_processing.py:510-532)."""
    text = replace_html_entities(text)
    if strip_handles:
        text = remove_handles(text)
    if reduce_len:
        text = reduce_lengthening(text)
    text = _LONG_PUNCT_RE.sub(r"\1\1\1", text)
    words = _TOKEN_RE.findall(text)
    words = [w[0] if isinstance(w, tuple) else w for w in words]
    if not preserve_case:
        words = [w if _EMOTICON_RE.search(w) else w.lower() for w in words]
    return words


# --------------------------------------------------------------------------
# Demojization without third-party deps, faithful to ``emoji==0.6.0`` which
# the reference uses (reference text_processing.py:186-194,243).  The
# vendored table maps bare codepoints to the package's CLDR-style names
# (provenance + forensics in tools/gen_emoji06_table.py).  Only 1-char
# tokens ever reach the demojizer (text_processing.py:242-246), so bare
# single codepoints are the complete reachable key space; characters absent
# from the 0.6.0-era table — including emoji added to Unicode later and
# stray variation selectors split off by the tokenizer — pass through
# unchanged, exactly as the frozen 0.6.0 table would leave them.
# --------------------------------------------------------------------------

from ._emoji06_table import EMOJI06_NAMES


@lru_cache(maxsize=4096)
def demojize_char(ch: str, unicode_name_fallback: bool = False) -> str:
    if len(ch) != 1:
        return ch
    name = EMOJI06_NAMES.get(ord(ch))
    if name is not None:
        return ":" + name + ":"
    if not unicode_name_fallback:
        return ch
    # Opt-in non-parity mode: derive a :snake_case: name from the Unicode
    # character name for emoji newer than the 0.6.0 table.
    cat = unicodedata.category(ch)
    if cat not in ("So", "Sk") and not (0x1F000 <= ord(ch) <= 0x1FAFF):
        return ch
    try:
        uname = unicodedata.name(ch)
    except ValueError:
        return ch
    return ":" + uname.lower().replace(" ", "_").replace("-", "_") + ":"


_SPECIAL_PUNCTS = {"’": "'", "…": "..."}


class TweetNormalizer:
    """``normalizeTweet``-equivalent (reference text_processing.py:196-248)."""

    def __init__(self):
        self.special_puncts = dict(_SPECIAL_PUNCTS)

    def normalize_token(self, token: str) -> str:
        low = token.lower()
        if token.startswith("@"):
            return "@USER"
        if low.startswith("http") or low.startswith("www"):
            return "HTTPURL"
        if len(token) == 1:
            if token in self.special_puncts:
                return self.special_puncts[token]
            return demojize_char(token)
        return token

    def normalize(self, tweet: str) -> str:
        for punct, repl in self.special_puncts.items():
            tweet = tweet.replace(punct, repl)

        tokens = tweet_tokenize(tweet)
        out = " ".join(self.normalize_token(tok) for tok in tokens)

        out = (
            out.replace("cannot ", "can not ")
            .replace("n't ", " n't ")
            .replace("n 't ", " n't ")
            .replace("ca n't", "can't")
            .replace("ai n't", "ain't")
        )
        out = (
            out.replace("'m ", " 'm ")
            .replace("'re ", " 're ")
            .replace("'s ", " 's ")
            .replace("'ll ", " 'll ")
            .replace("'d ", " 'd ")
            .replace("'ve ", " 've ")
        )
        out = (
            out.replace(" p . m .", "  p.m.")
            .replace(" p . m ", " p.m ")
            .replace(" a . m .", " a.m.")
            .replace(" a . m ", " a.m ")
        )
        return " ".join(out.split())

    # Reference-compatible aliases (Tweet_Preprocessing.normalizeTweet).
    normalizeTweet = normalize
    normalizeToken = normalize_token

"""The port's ``tokenizer.json`` components (``data/hf_layouts.py``,
``data/spm_precompiled.py``) against the Rust ``tokenizers`` library that the
JAX package reads them with (0.22.2 on this host), one component at a time,
on 300 seeded texts of tweet-like pieces: emoji, ZWJ sequences and skin
tones, flags, fullwidth letters, combining marks after 1-, 2- and 3-byte
bases, CR LF, zero-width and control characters, runs of spaces.

* Each normalizer against ``normalize_str`` and each pre-tokenizer against
  ``pre_tokenize_str``.
* ``Precompiled`` over a charsmap written here by a small Darts-clone encoder
  (``build_charsmap``) from seeded NFKC pairs, deletions and prefix pairs
  such as ``e`` / ``e`` + U+0301 that show the shortest-prefix rule on short
  grapheme clusters; the grapheme segmenter against ``regex``'s ``\\X``.
* ``Unigram`` over vocabularies from ``UnigramTrainer`` and from
  ``transformers``' ``XLMRobertaConverter`` (a hand-written ModelProto),
  random ones full of ties, unknown runs and ``byte_fallback``; a Metaspace
  ``first`` behind each normalizer, with added tokens.
* BPE ``byte_fallback`` and ``dropout`` (equal to Rust at 0 and 1; at 0.5 the
  pieces spell the word and repeat under one seed); ``WordLevel``; the
  ``Sequence`` post-processor. What the port does not read raises
  ``UnreadComponent``.
"""

import json
import struct

import numpy as np
import pytest
import regex
from tokenizers import AddedToken, Regex, Tokenizer, models, normalizers, pre_tokenizers
from tokenizers import processors, trainers

from socialmedia_textimage_classification_auxlosses_tpu_torch.data import hf_layouts as H
from socialmedia_textimage_classification_auxlosses_tpu_torch.data import spm_precompiled as S

PARTS = [
    "hello", "world", "tweet", "the", "ab", "a", "b", "e", " ", "  ", "   ", "\t", "\r\n", "\r",
    "\n", "\x01", "\x7f", "\x00", "\u200b", "\u200d", "\ufeff", "\xad", "\ufffd", "\x85",
    "\U0001f600", "\U0001f44d\U0001f3fd", "a\U0001f3fb", "\U0001f469\u200d\U0001f4bb",
    "\U0001f1fa\U0001f1f8", "\u2764\ufe0f", "\u00a9\u200d\u00a9", "\uff21", "\uff41\u0301",
    "\uff21\u0301", "e\u0301", "e\u0301\u0301", "\u00e9", "\u00e9\u0301", "\u0628\u064e",
    "\u0915\u094d\u0937", "\u0915\u093c\u0301", "\u1100\u1161\u11a8", "\uac00\u0301",
    "\u0600a", "\u0301", "\ufb01", "\u2460", "\u3000", "\xa0", "\u2581", "``", "''", "#tag",
    "@user", "don't", "42", "\u00b2", "\u2167", "\u0663", "\u0130", "\u03a3", "\u00df", "!",
    "_", "<x>", "<y>", "<s>", "<unk>", "\u4e16\u754c", "\U000107b0", "\u32ff", "\u1cf2"]


def fuzz_texts(seed=0, n=300):
    rng = np.random.RandomState(seed)
    return ["".join(PARTS[i] for i in rng.randint(0, len(PARTS), rng.randint(0, 20)))
            for _ in range(n)]


TEXTS = fuzz_texts()


def build_charsmap(pairs):
    """A precompiled charsmap of ``pairs`` (key -> normalized string): the
    trie's size, a Darts-clone double array over the keys' bytes (each node's
    children at ``base ^ label``, a base used once, a leaf under label 0
    holding the string's offset), then the NUL-ended strings."""
    blob, offsets = bytearray(), {}
    for key in sorted(pairs):
        offsets[key] = len(blob)
        blob += pairs[key].encode() + b"\0"
    trie = {}
    for key in pairs:
        node = trie
        for b in key.encode():
            node = node.setdefault(b, {})
        node[0] = offsets[key]
    units, used, bases, queue = [0] * 256, {0}, set(), [(0, trie)]
    while queue:
        pos, node = queue.pop(0)
        base = 1
        while base in bases or any((base ^ label) in used for label in node):
            base += 1
        bases.add(base)
        units[pos] |= (pos ^ base) << 10
        units += [0] * ((base | 255) + 1 - len(units))
        for label, child in node.items():
            used.add(base ^ label)
            if label:
                units[base ^ label] = label
                queue.append((base ^ label, child))
            else:
                units[base] = child | (1 << 31)
                units[pos] |= 1 << 8
    return struct.pack(f"<I{len(units)}I", 4 * len(units), *units) + bytes(blob)


def charsmap_pairs(seed=0):
    """Seeded NFKC pairs (fullwidth letters, ligatures, circled digits,
    spaces), deletions, and prefix pairs: ``a`` beside ``ab``, ``e`` beside
    ``e`` + U+0301."""
    rng = np.random.RandomState(seed)
    nfkc = [c for c in map(chr, list(range(0xFF01, 0xFF5F)) + list(range(0x2460, 0x2474))
                           + [0xFB01, 0xFB02, 0x3000, 0xA0, 0xB2, 0x2167, 0x32FF])
            if __import__("unicodedata").normalize("NFKC", c) != c]
    pairs = {c: __import__("unicodedata").normalize("NFKC", c)
             for c in rng.choice(nfkc, 60, replace=False)}
    pairs.update({"\uff21": "A", "\u200b": "", "\xad": "", "\ufeff": "", "a": "A", "ab": "X",
                  "e": "E", "e\u0301": "\u00e9", "\u0915": "K", "\u0600": "P", "\u00a9": "C",
                  "\U0001f600": "<smile>", "\u1161": "V"})
    return pairs


CHARSMAP = build_charsmap(charsmap_pairs())


def spec(component):
    return json.loads(component.__getstate__())


NORMALIZERS = {
    "Strip": normalizers.Strip(), "Strip_right": normalizers.Strip(left=False, right=True),
    "Replace_string": normalizers.Replace("``", '"'),
    "Replace_regex": normalizers.Replace(Regex(" {2,}"), "\u2581"),
    "NFC": normalizers.NFC(), "NFD": normalizers.NFD(), "NFKC": normalizers.NFKC(),
    "NFKD": normalizers.NFKD(), "Nmt": normalizers.Nmt(), "Lowercase": normalizers.Lowercase(),
    "StripAccents": normalizers.StripAccents(), "Prepend": normalizers.Prepend("\u2581"),
    "ByteLevel": normalizers.ByteLevel(),
    "Sequence": normalizers.Sequence([normalizers.NFKD(), normalizers.StripAccents(),
                                      normalizers.Lowercase()]),
    "Precompiled": normalizers.Precompiled(CHARSMAP),
    "xlmr_published": normalizers.Sequence([
        normalizers.Replace("``", '"'), normalizers.Replace("''", '"'),
        normalizers.Precompiled(CHARSMAP), normalizers.Replace(Regex(" {2,}"), " ")]),
    "xlmr_converter": normalizers.Sequence([
        normalizers.Precompiled(CHARSMAP), normalizers.Strip(left=False, right=True),
        normalizers.Replace(Regex(" {2,}"), "\u2581")]),
}


@pytest.mark.parametrize("name", sorted(NORMALIZERS))
def test_normalizer_matches_rust(name):
    rust = NORMALIZERS[name]
    port = H.TokenizerJson._normalizer(spec(rust))
    for text in TEXTS:
        assert port(text) == rust.normalize_str(text), ascii(text)


PRE_TOKENIZERS = {
    "Metaspace": pre_tokenizers.Metaspace(),
    "Metaspace_never": pre_tokenizers.Metaspace(prepend_scheme="never"),
    "Metaspace_first": pre_tokenizers.Metaspace(prepend_scheme="first"),
    "Metaspace_unsplit": pre_tokenizers.Metaspace(split=False),
    "Whitespace": pre_tokenizers.Whitespace(), "WhitespaceSplit": pre_tokenizers.WhitespaceSplit(),
    "Punctuation": pre_tokenizers.Punctuation(),
    "Punctuation_merged_with_next": pre_tokenizers.Punctuation("merged_with_next"),
    "Punctuation_merged_with_previous": pre_tokenizers.Punctuation("merged_with_previous"),
    "Punctuation_contiguous": pre_tokenizers.Punctuation("contiguous"),
    "Digits": pre_tokenizers.Digits(False), "Digits_individual": pre_tokenizers.Digits(True),
    "CharDelimiterSplit": pre_tokenizers.CharDelimiterSplit("a"),
    "Split_string_removed": pre_tokenizers.Split(" ", "removed"),
    "Split_regex_inverted": pre_tokenizers.Split(Regex(" +"), "merged_with_next", invert=True),
    "Split_string_contiguous": pre_tokenizers.Split("l", "contiguous"),
    "Sequence": pre_tokenizers.Sequence([pre_tokenizers.WhitespaceSplit(),
                                         pre_tokenizers.Digits(True),
                                         pre_tokenizers.Metaspace(prepend_scheme="first")]),
}


@pytest.mark.parametrize("name", sorted(PRE_TOKENIZERS))
def test_pre_tokenizer_matches_rust(name):
    rust = PRE_TOKENIZERS[name]
    port = H.TokenizerJson._pre_tokenizer(spec(rust))
    for text in TEXTS:
        if text:  # the pipeline drops empty pieces before this step
            assert port(text) == [p for p, _ in rust.pre_tokenize_str(text)], ascii(text)


def test_legacy_metaspace_is_always_and_split():
    """``{"add_prefix_space": true}`` without ``prepend_scheme``: Rust 0.22.2
    reads ``always`` and ``split``; ``false`` reads ``never``."""
    for flag, scheme in ((True, "always"), (False, "never")):
        got = H.TokenizerJson._pre_tokenizer({"type": "Metaspace", "replacement": "\u2581",
                                              "add_prefix_space": flag})
        assert (got.prepend_scheme, got.split_pieces) == (scheme, True)


def test_precompiled_shortest_prefix_replaces_short_clusters():
    """A cluster under 6 bytes takes the string of its shortest key prefix,
    the rest of it dropped; a longer one goes a character at a time."""
    rust, port = normalizers.Precompiled(CHARSMAP), S.Precompiled(CHARSMAP)
    cases = {"\uff21\u0301": "A",  # 5 bytes: the mark is dropped
             "e\u0301": "E",  # the shortest key, e, not e + U+0301
             "e\u0301\u0301": "E",  # 5 bytes
             "\u00e9\u0301": "\u00e9\u0301",  # no key is a prefix: kept
             "a\U0001f3fb": "A",  # a skin tone is Extend
             "\u0600a": "P",  # Prepend joins its base
             "\u0915\u094d\u0915\u0301": "K\u094dK\u0301",  # one cluster by GB9c, 11 bytes
             "\u00a9\u200d\u00a9": "C\u200dC",  # one cluster by GB11, 7 bytes
             "\u1100\u1161\u0301": "\u1100V\u0301",  # L V and the mark, 8 bytes
             "\uac00\u0301": "\uac00\u0301"}  # LV and the mark, 5 bytes: no key
    for text, want in cases.items():
        assert rust.normalize_str(text) == want, ascii(text)
        assert port(text) == want, ascii(text)


def test_grapheme_clusters_match_regex():
    rng = np.random.RandomState(1)
    for _ in range(2000):
        text = "".join(PARTS[i] for i in rng.randint(0, len(PARTS), rng.randint(1, 8)))
        assert S.graphemes(text) == regex.findall(r"\X", text), ascii(text)


def test_grapheme_joins_match_rust_on_every_ninth_code_point():
    """``a`` + c is one cluster (under 6 bytes, so ``a``'s string replaces it)
    exactly where Rust's segmentation joins them: Extend, ZWJ and
    SpacingMark of Unicode 16.0."""
    blob = build_charsmap({"a": "b"})
    cps = [c for c in range(0, 0x110000, 9) if not 0xD800 <= c <= 0xDFFF and c not in (10, 13)]
    rust = normalizers.Precompiled(blob).normalize_str("\n".join("a" + chr(c) for c in cps))
    assert [len(S.graphemes("a" + chr(c))) == 1 for c in cps] == [
        out == "b" for out in rust.split("\n")]


def _tokenizer_json(tok, tmp_path, name="tokenizer.json", seed=None):
    path = tmp_path / name
    tok.save(str(path))
    return H.TokenizerJson(str(path), 10 ** 6, False, seed)


def _same_ids(rust, port, texts=TEXTS):
    for text in texts:
        assert port.encode(text)[0] == rust.encode(text).ids, ascii(text)


CORPUS = fuzz_texts(2, 200) + ["hello world this is a tweet", "another tweet about the world"] * 20


@pytest.mark.parametrize("scheme", ["always", "first", "never"])
def test_unigram_behind_each_normalizer_matches_rust(tmp_path, scheme):
    """A trained Unigram behind a Metaspace of each scheme and each of
    several normalizers, with a raw and a normalized added token (``first``
    prepends only where the text's first offset survives normalization)."""
    for n, norm in enumerate([None, NORMALIZERS["Strip"], NORMALIZERS["Replace_string"],
                              NORMALIZERS["Nmt"], NORMALIZERS["StripAccents"],
                              NORMALIZERS["xlmr_published"]]):
        tok = Tokenizer(models.Unigram())
        if norm is not None:
            tok.normalizer = norm
        tok.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme=scheme)
        tok.train_from_iterator(CORPUS, trainers.UnigramTrainer(
            vocab_size=150, special_tokens=["<unk>"], unk_token="<unk>"))
        tok.add_tokens([AddedToken("<x>", normalized=False),
                        AddedToken("<y>", normalized=True, lstrip=True)])
        _same_ids(tok, _tokenizer_json(tok, tmp_path, f"{n}.json"))


def test_unigram_ties_unknowns_and_byte_fallback_match_rust(tmp_path):
    """Random vocabularies of few scores (many ties), with and without an
    ``unk_id`` and ``<0xAB>`` pieces, on texts with unknown runs."""
    rust = Tokenizer(models.Unigram([("<unk>", 0.0), ("a", -1.0), ("b", -1.0), ("c", -1.0),
                                     ("ab", -2.0), ("bc", -2.0), ("abc", -3.0)], 0))
    assert rust.encode("abc").tokens == ["abc"]
    assert _tokenizer_json(rust, tmp_path).model.pieces("abc") == ["abc"]
    rng = np.random.RandomState(3)
    chars = list("abcd\u00e9\U0001f600xyz")
    for trial in range(150):
        pieces = sorted({"".join(rng.choice(chars[:6], rng.randint(1, 4)))
                         for _ in range(rng.randint(3, 25))})
        vocab = [("<unk>", 0.0)] + [(p, float(-rng.randint(1, 4))) for p in pieces]
        fallback = bool(rng.randint(2))
        if fallback:
            vocab += [(f"<0x{b:02X}>", -5.0) for b in "\u00e9x".encode()]
        unk = 0 if rng.randint(4) else None
        rust = Tokenizer(models.Unigram(vocab, unk, byte_fallback=fallback))
        port = _tokenizer_json(rust, tmp_path, f"{trial}.json")
        for _ in range(15):
            text = "".join(rng.choice(chars, rng.randint(0, 10)))
            try:
                want = rust.encode(text).ids
            except Exception:  # no unk_id for an unknown
                with pytest.raises(H.MissingToken):
                    port.encode(text)
                continue
            assert port.encode(text)[0] == want, (ascii(text), vocab, unk)


def _xlmr_proto(charsmap):
    from transformers.utils import sentencepiece_model_pb2_new as pb2

    proto = pb2.ModelProto()
    rng = np.random.RandomState(4)
    words = sorted({w for t in CORPUS for w in t.split()})
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3), ("\u2581", -2.0, 1)]
    pieces += [(c, -5.0 - rng.rand(), 1) for c in sorted(set("".join(words)))]
    pieces += [("\u2581" + w[:k], -float(rng.randint(1, 6)), 1) for w in words[:80]
               for k in range(2, len(w) + 1, 2)]
    seen = set()
    for piece, score, typ in pieces:
        if piece in seen:
            continue
        seen.add(piece)
        p = proto.pieces.add()
        p.piece, p.score, p.type = piece, score, typ
    proto.trainer_spec.model_type = 1  # Unigram
    if charsmap:
        proto.normalizer_spec.precompiled_charsmap = charsmap
    return proto


@pytest.mark.parametrize("charsmap", [False, True], ids=["plain", "precompiled"])
def test_xlmr_converter_file_matches_rust(tmp_path, charsmap):
    """``XLMRobertaConverter`` on a hand-written Unigram ModelProto (a stub
    tokenizer holding its path): the ``tokenizer.json`` it writes."""
    from transformers.convert_slow_tokenizer import XLMRobertaConverter

    path = tmp_path / "sentencepiece.bpe.model"
    path.write_bytes(_xlmr_proto(CHARSMAP if charsmap else None).SerializeToString())

    class Stub:
        vocab_file = str(path)

        @staticmethod
        def convert_tokens_to_ids(token):
            return {"<s>": 0, "</s>": 2}[token]

    rust = XLMRobertaConverter(Stub()).converted()
    port = _tokenizer_json(rust, tmp_path)
    kinds = [n["type"] for n in spec(rust.normalizer)["normalizers"]]
    assert ("Precompiled" in kinds) == charsmap
    _same_ids(rust, port)


def test_bpe_byte_fallback_matches_rust(tmp_path):
    """Bytes for a missing character (the prefix's bytes too), an unknown
    pending before them coming after them, with and without ``fuse_unk``."""
    rng = np.random.RandomState(5)
    for trial in range(60):
        vocab = {t: i for i, t in enumerate(["<unk>", "a", "b", "ab", "##b", "##a", "a##b"])}
        for b in (range(256) if rng.randint(2) else "\u00e9#".encode()):
            vocab.setdefault(f"<0x{b:02X}>", len(vocab))
        kw = dict(unk_token="<unk>" if rng.randint(2) else None, fuse_unk=bool(rng.randint(2)),
                  byte_fallback=True)
        merges = [("a", "b")]
        if rng.randint(2):
            kw["continuing_subword_prefix"], merges = "##", [("a", "##b")]
        rust = Tokenizer(models.BPE(vocab, merges, **kw))
        port = _tokenizer_json(rust, tmp_path, f"{trial}.json")
        _same_ids(rust, port, ["".join(rng.choice(list("ab\u00e9\u20acx\U0001f600"),
                                                  rng.randint(0, 8))) for _ in range(15)])


def test_bpe_dropout(tmp_path):
    """Equal to Rust at 0 and at 1 (no merge); at 0.5 the pieces spell the
    word, vary, and repeat under one seed."""
    vocab = {t: i for i, t in enumerate(["a", "b", "c", "ab", "abc", "bc"])}
    merges = [("a", "b"), ("ab", "c"), ("b", "c")]
    words = ["abcabc", "abc", "cab", "bcabca"]
    for p in (0.0, 1.0):
        rust = Tokenizer(models.BPE(vocab, merges, dropout=p))
        _same_ids(rust, _tokenizer_json(rust, tmp_path, f"{p}.json"), words)
    rust = Tokenizer(models.BPE(vocab, merges, dropout=0.5))
    runs = []
    for _ in range(2):
        port = _tokenizer_json(rust, tmp_path, "half.json", seed=30)
        runs.append([port.encode("abcabc")[0] for _ in range(40)])
    assert runs[0] == runs[1]
    assert len({tuple(r) for r in runs[0]}) > 1
    names = {i: t for t, i in vocab.items()}
    assert all("".join(names[i] for i in ids) == "abcabc" for ids in runs[0])


def test_wordlevel_and_sequence_post_processor_match_rust(tmp_path):
    rust = Tokenizer(models.WordLevel({"<unk>": 0, "hello": 1, "<s>": 2, "</s>": 3,
                                       "[CLS]": 4}, unk_token="<unk>"))
    rust.pre_tokenizer = pre_tokenizers.Whitespace()
    for post in (processors.Sequence([processors.ByteLevel(), processors.TemplateProcessing(
            single="<s> $A:1 </s>", special_tokens=[("<s>", 2), ("</s>", 3)])]),
            processors.Sequence([processors.ByteLevel(), processors.BertProcessing(
                ("</s>", 3), ("[CLS]", 4)), processors.TemplateProcessing(
                single="<s> $A:1", special_tokens=[("<s>", 2)])])):
        rust.post_processor = post
        port = _tokenizer_json(rust, tmp_path)
        for text in ("hello you hello", "", "you"):
            want = rust.encode(text)
            assert port.encode(text) == (want.ids, want.type_ids)


@pytest.mark.parametrize("component,name,rust_refuses", [
    ({"pre_tokenizer": {"type": "UnicodeScripts"}}, "pre_tokenizer UnicodeScripts", False),
    ({"normalizer": {"type": "Replace", "pattern": {"Regex": "\\p{L}+"}, "content": ""}},
     "normalizer Replace with the regular expression", False),
    ({"normalizer": {"type": "Replace", "pattern": {"Regex": "x*"}, "content": ""}},
     "matches the empty string", False),
    ({"normalizer": {"type": "Precompiled", "precompiled_charsmap": ""}},
     "normalizer Precompiled whose charsmap does not parse", True),
    ({"model": {"type": "BPE", "vocab": {}, "merges": [], "dropout": 1.5}}, "dropout 1.5", True)])
def test_unread_components_are_named(tmp_path, component, name, rust_refuses):
    """What the port does not read raises ``UnreadComponent`` naming it; a
    file the Rust library refuses too (then the JAX package reads the
    directory's next layout, as ``build_tokenizer`` does)."""
    body = {"normalizer": None, "pre_tokenizer": None, "post_processor": None,
            "added_tokens": [], "model": {"type": "WordLevel", "vocab": {"a": 0},
                                          "unk_token": "a"}}
    body.update(component)
    (tmp_path / "tokenizer.json").write_text(json.dumps(body))
    with pytest.raises(H.UnreadComponent, match=name):
        H.TokenizerJson(str(tmp_path / "tokenizer.json"), 8, False)
    if rust_refuses:
        with pytest.raises(BaseException):  # a load error, or a panic
            Tokenizer.from_file(str(tmp_path / "tokenizer.json"))


# -- an XLM-R-family directory, as Bernice's ships ---------------------------------------


def spm_model_bytes(pieces):
    """A ModelProto in protobuf wire format: repeated field 1, each a
    SentencePiece of piece (1, string), score (2, float) and type (3, enum)."""
    def varint(n):
        out = bytearray()
        while True:
            out.append((n & 0x7F) | (0x80 if n > 0x7F else 0))
            n >>= 7
            if not n:
                return bytes(out)

    buf = bytearray()
    for piece, score, typ in pieces:
        raw = piece.encode("utf-8")
        msg = (b"\x0a" + varint(len(raw)) + raw + b"\x15" + struct.pack("<f", score)
               + b"\x18" + varint(typ))
        buf += b"\x0a" + varint(len(msg)) + msg
    return bytes(buf)


def xlmr_pieces(words, seed):
    """SentencePiece pieces over ``words``: ``<unk> <s> </s>``, the word
    marker and each character, and the marked prefixes of each word, with
    seeded float32 scores."""
    rng = np.random.RandomState(seed)
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3), ("▁", -3.0, 1)]
    seen = {p for p, _, _ in pieces}
    for p in sorted(set("".join(words))) + sorted({"▁" + w[:k] for w in words
                                                  for k in range(1, len(w) + 1)}):
        if p not in seen:
            seen.add(p)
            pieces.append((p, float(np.float32(-rng.uniform(1, 12))), 1))
    return pieces


def xlmr_tokenizer_json(pieces, charsmap):
    """The ``tokenizer.json`` that ``XLMRobertaConverter`` published for
    XLM-R-family models: ``Sequence[Replace, Replace, Precompiled, Replace]``,
    the legacy ``Metaspace``, ``Unigram`` over fairseq's ids (``<s> <pad>
    </s> <unk>``, the pieces past the first three, ``<mask>``), ``<s> $A
    </s>``."""
    vocab = [["<s>", 0.0], ["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0]]
    vocab += [[p, s] for p, s, _ in pieces[3:]] + [["<mask>", 0.0]]
    added = [{"id": i, "content": t, "single_word": False, "lstrip": t == "<mask>",
              "rstrip": False, "normalized": False, "special": True}
             for i, t in ((0, "<s>"), (1, "<pad>"), (2, "</s>"), (3, "<unk>"),
                          (len(vocab) - 1, "<mask>"))]
    metaspace = {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True}
    return {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Replace", "pattern": {"String": "``"}, "content": '"'},
            {"type": "Replace", "pattern": {"String": "''"}, "content": '"'},
            {"type": "Precompiled",
             "precompiled_charsmap": __import__("base64").b64encode(charsmap).decode()},
            {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
        "pre_tokenizer": metaspace,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "special_tokens": {t: {"id": t, "ids": [i], "tokens": [t]}
                               for t, i in (("<s>", 0), ("</s>", 2))}},
        "decoder": metaspace,
        "model": {"type": "Unigram", "unk_id": 3, "vocab": vocab}}


def write_xlmr_dir(d, pieces, charsmap=CHARSMAP):
    """``d`` as an XLM-R-family checkpoint's tokenizer files:
    ``sentencepiece.bpe.model`` and its converted ``tokenizer.json``."""
    d.mkdir(parents=True, exist_ok=True)
    (d / "sentencepiece.bpe.model").write_bytes(spm_model_bytes(pieces))
    (d / "tokenizer.json").write_text(json.dumps(xlmr_tokenizer_json(pieces, charsmap)))
    return str(d)


def test_published_xlmr_layout_matches_rust(tmp_path):
    words = sorted({w for t in CORPUS for w in t.lower().split()})
    d = write_xlmr_dir(tmp_path / "xlmr", xlmr_pieces(words, 6))
    rust = Tokenizer.from_file(d + "/tokenizer.json")
    _same_ids(rust, H.TokenizerJson(d + "/tokenizer.json", 10 ** 6, False))

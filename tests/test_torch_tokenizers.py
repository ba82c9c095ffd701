"""PyTorch port's tokenizers + tweet normalizer against the JAX package's:
identical ids, masks and token types on tweet-like strings with emoji, URLs,
@-mentions, hashtags and HTML, for the hashing tokenizer (the JAX one may run
its native C++ encoder) and for the vocabulary backends on the fixture
layouts of the JAX package's tokenizer tests: fastBPE and SentencePiece-BPE
(the JAX Python paths), and the layouts the JAX package reads through the
Rust ``tokenizers`` backend, held against that backend on this host: a BERT
``vocab.txt`` (``BertWordPieceTokenizer``), RoBERTa's ``vocab.json`` +
``merges.txt`` and ``tokenizer.json`` with WordPiece and with byte-level BPE
(vocabularies trained here as the JAX package's
``tests/test_rust_tokenizer_paths.py`` trains them), each also on a few
hundred seeded strings of tricky code points; an XLM-R-family directory
(Bernice's layout: ``sentencepiece.bpe.model`` and the converter's
``tokenizer.json`` with Precompiled, Metaspace and Unigram), read through the
``tokenizer.json`` as the JAX package's Rust path reads it; a ``vocab.txt``
without ``[CLS]`` or ``[SEP]``, which the JAX package's C++ WordPiece reads
(the port's library and its Python twin against the JAX library, built
privately here). Also: the probe order (BERTweet's fairseq ``vocab.txt`` is
not read as WordPiece); a ``tokenizer.json`` component the port does not read
(a warning and the next layout, or ``SystemExit``); and the port's own
ModelProto reader against the protobuf schema."""

import logging
import os
import re
import shutil
import sys

import numpy as np
import pytest

from socialmedia_textimage_classification_auxlosses_tpu.data import native as JN
from socialmedia_textimage_classification_auxlosses_tpu.data import tokenizers as JT
from socialmedia_textimage_classification_auxlosses_tpu_torch.data import native as TN
from socialmedia_textimage_classification_auxlosses_tpu_torch.data import tokenizers as TT

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_hf_components as HC  # noqa: E402

TWEETS = [
    "I love this!!!! 😍😍 https://t.co/abc123 @someone",
    "@user1 @user2 check out #NewMusic http://example.com/x?y=1",
    "can't wait for the weekend 🎉🎉🎉",
    "RT @news: Breaking — markets fall 3% at 9:30 a.m. EST",
    "&amp; then &lt;3 happened... sooo goooood",
    "Call me at 555-123-4567 or mail me@example.org",
    "😂😂😂 this is too much lol",
    "Ça va? ¿Qué tal? Привет мир 你好",
    "",
    "   leading and trailing spaces   ",
    "#throwback to 2019 ❤️ #summer #beach",
    "wow :) :-( <3 :P",
    "The quick brown fox jumps over the lazy dog " * 12,
    "she said \"no way\" and left -> bye",
    "@USER HTTPURL already normalized",
    "emoji with skin tone 👍🏽 and flags 🇺🇸",
    "www.example.com is up, and so is t.co/xyz",
    "don't won't shouldn't y'all",
    "numbers 1,000,000 and 3.14159 and -42",
    "mixed CASE Words AND MoRe",
]


@pytest.mark.parametrize("model_name", ["bernice", "bert"])
def test_hash_tokenizer_matches_jax(jax_native, model_name):
    vocab = 250002 if model_name == "bernice" else 30522
    jt = JT.build_tokenizer(model_name, None, 128, vocab)
    tt = TT.build_tokenizer(model_name, None, 128, vocab)
    je, te = jt(TWEETS), tt(TWEETS)
    assert set(je) == set(te)
    for key in je:
        np.testing.assert_array_equal(te[key], je[key], err_msg=key)
        assert te[key].dtype == np.int32


def test_normalized_text_matches_jax():
    from socialmedia_textimage_classification_auxlosses_tpu.data.normalize import (
        TweetNormalizer as JN,
    )
    from socialmedia_textimage_classification_auxlosses_tpu_torch.data.normalize import (
        TweetNormalizer as TN,
    )

    jn, tn = JN(), TN()
    assert [tn.normalize(s) for s in TWEETS] == [jn.normalize(s) for s in TWEETS]


SPM_PIECES = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)] + [
    (p, s, 1) for p, s in [
        ("▁", -10.0), ("h", -9.0), ("e", -8.0), ("l", -7.0), ("o", -6.0), ("▁h", -4.0),
        ("▁he", -2.0), ("ll", -5.0), ("llo", -3.0), ("▁hello", -1.0), ("w", -9.5),
        ("r", -9.4), ("d", -9.3), ("▁w", -4.5), ("▁wo", -3.5), ("▁wor", -3.2),
        ("▁worl", -3.1), ("▁world", -1.5), ("é", -8.5), ("ö", -8.6), ("\U0001f600", -0.5)]]

TEXTS = TWEETS + ["hello world", "hello hellox world", "x", "hel wo wrld", "héllo wörld",
                  "emoji \U0001f600 test", "  spaced   out  ", "hello " * 40,
                  "hello\u00a0world", "hello\tworld\x0bx"]


@pytest.fixture
def spm_dir(tmp_path):
    from transformers.utils import sentencepiece_model_pb2_new as pb2

    proto = pb2.ModelProto()
    for piece, score, typ in SPM_PIECES:
        p = proto.pieces.add()
        p.piece, p.score, p.type = piece, score, typ
    proto.trainer_spec.model_type = 2  # BPE: a field the reader must skip
    d = tmp_path / "bernice_model"
    d.mkdir()
    (d / "sentencepiece.bpe.model").write_bytes(proto.SerializeToString())
    return str(d)


@pytest.fixture
def bertweet_dir(tmp_path):
    d = tmp_path / "bertweet_model"
    d.mkdir()
    (d / "bpe.codes").write_text(
        "h e 100\nhe l 90\nhel lo</w> 80\nw o 70\nwo rld</w> 60\n")
    (d / "vocab.txt").write_text(
        "hello 50\nworld 40\nhel 30\nlo 20\nhe 10\nwo 9\nrld 8\nx 7\n")
    return str(d)


WP_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hello", "world", "the", "tw", "##ee", "##t",
            "@", "user", "#", "news", "!", ".", "love", "this", "check", "out", "cafe", "_", "a",
            "b"]
# where the JAX package's Rust BertWordPieceTokenizer and a lowercase + \w+ split differ:
# (text, the Rust ids at max_length 12, normalize=False; tokenizers 0.22.2)
WP_TABLE = [("hello\U0001f600 world", [2, 1, 5, 3]), ("caf\u00e9 news", [2, 20, 13, 3]),
            ("a_b", [2, 22, 21, 23, 3]), ("hello \u4e16\u754c", [2, 4, 1, 1, 3]),
            ("check\xadout", [2, 1, 3])]


@pytest.fixture
def wordpiece_dir(tmp_path):
    d = tmp_path / "bert_model"
    d.mkdir()
    (d / "vocab.txt").write_text("\n".join(WP_VOCAB) + "\n")
    return str(d)


# tricky code points for the seeded strings: emoji and a ZWJ sequence, skin tone and
# flag, NBSP, U+200B, U+FEFF, \x1c, soft hyphen, combining and precomposed accents,
# CJK, dotted I, final sigma, underscore, contractions, digits and numerals, the
# layouts' special tokens written out, control and private-use characters, scripts
# with marks, code points whose class changed between Unicode versions
FUZZ_ALPHABET = [
    "\U0001f600", "\U0001f469\u200d\U0001f4bb", "\U0001f44d\U0001f3fd", "\U0001f1fa\U0001f1f8",
    "\u200d", "\xa0", "\u200b", "\ufeff", "\x1c", "\xad", "\u0301", "e\u0301", "\u00e9",
    "\u4e16\u754c", "\U00020000", "\u0130", "\u0391\u03a3", "_", "'s", "'S", "'ll", "0", "42",
    "\u2460", "\u216b", "<s>", "</s>", "[CLS]", "[SEP]", "[MASK]", "<mask>", "<pad>", "[cls]",
    "\t", "\n", "\r", "\x0b", "\u2028", "\u3000", "\ue000", "\ufffd", "\x00", '"', "!", "#",
    "@", "\u2026", "\u2019", "\u20ac", "\u2211", "\uff21", "\u00df", "\u01c5", "\u24b6",
    "\U0001f170", "\u0645\u0631\u062d\u0628\u0627", "\u0e2a\u0e27\u0e31\u0e2a\u0e14\u0e35",
    "\u0928\u092e\u0938\u094d\u0924\u0947", "\ud55c\uad6d\uc5b4", "\u1734", "\u166d",
    "\u0890", "\u2e43", " ", "  ", "hello", "world", "tweet", "the", "caf\u00e9", "a", "b", "x",
    "HTTPURL", "@USER", "don't", "'", "-", ".", ","]
CORPUS = ["hello world this is a tweet", "another tweet about the world",
          "hello hello hello twitter world"] * 10


def fuzz_texts(seed, n=300):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        picks = rng.randint(0, len(FUZZ_ALPHABET), rng.randint(0, 25))
        out.append("".join(FUZZ_ALPHABET[i] + ("", " ", "  ")[rng.randint(0, 3)] for i in picks))
    return out


@pytest.fixture(scope="module")
def rust_layouts(tmp_path_factory):
    """Directories of the layouts the JAX package reads through the Rust
    backend, from vocabularies trained on ``CORPUS`` and seeded strings:
    ``bert_vocab_txt``, ``vocab_json_merges`` (RoBERTa), ``tokenizer_json``
    (the byte-level BPE with ``RobertaProcessing`` and ``<mask>`` added with
    ``lstrip``, as roberta-base's file) and ``tokenizer_json_wordpiece``."""
    from tokenizers import AddedToken, BertWordPieceTokenizer, ByteLevelBPETokenizer
    from tokenizers.processors import RobertaProcessing

    root = tmp_path_factory.mktemp("rust_layouts")
    corpus = CORPUS + fuzz_texts(1, 100)
    dirs = {name: root / name for name in ("bert_vocab_txt", "vocab_json_merges",
                                          "tokenizer_json", "tokenizer_json_wordpiece")}
    for d in dirs.values():
        d.mkdir()
    wp = BertWordPieceTokenizer(lowercase=True)
    wp.train_from_iterator(corpus, vocab_size=300, min_frequency=1,
                           special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    wp.save_model(str(dirs["bert_vocab_txt"]))
    wp.save(str(dirs["tokenizer_json_wordpiece"] / "tokenizer.json"))
    bpe = ByteLevelBPETokenizer()
    bpe.train_from_iterator(corpus, vocab_size=500, min_frequency=1,
                            special_tokens=["<s>", "<pad>", "</s>", "<unk>"])
    bpe.save_model(str(dirs["vocab_json_merges"]))
    bpe._tokenizer.post_processor = RobertaProcessing(("</s>", bpe.token_to_id("</s>")),
                                                      ("<s>", bpe.token_to_id("<s>")))
    bpe.add_special_tokens([AddedToken("<mask>", lstrip=True, normalized=True)])
    bpe.save(str(dirs["tokenizer_json"] / "tokenizer.json"))
    return {name: str(d) for name, d in dirs.items()}


LAYOUT_BACKENDS = {"bert_vocab_txt": ("bert", "BertWordPiece"),
                   "vocab_json_merges": ("roberta", "ByteLevelBPE"),
                   "tokenizer_json": ("roberta", "TokenizerJson"),
                   "tokenizer_json_wordpiece": ("bert", "TokenizerJson")}


def _same_encoding(name, model_dir, max_length, vocab, texts=TEXTS, normalize=True):
    jt = JT.build_tokenizer(name, model_dir, max_length, vocab, normalize=normalize)
    tt = TT.build_tokenizer(name, model_dir, max_length, vocab, normalize=normalize)
    je, te = jt(texts), tt(texts)
    assert set(je) == set(te)
    assert tt.pad_token_id == jt.pad_token_id
    for key in je:
        np.testing.assert_array_equal(te[key], je[key], err_msg=key)
    return tt, te


def test_sentencepiece_bpe_matches_jax(spm_dir, monkeypatch):
    from socialmedia_textimage_classification_auxlosses_tpu.data import bpe_backends as JB

    real = JB.SentencePieceBPE.__init__
    monkeypatch.setattr(JB.SentencePieceBPE, "__init__",  # the JAX Python path
                        lambda self, *a, **k: real(self, *a, **{**k, "use_native": False}))
    tt, _ = _same_encoding("bernice", spm_dir, 16, 300)
    assert type(tt.backend).__name__ == "SentencePieceBPE"


def test_fastbpe_matches_jax(bertweet_dir, monkeypatch):
    """BERTweet's layout goes to fastBPE, not WordPiece, though it holds a
    vocab.txt."""
    from socialmedia_textimage_classification_auxlosses_tpu.data import bpe_backends as JB

    real = JB.FastBPE.__init__
    monkeypatch.setattr(JB.FastBPE, "__init__",
                        lambda self, *a, **k: real(self, *a, **{**k, "use_native": False}))
    tt, _ = _same_encoding("bertweet", bertweet_dir, 16, 300)
    assert type(tt.backend).__name__ == "FastBPE"


def test_wordpiece_matches_jax(wordpiece_dir):
    """A BERT ``vocab.txt`` against the JAX package's Rust
    ``BertWordPieceTokenizer``: the tweets, normalized, and the texts on which
    a lowercase + ``\\w+`` split differs from it, raw."""
    tt, _ = _same_encoding("bert", wordpiece_dir, 24, 30522)
    assert type(tt.backend).__name__ == "BertWordPiece"
    assert "token_type_ids" in tt(["hello"])
    _, te = _same_encoding("bert", wordpiece_dir, 12, 30522,
                           texts=[t for t, _ in WP_TABLE], normalize=False)
    for row, (text, want) in zip(te["ids"], WP_TABLE):
        assert row[:len(want)].tolist() == want and not row[len(want):].any(), text


@pytest.mark.parametrize("layout", ["tokenizer_json", "vocab_json_merges",
                                    "tokenizer_json_wordpiece"])
def test_vocabulary_directory_matches_jax(rust_layouts, layout):
    """RoBERTa's two layouts and a BERT ``tokenizer.json`` give the JAX
    package's Rust ids, masks and token types, and its pad id."""
    name, backend = LAYOUT_BACKENDS[layout]
    tt, te = _same_encoding(name, rust_layouts[layout], 24, 50265)
    assert type(tt.backend).__name__ == backend
    assert ("token_type_ids" in te) == (name == "bert")
    if name == "roberta":
        assert tt.pad_token_id == 1 and te["ids"][0, 0] == 0


@pytest.mark.parametrize("layout", sorted(LAYOUT_BACKENDS))
def test_tricky_code_points_match_jax(rust_layouts, layout):
    """300 seeded strings of ``FUZZ_ALPHABET``, unnormalized, against the Rust
    backend; truncation at 16 tokens and empty strings among them."""
    name, backend = LAYOUT_BACKENDS[layout]
    tt, _ = _same_encoding(name, rust_layouts[layout], 16, 50265,
                           texts=fuzz_texts(7) + ["", "<s>", "[CLS] x"], normalize=False)
    assert type(tt.backend).__name__ == backend


def _unread_tokenizer_json(d):
    """A Unigram file with a ``UnicodeScripts`` pre-tokenizer, which the port
    does not read."""
    import json

    d.mkdir()
    (d / "tokenizer.json").write_text(json.dumps({
        "normalizer": None, "pre_tokenizer": {"type": "UnicodeScripts"},
        "post_processor": None, "added_tokens": [],
        "model": {"type": "Unigram", "vocab": [["<unk>", 0.0]], "unk_id": 0}}))


def test_unread_tokenizer_json_component_falls_through_or_exits(tmp_path, spm_dir, caplog):
    """A ``tokenizer.json`` the port does not read (a ``UnicodeScripts``
    pre-tokenizer) is named in a warning and the next layout is read; with no
    other layout the probe exits naming it."""
    _unread_tokenizer_json(tmp_path / "alone")
    with pytest.raises(SystemExit, match="pre_tokenizer UnicodeScripts"):
        TT.build_tokenizer("bernice", str(tmp_path / "alone"), 16, 300)
    _unread_tokenizer_json(tmp_path / "with_spm")
    shutil.copy(os.path.join(spm_dir, "sentencepiece.bpe.model"), tmp_path / "with_spm")
    with caplog.at_level(logging.WARNING):
        tok = TT.build_tokenizer("bernice", str(tmp_path / "with_spm"), 16, 300)
    assert type(tok.backend).__name__ == "SentencePieceBPE"
    assert any("pre_tokenizer UnicodeScripts" in r.message for r in caplog.records)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's ``data/native.py`` pointed at a tokenizer library
    built under a directory of this module's own, its loaded library and
    failure flag reset, so that no other test process's build of the shared
    ``csrc/libsmtc_tokenizer.so`` can be read half written (its
    ``NativeWordPiece`` would fall back to another encoder); restored on
    exit. Only the module's globals are patched."""
    d = str(tmp_path_factory.mktemp("jax_tokenizer"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JN, "_LIB_PATH", os.path.join(d, "libsmtc_tokenizer.so"))
        mp.setattr(JN, "_lib", None)
        mp.setattr(JN, "_build_failed", False)
        yield JN


@pytest.fixture
def jax_wordpiece(jax_native):
    if jax_native.get_lib() is None:
        pytest.skip("the JAX package's C++ WordPiece did not build here (no g++)")
    return jax_native


@pytest.mark.parametrize("layout,missing", [("vocab_json_merges", "<s>"),
                                            ("bert_vocab_txt", "[CLS]")])
def test_layout_without_its_template_token_exits(rust_layouts, jax_wordpiece, tmp_path, layout,
                                                 missing):
    """RoBERTa's vocabulary without ``<s>`` exits naming it (the JAX package
    hashes there); a BERT ``vocab.txt`` without ``[CLS]``, which the JAX
    package's Rust ``BertWordPieceTokenizer`` refuses, gives the ids of the
    JAX package's C++ WordPiece, which it reads instead."""
    import json

    d = tmp_path / layout
    shutil.copytree(rust_layouts[layout], d)
    if layout == "vocab_json_merges":
        vocab = json.loads((d / "vocab.json").read_text())
        del vocab[missing]
        (d / "vocab.json").write_text(json.dumps(vocab))
        with pytest.raises(SystemExit, match=re.escape(missing)):
            TT.build_tokenizer(LAYOUT_BACKENDS[layout][0], str(d), 16, 50265)
        return
    lines = (d / "vocab.txt").read_text().split("\n")
    (d / "vocab.txt").write_text("\n".join(t for t in lines if t != missing))
    tt, _ = _same_encoding("bert", str(d), 16, 50265, texts=fuzz_texts(7), normalize=False)
    assert type(tt.backend).__name__ == "NativeWordPiece"


# words for a C++ WordPiece vocabulary: non-ASCII pieces (matched byte for byte,
# never lowercased), a continuation of a multibyte character, punctuation
NATIVE_WP_VOCAB = ["hello", "world", "caf", "##\u00e9", "\u00c9cole", "tw", "##ee", "##t", "!",
                   "#", "@", "user", "\u4e16", "\U0001f600", "'", "s", "don", "t", "42", "a",
                   "##b", "[MASK]"]


@pytest.mark.parametrize("library", ["cpp", "python"])
@pytest.mark.parametrize("missing", ["[CLS]", "[SEP]", "[CLS] [SEP]"])
def test_vocab_without_template_tokens_reads_as_jax_native_wordpiece(
        jax_wordpiece, tmp_path, monkeypatch, library, missing):
    """The JAX package's C++ WordPiece ids through the port's library and
    through its Python twin: ASCII-only lowercasing, words at whitespace and
    ASCII punctuation, a word over 100 bytes ``[UNK]``, missing specials as
    ``[CLS]`` 101 / ``[SEP]`` 102, rows padded with ``[PAD]``'s id (5 here)
    while the pad id reported is 0, as in the JAX package."""
    specials = ["[UNK]", "[CLS]", "[SEP]", "x", "y", "[PAD]"]
    vocab = [t for t in specials if t not in missing.split()] + NATIVE_WP_VOCAB
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    if library == "cpp":
        if not TN.tokenizer_available():
            pytest.skip(f"the port's tokenizer library did not build: {TN.TOKENIZER.error}")
    else:
        monkeypatch.setattr(TN.TOKENIZER, "get", lambda: None)
    texts = fuzz_texts(8) + TWEETS + [
        "Hello WORLD caf\u00e9 CAF\u00c9 \u00c9cole \u00e9cole", "a" * 101, "ab" * 50,
        "hello\x1cworld\x85!!", "don't #tw@user \u4e16\u754c\U0001f600", ""]
    tt, te = _same_encoding("bert", str(tmp_path), 24, 30522, texts=texts, normalize=False)
    assert type(tt.backend).__name__ == "NativeWordPiece"
    assert (tt.backend._native is None) == (library == "python")
    assert tt.pad_token_id == 0 and (te["ids"][-1, 2:] == vocab.index("[PAD]")).all()


@pytest.fixture(scope="module")
def xlmr_dir(tmp_path_factory):
    words = sorted({w for t in TWEETS + CORPUS + HC.CORPUS for w in t.lower().split()})
    return HC.write_xlmr_dir(tmp_path_factory.mktemp("xlmr") / "bernice",
                             HC.xlmr_pieces(words, 6))


@pytest.mark.parametrize("normalize", [True, False])
def test_xlmr_directory_matches_jax(xlmr_dir, caplog, normalize):
    """Bernice's layout reads through its ``tokenizer.json``, as the JAX
    package's Rust path does, not the SentencePiece-BPE beside it: equal ids,
    masks and pad id (``<pad>``'s, 1) on tweets and seeded strings, and no
    warning."""
    with caplog.at_level(logging.WARNING):
        tt, te = _same_encoding("bernice", xlmr_dir, 24, 250002,
                                texts=TEXTS + fuzz_texts(9) + HC.TEXTS, normalize=normalize)
    assert type(tt.backend).__name__ == "TokenizerJson"
    assert tt.pad_token_id == 1 and "token_type_ids" not in te
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING]


def test_spm_reader_matches_the_protobuf_schema(spm_dir):
    from socialmedia_textimage_classification_auxlosses_tpu_torch.data.bpe_backends import (
        read_spm_pieces)

    got = read_spm_pieces(os.path.join(spm_dir, "sentencepiece.bpe.model"))
    assert [(p, t) for p, _, t in got] == [(p, t) for p, _, t in SPM_PIECES]
    np.testing.assert_array_equal(np.float32([s for _, s, _ in got]),
                                  np.float32([s for _, s, _ in SPM_PIECES]))


def test_directory_without_vocabulary_hashes_with_a_warning(tmp_path, caplog):
    import logging

    (tmp_path / "config.json").write_text("{}")
    with caplog.at_level(logging.WARNING):
        tok = TT.build_tokenizer("bernice", str(tmp_path), 8, 64)
    assert type(tok.backend).__name__ == "HashTokenizer"
    assert any("HASHING TOKENIZER" in r.message for r in caplog.records)

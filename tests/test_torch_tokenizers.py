"""PyTorch port's tokenizers + tweet normalizer against the JAX package's:
identical ids and masks on tweet-like strings with emoji, URLs, @-mentions,
hashtags and HTML, for the hashing tokenizer (the JAX one may run its native
C++ encoder) and for the vocabulary backends (WordPiece, fastBPE,
SentencePiece-BPE; the JAX Python paths) on the fixture layouts of the JAX
package's tokenizer tests; the probe order (BERTweet's fairseq ``vocab.txt``
is not read as WordPiece); the refusal of layouts only the Rust backend
reads; and the port's own ModelProto reader against the protobuf schema."""

import os

import numpy as np
import pytest

from socialmedia_textimage_classification_auxlosses_tpu.data import tokenizers as JT
from socialmedia_textimage_classification_auxlosses_tpu_torch.data import tokenizers as TT

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
def test_hash_tokenizer_matches_jax(model_name):
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


@pytest.mark.parametrize("files", [("tokenizer.json",), ("vocab.json", "merges.txt")],
                         ids=["tokenizer_json", "vocab_json_merges"])
def test_vocabulary_directory_is_refused(tmp_path, files):
    """A layout only the Rust ``tokenizers`` backend reads is refused, not
    hashed."""
    for name in files:
        (tmp_path / name).write_text("{}")
    with pytest.raises(SystemExit, match="Rust"):
        TT.build_tokenizer("roberta", str(tmp_path), 16, 50265)


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


@pytest.fixture
def wordpiece_dir(tmp_path):
    d = tmp_path / "bert_model"
    d.mkdir()
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hello", "world", "the", "tw", "##ee",
             "##t", "@", "user", "#", "news", "!", ".", "love", "this", "check", "out"]
    (d / "vocab.txt").write_text("\n".join(vocab) + "\n")
    return str(d)


def _same_encoding(name, model_dir, max_length, vocab):
    jt = JT.build_tokenizer(name, model_dir, max_length, vocab)
    tt = TT.build_tokenizer(name, model_dir, max_length, vocab)
    je, te = jt(TEXTS), tt(TEXTS)
    assert set(je) == set(te)
    for key in je:
        np.testing.assert_array_equal(te[key], je[key], err_msg=key)
    return tt


def test_sentencepiece_bpe_matches_jax(spm_dir, monkeypatch):
    from socialmedia_textimage_classification_auxlosses_tpu.data import bpe_backends as JB

    real = JB.SentencePieceBPE.__init__
    monkeypatch.setattr(JB.SentencePieceBPE, "__init__",  # the JAX Python path
                        lambda self, *a, **k: real(self, *a, **{**k, "use_native": False}))
    tt = _same_encoding("bernice", spm_dir, 16, 300)
    assert type(tt.backend).__name__ == "SentencePieceBPE"


def test_fastbpe_matches_jax(bertweet_dir, monkeypatch):
    """BERTweet's layout goes to fastBPE, not WordPiece, though it holds a
    vocab.txt."""
    from socialmedia_textimage_classification_auxlosses_tpu.data import bpe_backends as JB

    real = JB.FastBPE.__init__
    monkeypatch.setattr(JB.FastBPE, "__init__",
                        lambda self, *a, **k: real(self, *a, **{**k, "use_native": False}))
    tt = _same_encoding("bertweet", bertweet_dir, 16, 300)
    assert type(tt.backend).__name__ == "FastBPE"


def test_wordpiece_matches_jax(wordpiece_dir, monkeypatch):
    from socialmedia_textimage_classification_auxlosses_tpu.data import native as JN

    def no_native(*a, **k):
        raise RuntimeError("the Python WordPiece is the reference here")

    monkeypatch.setattr(JN, "NativeWordPiece", no_native)
    monkeypatch.setattr(JT, "_try_rust_backend", lambda *a: None)
    tt = _same_encoding("bert", wordpiece_dir, 24, 30522)
    assert type(tt.backend).__name__ == "PyWordPiece"
    assert "token_type_ids" in tt(["hello"])


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

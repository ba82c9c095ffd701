"""The port's native tokenizer encoders (``<port>/csrc/tokenizer.cpp`` through
``data/native.py``) and a RoBERTa run from its own vocabulary, on the CPU.

* The hashing tokenizer, SentencePiece-BPE and fastBPE: the ids and masks of
  the port's C++ library equal the port's Python path and the JAX package's
  native path, on the fixtures of the JAX package's ``tests/test_native_bpe.py``
  and ``tests/test_tokenizers.py``, with multibyte, emoji, truncation, empty
  and Unicode-whitespace edges. The library is built into
  ``build/tokenizer/`` at first use; the tests skip only where there is no
  ``g++``, and fail where it is present and the build fails.
* ``cli/run_txt.py --model_name roberta`` at ``--arch tiny`` from a directory
  of ``vocab.json`` + ``merges.txt`` (a byte-level BPE trained here): the
  backend is the byte-level BPE with ``<pad>``'s id 1, the pipelines' ids are
  the JAX runner's, and on the JAX runner's initial parameters (carried with
  ``models/from_jax.py``, dropout 0) the first step's loss equals the JAX
  runner's within 1e-5 relative. The same for ``--model_name bernice`` from
  an XLM-R-family directory (``sentencepiece.bpe.model`` and the converter's
  ``tokenizer.json``: Precompiled, Metaspace, Unigram), read through the
  ``tokenizer.json``.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

from socialmedia_textimage_classification_auxlosses_tpu.cli import run_txt as jax_run_txt
from socialmedia_textimage_classification_auxlosses_tpu.core import config as JC
from socialmedia_textimage_classification_auxlosses_tpu.data import bpe_backends as JB
from socialmedia_textimage_classification_auxlosses_tpu.data import tokenizers as JT
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_txt
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as C
from socialmedia_textimage_classification_auxlosses_tpu_torch.data import bpe_backends as TB
from socialmedia_textimage_classification_auxlosses_tpu_torch.data import native
from socialmedia_textimage_classification_auxlosses_tpu_torch.data import tokenizers as TT

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_hf_components as HC  # noqa: E402
from fixtures import make_task_fixture  # noqa: E402
from test_torch_from_jax import carry, to_numpy_tree  # noqa: E402

# the JAX package's tests/test_native_bpe.py texts, and tweet-like ones
TEXTS = ["hello world", "hello hellox world", "x", "", "hel wo wrld", "héllo wörld",
         "emoji \U0001f600 test", "  spaced   out  ", "hello " * 40, "hello world",
         "hello world　x", " hello world ", "hello\tworld\x0bx",
         "a\x1cb c\x85d", "tweet #1 @user https://t.co/x \U0001f469‍\U0001f4bb"]

SPM_PIECES = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)] + [
    (p, s, 1) for p, s in [
        ("▁", -10.0), ("h", -9.0), ("e", -8.0), ("l", -7.0), ("o", -6.0),
        ("▁h", -4.0), ("▁he", -2.0), ("ll", -5.0), ("llo", -3.0),
        ("▁hello", -1.0), ("w", -9.5), ("r", -9.4), ("d", -9.3), ("▁w", -4.5),
        ("▁wo", -3.5), ("▁wor", -3.2), ("▁worl", -3.1), ("▁world", -1.5),
        ("é", -8.5), ("ö", -8.6)]]


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the Python encoders run")
    assert native.tokenizer_available(), native.TOKENIZER.error
    assert os.path.dirname(native.TOKENIZER.path()).endswith(os.path.join("build", "tokenizer"))
    return native.TOKENIZER


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    from transformers.utils import sentencepiece_model_pb2_new as pb2

    root = tmp_path_factory.mktemp("native_layouts")
    proto = pb2.ModelProto()
    for piece, score, typ in SPM_PIECES:
        p = proto.pieces.add()
        p.piece, p.score, p.type = piece, score, typ
    (root / "sentencepiece.bpe.model").write_bytes(proto.SerializeToString())
    (root / "bpe.codes").write_text("h e 100\nhe l 90\nhel lo</w> 80\nw o 70\nwo rld</w> 60\n")
    (root / "vocab.txt").write_text("hello 50\nworld 40\nhel 30\nlo 20\nhe 10\nwo 9\nrld 8\nx 7\n")
    return str(root)


def _equal(*encodings):
    for got in encodings[1:]:
        np.testing.assert_array_equal(got[0], encodings[0][0])
        np.testing.assert_array_equal(got[1], encodings[0][1])


@pytest.mark.parametrize("max_length", [5, 10, 64])
def test_hash_native_matches_python_and_jax(lib, monkeypatch, max_length):
    tok = TT.HashTokenizer(vocab_size=1000, max_length=max_length, use_token_types=True)
    built = tok.encode_batch(TEXTS)
    want = JT.HashTokenizer(1000, max_length, True).encode_batch(TEXTS)
    monkeypatch.setattr(native, "hash_encode_batch", lambda *a: None)  # the Python path
    _equal(built, tok.encode_batch(TEXTS), want)
    assert built[2].shape == (len(TEXTS), max_length)


def test_spbpe_native_matches_python_and_jax(lib, layouts):
    path = os.path.join(layouts, "sentencepiece.bpe.model")
    built = TB.SentencePieceBPE(path, 16)
    assert built._native is not None
    jax_native = JB.SentencePieceBPE(path, 16, use_native=True)
    _equal(built.encode_batch(TEXTS), TB.SentencePieceBPE(path, 16, use_native=False)
           .encode_batch(TEXTS), jax_native.encode_batch(TEXTS))


def test_fastbpe_native_matches_python_and_jax(lib, layouts):
    vocab, codes = os.path.join(layouts, "vocab.txt"), os.path.join(layouts, "bpe.codes")
    built = TB.FastBPE(vocab, codes, 16)
    assert built._native is not None
    _equal(built.encode_batch(TEXTS), TB.FastBPE(vocab, codes, 16, use_native=False)
           .encode_batch(TEXTS), JB.FastBPE(vocab, codes, 16, use_native=True)
           .encode_batch(TEXTS))


# -- a RoBERTa run from vocab.json + merges.txt ------------------------------------------

ROBERTA = ["--model_name", "roberta", "--task", "3", "--epochs", "1", "--arch", "tiny",
           "--dtype", "float32", "--log_every", "1", "--dropout", "0", "--seed", "30"]


def _runs(root, csv_path, model, hub, argv):
    """``run_txt.main(argv)`` of the JAX package, then of the port on the JAX
    runner's initial parameters; each side's first-step loss, training ids
    and pad id (and the port's backend)."""
    jax_side, port_side = {}, {}
    real_jax, real_port = jax_run_txt.build_text_setup, run_txt.build_text_setup

    def jax_build(*a, **k):
        setup = real_jax(*a, **k)
        jax_side.update(params=to_numpy_tree(setup.params), ids=setup.pipes["train"].ids,
                        pad=setup.tokenizer.pad_token_id)
        step = setup.train_step

        def first(params, opt_state, batch, key):
            out = step(params, opt_state, batch, key)
            jax_side.setdefault("loss", float(out[2]["loss"]))
            return out

        setup.train_step = first
        return setup

    def port_build(*a, **k):
        setup = real_port(*a, **k)
        carry(jax_side["params"], setup.model)
        port_side.update(ids=setup.pipes["train"].ids, backend=setup.tokenizer.backend,
                         pad=setup.tokenizer.pad_token_id)
        return setup

    mp = pytest.MonkeyPatch()
    for mod, results in ((JC, "jax"), (C, "port")):
        mp.setitem(mod.PATH, 3, csv_path)
        mp.setitem(mod.MODEL_DIR_DICT, model, str(hub) + os.sep)
        mp.setattr(mod, "results_dir_txt", str(root / results) + os.sep)
    mp.setattr(jax_run_txt, "build_text_setup", jax_build)
    mp.setattr(run_txt, "build_text_setup", port_build)
    try:
        jax_run_txt.main(argv)
        losses = []
        run_txt.main(argv + ["--device", "cpu"],
                     on_step=lambda step, m: losses.append(float(m["loss"])))
    finally:
        mp.undo()
    port_side["loss"] = losses[0]
    return jax_side, port_side


@pytest.fixture(scope="module")
def roberta_runs(tmp_path_factory):
    from tokenizers import ByteLevelBPETokenizer

    root = tmp_path_factory.mktemp("roberta_run")
    csv_path, _, frame = make_task_fixture(root / "data", task=3, n=40)
    hub = root / "hub"
    hub.mkdir()
    bpe = ByteLevelBPETokenizer()
    bpe.train_from_iterator(list(frame["text"]) * 3 + ["café \U0001f600 news"],
                            vocab_size=400, min_frequency=1,
                            special_tokens=["<s>", "<pad>", "</s>", "<unk>"])
    bpe.save_model(str(hub))
    (hub / "config.json").write_text(json.dumps({"hidden_dropout_prob": 0.0,
                                                 "vocab_size": bpe.get_vocab_size()}))
    return _runs(root, csv_path, "roberta", hub, ROBERTA)


def test_roberta_run_from_its_vocabulary_matches_jax(roberta_runs):
    jax_side, port_side = roberta_runs
    assert type(port_side["backend"]).__name__ == "ByteLevelBPE"
    assert port_side["pad"] == jax_side["pad"] == 1
    np.testing.assert_array_equal(port_side["ids"], jax_side["ids"])
    assert (port_side["ids"] == 1).any()  # padding with <pad>'s id reached the model
    np.testing.assert_allclose(port_side["loss"], jax_side["loss"], rtol=1e-5)


@pytest.fixture(scope="module")
def bernice_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("bernice_run")
    csv_path, _, frame = make_task_fixture(root / "data", task=3, n=40)
    words = sorted({w for t in frame["text"] for w in str(t).lower().split()})
    pieces = HC.xlmr_pieces(words[::2], 7)  # half the words: unknowns and splits
    hub = root / "hub"
    HC.write_xlmr_dir(hub, pieces)
    (hub / "config.json").write_text(json.dumps({"hidden_dropout_prob": 0.0,
                                                 "vocab_size": len(pieces) + 2}))
    argv = [("bernice" if a == "roberta" else a) for a in ROBERTA]
    return _runs(root, csv_path, "bernice", hub, argv)


def test_bernice_run_from_its_tokenizer_json_matches_jax(bernice_runs):
    jax_side, port_side = bernice_runs
    assert type(port_side["backend"]).__name__ == "TokenizerJson"
    assert port_side["pad"] == jax_side["pad"] == 1
    np.testing.assert_array_equal(port_side["ids"], jax_side["ids"])
    assert (port_side["ids"] == 1).any() and (port_side["ids"] == 3).any()  # padding, <unk>
    np.testing.assert_allclose(port_side["loss"], jax_side["loss"], rtol=1e-5)

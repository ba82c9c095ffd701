"""Host-side tokenization into fixed-shape arrays.

Counterpart of the JAX package's ``data/tokenizers.py``. ``build_tokenizer``
probes a model directory in the JAX package's order:

  1. ``tokenizer.json``            -> the pipeline it describes
                                      (``data/hf_layouts.py::TokenizerJson``:
                                      XLM-R's Precompiled, Metaspace and
                                      Unigram among the components); one the
                                      port does not read (``UnicodeScripts``,
                                      a regex Python may read otherwise, a
                                      file the Rust library refuses) is named
                                      in a warning and the next layout is
                                      used, or, with none, ``SystemExit``
  2. ``sentencepiece.bpe.model``   -> SentencePiece-BPE (Bernice / XLM-R,
                                      ``data/bpe_backends.py``)
  3. ``bpe.codes`` + ``vocab.txt`` -> fastBPE (BERTweet); probed before plain
                                      ``vocab.txt``, which BERTweet's fairseq
                                      vocabulary would be misread as
  4. ``vocab.txt``                 -> BERT WordPiece, as the JAX package's Rust
                                      ``BertWordPieceTokenizer``
                                      (``hf_layouts.BertWordPiece``); one
                                      without ``[CLS]`` or ``[SEP]``, which
                                      that refuses, goes to the JAX package's
                                      C++ WordPiece (``native.NativeWordPiece``),
                                      as there; else
     ``vocab.json`` + ``merges.txt`` -> RoBERTa's byte-level BPE
                                      (``hf_layouts.ByteLevelBPE``)
  5. no vocabulary at all          -> the deterministic FNV-1a hashing
                                      tokenizer, with a loud warning, as in the
                                      JAX package (hermetic runs).

The hashing tokenizer, SentencePiece-BPE, fastBPE and the C++ WordPiece encode
in the port's C++ library (``csrc/tokenizer.cpp`` through ``data/native.py``)
when it builds, else in Python, with the same ids. RoBERTa's two files without
``<s>`` or ``</s>`` raise ``SystemExit``: the JAX package falls back to the
hashing tokenizer there, whose ids the pretrained model was not trained on.
Every backend emits the triple (ids, mask, token_type_ids or None) in its
family's special-token layout (BERT: ``[CLS] x [SEP]``; RoBERTa-likes:
``<s> x </s>`` and no token types).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..utils.logging import get_logger
from . import native
from .bpe_backends import try_fast_bpe, try_sp_bpe
from .hf_layouts import BertWordPiece, ByteLevelBPE, MissingToken, TokenizerJson, UnreadComponent
from .normalize import TweetNormalizer

logger = get_logger(__name__)


class BatchEncoding(dict):
    @property
    def ids(self):
        return self["ids"]


class HashTokenizer:
    """Offline tokenizer: whitespace tokens FNV-1a-hashed into the vocab
    range, ``[cls] tokens [sep]`` then padding with ``pad_id``; in the C++
    library when it builds."""

    def __init__(self, vocab_size: int, max_length: int, use_token_types: bool,
                 pad_id=0, unk_id=1, cls_id=2, sep_id=3):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.use_token_types = use_token_types
        self.pad_id, self.unk_id, self.cls_id, self.sep_id = pad_id, unk_id, cls_id, sep_id
        self.pad_token_id = pad_id

    def _token_id(self, token: str) -> int:
        return 4 + native.fnv1a(token) % (self.vocab_size - 4)

    def encode_batch(self, texts: List[str]):
        texts = [str(t) for t in texts]
        n, L = len(texts), self.max_length
        out = native.hash_encode_batch(texts, L, self.vocab_size, self.pad_id, self.cls_id,
                                       self.sep_id)
        if out is not None:
            return out[0], out[1], (np.zeros((n, L), np.int32) if self.use_token_types else None)
        ids = np.full((n, L), self.pad_id, np.int32)
        mask = np.zeros((n, L), np.int32)
        for i, text in enumerate(texts):
            toks = [self._token_id(t) for t in text.split()][: L - 2]
            row = [self.cls_id] + toks + [self.sep_id]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        tt = np.zeros((n, L), np.int32) if self.use_token_types else None
        return ids, mask, tt


class TweetTokenizerFrontend:
    """Tweet normalization + tokenization; ``normalize=True`` applies the
    BERTweet normalization."""

    def __init__(self, backend, normalize: bool = True):
        self.backend = backend
        self.normalizer = TweetNormalizer() if normalize else None
        self.max_length = backend.max_length
        self.pad_token_id = backend.pad_token_id
        self.use_token_types = backend.use_token_types

    def __call__(self, texts) -> BatchEncoding:
        texts = [str(t) for t in texts]
        if self.normalizer is not None:
            texts = [self.normalizer.normalize(t) for t in texts]
        ids, mask, tt = self.backend.encode_batch(texts)
        out = BatchEncoding(ids=ids, mask=mask)
        if tt is not None:
            out["token_type_ids"] = tt
        return out


def _try_rust_layouts(model_dir: str, max_length: int, use_tt: bool):
    """The JAX package's Rust-backend step: ``vocab.txt`` (the C++ WordPiece
    where it lacks ``[CLS]`` or ``[SEP]``), else ``vocab.json`` +
    ``merges.txt``."""
    vt = os.path.join(model_dir, "vocab.txt")
    if os.path.isfile(vt):
        try:
            return BertWordPiece(vt, max_length, use_tt)
        except MissingToken as e:
            logger.info("build_tokenizer: %s; the JAX package's C++ WordPiece reads it", e)
            return native.NativeWordPiece(vt, max_length, use_tt)
    vj, mg = os.path.join(model_dir, "vocab.json"), os.path.join(model_dir, "merges.txt")
    if os.path.isfile(vj) and os.path.isfile(mg):
        return ByteLevelBPE(vj, mg, max_length, use_tt)
    return None


def build_tokenizer(
    model_name: str,
    model_dir: Optional[str],
    max_length: int,
    vocab_size: int,
    normalize: bool = True,
    seed: Optional[int] = None,
) -> TweetTokenizerFrontend:
    """The directory's tokenizer (see the module's docstring); ``seed`` seeds
    a ``tokenizer.json`` BPE's dropout."""
    from ..models.text import NO_TOKEN_TYPES

    use_tt = model_name not in NO_TOKEN_TYPES
    backend = None
    if model_dir and os.path.isdir(model_dir):
        tj = os.path.join(model_dir, "tokenizer.json")
        unread = None
        try:
            if os.path.isfile(tj):
                try:
                    backend = TokenizerJson(tj, max_length, use_tt, seed)
                except UnreadComponent as e:
                    unread = e
            backend = (backend or try_sp_bpe(model_dir, max_length, use_tt)
                       or try_fast_bpe(model_dir, max_length, use_tt)
                       or _try_rust_layouts(model_dir, max_length, use_tt))
        except MissingToken as e:
            raise SystemExit(f"build_tokenizer({model_name}): {e}") from e
        if unread is not None:
            if backend is None:
                raise SystemExit(f"build_tokenizer({model_name}): {tj} holds {unread.component}, "
                                 "which the port does not read, and the directory holds no "
                                 "other tokenizer layout")
            logger.warning("build_tokenizer(%s): %s holds %s, which the port does not read; "
                           "using %s instead", model_name, tj, unread.component,
                           type(backend).__name__)
        if backend is None:
            logger.warning(
                "build_tokenizer(%s): model dir %r has no recognizable tokenizer layout "
                "(tokenizer.json / sentencepiece.bpe.model / bpe.codes+vocab.txt / vocab.txt / "
                "vocab.json+merges.txt) - FALLING BACK TO THE HASHING TOKENIZER. Token ids will "
                "NOT match the pretrained model's vocabulary.", model_name, model_dir)
    elif model_dir:
        logger.warning("build_tokenizer(%s): model dir %r not found - using the hashing "
                       "tokenizer (hermetic mode).", model_name, model_dir)
    if backend is None:
        backend = HashTokenizer(vocab_size, max_length, use_tt)
    else:
        logger.info("build_tokenizer(%s): backend %s", model_name, type(backend).__name__)
    return TweetTokenizerFrontend(backend, normalize=normalize)

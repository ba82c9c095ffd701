"""Host-side tokenization into fixed-shape arrays.

Counterpart of the JAX package's ``data/tokenizers.py``. ``build_tokenizer``
probes a model directory in the JAX package's order, minus the backends the
port does not have:

  1. ``sentencepiece.bpe.model``  -> SentencePiece-BPE (Bernice / XLM-R,
                                     ``data/bpe_backends.py``)
  2. ``bpe.codes`` + ``vocab.txt`` -> fastBPE (BERTweet); probed before plain
                                     ``vocab.txt``, which BERTweet's fairseq
                                     vocabulary would be misread as
  3. ``vocab.txt``                 -> WordPiece (``PyWordPiece``)
  4. ``tokenizer.json`` alone, or ``vocab.json`` + ``merges.txt``: only the
     Rust ``tokenizers`` backend reads these, and the port has none, so
     ``build_tokenizer`` raises ``SystemExit`` naming it. The JAX package
     swallows that backend's failure and hashes instead; a token stream other
     than the pretrained model's would be silent, so the port refuses.
  5. no vocabulary at all          -> the deterministic FNV-1a hashing
                                     tokenizer, with a loud warning, as in the
                                     JAX package (hermetic runs).

The JAX package's native C++ encoders (``csrc/tokenizer.cpp``) are not
ported; their ids equal the Python backends' (the JAX package's
``tests/test_native_bpe.py``). Every backend emits the triple (ids, mask,
token_type_ids or None) in its family's special-token layout (BERT:
``[CLS] x [SEP]``; RoBERTa-likes: ``<s> x </s>`` and no token types).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np

from ..utils.logging import get_logger
from .bpe_backends import try_fast_bpe, try_sp_bpe
from .native import fnv1a
from .normalize import TweetNormalizer

logger = get_logger(__name__)

# The layouts only the Rust ``tokenizers`` backend reads.
_RUST_ONLY = (("tokenizer.json",), ("vocab.json", "merges.txt"))


class BatchEncoding(dict):
    @property
    def ids(self):
        return self["ids"]


class HashTokenizer:
    """Offline tokenizer: whitespace tokens FNV-1a-hashed into the vocab
    range, ``[cls] tokens [sep]`` then padding with ``pad_id``."""

    def __init__(self, vocab_size: int, max_length: int, use_token_types: bool,
                 pad_id=0, unk_id=1, cls_id=2, sep_id=3):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.use_token_types = use_token_types
        self.pad_id, self.unk_id, self.cls_id, self.sep_id = pad_id, unk_id, cls_id, sep_id
        self.pad_token_id = pad_id

    def _token_id(self, token: str) -> int:
        return 4 + fnv1a(token) % (self.vocab_size - 4)

    def encode_batch(self, texts: List[str]):
        n, L = len(texts), self.max_length
        ids = np.full((n, L), self.pad_id, np.int32)
        mask = np.zeros((n, L), np.int32)
        for i, text in enumerate(texts):
            toks = [self._token_id(t) for t in str(text).split()][: L - 2]
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


class PyWordPiece:
    """Greedy WordPiece over a BERT-layout ``vocab.txt``: lowercased words
    and punctuation, longest ``##`` continuation first, ``[UNK]`` for a word
    that does not split."""

    def __init__(self, vocab_path: str, max_length: int, use_token_types: bool):
        with open(vocab_path) as f:
            self.vocab = {line.rstrip("\r\n"): i for i, line in enumerate(f)}
        self.max_length = max_length
        self.use_token_types = use_token_types
        self.unk = self.vocab.get("[UNK]", 100)
        self.cls = self.vocab.get("[CLS]", 101)
        self.sep = self.vocab.get("[SEP]", 102)
        self.pad_token_id = self.vocab.get("[PAD]", 0)

    def _word(self, word: str):
        if len(word) > 100:
            return [self.unk]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            pieces.append(cur)
            start = end
        return pieces

    def encode_batch(self, texts: List[str]):
        n, L = len(texts), self.max_length
        ids = np.full((n, L), self.pad_token_id, np.int32)
        mask = np.zeros((n, L), np.int32)
        for i, text in enumerate(texts):
            toks: List[int] = []
            for w in re.findall(r"\w+|[^\w\s]", str(text).lower()):
                toks.extend(self._word(w))
            row = [self.cls] + toks[:L - 2] + [self.sep]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        tt = np.zeros((n, L), np.int32) if self.use_token_types else None
        return ids, mask, tt


def _try_wordpiece(model_dir: str, max_length: int, use_tt: bool) -> Optional[PyWordPiece]:
    vt = os.path.join(model_dir, "vocab.txt")
    return PyWordPiece(vt, max_length, use_tt) if os.path.isfile(vt) else None


def build_tokenizer(
    model_name: str,
    model_dir: Optional[str],
    max_length: int,
    vocab_size: int,
    normalize: bool = True,
) -> TweetTokenizerFrontend:
    from ..models.text import NO_TOKEN_TYPES

    use_tt = model_name not in NO_TOKEN_TYPES
    backend = None
    if model_dir and os.path.isdir(model_dir):
        backend = (try_sp_bpe(model_dir, max_length, use_tt)
                   or try_fast_bpe(model_dir, max_length, use_tt)
                   or _try_wordpiece(model_dir, max_length, use_tt))
        if backend is None:
            for files in _RUST_ONLY:
                if all(os.path.isfile(os.path.join(model_dir, f)) for f in files):
                    raise SystemExit(
                        f"build_tokenizer({model_name}): {model_dir!r} holds "
                        f"{' + '.join(files)}, which only the Rust `tokenizers` backend "
                        "reads, and the PyTorch port has no such backend; add the "
                        "model's sentencepiece.bpe.model, bpe.codes + vocab.txt or "
                        "vocab.txt")
            logger.warning(
                "build_tokenizer(%s): model dir %r has no recognizable tokenizer layout "
                "(sentencepiece.bpe.model / bpe.codes+vocab.txt / vocab.txt) - FALLING "
                "BACK TO THE HASHING TOKENIZER. Token ids will NOT match the pretrained "
                "model's vocabulary.", model_name, model_dir)
    elif model_dir:
        logger.warning("build_tokenizer(%s): model dir %r not found - using the hashing "
                       "tokenizer (hermetic mode).", model_name, model_dir)
    if backend is None:
        backend = HashTokenizer(vocab_size, max_length, use_tt)
    else:
        logger.info("build_tokenizer(%s): backend %s", model_name, type(backend).__name__)
    return TweetTokenizerFrontend(backend, normalize=normalize)

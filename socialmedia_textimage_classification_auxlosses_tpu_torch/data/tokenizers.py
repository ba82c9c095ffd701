"""Host-side tokenization into fixed-shape arrays.

Counterpart of the JAX package's ``data/tokenizers.py``, hashing branch: with
no vocabulary files in the repository, ``build_tokenizer`` uses the
deterministic FNV-1a hashing tokenizer, as the JAX package does offline.
The vocabulary and BPE backends are not ported yet.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..utils.logging import get_logger
from .native import fnv1a
from .normalize import TweetNormalizer

logger = get_logger(__name__)

# The layouts the JAX package's vocabulary backends read.
_VOCAB_FILES = ("tokenizer.json", "sentencepiece.bpe.model", "bpe.codes",
                "vocab.txt", "vocab.json")


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


def build_tokenizer(
    model_name: str,
    model_dir: Optional[str],
    max_length: int,
    vocab_size: int,
    normalize: bool = True,
) -> TweetTokenizerFrontend:
    from ..models.text import NO_TOKEN_TYPES

    if model_dir and any(os.path.isfile(os.path.join(model_dir, f))
                         for f in _VOCAB_FILES):
        raise NotImplementedError(
            f"build_tokenizer({model_name}): {model_dir!r} holds a vocabulary, "
            "but only the hashing tokenizer is ported yet; its ids would not "
            "match the pretrained model's vocabulary")
    if model_dir:
        logger.warning("build_tokenizer(%s): no vocabulary in %r - using "
                       "the hashing tokenizer (hermetic mode).", model_name,
                       model_dir)
    backend = HashTokenizer(vocab_size, max_length, model_name not in NO_TOKEN_TYPES)
    return TweetTokenizerFrontend(backend, normalize=normalize)

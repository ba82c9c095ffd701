"""The FNV-1a hash of the hashing tokenizer.

Counterpart of ``fnv1a`` in the JAX package's ``data/native.py``. The port
takes the pure-Python path and loads no native library.
"""

from __future__ import annotations


def fnv1a(token: str) -> int:
    """32-bit FNV-1a over the token's UTF-8 bytes."""
    h = 2166136261
    for b in token.encode("utf-8"):
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h

"""The port's native host code: the tokenizer encoders and the image decoder.

Counterpart of the JAX package's ``data/native.py``. Each library is the
port's own copy of a C++ source under ``csrc/``, compiled at first use with
the host's C++ compiler into ``build/<name>/`` at the repository root
(``SMTC_TORCH_KERNEL_DIR``'s sibling ``<name>`` when that is set) and bound
with ``ctypes``. The file name carries a digest of the source and the flags.
When a build fails, ``get()`` is None, ``error`` holds the compiler's message,
and every caller keeps its Python path, as in the JAX package:

* ``csrc/tokenizer.cpp`` (``-O3 -shared -fPIC -std=c++17``): the FNV-1a hashing
  tokenizer, SentencePiece-BPE's merge loop, fastBPE and the JAX package's
  greedy WordPiece, with the ids of the Python encoders
  (``data/tokenizers.py::HashTokenizer``, ``data/bpe_backends.py``,
  ``NativeWordPiece``'s twin here);
* ``csrc/imgdec.cpp`` (``-O3 -march=native ... -ljpeg -lpng``): JPEG (libjpeg,
  DCT-scaled on downscale, so a large photo never decodes at full size) and
  PNG (libpng), then PIL's triangle resize, in one call. Built with
  ``-march=native``, its file name also carries the host CPU's tag: a library
  built on another CPU is a cache miss, never a load.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.logging import get_logger

logger = get_logger(__name__)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENIZER_SOURCE = os.path.join(_PKG, "csrc", "tokenizer.cpp")
TOKENIZER_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
IMGDEC_SOURCE = os.path.join(_PKG, "csrc", "imgdec.cpp")
IMGDEC_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
IMGDEC_LIBS = ("-ljpeg", "-lpng")


def fnv1a(token: str) -> int:
    """32-bit FNV-1a over the token's UTF-8 bytes."""
    h = 2166136261
    for b in token.encode("utf-8"):
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


def host_cpu_tag() -> str:
    """The machine name and a digest of the CPU's feature flags: a library
    built with ``-march=native`` is only valid on a CPU with the same ISA."""
    feats = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feats = line
                    break
    except OSError:
        pass
    return f"{platform.machine()}-{hashlib.sha1(feats.encode()).hexdigest()[:8]}"


class NativeLibrary:
    """A C++ source built with ``g++`` at the first ``get()`` and loaded with
    ``ctypes``; ``bind`` declares the functions' types. The outcome is logged
    once; ``error`` holds the compiler's (or the loader's) message when it
    failed, ``build_seconds`` the compile time when this process built it."""

    def __init__(self, name: str, source: str, flags: Sequence[str], libs: Sequence[str] = (),
                 cpu_tag: bool = False, bind: Optional[Callable[[ctypes.CDLL], None]] = None):
        self.name, self.source, self.flags, self.libs = name, source, tuple(flags), tuple(libs)
        self.cpu_tag, self.bind = cpu_tag, bind
        self.error: Optional[str] = None
        self.build_seconds: Optional[float] = None
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def path(self) -> str:
        """Where the library is (or will be) built."""
        kernels = os.environ.get("SMTC_TORCH_KERNEL_DIR")
        root = (os.path.join(os.path.dirname(kernels.rstrip(os.sep)), self.name) if kernels
                else os.path.join(os.path.dirname(_PKG), "build", self.name))
        h = hashlib.sha256(" ".join(self.flags + self.libs).encode())
        with open(self.source, "rb") as f:
            h.update(f.read())
        tag = f".{host_cpu_tag()}" if self.cpu_tag else ""
        return os.path.join(root, f"libsmtc_{self.name}-{h.hexdigest()[:16]}{tag}.so")

    def _build(self, out: str) -> Optional[str]:
        """Compile into ``out``; returns the error text, or None."""
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = ["g++", *self.flags, self.source, "-o", tmp, *self.libs]
        t0 = time.monotonic()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            return repr(e)
        if proc.returncode != 0:
            return (proc.stderr or proc.stdout or f"g++ exited {proc.returncode}").strip()
        os.replace(tmp, out)
        self.build_seconds = time.monotonic() - t0
        return None

    def get(self) -> Optional[ctypes.CDLL]:
        """The loaded library, built at the first call; None when it does not
        build or load (the reason in ``error``)."""
        with self._lock:
            if self._lib is not None or self.error is not None:
                return self._lib
            path = self.path()
            if not os.path.isfile(path):
                self.error = self._build(path)
            if self.error is None:
                try:
                    lib = ctypes.CDLL(path)
                    if self.bind is not None:
                        self.bind(lib)
                    self._lib = lib
                except (OSError, AttributeError) as e:
                    self.error = repr(e)
            if self._lib is not None:
                logger.info("native %s: %s", self.name, path)
            else:
                logger.warning("native %s: unavailable (%s); the Python path runs", self.name,
                               self.error.splitlines()[-1] if self.error else "")
            return self._lib


def _bind_tokenizer(lib: ctypes.CDLL) -> None:
    i32, i64, i32p, i64p = ctypes.c_int32, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), \
        ctypes.POINTER(ctypes.c_int64)
    lib.hash_encode_batch.restype = None
    lib.hash_encode_batch.argtypes = [ctypes.c_char_p, i64p, i64, i32, i32, i32, i32, i32,
                                      i32p, i32p]
    lib.spbpe_load.restype = ctypes.c_void_p
    lib.spbpe_load.argtypes = [ctypes.c_char_p, i64p, ctypes.POINTER(ctypes.c_float),
                               ctypes.POINTER(ctypes.c_uint8), i64]
    lib.spbpe_free.restype = None
    lib.spbpe_free.argtypes = [ctypes.c_void_p]
    lib.fastbpe_load.restype = ctypes.c_void_p
    lib.fastbpe_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.fastbpe_free.restype = None
    lib.fastbpe_free.argtypes = [ctypes.c_void_p]
    for fn in (lib.spbpe_encode_batch, lib.fastbpe_encode_batch):
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, i64p, i64, i32, i32p, i32p]
    lib.wp_load.restype = ctypes.c_void_p
    lib.wp_load.argtypes = [ctypes.c_char_p]
    lib.wp_free.restype = None
    lib.wp_free.argtypes = [ctypes.c_void_p]
    lib.wp_encode_batch.restype = None
    lib.wp_encode_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p, i64p, i64, i32, i32p, i32p,
                                    i32p]


def _bind_imgdec(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.smtc_decode_resize.restype = ctypes.c_int
    lib.smtc_decode_resize.argtypes = [ctypes.c_char_p, ctypes.c_int, u8p]
    lib.smtc_decode_full.restype = ctypes.c_int
    lib.smtc_decode_full.argtypes = [ctypes.c_char_p, u8p, ctypes.c_long,
                                     ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.smtc_decode_resize_mem.restype = ctypes.c_int
    lib.smtc_decode_resize_mem.argtypes = [u8p, ctypes.c_long, ctypes.c_int, u8p]


TOKENIZER = NativeLibrary("tokenizer", TOKENIZER_SOURCE, TOKENIZER_FLAGS, bind=_bind_tokenizer)
IMGDEC = NativeLibrary("imgdec", IMGDEC_SOURCE, IMGDEC_FLAGS, IMGDEC_LIBS, cpu_tag=True,
                       bind=_bind_imgdec)


# -- the tokenizer encoders -----------------------------------------------------


def tokenizer_available() -> bool:
    return TOKENIZER.get() is not None


def _pack(texts: List[str]) -> Tuple[bytes, np.ndarray]:
    """The texts' UTF-8 bytes back to back, and the n + 1 offsets that delimit them."""
    enc = [t.encode("utf-8") for t in texts]
    offsets = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(b) for b in enc], out=offsets[1:])
    return b"".join(enc), offsets


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def hash_encode_batch(texts: List[str], max_len: int, vocab_size: int, pad_id: int,
                      cls_id: int, sep_id: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The hashing tokenizer's (ids, mask) in C++; None without the library."""
    lib = TOKENIZER.get()
    if lib is None:
        return None
    buf, offsets = _pack(texts)
    ids = np.empty((len(texts), max_len), np.int32)
    mask = np.empty((len(texts), max_len), np.int32)
    lib.hash_encode_batch(buf, _ptr(offsets, ctypes.c_int64), len(texts), max_len, vocab_size,
                          pad_id, cls_id, sep_id, _ptr(ids, ctypes.c_int32),
                          _ptr(mask, ctypes.c_int32))
    return ids, mask


class _Encoder:
    """A handle on an encoder built inside the library, freed with the object."""

    _free = ""

    def __init__(self, lib: ctypes.CDLL, handle):
        if not handle:
            raise RuntimeError(f"{type(self).__name__}: the library refused the vocabulary")
        self._lib, self._handle = lib, handle

    def _encode(self, fn, texts: List[str], max_length: int):
        buf, offsets = _pack(texts)
        ids = np.empty((len(texts), max_length), np.int32)
        mask = np.empty((len(texts), max_length), np.int32)
        fn(self._handle, buf, _ptr(offsets, ctypes.c_int64), len(texts), max_length,
           _ptr(ids, ctypes.c_int32), _ptr(mask, ctypes.c_int32))
        return ids, mask

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            getattr(self._lib, self._free)(handle)


class NativeSpBpe(_Encoder):
    """SentencePiece-BPE's merge loop in C++. The ModelProto is read by
    ``data/bpe_backends.py``; the texts given to ``encode_batch`` are already
    normalized, with the ``▁`` word markers."""

    _free = "spbpe_free"

    def __init__(self, lib: ctypes.CDLL, pieces: List[str], scores, is_normal):
        buf, offsets = _pack(pieces)
        scores = np.ascontiguousarray(scores, np.float32)
        is_normal = np.ascontiguousarray(is_normal, np.uint8)
        super().__init__(lib, lib.spbpe_load(buf, _ptr(offsets, ctypes.c_int64),
                                             _ptr(scores, ctypes.c_float),
                                             _ptr(is_normal, ctypes.c_uint8), len(pieces)))

    def encode_batch(self, marked_texts: List[str], max_length: int):
        return self._encode(self._lib.spbpe_encode_batch, marked_texts, max_length)


class NativeFastBpe(_Encoder):
    """fastBPE in C++ over BERTweet's fairseq ``vocab.txt`` and ``bpe.codes``."""

    _free = "fastbpe_free"

    def __init__(self, lib: ctypes.CDLL, vocab_path: str, codes_path: str):
        super().__init__(lib, lib.fastbpe_load(os.fsencode(vocab_path), os.fsencode(codes_path)))

    def encode_batch(self, texts: List[str], max_length: int):
        return self._encode(self._lib.fastbpe_encode_batch, texts, max_length)


class _WordPieceHandle(_Encoder):
    _free = "wp_free"

    def __init__(self, lib: ctypes.CDLL, vocab_path: str):
        super().__init__(lib, lib.wp_load(os.fsencode(vocab_path)))

    def encode(self, texts: List[str], max_length: int):
        buf, offsets = _pack(texts)
        ids = np.empty((len(texts), max_length), np.int32)
        mask = np.empty((len(texts), max_length), np.int32)
        self._lib.wp_encode_batch(self._handle, buf, _ptr(offsets, ctypes.c_int64), len(texts),
                                  max_length, _ptr(ids, ctypes.c_int32),
                                  _ptr(mask, ctypes.c_int32), None)
        return ids, mask


# csrc/tokenizer.cpp ws_len: ASCII whitespace with \x1c-\x1f, and U+0085, U+00A0,
# U+1680, U+2000-U+200A, U+2028, U+2029, U+202F, U+205F, U+3000
_WP_SPACE = frozenset(" \t\n\x0b\x0c\r\x1c\x1d\x1e\x1f\x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
                      + "".join(map(chr, range(0x2000, 0x200B))))
_ASCII_PUNCT = frozenset(b"!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")


class WordPieceTwin:
    """The C++ ``wp_*`` in Python, on bytes as it runs: ``vocab.txt`` lines
    split at ``\\n``, one ``\\r`` dropped, the first of equal lines kept; text
    split at ``_WP_SPACE`` and at each ASCII punctuation byte, ASCII
    lowercased; a word over 100 bytes, or one that does not split, is
    ``[UNK]``; ``[CLS]`` words ``[SEP]``, the words cut to ``max_length`` - 2."""

    def __init__(self, vocab_path: str):
        with open(vocab_path, "rb") as f:
            lines = f.read().split(b"\n")
        if lines and lines[-1] == b"":
            lines.pop()
        self.vocab: Dict[bytes, int] = {}
        for i, line in enumerate(lines):
            self.vocab.setdefault(line[:-1] if line.endswith(b"\r") else line, i)
        self.unk, self.cls, self.sep, self.pad = (self.vocab.get(t, d) for t, d in (
            (b"[UNK]", 100), (b"[CLS]", 101), (b"[SEP]", 102), (b"[PAD]", 0)))

    def _word(self, word: bytes) -> List[int]:
        if len(word) > 100:
            return [self.unk]
        pieces, start = [], 0
        while start < len(word):
            for end in range(len(word), start, -1):
                tid = self.vocab.get(word[start:end] if start == 0 else b"##" + word[start:end])
                if tid is not None:
                    pieces.append(tid)
                    start = end
                    break
            else:
                return [self.unk]
        return pieces

    def words(self, text: str) -> List[bytes]:
        out, word = [], bytearray()
        for c in text:
            if c in _WP_SPACE or (ord(c) < 128 and ord(c) in _ASCII_PUNCT):
                if word:
                    out.append(bytes(word))
                    word.clear()
                if c not in _WP_SPACE:
                    out.append(c.encode())
            else:
                word += c.lower().encode() if c.isascii() else c.encode("utf-8")
        if word:
            out.append(bytes(word))
        return out

    def encode(self, texts: List[str], max_length: int):
        ids = np.full((len(texts), max_length), self.pad, np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, text in enumerate(texts):
            toks = [t for w in self.words(text) for t in self._word(w)]
            row = [self.cls] + toks[:max_length - 2] + [self.sep]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return ids, mask


class NativeWordPiece:
    """The JAX package's C++ WordPiece over a ``vocab.txt`` (its
    ``data/native.py::NativeWordPiece``), which it reaches where its Rust
    ``BertWordPieceTokenizer`` refuses the file (no ``[CLS]`` or ``[SEP]``):
    the port's library when it builds (and ``use_native``), else
    ``WordPieceTwin``, with the same ids. As in the JAX package the rows are
    padded with ``[PAD]``'s id (0 without one) while ``pad_token_id`` is 0."""

    def __init__(self, vocab_path: str, max_length: int, use_token_types: bool,
                 use_native: bool = True):
        self.max_length = max_length
        self.use_token_types = use_token_types
        self.pad_token_id = 0
        lib = TOKENIZER.get() if use_native else None
        self._native = _WordPieceHandle(lib, vocab_path) if lib is not None else None
        self._python = WordPieceTwin(vocab_path) if self._native is None else None

    def encode_batch(self, texts: Sequence[str]):
        texts = [str(t) for t in texts]
        ids, mask = (self._native or self._python).encode(texts, self.max_length)
        return ids, mask, (np.zeros_like(ids) if self.use_token_types else None)


# -- the image decoder --------------------------------------------------------------


def imgdec_library_path() -> str:
    """Where the decoder's library is (or will be) built."""
    return IMGDEC.path()


def get_imgdec_lib() -> Optional[ctypes.CDLL]:
    """The decoder's library, built at the first call; None when it does
    not build or load (the reason in ``build_error()``)."""
    return IMGDEC.get()


def imgdec_available() -> bool:
    return get_imgdec_lib() is not None


def build_error() -> Optional[str]:
    """The compiler's (or the loader's) message when the decoder did not
    build; None when it built or was not asked for yet."""
    return IMGDEC.error


def native_decode_resize(path: str, size: int) -> Optional[np.ndarray]:
    """Decode a JPEG or PNG file (told apart by its signature) and resize it
    to (size, size, 3) uint8. None on any failure: the caller decodes with
    PIL instead."""
    lib = get_imgdec_lib()
    if lib is None:
        return None
    out = np.empty((size, size, 3), np.uint8)
    rc = lib.smtc_decode_resize(os.fsencode(path), size,
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if rc == 0 else None


def native_decode_resize_mem(data: bytes, size: int) -> Optional[np.ndarray]:
    """``native_decode_resize`` of encoded bytes in memory (a request's
    ``image_b64``). None on any failure."""
    lib = get_imgdec_lib()
    if lib is None or not data:
        return None
    out = np.empty((size, size, 3), np.uint8)
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    rc = lib.smtc_decode_resize_mem(ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)),
                                    ctypes.c_long(len(data)), size,
                                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if rc == 0 else None


def native_decode_full(path: str, max_pixels: int = 64 << 20) -> Optional[np.ndarray]:
    """Full-size decode to (h, w, 3) uint8. None on any failure."""
    lib = get_imgdec_lib()
    if lib is None:
        return None
    cap = max_pixels * 3
    buf = np.empty(cap, np.uint8)
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.smtc_decode_full(os.fsencode(path),
                              buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
                              ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return buf[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()

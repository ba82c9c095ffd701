"""The FNV-1a hash of the hashing tokenizer, and the native image decoder.

Counterpart of ``fnv1a`` and of the image-decoder bindings in the JAX
package's ``data/native.py``. The tokenizer takes the pure-Python path and
loads no native library.

The image decoder is the port's own copy of the C++ source,
``csrc/imgdec.cpp``: JPEG (libjpeg, DCT-scaled on downscale, so a large
photo never decodes at full size) and PNG (libpng), then PIL's triangle
resize, in one call. It is compiled at first use with the host's C++
compiler (``-O3 -march=native ... -ljpeg -lpng``) into ``build/imgdec/`` at
the repository root (``SMTC_TORCH_KERNEL_DIR``'s sibling ``imgdec`` when that
is set). The file name carries a digest of the source and the flags, and the
host CPU's tag: a library built with ``-march=native`` on another CPU is a
cache miss, never a load. When the build fails (no compiler, no libjpeg or
libpng headers) the decoder is unavailable, ``build_error()`` holds the
compiler's message, and every caller keeps the PIL path, as in the JAX
package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional

import numpy as np

from ..utils.logging import get_logger

logger = get_logger(__name__)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMGDEC_SOURCE = os.path.join(_PKG, "csrc", "imgdec.cpp")
IMGDEC_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
IMGDEC_LIBS = ("-ljpeg", "-lpng")

_imgdec_lock = threading.Lock()
_imgdec_lib = None
_imgdec_error: Optional[str] = None


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


def imgdec_library_path() -> str:
    """Where the decoder's library is (or will be) built."""
    kernels = os.environ.get("SMTC_TORCH_KERNEL_DIR")
    root = (os.path.join(os.path.dirname(kernels.rstrip(os.sep)), "imgdec") if kernels
            else os.path.join(os.path.dirname(_PKG), "build", "imgdec"))
    h = hashlib.sha256(" ".join(IMGDEC_FLAGS + IMGDEC_LIBS).encode())
    with open(IMGDEC_SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(root, f"libsmtc_imgdec-{h.hexdigest()[:16]}.{host_cpu_tag()}.so")


def _build_imgdec(out: str) -> Optional[str]:
    """Compile the decoder into ``out``; returns the error text, or None."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *IMGDEC_FLAGS, IMGDEC_SOURCE, "-o", tmp, *IMGDEC_LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return repr(e)
    if proc.returncode != 0:
        return (proc.stderr or proc.stdout or f"g++ exited {proc.returncode}").strip()
    os.replace(tmp, out)
    return None


def get_imgdec_lib() -> Optional[ctypes.CDLL]:
    """The decoder's library, built at the first call; None when it does
    not build or load (the reason in ``build_error()``)."""
    global _imgdec_lib, _imgdec_error
    with _imgdec_lock:
        if _imgdec_lib is not None or _imgdec_error is not None:
            return _imgdec_lib
        path = imgdec_library_path()
        if not os.path.isfile(path):
            _imgdec_error = _build_imgdec(path)
            if _imgdec_error is not None:
                logger.info("native imgdec build failed (%s); using the PIL path",
                            _imgdec_error.splitlines()[-1] if _imgdec_error else "")
                return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            _imgdec_error = repr(e)
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.smtc_decode_resize.restype = ctypes.c_int
        lib.smtc_decode_resize.argtypes = [ctypes.c_char_p, ctypes.c_int, u8p]
        lib.smtc_decode_full.restype = ctypes.c_int
        lib.smtc_decode_full.argtypes = [ctypes.c_char_p, u8p, ctypes.c_long,
                                         ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_int)]
        lib.smtc_decode_resize_mem.restype = ctypes.c_int
        lib.smtc_decode_resize_mem.argtypes = [u8p, ctypes.c_long, ctypes.c_int, u8p]
        _imgdec_lib = lib
        return lib


def imgdec_available() -> bool:
    return get_imgdec_lib() is not None


def build_error() -> Optional[str]:
    """The compiler's (or the loader's) message when the decoder did not
    build; None when it built or was not asked for yet."""
    return _imgdec_error


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

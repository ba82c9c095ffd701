"""The flax msgpack format, read and written without msgpack or flax.

The JAX package writes its final artifacts (``...net.pth``) and Hugging Face
writes ``flax_model.msgpack`` with ``flax.serialization.to_bytes``: a
msgpack document of nested string-keyed maps whose leaves are

* ext type 1, an ndarray: the msgpack array ``[shape, dtype name, raw
  C-order bytes]`` packed into the ext payload;
* ext type 3, a numpy scalar, packed as a 0-d ndarray;
* ext type 2, a Python complex (refused here: no parameter tree holds one);
* plain msgpack values (nil, bool, int, float, str, bin, array, map);
* arrays larger than ``MAX_CHUNK_SIZE`` bytes, which flax splits into a map
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ..}, "chunks": {"0":
  flat chunk, ..}}`` of flat chunks.

``msgpack_restore`` reads such a document into nested dicts whose array
leaves are torch tensors on the CPU (bfloat16 through
``torch.frombuffer``: numpy has no bfloat16). A bytes-like input that is
writable (a ``bytearray``, as ``read_file`` gives) is shared, not copied,
by the tensors. ``msgpack_serialize`` is the inverse, for trees of torch
tensors or numpy arrays; its bytes are those ``flax.serialization.to_bytes``
writes for the same tree.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Mapping

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin 8/16/32: the length's format
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

# numpy dtype names (as flax writes them) <-> torch dtypes
_DTYPES = {
    "float64": torch.float64, "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int64": torch.int64, "int32": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


class _Reader:
    """One msgpack document over a buffer; ``value()`` decodes the next
    object."""

    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack document ends inside an object")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in _BIN:
            return bytes(self.take(self.unpack(_BIN[b])))
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}  # ext 8/16/32
        if b in ext:
            n = self.unpack(ext[b])
            return self.ext(self.unpack(">b"), n)
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return str(self.take(self.unpack(strs[b])), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: byte 0x{b:02x} at offset {self.pos - 1} starts no object")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, code: int, n: int):
        """An ndarray or numpy scalar: the payload is the array ``[shape,
        dtype name, bin]``, its bytes read in place."""
        inner = _Reader(self.take(n))
        if code == EXT_COMPLEX:
            raise ValueError("msgpack: a complex number (flax ext type 2) is no parameter; "
                             "the reader does not take it")
        if code not in (EXT_NDARRAY, EXT_NPSCALAR) or inner.unpack(">B") != 0x93:
            raise ValueError(f"msgpack: ext type {code} is not an array flax writes")
        shape, name = inner.value(), inner.value()
        kind = inner.unpack(">B")
        if kind not in _BIN:
            raise ValueError("msgpack: an array's data is not a bin object")
        raw = inner.take(inner.unpack(_BIN[kind]))
        tensor = _tensor(list(shape), name if isinstance(name, str) else str(name, "ascii"), raw)
        return tensor.reshape(()) if code == EXT_NPSCALAR else tensor


def _tensor(shape, name: str, raw: memoryview) -> torch.Tensor:
    if name not in _DTYPES:
        raise ValueError(f"msgpack: an array of dtype {name!r}, which the reader does not take")
    dtype = _DTYPES[name]
    count = int(np.prod(shape)) if shape else 1
    itemsize = torch.empty((), dtype=dtype).element_size()
    if len(raw) != count * itemsize:
        raise ValueError(f"msgpack: an array of shape {shape} {name} holds {len(raw)} bytes")
    if count == 0:
        return torch.empty(shape, dtype=dtype)
    address = np.frombuffer(raw, np.uint8).__array_interface__["data"][0]
    if raw.readonly or address % itemsize:
        # frombuffer needs a writable buffer, and the kernels aligned elements
        raw = memoryview(bytearray(raw))
    return torch.frombuffer(raw, dtype=dtype, count=count).reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data) -> Any:
    """``flax.serialization.msgpack_restore``: the tree of ``data`` (bytes,
    a bytearray or a memoryview), array leaves as CPU torch tensors."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes after the document")
    return _unchunk(tree)


def read_file(path: str) -> Any:
    """``msgpack_restore`` of a file, read into one bytearray that the
    tensors then share."""
    with open(path, "rb") as f:
        data = bytearray(os.fstat(f.fileno()).st_size)
        if f.readinto(data) != len(data):
            raise ValueError(f"{path}: the file changed while it was read")
    return msgpack_restore(data)


def is_msgpack_tree(head: bytes) -> bool:
    """Whether a file that starts with ``head`` is a msgpack map of at least
    one entry (a flax tree), told apart from a torch file (a zip archive,
    ``PK``, or a pickle, ``0x80`` then the protocol) by its first byte."""
    return bool(head) and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


# -- the encoder ---------------------------------------------------------------


def _head(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, else 8/16/32-bit
    (``codes``: the three type bytes, the first None where the form has
    no 8-bit header)."""
    if n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                out += struct.pack(">B" + fmt[1], code, v)
                return
        raise OverflowError(v)
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if v >= low:
                out += struct.pack(">B" + fmt[1], code, v)
                return
        raise OverflowError(v)


def _pack_bin(out: bytearray, raw) -> None:
    n = len(raw)
    out += (struct.pack(">BB", 0xC4, n) if n < 1 << 8 else
            struct.pack(">BH", 0xC5, n) if n < 1 << 16 else struct.pack(">BI", 0xC6, n))
    out += raw


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out += struct.pack(">Bb", fixed[n], code)
    elif n < 1 << 8:
        out += struct.pack(">BBb", 0xC7, n, code)
    elif n < 1 << 16:
        out += struct.pack(">BHb", 0xC8, n, code)
    else:
        out += struct.pack(">BIb", 0xC9, n, code)
    out += payload


def _array_bytes(t: torch.Tensor):
    """(shape, dtype name, raw bytes) of a tensor or array, C order."""
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(t))
    t = t.detach().to("cpu").contiguous()
    if t.dtype not in _NAMES:
        raise ValueError(f"msgpack: dtype {t.dtype} has no flax name here")
    raw = t.reshape(-1).view(torch.uint8).numpy() if t.numel() else np.zeros(0, np.uint8)
    return list(t.shape), _NAMES[t.dtype], memoryview(raw)


def _ndarray_payload(t) -> bytearray:
    """flax's ``_ndarray_to_bytes``: the 3-array ``[shape, name, bin]``."""
    shape, name, raw = _array_bytes(t)
    out = bytearray([0x93])
    _pack(out, shape)
    _pack(out, name)
    _pack_bin(out, raw)
    return out


def _chunk(t: torch.Tensor, itemsize: int) -> dict:
    size = max(1, MAX_CHUNK_SIZE // itemsize)
    flat = t.reshape(-1)
    return {CHUNKED: True, "shape": {str(i): n for i, n in enumerate(t.shape)},
            "chunks": {str(i): flat[j:j + size]
                       for i, j in enumerate(range(0, flat.numel(), size))}}


def _pack(out: bytearray, v) -> None:
    if v is None:
        out.append(0xC0)
    elif isinstance(v, bool):
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out += struct.pack(">Bd", 0xCB, v)
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        _head(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(v, (bytes, bytearray)):
        _pack_bin(out, v)
    elif isinstance(v, Mapping):
        _head(out, len(v), 0x80, 16, (None, 0xDE, 0xDF))
        for key, item in v.items():
            _pack(out, key)
            _pack(out, item)
    elif isinstance(v, (list, tuple)):
        _head(out, len(v), 0x90, 16, (None, 0xDC, 0xDD))
        for item in v:
            _pack(out, item)
    elif isinstance(v, (torch.Tensor, np.ndarray)):
        t = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
        itemsize = t.element_size()
        if t.numel() * itemsize > MAX_CHUNK_SIZE:
            _pack(out, _chunk(t, itemsize))
        else:
            _pack_ext(out, EXT_NDARRAY, _ndarray_payload(t))
    elif isinstance(v, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(v)))
    else:
        raise TypeError(f"msgpack: cannot pack {type(v).__name__}")


def msgpack_serialize(tree: Dict[str, Any]) -> bytearray:
    """The bytes ``flax.serialization.msgpack_serialize`` writes for
    ``tree`` (nested dicts of tensors, arrays and plain values)."""
    out = bytearray()
    _pack(out, tree)
    return out


def write_file(path: str, tree: Dict[str, Any]) -> int:
    """``msgpack_serialize(tree)`` into ``path``; returns the bytes written."""
    data = msgpack_serialize(tree)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)

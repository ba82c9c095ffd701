"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The kernels take
pointers from ``tensor.data_ptr()`` and launch on PyTorch's current stream;
their C entry points return ``cudaGetLastError()``.

Libraries are built at first use, from the sources in the package, into
``build/torch_kernels/`` at the repository root (``SMTC_TORCH_KERNEL_DIR``
moves it). A library's file name carries a digest of its sources and flags,
so an edited source is rebuilt and a stale library is never loaded.
``build()`` starts one ``nvcc`` per missing library, all at once.

Nothing here runs at import: this module is imported on hosts without CUDA.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("sdpa_fwd", "attn_block_fwd", "sdpa_bwd", "attn_block_bwd",
           "attn_block_perhead_fwd", "attn_block_perhead_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_counters: List["LaunchCounter"] = []  # every counter, in creation order


class LaunchCounter:
    """Counts one wrapper's kernel launches, in total and per shape key.

    The wrapper adds one where it launches its kernel and nowhere else, so a
    run can show that its path went through the kernel. A launch recorded
    into a CUDA graph is counted when the graph replays, not when it is
    captured (``deferred_counts``, ``add_counts``)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.count = 0
        self.by_key: Dict[tuple, int] = {}
        _counters.append(self)

    def add(self, key: tuple, n: int = 1) -> None:
        with self._lock:
            self.count += n
            self.by_key[key] = self.by_key.get(key, 0) + n

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.by_key = {}


@contextlib.contextmanager
def deferred_counts():
    """For a CUDA graph's capture: the launches the block records go into the
    dict it yields (counter -> {key: n}) instead of the counters, which leave
    the block as they entered it. Each replay then adds them
    (``add_counts``), so the counters keep counting launches that run."""
    before = {c: (c.count, dict(c.by_key)) for c in _counters}
    record: Dict[LaunchCounter, Dict[tuple, int]] = {}
    try:
        yield record
    finally:
        for c in _counters:
            count, by_key = before.get(c, (0, {}))
            with c._lock:
                delta = {k: n - by_key.get(k, 0) for k, n in c.by_key.items()
                         if n != by_key.get(k, 0)}
                if delta:
                    record[c] = delta
                c.count, c.by_key = count, by_key


def add_counts(record: Dict[LaunchCounter, Dict[tuple, int]]) -> None:
    """Count once the launches a ``deferred_counts`` block recorded."""
    for counter, delta in record.items():
        for key, n in delta.items():
            counter.add(key, n)


def build_dir() -> str:
    return os.environ.get("SMTC_TORCH_KERNEL_DIR") or os.path.join(
        os.path.dirname(_PKG), "build", "torch_kernels")


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's CUDA "
        "kernels are compiled from csrc/ at first use and need the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, name + ".cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(build_dir(), f"lib{name}-{_digest(name)}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library among ``names`` in parallel.

    Returns the seconds each compile took (0.0 for one already built). The
    ``nvcc`` output (with ``-Xptxas -v``: registers, shared memory, spills)
    is kept beside each library as ``.log``. Raises on any failed compile."""
    os.makedirs(build_dir(), exist_ok=True)
    procs = {}
    secs = {}
    for name in names:
        out = library_path(name)
        if os.path.isfile(out):
            secs[name] = 0.0
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        log = open(out[:-3] + ".log", "w")
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       log, tmp, out, time.monotonic())
    failed = []
    for name, (proc, log, tmp, out, t0) in procs.items():
        rc = proc.wait()
        log.close()
        secs[name] = time.monotonic() - t0
        if rc == 0:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        else:
            with open(out[:-3] + ".log") as f:
                failed.append(f"{name}: nvcc exited {rc}\n{f.read()[-4000:]}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return secs


def build_log(name: str) -> str:
    path = library_path(name)[:-3] + ".log"
    if not os.path.isfile(path):
        return ""
    with open(path) as f:
        return f.read()


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            lib.smtc_error_string.argtypes = [ctypes.c_int]
            lib.smtc_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what}: CUDA error {rc} ({lib.smtc_error_string(rc).decode()})")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


DTYPE_CODES = {"float32": 0, "bfloat16": 1}

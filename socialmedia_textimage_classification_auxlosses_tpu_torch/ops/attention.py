"""Scaled-dot-product attention: the plain version and the CUDA kernel.

Counterpart of the JAX package's ``ops/attention.py``. Every attention of the
serving path goes through ``sdpa``: encoder self-attention (text L = 128 with
a key mask, image L = 197), and the fusion head's single query of width 768
over the image tokens, in float32.

``sdpa`` sends a CUDA tensor to the hand-written Hopper kernel
(``csrc/sdpa_fwd.cu``, kernel 1 in PERF.md) and a CPU tensor to
``sdpa_reference``. Unlike the JAX package's TPU dispatch (``_auto_impl``,
tuned on a v5e), ``auto`` on the card always means the kernel. ``impl="jnp"``
asks for the plain version on either device; it is how a plain-path service
is built to check the kernels against.

Semantics kept from the JAX package: key mask 1 = keep; masked scores are
-1e30, not -inf, so a fully masked row is uniform rather than NaN; softmax in
float32; probabilities cast to the input dtype before the P.V product.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _cuda

_NEG_INF = -1e30

IMPLS = ("auto", "pallas", "pallas_interpret", "fused", "fused_interpret", "jnp")

launches = _cuda.LaunchCounter("sdpa_fwd")


def sdpa_reference(q, k, v, key_mask=None, scale: Optional[float] = None):
    """softmax(q k^T * scale + mask) v, in plain PyTorch.

    q: (B, H, Lq, D); k, v: (B, H, Lk, D); key_mask: (B, Lk) 1=keep 0=pad.
    Mirrors the JAX ``sdpa_reference`` op for op, roundings included: the
    score product is taken in the input dtype, then raised to float32.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    scores = scores.float()
    if key_mask is not None:
        keep = key_mask[:, None, None, :] > 0
        scores = scores + torch.where(keep, 0.0, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _lib():
    lib = _cuda.library("sdpa_fwd")
    if not getattr(lib, "_smtc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.smtc_sdpa_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                      ctypes.c_float, i, i, p]
        lib.smtc_sdpa_fwd.restype = i
        lib.smtc_sdpa_max_lk.argtypes = []
        lib.smtc_sdpa_max_lk.restype = i
        lib._smtc_typed = True
    return lib


def max_key_length() -> int:
    """Longest key sequence the kernel takes: a block holds its rows of
    scores in shared memory."""
    return _lib().smtc_sdpa_max_lk()


def sdpa_fwd_cuda(q, k, v, key_mask, scale: float):
    """Launch kernel 1. q: (B, H, Lq, D), k/v: (B, H, Lk, D), contiguous CUDA
    tensors of one dtype (float32 or bfloat16); key_mask: None or (B, Lk)
    int32 on the same device. Returns o: (B, H, Lq, D)."""
    if q.device.type != "cuda":
        raise ValueError(f"sdpa_fwd_cuda needs CUDA tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, L, D)")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if tuple(k.shape) != (b, h, lk, d) or tuple(v.shape) != (b, h, lk, d):
        raise ValueError(f"shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} do not agree")
    dtype = str(q.dtype).removeprefix("torch.")
    if dtype not in _cuda.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"sdpa kernel takes float32 or bfloat16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    if key_mask is not None and (
            tuple(key_mask.shape) != (b, lk) or key_mask.dtype != torch.int32
            or key_mask.device != q.device or not key_mask.is_contiguous()):
        raise ValueError("key_mask must be a contiguous (B, Lk) int32 tensor "
                         "on the device of q")
    lib = _lib()
    if lk > lib.smtc_sdpa_max_lk():
        raise ValueError(f"sdpa kernel: Lk={lk} exceeds its shared-memory row "
                         f"of {lib.smtc_sdpa_max_lk()} keys")
    if min(b, h, lq, lk, d) == 0:
        raise ValueError("sdpa kernel: empty input")
    out = torch.empty_like(q)
    rc = lib.smtc_sdpa_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if key_mask is None else key_mask.data_ptr(), out.data_ptr(),
        b, h, lq, lk, d, float(scale), _cuda.DTYPE_CODES[dtype],
        q.device.index or 0, _cuda.stream_of(q))
    _cuda.check(lib, rc, "sdpa_fwd")
    launches.add((dtype, b, h, lq, lk, d, key_mask is not None))
    return out


def sdpa(q, k, v, key_mask=None, scale: Optional[float] = None,
         impl: str = "auto"):
    """Fused SDPA. ``impl``: one of ``IMPLS``, the JAX package's names.

    On a CUDA tensor every name but "jnp" launches the kernel (there is no
    interpret mode on the card); "jnp" is the plain version. On a CPU tensor
    every name runs the plain version."""
    if impl not in IMPLS:
        raise ValueError(f"unknown sdpa impl {impl!r}; expected one of {IMPLS}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "jnp" or q.device.type == "cpu":
        return sdpa_reference(q, k, v, key_mask, scale)
    if key_mask is not None:
        key_mask = key_mask.to(torch.int32).contiguous()
    return sdpa_fwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                         key_mask, scale)

"""Fused self-attention block: QKV projections + SDPA + out-projection.

Counterpart of the JAX package's ``ops/attn_block.py`` (the ``fused`` impl,
``_fwd_kernel2``). ``attn_block`` sends a CUDA tensor to the hand-written
Hopper kernel (``csrc/attn_block_fwd.cu``, kernel 2 in PERF.md) and a CPU
tensor to ``attn_block_reference``.

Weight layout. The four weights are taken in the flax Dense layout,
``(in, out)``, so tests hand both packages the same arrays. ``nn.Linear``
stores the transpose, ``(out, in)``, and that is what the kernel reads:
``models/encoder.py::Attention`` passes ``linear.weight.t()``, whose ``.t()``
here is the contiguous Linear weight again, so no copy is made; a contiguous
``(in, out)`` array is transposed once per call.

The per-head-split variant (``fused_perhead``, the JAX ``_fwd_kernel``) is not
ported yet (ROADMAP.md Queue 2); asking for it raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _cuda
from .attention import max_key_length, sdpa_reference

IMPLS = ("fused", "fused_interpret", "jnp")

launches = _cuda.LaunchCounter("attn_block_fwd")


def attn_block_reference(x, key_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                         heads: int, scale: Optional[float] = None):
    """Plain oracle: the same projections + SDPA + out-projection composed
    from PyTorch ops, mirroring the JAX ``attn_block_reference``. Weights are
    (in, out); the products round to the dtype of x."""
    if scale is None:
        scale = (x.shape[-1] // heads) ** -0.5
    b, l, h = x.shape

    def proj(w, bias):
        y = (x @ w + bias).reshape(b, l, heads, h // heads)
        return y.permute(0, 2, 1, 3)

    ctx = sdpa_reference(proj(wq, bq), proj(wk, bk), proj(wv, bv),
                         key_mask=key_mask, scale=scale)
    ctx = ctx.permute(0, 2, 1, 3).reshape(b, l, h)
    return ctx @ wo + bo


def _lib():
    lib = _cuda.library("attn_block_fwd")
    if not getattr(lib, "_smtc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.smtc_attn_block_fwd.argtypes = (
            [p] * 15 + [i, i, i, i, ctypes.c_float, i, i, p])
        lib.smtc_attn_block_fwd.restype = i
        lib._smtc_typed = True
    return lib


def attn_block_cuda(x, key_mask, wq, bq, wk, bk, wv, bv, wo, bo, heads: int,
                    scale: float):
    """Launch kernel 2. x: (B, L, H) contiguous CUDA float32 or bfloat16;
    weights (H, H) in the (in, out) layout and biases (H,), all of x's dtype;
    key_mask: None or (B, L) int32. Returns (B, L, H) in x's dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"attn_block_cuda needs CUDA tensors, got {x.device}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, L, H) tensor")
    b, l, h = x.shape
    dtype = str(x.dtype).removeprefix("torch.")
    if dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f"attn_block kernel takes float32 or bfloat16, got {x.dtype}")
    if h % heads or h % 8:
        raise ValueError(f"hidden {h} must divide into {heads} heads and by 8")
    wts = []
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
        if tuple(w.shape) != (h, h) or w.dtype != x.dtype or w.device != x.device:
            raise ValueError(f"{name} must be ({h}, {h}) {x.dtype} on {x.device}")
        wts.append(w.t().contiguous())  # (out, in); a view when w is a Linear's .t()
    for name, bias in (("bq", bq), ("bk", bk), ("bv", bv), ("bo", bo)):
        if (tuple(bias.shape) != (h,) or bias.dtype != x.dtype
                or bias.device != x.device or not bias.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({h},) {x.dtype} tensor")
    if key_mask is not None and (
            tuple(key_mask.shape) != (b, l) or key_mask.dtype != torch.int32
            or key_mask.device != x.device or not key_mask.is_contiguous()):
        raise ValueError("key_mask must be a contiguous (B, L) int32 tensor on "
                         "the device of x")
    lib = _lib()
    if l > max_key_length():
        raise ValueError(f"attn_block kernel: L={l} exceeds the SDPA row of "
                         f"{max_key_length()} keys")
    if any(t.data_ptr() % 16 for t in [x] + wts):
        raise ValueError("attn_block kernel: x and weights must be 16-byte aligned")
    qkv = torch.empty((3, b, l, h), dtype=x.dtype, device=x.device)
    ctx = torch.empty_like(x)
    out = torch.empty_like(x)
    wq_t, wk_t, wv_t, wo_t = wts
    rc = lib.smtc_attn_block_fwd(
        x.data_ptr(), None if key_mask is None else key_mask.data_ptr(),
        wq_t.data_ptr(), bq.data_ptr(), wk_t.data_ptr(), bk.data_ptr(),
        wv_t.data_ptr(), bv.data_ptr(), wo_t.data_ptr(), bo.data_ptr(),
        qkv[0].data_ptr(), qkv[1].data_ptr(), qkv[2].data_ptr(),
        ctx.data_ptr(), out.data_ptr(),
        b, l, h, heads, float(scale), _cuda.DTYPE_CODES[dtype],
        x.device.index or 0, _cuda.stream_of(x))
    _cuda.check(lib, rc, "attn_block_fwd")
    launches.add((dtype, b, l, h, heads, key_mask is not None))
    return out


def attn_block(x, key_mask, wq, bq, wk, bk, wv, bv, wo, bo, heads: int,
               scale: Optional[float] = None, impl: str = "fused"):
    """Fused self-attention block.

    x: (B, L, H); key_mask: (B, L) 1=keep or None; weights: four (H, H)
    matrices in the flax (in, out) layout + (H,) biases. ``impl``: "fused" /
    "fused_interpret" launch the kernel on a CUDA tensor; "jnp" is the plain
    oracle. A CPU tensor always takes the plain oracle."""
    if impl not in IMPLS:
        raise ValueError(
            f"attn_block impl {impl!r} is not available in the PyTorch port "
            f"(expected one of {IMPLS}; fused_perhead is not ported yet)")
    if scale is None:
        scale = (x.shape[-1] // heads) ** -0.5
    if impl == "jnp" or x.device.type == "cpu":
        return attn_block_reference(x, key_mask, wq, bq, wk, bk, wv, bv, wo,
                                    bo, heads, scale)
    if key_mask is not None:
        key_mask = key_mask.to(torch.int32).contiguous()
    return attn_block_cuda(x.contiguous(), key_mask, wq, bq, wk, bk, wv, bv,
                           wo, bo, heads, scale)

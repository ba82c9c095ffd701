"""Fused self-attention block: QKV projections + SDPA + out-projection.

Counterpart of the JAX package's ``ops/attn_block.py`` (the ``fused`` impl,
``_fwd_kernel2`` and ``_bwd_kernel2`` under the custom VJP ``_attn_block2``).
``attn_block`` runs ``_AttnBlockFunction``: on a CUDA tensor its forward
launches the hand-written Hopper kernel (``csrc/attn_block_fwd.cu``, TPU
kernel 7 of PERF.md's table) and its backward the backward kernel
(``csrc/attn_block_bwd.cu``, TPU kernel 8), which returns dx and the packed
dq/dk/dv/ctx; the weight and bias gradients are then plain large products
(``torch.matmul`` in float32, a float32 sum), outside the kernel as in the
JAX package. On a CPU tensor forward and backward are the plain versions
``attn_block_reference`` and ``attn_block_bwd_reference``.

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
from .attention import _acc_dtype, _NEG_INF, backward_fits, max_key_length, sdpa_reference

IMPLS = ("fused", "fused_interpret", "jnp")

launches = _cuda.LaunchCounter("attn_block_fwd")
bwd_launches = _cuda.LaunchCounter("attn_block_bwd")


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


def _param_grads(x, dq, dk, dv, ctx, do, w_dtype, b_dtype):
    """The eight weight and bias gradients from the packed (B, L, H)
    activations: wgrad = a^T g over the flattened batch, accumulated in
    float32 and cast to the weight's dtype; bgrad = the float32 sum over
    (B, L). The JAX package leaves the same products to XLA
    (``_attn_block2_bwd``)."""
    h = x.shape[-1]
    acc = _acc_dtype(x.dtype)

    def wgrad(a, g):
        return torch.matmul(a.reshape(-1, h).to(acc).t(),
                            g.reshape(-1, h).to(acc)).to(w_dtype)

    def bgrad(g):
        return g.to(acc).sum(dim=(0, 1)).to(b_dtype)

    return (wgrad(x, dq), bgrad(dq), wgrad(x, dk), bgrad(dk),
            wgrad(x, dv), bgrad(dv), wgrad(ctx, do), bgrad(do))


def attn_block_bwd_reference(x, key_mask, wq, bq, wk, bk, wv, bv, wo, bo, do,
                             heads: int, scale: Optional[float] = None):
    """The backward of ``attn_block`` for the output gradient ``do``: the
    ten gradients of its arguments (dx, None for the mask, then dwq, dbq,
    dwk, dbk, dwv, dbv, dwo, dbo in the (in, out) layout): the plain kernel
    body (``attn_block_bwd_packed_reference``) and the weight and bias
    products of the JAX wrapper ``_attn_block2_bwd``."""
    dx, dq, dk, dv, ctx = attn_block_bwd_packed_reference(
        x, key_mask, wq, bq, wk, bk, wv, bv, wo, do, heads, scale)
    return (dx, None) + _param_grads(x, dq, dk, dv, ctx, do, wq.dtype, bq.dtype)


def attn_block_bwd_packed_reference(x, key_mask, wq, bq, wk, bk, wv, bv, wo, do,
                                    heads: int, scale: Optional[float] = None):
    """What the backward kernel (TPU kernel 8) returns, (dx, dq, dk, dv,
    ctx), in plain PyTorch.

    An op-for-op mirror of the JAX Pallas kernel ``_bwd_kernel2``, not
    autograd of the forward: q/k/v recomputed as float32 products plus bias,
    rounded to x's dtype; dctx = dO Wo^T rounded; per head the SDPA backward
    with the rounding points of ``attention.sdpa_bwd_reference`` and
    ctx = round(P) V, packed back to (B, L, H) and rounded; dx as one float32
    sum of three products, rounded once."""
    b, l, h = x.shape
    d = h // heads
    if scale is None:
        scale = d ** -0.5
    dt, acc = x.dtype, _acc_dtype(x.dtype)
    xa = x.to(acc)

    def proj(w, bias):
        return (xa @ w.to(acc) + bias.to(acc)).to(dt)

    def split(t):
        return t.reshape(b, l, heads, d).permute(0, 2, 1, 3).to(acc)

    def merge(t):
        return t.to(dt).permute(0, 2, 1, 3).reshape(b, l, h)

    q, k, v = split(proj(wq, bq)), split(proj(wk, bk)), split(proj(wv, bv))
    dctx = split((do.to(acc) @ wo.to(acc).t()).to(dt))
    s = q @ k.transpose(-1, -2) * scale
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :] > 0, s, _NEG_INF)
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = e / e.sum(dim=-1, keepdim=True)
    pc = p.to(dt).to(acc)
    ctx = merge(pc @ v)
    dv = pc.transpose(-1, -2) @ dctx
    dp = dctx @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsc = ds.to(dt).to(acc)
    dq = merge((dsc @ k) * scale)
    dk = merge((dsc.transpose(-1, -2) @ q) * scale)
    dv = merge(dv)
    dx = (dq.to(acc) @ wq.to(acc).t() + dk.to(acc) @ wk.to(acc).t()
          + dv.to(acc) @ wv.to(acc).t()).to(dt)
    return dx, dq, dk, dv, ctx


def _lib():
    lib = _cuda.library("attn_block_fwd")
    if not getattr(lib, "_smtc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.smtc_attn_block_fwd.argtypes = (
            [p] * 15 + [i, i, i, i, ctypes.c_float, i, i, p])
        lib.smtc_attn_block_fwd.restype = i
        lib._smtc_typed = True
    return lib


def _bwd_lib():
    lib = _cuda.library("attn_block_bwd")
    if not getattr(lib, "_smtc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.smtc_attn_block_bwd.argtypes = (
            [p] * 20 + [i, i, i, i, ctypes.c_float, i, i, p])
        lib.smtc_attn_block_bwd.restype = i
        lib._smtc_typed = True
    return lib


def _check_block(x, key_mask, ws, bs, heads, what):
    """The checks both block kernels make; returns the four weights in the
    (out, in) layout the kernels read."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {x.device}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, L, H) tensor")
    b, l, h = x.shape
    dtype = str(x.dtype).removeprefix("torch.")
    if dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f"attn_block kernel takes float32 or bfloat16, got {x.dtype}")
    if h % heads or h % 8:
        raise ValueError(f"hidden {h} must divide into {heads} heads and by 8")
    wts = []
    for name, w in zip(("wq", "wk", "wv", "wo"), ws):
        if tuple(w.shape) != (h, h) or w.dtype != x.dtype or w.device != x.device:
            raise ValueError(f"{name} must be ({h}, {h}) {x.dtype} on {x.device}")
        wts.append(w.t().contiguous())  # (out, in); a view when w is a Linear's .t()
    for name, bias in zip(("bq", "bk", "bv", "bo"), bs):
        if (tuple(bias.shape) != (h,) or bias.dtype != x.dtype
                or bias.device != x.device or not bias.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({h},) {x.dtype} tensor")
    if key_mask is not None and (
            tuple(key_mask.shape) != (b, l) or key_mask.dtype != torch.int32
            or key_mask.device != x.device or not key_mask.is_contiguous()):
        raise ValueError("key_mask must be a contiguous (B, L) int32 tensor on "
                         "the device of x")
    if l > max_key_length():
        raise ValueError(f"attn_block kernel: L={l} exceeds the SDPA row of "
                         f"{max_key_length()} keys")
    if any(t.data_ptr() % 16 for t in [x] + wts):
        raise ValueError("attn_block kernel: x and weights must be 16-byte aligned")
    return wts


def attn_block_cuda(x, key_mask, wq, bq, wk, bk, wv, bv, wo, bo, heads: int,
                    scale: float):
    """Launch the forward kernel (TPU kernel 7). x: (B, L, H) contiguous
    CUDA float32 or bfloat16; weights (H, H) in the (in, out) layout and
    biases (H,), all of x's dtype; key_mask: None or (B, L) int32. Returns
    (B, L, H) in x's dtype."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, wq, bq, wk, bk, wv, bv, wo, bo)):
        raise RuntimeError("attn_block_cuda returns no gradient: call "
                           "attn_block(), whose autograd function launches the "
                           "backward kernel")
    wts = _check_block(x, key_mask, (wq, wk, wv, wo), (bq, bk, bv, bo), heads,
                       "attn_block_cuda")
    b, l, h = x.shape
    dtype = str(x.dtype).removeprefix("torch.")
    lib = _lib()
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


def attn_block_bwd_cuda(x, key_mask, wq, bq, wk, bk, wv, bv, wo, do,
                        heads: int, scale: float):
    """Launch the backward kernel (TPU kernel 8) for the output gradient
    ``do`` (contiguous, shaped and typed like x). Takes what
    ``attn_block_cuda`` takes (the out-projection bias plays no part).
    Returns (dx, dq, dk, dv, ctx), each (B, L, H) in x's dtype: the packed
    per-head gradients and the recomputed context feed the weight
    gradients."""
    wts = _check_block(x, key_mask, (wq, wk, wv, wo), (bq, bk, bv), heads,
                       "attn_block_bwd_cuda")
    if (do.shape != x.shape or do.dtype != x.dtype or do.device != x.device
            or not do.is_contiguous() or do.data_ptr() % 16):
        raise ValueError("do must be a contiguous, 16-byte aligned tensor shaped "
                         "and typed like x")
    b, l, h = x.shape
    if not backward_fits(l, l, h // heads):
        raise ValueError(f"attn_block backward kernel: L={l} does not fit the "
                         "SDPA backward block")
    dtype = str(x.dtype).removeprefix("torch.")
    lib = _bwd_lib()
    scratch = torch.empty((4, b, l, h), dtype=x.dtype, device=x.device)  # q k v dctx
    stats = torch.empty((b, heads, l, 3), dtype=torch.float32, device=x.device)
    ctx, dq, dk, dv, dx = (torch.empty_like(x) for _ in range(5))
    wq_t, wk_t, wv_t, wo_t = wts
    rc = lib.smtc_attn_block_bwd(
        x.data_ptr(), None if key_mask is None else key_mask.data_ptr(),
        wq_t.data_ptr(), bq.data_ptr(), wk_t.data_ptr(), bk.data_ptr(),
        wv_t.data_ptr(), bv.data_ptr(), wo_t.data_ptr(), do.data_ptr(),
        scratch[0].data_ptr(), scratch[1].data_ptr(), scratch[2].data_ptr(),
        scratch[3].data_ptr(), ctx.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dx.data_ptr(), stats.data_ptr(),
        b, l, h, heads, float(scale), _cuda.DTYPE_CODES[dtype],
        x.device.index or 0, _cuda.stream_of(x))
    _cuda.check(lib, rc, "attn_block_bwd")
    bwd_launches.add((dtype, b, l, h, heads, key_mask is not None))
    return dx, dq, dk, dv, ctx


class _AttnBlockFunction(torch.autograd.Function):
    """``attn_block`` with a gradient: the kernels on CUDA, the plain
    versions on the CPU. Saves only its inputs, as the JAX residuals do."""

    @staticmethod
    def forward(ctx, x, key_mask, wq, bq, wk, bk, wv, bv, wo, bo, heads, scale):
        ctx.heads, ctx.scale = heads, scale
        ctx.save_for_backward(x, key_mask, wq, bq, wk, bk, wv, bv, wo, bo)
        args = (x, key_mask, wq, bq, wk, bk, wv, bv, wo, bo, heads, scale)
        if x.device.type == "cpu":
            return attn_block_reference(*args)
        return attn_block_cuda(*args)

    @staticmethod
    def backward(ctx, do):
        x, key_mask, wq, bq, wk, bk, wv, bv, wo, bo = ctx.saved_tensors
        do = do.contiguous()
        if x.device.type == "cpu":
            grads = attn_block_bwd_reference(x, key_mask, wq, bq, wk, bk, wv,
                                             bv, wo, bo, do, ctx.heads, ctx.scale)
        else:
            if do.data_ptr() % 16:
                do = do.clone()
            dx, dq, dk, dv, cx = attn_block_bwd_cuda(
                x, key_mask, wq, bq, wk, bk, wv, bv, wo, do, ctx.heads, ctx.scale)
            grads = (dx, None) + _param_grads(x, dq, dk, dv, cx, do, wq.dtype, bq.dtype)
        return (*grads, None, None)


def attn_block(x, key_mask, wq, bq, wk, bk, wv, bv, wo, bo, heads: int,
               scale: Optional[float] = None, impl: str = "fused"):
    """Fused self-attention block.

    x: (B, L, H); key_mask: (B, L) 1=keep or None; weights: four (H, H)
    matrices in the flax (in, out) layout + (H,) biases. ``impl``: "fused" /
    "fused_interpret" launch the kernels on a CUDA tensor (the backward when
    a gradient is asked for) and take the plain versions on a CPU tensor;
    "jnp" is the plain oracle with PyTorch's autograd. A CUDA call that needs
    a gradient at a length the backward kernel does not take raises here."""
    if impl not in IMPLS:
        raise ValueError(
            f"attn_block impl {impl!r} is not available in the PyTorch port "
            f"(expected one of {IMPLS}; fused_perhead is not ported yet)")
    if scale is None:
        scale = (x.shape[-1] // heads) ** -0.5
    if impl == "jnp":
        return attn_block_reference(x, key_mask, wq, bq, wk, bk, wv, bv, wo,
                                    bo, heads, scale)
    if key_mask is not None:
        key_mask = key_mask.to(torch.int32).contiguous()
    x = x.contiguous()
    params = (wq, bq, wk, bk, wv, bv, wo, bo)
    l, h = x.shape[1], x.shape[2]
    if (x.device.type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (x,) + params)
            and not backward_fits(l, l, h // heads)):
        raise ValueError(f"attn_block: a gradient is needed at L={l}, which the "
                         "backward kernel does not take")
    return _AttnBlockFunction.apply(x, key_mask, *params, heads, scale)

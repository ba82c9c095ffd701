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

The per-head variant, ``impl="fused_perhead"`` (the JAX ``_fwd_kernel`` and
``_bwd_kernel`` under the custom VJP ``_attn_block``, kept there as an
ablation), runs ``_AttnBlockPerheadFunction``: on a CUDA tensor the kernels
of ``csrc/attn_block_perhead_fwd.cu`` (TPU kernel 5) and
``csrc/attn_block_perhead_bwd.cu`` (TPU kernel 6), on a CPU tensor their plain
versions ``attn_block_perhead_reference`` and
``attn_block_perhead_bwd_reference``. It differs from ``fused`` in the order
of its float32 sums, not in what it computes: the out-projection is summed
head by head in order, dx over heads and within a head over q, k, v, and the
backward returns dq, dk, dv and ctx head-banked, (B, heads, L, d). The
per-head kernels read Wq, Wk and Wv in the Linear (out, in) layout and Wo in
the flax (in, out) layout, where each head's block is a contiguous row block.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _cuda
from .attention import _acc_dtype, _NEG_INF, backward_fits, max_key_length, sdpa_reference

IMPLS = ("fused", "fused_interpret", "fused_perhead", "fused_perhead_interpret", "jnp")

launches = _cuda.LaunchCounter("attn_block_fwd")
bwd_launches = _cuda.LaunchCounter("attn_block_bwd")
perhead_launches = _cuda.LaunchCounter("attn_block_perhead_fwd")
perhead_bwd_launches = _cuda.LaunchCounter("attn_block_perhead_bwd")


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


def _perhead_parts(x, key_mask, wq, bq, wk, bk, wv, bv, heads, scale):
    """Per head, as the JAX ``_qkv_head`` and ``_head_softmax``: the head's
    column slice, q/k/v as float32 products plus bias rounded to x's dtype,
    and the float32 softmax of the scaled, masked scores. Yields (slice, q,
    k, v, p), q/k/v raised back to float32."""
    h = x.shape[-1]
    d = h // heads
    dt, acc = x.dtype, _acc_dtype(x.dtype)
    xa = x.to(acc)
    for hh in range(heads):
        sl = slice(hh * d, (hh + 1) * d)
        q, k, v = ((xa @ w[:, sl].to(acc) + bias[sl].to(acc)).to(dt).to(acc)
                   for w, bias in ((wq, bq), (wk, bk), (wv, bv)))
        s = q @ k.transpose(-1, -2) * scale
        if key_mask is not None:
            s = torch.where(key_mask[:, None, :] > 0, s, _NEG_INF)
        s = s - s.amax(dim=-1, keepdim=True)
        e = torch.exp(s)
        yield sl, q, k, v, e / e.sum(dim=-1, keepdim=True)


def attn_block_perhead_reference(x, key_mask, wq, bq, wk, bk, wv, bv, wo, bo,
                                 heads: int, scale: Optional[float] = None):
    """Plain version of the per-head forward (TPU kernel 5), op for op the
    JAX ``_fwd_kernel``: per head, ctx = round(round(P) V), and
    ``acc += ctx Wo_h`` in float32, head 0 to heads - 1 in order; then
    ``acc + bo`` rounded once. Weights (in, out)."""
    if scale is None:
        scale = (x.shape[-1] // heads) ** -0.5
    dt, acc_t = x.dtype, _acc_dtype(x.dtype)
    acc = torch.zeros(x.shape, dtype=acc_t, device=x.device)
    for sl, q, k, v, p in _perhead_parts(x, key_mask, wq, bq, wk, bk, wv, bv, heads, scale):
        ctx = (p.to(dt).to(acc_t) @ v).to(dt)
        acc = acc + ctx.to(acc_t) @ wo[sl, :].to(acc_t)
    return (acc + bo.to(acc_t)).to(dt)


def attn_block_perhead_bwd_banked_reference(x, key_mask, wq, bq, wk, bk, wv, bv, wo, do,
                                            heads: int, scale: Optional[float] = None):
    """What the per-head backward kernel (TPU kernel 6) returns: dx (B, L, H)
    and dq, dk, dv, ctx head-banked (B, heads, L, d), in plain PyTorch.

    Op for op the JAX ``_bwd_kernel``: per head, dctx = round(dO Wo_h^T);
    dv = round(P)^T dctx, dP = dctx V^T, dS = P (dP - rowsum(dP P)) rounded,
    dq = (dS K) scale and dk = (dS^T Q) scale, each rounded, ctx =
    round(round(P) V); dx summed in float32 over heads in order and within a
    head over q, k, v in order, rounded once."""
    if scale is None:
        scale = (x.shape[-1] // heads) ** -0.5
    dt, acc_t = x.dtype, _acc_dtype(x.dtype)
    doa = do.to(acc_t)
    dx = torch.zeros(x.shape, dtype=acc_t, device=x.device)
    banks = ([], [], [], [])
    for sl, q, k, v, p in _perhead_parts(x, key_mask, wq, bq, wk, bk, wv, bv, heads, scale):
        pc = p.to(dt).to(acc_t)
        ctx = (pc @ v).to(dt)
        dctx = (doa @ wo[sl, :].to(acc_t).t()).to(dt).to(acc_t)
        dv = (pc.transpose(-1, -2) @ dctx).to(dt)
        dp = dctx @ v.transpose(-1, -2)
        ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).to(acc_t)
        dq = ((ds @ k) * scale).to(dt)
        dk = ((ds.transpose(-1, -2) @ q) * scale).to(dt)
        for g, w in ((dq, wq), (dk, wk), (dv, wv)):
            dx = dx + g.to(acc_t) @ w[:, sl].to(acc_t).t()
        for bank, t in zip(banks, (dq, dk, dv, ctx)):
            bank.append(t)
    dq, dk, dv, ctx = (torch.stack(bank, dim=1) for bank in banks)
    return dx.to(dt), dq, dk, dv, ctx


def _merge_heads(t):
    """(B, heads, L, d) -> (B, L, H), as the JAX ``_attn_block_bwd``'s merge."""
    b, heads, l, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b, l, heads * d)


def attn_block_perhead_bwd_reference(x, key_mask, wq, bq, wk, bk, wv, bv, wo, bo, do,
                                     heads: int, scale: Optional[float] = None):
    """The ten gradients of ``attn_block(impl="fused_perhead")`` for ``do``
    (dx, None for the mask, then the weight and bias gradients in the (in,
    out) layout): the plain kernel body and the products of the JAX wrapper
    ``_attn_block_bwd`` over the merged banks."""
    dx, dq, dk, dv, ctx = attn_block_perhead_bwd_banked_reference(
        x, key_mask, wq, bq, wk, bk, wv, bv, wo, do, heads, scale)
    return (dx, None) + _param_grads(x, _merge_heads(dq), _merge_heads(dk),
                                     _merge_heads(dv), _merge_heads(ctx), do,
                                     wq.dtype, bq.dtype)


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


def _check_block(x, key_mask, ws, bs, heads, what, wo_flax=False):
    """The checks every block kernel makes; returns the four weights in the
    (out, in) layout the kernels read, but Wo, with ``wo_flax``, in the
    (in, out) layout the per-head kernels read."""
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
        if wo_flax and name == "wo":
            wts.append(w.contiguous())  # (in, out): head h's rows are Wo_h
        else:
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


def _perhead_lib():
    lib = _cuda.library("attn_block_perhead_fwd")
    if not getattr(lib, "_smtc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.smtc_attn_block_perhead_fwd.argtypes = (
            [p] * 15 + [i, i, i, i, ctypes.c_float, i, i, p])
        lib.smtc_attn_block_perhead_fwd.restype = i
        lib._smtc_typed = True
    return lib


def _perhead_bwd_lib():
    lib = _cuda.library("attn_block_perhead_bwd")
    if not getattr(lib, "_smtc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.smtc_attn_block_perhead_bwd.argtypes = (
            [p] * 20 + [i, i, i, i, ctypes.c_float, i, i, p])
        lib.smtc_attn_block_perhead_bwd.restype = i
        lib._smtc_typed = True
    return lib


def attn_block_perhead_cuda(x, key_mask, wq, bq, wk, bk, wv, bv, wo, bo, heads: int,
                            scale: float):
    """Launch the per-head forward kernel (TPU kernel 5). Takes and returns
    what ``attn_block_cuda`` does."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, wq, bq, wk, bk, wv, bv, wo, bo)):
        raise RuntimeError("attn_block_perhead_cuda returns no gradient: call "
                           "attn_block(impl='fused_perhead'), whose autograd "
                           "function launches the backward kernel")
    wq_t, wk_t, wv_t, wo_f = _check_block(x, key_mask, (wq, wk, wv, wo), (bq, bk, bv, bo),
                                          heads, "attn_block_perhead_cuda", wo_flax=True)
    b, l, h = x.shape
    dtype = str(x.dtype).removeprefix("torch.")
    lib = _perhead_lib()
    banks = torch.empty((4, b, heads, l, h // heads), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    rc = lib.smtc_attn_block_perhead_fwd(
        x.data_ptr(), None if key_mask is None else key_mask.data_ptr(),
        wq_t.data_ptr(), bq.data_ptr(), wk_t.data_ptr(), bk.data_ptr(),
        wv_t.data_ptr(), bv.data_ptr(), wo_f.data_ptr(), bo.data_ptr(),
        banks[0].data_ptr(), banks[1].data_ptr(), banks[2].data_ptr(),
        banks[3].data_ptr(), out.data_ptr(),
        b, l, h, heads, float(scale), _cuda.DTYPE_CODES[dtype],
        x.device.index or 0, _cuda.stream_of(x))
    _cuda.check(lib, rc, "attn_block_perhead_fwd")
    perhead_launches.add((dtype, b, l, h, heads, key_mask is not None))
    return out


def attn_block_perhead_bwd_cuda(x, key_mask, wq, bq, wk, bk, wv, bv, wo, do,
                                heads: int, scale: float):
    """Launch the per-head backward kernel (TPU kernel 6) for the output
    gradient ``do``. Takes what ``attn_block_bwd_cuda`` takes. Returns dx
    (B, L, H) and dq, dk, dv, ctx head-banked, (B, heads, L, d), in x's
    dtype, as ``attn_block_perhead_bwd_banked_reference``."""
    wq_t, wk_t, wv_t, wo_f = _check_block(x, key_mask, (wq, wk, wv, wo), (bq, bk, bv), heads,
                                          "attn_block_perhead_bwd_cuda", wo_flax=True)
    if (do.shape != x.shape or do.dtype != x.dtype or do.device != x.device
            or not do.is_contiguous() or do.data_ptr() % 16):
        raise ValueError("do must be a contiguous, 16-byte aligned tensor shaped "
                         "and typed like x")
    b, l, h = x.shape
    if not backward_fits(l, l, h // heads):
        raise ValueError(f"attn_block perhead backward kernel: L={l} does not fit the "
                         "SDPA backward block")
    dtype = str(x.dtype).removeprefix("torch.")
    lib = _perhead_bwd_lib()
    banks = torch.empty((8, b, heads, l, h // heads), dtype=x.dtype, device=x.device)
    q, k, v, dctx, ctx, dq, dk, dv = banks
    stats = torch.empty((b, heads, l, 3), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    rc = lib.smtc_attn_block_perhead_bwd(
        x.data_ptr(), None if key_mask is None else key_mask.data_ptr(),
        wq_t.data_ptr(), bq.data_ptr(), wk_t.data_ptr(), bk.data_ptr(),
        wv_t.data_ptr(), bv.data_ptr(), wo_f.data_ptr(), do.data_ptr(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dctx.data_ptr(), ctx.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dx.data_ptr(), stats.data_ptr(),
        b, l, h, heads, float(scale), _cuda.DTYPE_CODES[dtype],
        x.device.index or 0, _cuda.stream_of(x))
    _cuda.check(lib, rc, "attn_block_perhead_bwd")
    perhead_bwd_launches.add((dtype, b, l, h, heads, key_mask is not None))
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


class _AttnBlockPerheadFunction(torch.autograd.Function):
    """``attn_block(impl="fused_perhead")`` with a gradient: kernels 5 and 6
    on CUDA, their plain versions on the CPU. Saves only its inputs."""

    @staticmethod
    def forward(ctx, x, key_mask, wq, bq, wk, bk, wv, bv, wo, bo, heads, scale):
        ctx.heads, ctx.scale = heads, scale
        ctx.save_for_backward(x, key_mask, wq, bq, wk, bk, wv, bv, wo, bo)
        args = (x, key_mask, wq, bq, wk, bk, wv, bv, wo, bo, heads, scale)
        if x.device.type == "cpu":
            return attn_block_perhead_reference(*args)
        return attn_block_perhead_cuda(*args)

    @staticmethod
    def backward(ctx, do):
        x, key_mask, wq, bq, wk, bk, wv, bv, wo, bo = ctx.saved_tensors
        do = do.contiguous()
        if x.device.type == "cpu":
            grads = attn_block_perhead_bwd_reference(x, key_mask, wq, bq, wk, bk, wv, bv,
                                                     wo, bo, do, ctx.heads, ctx.scale)
        else:
            if do.data_ptr() % 16:
                do = do.clone()
            dx, dq, dk, dv, cx = attn_block_perhead_bwd_cuda(
                x, key_mask, wq, bq, wk, bk, wv, bv, wo, do, ctx.heads, ctx.scale)
            grads = (dx, None) + _param_grads(x, _merge_heads(dq), _merge_heads(dk),
                                              _merge_heads(dv), _merge_heads(cx), do,
                                              wq.dtype, bq.dtype)
        return (*grads, None, None)


def attn_block(x, key_mask, wq, bq, wk, bk, wv, bv, wo, bo, heads: int,
               scale: Optional[float] = None, impl: str = "fused"):
    """Fused self-attention block.

    x: (B, L, H); key_mask: (B, L) 1=keep or None; weights: four (H, H)
    matrices in the flax (in, out) layout + (H,) biases. ``impl``: "fused" /
    "fused_interpret" (kernels 7 and 8) and "fused_perhead" /
    "fused_perhead_interpret" (kernels 5 and 6) launch the kernels on a CUDA
    tensor (the backward when a gradient is asked for) and take the plain
    versions on a CPU tensor; "jnp" is the plain oracle with PyTorch's
    autograd. A CUDA call that needs a gradient at a length the backward
    kernel does not take raises here."""
    if impl not in IMPLS:
        raise ValueError(f"attn_block impl {impl!r} is not available in the PyTorch "
                         f"port (expected one of {IMPLS})")
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
    fn = _AttnBlockPerheadFunction if impl.startswith("fused_perhead") else _AttnBlockFunction
    return fn.apply(x, key_mask, *params, heads, scale)

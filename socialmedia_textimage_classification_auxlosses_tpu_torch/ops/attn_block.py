"""Fused self-attention block: QKV projections + SDPA + out-projection.

Counterpart of the JAX package's ``ops/attn_block.py`` (the ``fused`` impl,
``_fwd_kernel2`` and ``_bwd_kernel2`` under the custom VJP ``_attn_block2``).
``attn_block`` runs ``_AttnBlockFunction``: on a CUDA tensor its forward
launches the hand-written Hopper kernel (``csrc/attn_block_fwd.cu``, TPU
kernel 7 of PERF.md's table) and its backward the backward kernel
(``csrc/attn_block_bwd.cu``, TPU kernel 8), which returns dx and the packed
dq/dk/dv/ctx; the weight gradients are then large products outside the
kernel, as in the JAX package: in bfloat16 the port's TN GEMM (``gemm_tn``,
the four of a block in one launch), in float32 ``torch.matmul``; the bias
gradients a float32 sum. On a CPU tensor forward and backward are the plain
versions ``attn_block_reference`` and ``attn_block_bwd_reference``.

The three orientations of the blocks' bf16 GEMM (``csrc/gemm_core.cuh``, one
wgmma kernel fed by TMA) can also be called alone, each beside its plain
version: ``gemm_nt`` (the projections), ``gemm_nn`` (dctx and dx of the
backward kernel) and ``gemm_tn`` (the weight gradients).

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

Under ``torch.export`` (``cli/export.py``) ``attn_block`` records kernel 7 as
the ``torch.library`` op ``smtc::attn_block_fwd`` (``attn_block_fwd_op``,
whose CUDA implementation is ``attn_block_cuda``); a program exported for the
CPU holds the plain forward. ``serve`` offers no per-head block, so the
per-head kernels have no op.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _cuda
from .attention import (_acc_dtype, _NEG_INF, backward_fits, bwd_scratch, max_key_length,
                        sdpa_reference)

IMPLS = ("fused", "fused_interpret", "fused_perhead", "fused_perhead_interpret", "jnp")

launches = _cuda.LaunchCounter("attn_block_fwd")
bwd_launches = _cuda.LaunchCounter("attn_block_bwd")
perhead_launches = _cuda.LaunchCounter("attn_block_perhead_fwd")
perhead_bwd_launches = _cuda.LaunchCounter("attn_block_perhead_bwd")
gemm_launches = _cuda.LaunchCounter("gemm_nt_bf16")  # the GEMM alone (gemm_nt)
gemm_nn_launches = _cuda.LaunchCounter("gemm_nn_bf16")  # the NN GEMM alone (gemm_nn)
wgrad_launches = _cuda.LaunchCounter("gemm_tn_bf16")  # the weight gradients (gemm_tn)


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
    activations, as the JAX package's ``_attn_block2_bwd`` forms them:
    wgrad = a^T g over the flattened batch, accumulated in float32 and cast
    to the weight's dtype; bgrad = the float32 sum over (B, L). On a bf16
    CUDA tensor the four products are one launch of the TN GEMM
    (``gemm_tn``), which reads the bf16 activations as they are; elsewhere
    (the CPU, and float32 on the card) they are float32 products. Each
    weight gradient is the ``.t()`` view of its (out, in) product, the
    nn.Linear layout, so a Linear weight's ``.t()`` takes it back without a
    copy."""
    h = x.shape[-1]
    xs = [t.reshape(-1, h) for t in (x, x, x, ctx)]
    gs = [t.reshape(-1, h) for t in (dq, dk, dv, do)]
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        dws = gemm_tn(xs, gs)
    else:
        dws = gemm_tn_reference(xs, gs)
    acc = _acc_dtype(x.dtype)
    grads = ()
    for dw, g in zip(dws, (dq, dk, dv, do)):
        grads += (dw.t().to(w_dtype), g.sum(dim=(0, 1), dtype=acc).to(b_dtype))
    return grads


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
        lib.smtc_gemm_nt_bf16.argtypes = [p] * 10 + [i] * 7 + [p]
        lib.smtc_gemm_nt_bf16.restype = i
        lib._smtc_typed = True
    return lib


def gemm_nt_reference(a, ws, biases, heads: int = 0, length: Optional[int] = None):
    """The block kernels' NT GEMM in plain PyTorch: C_z = a . W_z^T + b_z for
    each pair (W_z, b_z) of ``ws`` and ``biases``, the product and the bias
    in float32, rounded once to a's dtype. a: (M, K); W_z: (N, K), the
    nn.Linear layout; b_z: (N,) or None. With ``heads`` > 0 each C_z is
    head-banked, (M / length, heads, length, N / heads), as the per-head
    kernels write q, k and v; else (M, N)."""
    m, n = a.shape[0], ws[0].shape[0]
    acc = _acc_dtype(a.dtype)
    outs = []
    for w, bias in zip(ws, biases):
        c = a.to(acc) @ w.to(acc).t()
        if bias is not None:
            c = c + bias.to(acc)
        c = c.to(a.dtype)
        if heads:
            c = c.reshape(m // length, length, heads, n // heads).permute(0, 2, 1, 3).contiguous()
        outs.append(c)
    return outs


def gemm_nt(a, ws, biases, heads: int = 0, length: Optional[int] = None):
    """``gemm_nt_reference``'s function: on a CUDA tensor the bf16 GEMM
    (``csrc/gemm_core.cuh``, wgmma fed by TMA) that kernels 5-8 launch inside
    their entry points, here alone, so that it can be held against its plain
    version and timed at the blocks' shapes; on a CPU tensor the plain
    version. Up to three (W_z, b_z) pairs, as the QKV projections pass."""
    if not 1 <= len(ws) <= 3 or len(biases) != len(ws):
        raise ValueError("gemm_nt takes one to three weights, each with a bias or None")
    if heads and (length is None or a.shape[0] % length or ws[0].shape[0] % heads):
        raise ValueError("a banked gemm_nt needs length dividing M and heads dividing N")
    if a.device.type == "cpu":
        return gemm_nt_reference(a, ws, biases, heads, length)
    if a.dtype != torch.bfloat16 or a.dim() != 2 or not a.is_contiguous():
        raise ValueError("gemm_nt's kernel takes a contiguous (M, K) bfloat16 matrix")
    m, k = a.shape
    n = ws[0].shape[0]
    for w, bias in zip(ws, biases):
        if (w.shape != (n, k) or w.dtype != a.dtype or w.device != a.device
                or not w.is_contiguous()):
            raise ValueError(f"each weight must be a contiguous ({n}, {k}) {a.dtype} tensor "
                             f"on {a.device}")
        if bias is not None and (bias.shape != (n,) or bias.dtype != a.dtype
                                 or bias.device != a.device or not bias.is_contiguous()):
            raise ValueError(f"each bias must be None or a contiguous ({n},) {a.dtype} tensor")
    if heads:
        outs = [torch.empty((m // length, heads, length, n // heads), dtype=a.dtype,
                            device=a.device) for _ in ws]
    else:
        outs = [torch.empty((m, n), dtype=a.dtype, device=a.device) for _ in ws]
    pad = [None] * (3 - len(ws))
    lib = _lib()
    rc = lib.smtc_gemm_nt_bf16(
        a.data_ptr(), *[w.data_ptr() for w in ws], *pad,
        *[None if bias is None else bias.data_ptr() for bias in biases], *pad,
        *[c.data_ptr() for c in outs], *pad,
        m, n, k, len(ws), length or 0, heads, a.device.index or 0, _cuda.stream_of(a))
    _cuda.check(lib, rc, "gemm_nt_bf16")
    gemm_launches.add((m, n, k, len(ws), heads, any(bias is not None for bias in biases)))
    return outs


def _bwd_lib():
    lib = _cuda.library("attn_block_bwd")
    if not getattr(lib, "_smtc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.smtc_attn_block_bwd.argtypes = (
            [p] * 20 + [i, i, i, i, ctypes.c_float, i, i, p])
        lib.smtc_attn_block_bwd.restype = i
        lib.smtc_gemm_nn_bf16.argtypes = [p] * 7 + [i] * 5 + [p]
        lib.smtc_gemm_nn_bf16.restype = i
        lib.smtc_gemm_tn_bf16.argtypes = [p] * 13 + [i] * 5 + [p]
        lib.smtc_gemm_tn_bf16.restype = i
        lib.smtc_gemm_tn_partial_floats.argtypes = [i] * 5
        lib.smtc_gemm_tn_partial_floats.restype = ctypes.c_longlong
        lib.smtc_gemm_blocks_per_sm.argtypes = [i]
        lib.smtc_gemm_blocks_per_sm.restype = i
        lib._smtc_typed = True
    return lib


def gemm_nn_reference(as_, ws):
    """The backward kernel's NN GEMM in plain PyTorch: C = sum_z a_z . W_z
    over the pairs of ``as_`` and ``ws``, float32 products summed and
    rounded once to a's dtype. a_z: (M, K); W_z: (K, N), a Linear's (out,
    in) weight read as (K, N)."""
    acc = _acc_dtype(as_[0].dtype)
    c = as_[0].to(acc) @ ws[0].to(acc)
    for a, w in zip(as_[1:], ws[1:]):
        c = c + a.to(acc) @ w.to(acc)
    return c.to(as_[0].dtype)


def gemm_nn(as_, ws):
    """``gemm_nn_reference``'s function: on a CUDA tensor the bf16 GEMM that
    the backward kernel (TPU kernel 8) launches for dctx (one pair) and dx
    (three), here alone (``csrc/gemm_core.cuh``, wgmma fed by TMA, the
    weight read MN-major); on a CPU tensor the plain version."""
    if not 1 <= len(as_) <= 3 or len(ws) != len(as_):
        raise ValueError("gemm_nn takes one to three (a, W) pairs")
    a0 = as_[0]
    m, k = a0.shape
    n = ws[0].shape[-1]
    if any(a.shape != (m, k) or w.shape != (k, n) for a, w in zip(as_, ws)):
        raise ValueError(f"each pair must be an ({m}, {k}) a and a ({k}, {n}) W")
    if a0.device.type == "cpu":
        return gemm_nn_reference(as_, ws)
    if a0.dtype != torch.bfloat16 or any(
            t.dtype != a0.dtype or t.device != a0.device or not t.is_contiguous()
            for t in as_ + ws):
        raise ValueError(f"gemm_nn's kernel takes contiguous bfloat16 tensors on {a0.device}")
    out = torch.empty((m, n), dtype=a0.dtype, device=a0.device)
    pad = [None] * (3 - len(as_))
    lib = _bwd_lib()
    rc = lib.smtc_gemm_nn_bf16(*[a.data_ptr() for a in as_], *pad,
                               *[w.data_ptr() for w in ws], *pad, out.data_ptr(),
                               m, n, k, len(as_), a0.device.index or 0, _cuda.stream_of(a0))
    _cuda.check(lib, rc, "gemm_nn_bf16")
    gemm_nn_launches.add((m, n, k, len(as_)))
    return out


def gemm_tn_reference(xs, gs):
    """The weight-gradient GEMM in plain PyTorch: C_z = g_z^T . x_z for each
    pair of ``xs`` and ``gs``, a float32 product over the K rows rounded
    once to x's dtype. x_z: (K, N); g_z: (K, M); C_z: (M, N), the nn.Linear
    (out, in) layout of a weight's gradient."""
    acc = _acc_dtype(xs[0].dtype)
    return [(g.to(acc).t() @ x.to(acc)).to(xs[0].dtype) for x, g in zip(xs, gs)]


_tn_floats = {}  # (M, N, K, count, device) -> f32 elements of the partial sums


def _tn_partial_floats(lib, m, n, k, count, device):
    """The size of the partial sums the library needs for this call, asked
    once per shape."""
    key = (m, n, k, count, device)
    floats = _tn_floats.get(key)
    if floats is None:
        floats = lib.smtc_gemm_tn_partial_floats(m, n, k, count, device)
        _cuda.check(lib, max(0, -floats), "gemm_tn_partial_floats")
        _tn_floats[key] = floats
    return floats


def gemm_tn(xs, gs):
    """``gemm_tn_reference``'s function: on a CUDA tensor the port's bf16 TN
    GEMM (``csrc/gemm_core.cuh``, wgmma fed by TMA, both operands read
    MN-major), up to four products in one launch, each an f32 sum over all
    K rows rounded once; on a CPU tensor the plain version. Where K is long
    enough the library cuts the K rows of the tiles past the card's last
    full round of SMs into slices, summed apart and then added in slice
    order, so two runs agree bit for bit."""
    if not 1 <= len(xs) <= 4 or len(gs) != len(xs):
        raise ValueError("gemm_tn takes one to four (x, g) pairs")
    x0 = xs[0]
    k, n = x0.shape
    m = gs[0].shape[-1]
    if any(x.shape != (k, n) or g.shape != (k, m) for x, g in zip(xs, gs)):
        raise ValueError(f"each pair must be a ({k}, {n}) x and a ({k}, {m}) g")
    if x0.device.type == "cpu":
        return gemm_tn_reference(xs, gs)
    if x0.dtype != torch.bfloat16 or any(
            t.dtype != x0.dtype or t.device != x0.device or not t.is_contiguous()
            for t in xs + gs):
        raise ValueError(f"gemm_tn's kernel takes contiguous bfloat16 tensors on {x0.device}")
    count, device = len(xs), x0.device.index or 0
    lib = _bwd_lib()
    floats = _tn_partial_floats(lib, m, n, k, count, device)
    outs = torch.empty((count, m, n), dtype=x0.dtype, device=x0.device)
    partial = torch.empty(floats, dtype=torch.float32, device=x0.device) if floats else None
    pad = [None] * (4 - count)
    rc = lib.smtc_gemm_tn_bf16(
        *[x.data_ptr() for x in xs], *pad, *[g.data_ptr() for g in gs], *pad,
        *[c.data_ptr() for c in outs], *pad, None if partial is None else partial.data_ptr(),
        m, n, k, count, device, _cuda.stream_of(x0))
    _cuda.check(lib, rc, "gemm_tn_bf16")
    wgrad_launches.add((k, m, n, count))
    return list(outs)


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
    stats = bwd_scratch(b, heads, l, l, x.device)
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
    stats = bwd_scratch(b, heads, l, l, x.device)
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


@torch.library.custom_op("smtc::attn_block_fwd", mutates_args=(), device_types="cuda")
def attn_block_fwd_op(x: torch.Tensor, key_mask: Optional[torch.Tensor], wq: torch.Tensor,
                      bq: torch.Tensor, wk: torch.Tensor, bk: torch.Tensor, wv: torch.Tensor,
                      bv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor, heads: int,
                      scale: float) -> torch.Tensor:
    """``attn_block_cuda`` as the ``torch.library`` op
    ``smtc::attn_block_fwd``, the node ``torch.export`` records for kernel 7.
    Its CUDA implementation launches the kernel (and counts it); it has no
    CPU one."""
    return attn_block_cuda(x, key_mask, wq, bq, wk, bk, wv, bv, wo, bo, heads, scale)


@attn_block_fwd_op.register_fake
def _attn_block_fwd_fake(x, key_mask, wq, bq, wk, bk, wv, bv, wo, bo, heads, scale):
    return torch.empty_like(x)


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
    perhead = impl.startswith("fused_perhead")
    if torch.compiler.is_exporting() and not perhead:
        # torch.export (cli/export.py): kernel 7 as its op node on CUDA, the
        # plain forward on the CPU (serve offers no per-head block)
        if x.device.type == "cuda":
            return attn_block_fwd_op(x, key_mask, *params, heads, scale)
        return attn_block_reference(x, key_mask, *params, heads, scale)
    fn = _AttnBlockPerheadFunction if perhead else _AttnBlockFunction
    return fn.apply(x, key_mask, *params, heads, scale)

"""Scaled-dot-product attention: the plain version and the CUDA kernels.

Counterpart of the JAX package's ``ops/attention.py``. Every attention of the
serving and training paths goes through ``sdpa``: encoder self-attention
(text L = 128 with a key mask, 2B rows in training with TIM; image L = 197;
ViLT's joint text + image sequence, L = 40 + 362 = 402 under
``--vilt_exact_resize``, 40 + 145 = 185 otherwise), and the fusion head's
single query of width 768 over the image tokens, in float32. The frozen
vision tower needs no backward; the text tower, the fusion head and ViLT do.

``sdpa`` runs ``_SdpaFunction``, the counterpart of the JAX custom VJP
``_sdpa_pallas``: on a CUDA tensor its forward launches the hand-written
Hopper kernel (``csrc/sdpa_fwd.cu``, TPU kernels 1 and 3 of PERF.md's table:
its 64-row query tiles cover the JAX whole-Lq and 128-row-blocked forwards
alike; on the tensor cores, wgmma fed by TMA, in float32 each product three
tf32 passes that keep float32's accuracy) and its backward the backward
kernels (``csrc/sdpa_bwd.cu``, TPU kernels 2 and 4: at head dims 32 and 64
the tensor-core query-tiled pair of the dtype, else the row pair, a block
kernel or the FMA query-tiled pair, by shape); on a CPU tensor they are the
plain versions ``sdpa_reference`` and ``sdpa_bwd_reference``. Like the JAX
residuals, the function saves its inputs and recomputes the probabilities in
the backward; where the backward will run a tensor-core pair (bf16 or
float32, more than 4 query rows, head dim 32 or 64), it also saves the
forward kernel's row statistics,
each query row's float32 max and sum of exponentials, (B, H, Lq, 2) (0.3 MB
at 16x12x197), which the backward's first pass reads instead of forming them
again. Unlike the JAX
package's TPU dispatch (``_auto_impl``, tuned on a v5e), ``auto`` on the card
always means the kernels. ``impl="jnp"`` asks for the plain forward on
either device, with PyTorch's autograd of its ops for the gradient; it is how
a plain path is built to check the kernels against.

Semantics kept from the JAX package: key mask 1 = keep; masked scores are
-1e30, not -inf, so a fully masked row is uniform rather than NaN; softmax in
float32; probabilities cast to the input dtype before the P.V product.

Under ``torch.export`` (``cli/export.py``) ``sdpa`` records the forward
kernel as the ``torch.library`` op ``smtc::sdpa_fwd`` (``sdpa_fwd_op``),
whose CUDA implementation is ``sdpa_fwd_cuda``; a program exported for the
CPU holds the plain forward. Eager calls and CUDA-graph captures do not go
through the op.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _cuda

_NEG_INF = -1e30

IMPLS = ("auto", "pallas", "pallas_interpret", "fused", "fused_interpret", "jnp")

launches = _cuda.LaunchCounter("sdpa_fwd")
bwd_launches = _cuda.LaunchCounter("sdpa_bwd")


def sdpa_reference(q, k, v, key_mask=None, scale: Optional[float] = None,
                   with_stats: bool = False):
    """softmax(q k^T * scale + mask) v, in plain PyTorch.

    q: (B, H, Lq, D); k, v: (B, H, Lk, D); key_mask: (B, Lk) 1=keep 0=pad.
    Mirrors the JAX ``sdpa_reference`` op for op, roundings included: the
    score product is taken in the input dtype, then raised to float32. It is
    the plain version of the forward at every length: the JAX Pallas
    forwards for Lq <= 256 (``_fwd_kernel``) and above it
    (``_fwd_kernel_blocked``, 128-row query tiles) compute this one function.
    ``with_stats`` also returns ``row_stats`` of the same inputs, the plain
    version of the statistics the tensor-core kernel writes: ``(o, stats)``.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    scores = scores.to(_acc_dtype(q.dtype))
    if key_mask is not None:
        keep = key_mask[:, None, None, :] > 0
        scores = scores + torch.where(keep, 0.0, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    if with_stats:
        return out, row_stats(q, k, key_mask, scale)
    return out


def _scores(q, k, key_mask, scale):
    """The JAX kernels' scores (``_probs``): q k^T with float32 products and
    sums (the inputs raised to float32 first), times scale, masked keys at
    -1e30."""
    acc = _acc_dtype(q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * scale
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :] > 0, s, _NEG_INF)
    return s


def row_stats(q, k, key_mask=None, scale: Optional[float] = None):
    """Each query row's max m of the scores and sum l of exp(s - m), as the
    JAX ``_probs`` forms them before P = exp(s - m) / l: (B, H, Lq, 2) in
    float32 (the accumulation dtype), m then l. The plain version of what the
    tensor-core forwards write for the backward."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _scores(q, k, key_mask, scale)
    m = s.amax(dim=-1, keepdim=True)
    l = torch.exp(s - m).sum(dim=-1, keepdim=True)
    return torch.cat([m, l], dim=-1)


def _acc_dtype(dtype):
    """float32 for the narrow types, the type itself for float64 (so the
    plain versions can be gradient-checked in double precision)."""
    return torch.promote_types(dtype, torch.float32)


def sdpa_bwd_reference(q, k, v, key_mask, do, scale: Optional[float] = None,
                       stats=None):
    """The backward of ``sdpa``: (dq, dk, dv) for the output gradient ``do``.

    An op-for-op mirror of the JAX Pallas kernel ``_bwd_kernel`` with its
    rounding points, not autograd of the forward: P recomputed in float32
    (products of the input dtype accumulated in float32, masked keys at
    -1e30); P rounded to dO's dtype only for dV = P^T dO; dP = dO V^T in
    float32; dS = P (dP - rowsum(dP P)) from the unrounded P, then rounded to
    K's dtype; dQ = (dS K) * scale and dK = (dS^T Q) * scale, scaled after the
    product; each output cast to its input's dtype.

    It is the plain version at every length: the blocked JAX kernel
    (``_bwd_kernel_blocked``, Lq > 256) computes the same function per
    128-row query tile and sums dK and dV over the tiles in float32 before
    its one rounding, so the two JAX kernels differ only in the order of
    their float32 sums, as the port's block kernel and query-tiled pair do.

    ``stats``: the forward's (B, H, Lq, 2) row max and sum (``row_stats``),
    taken for P = exp(s - m) / l in place of forming them again, as the
    tensor-core pair takes the forward kernel's."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    acc = _acc_dtype(q.dtype)
    qa, ka, va, doa = (t.to(acc) for t in (q, k, v, do))
    s = _scores(q, k, key_mask, scale)
    if stats is None:
        s = s - s.amax(dim=-1, keepdim=True)
        e = torch.exp(s)
        p = e / e.sum(dim=-1, keepdim=True)
    else:
        stats = stats.to(acc)
        p = torch.exp(s - stats[..., :1]) / stats[..., 1:]
    pc = p.to(do.dtype).to(acc)
    dv = torch.einsum("bhqk,bhqd->bhkd", pc, doa)
    dp = torch.einsum("bhqd,bhkd->bhqk", doa, va)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsc = ds.to(k.dtype).to(acc)
    dq = torch.einsum("bhqk,bhkd->bhqd", dsc, ka) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", dsc, qa) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _lib():
    lib = _cuda.library("sdpa_fwd")
    if not getattr(lib, "_smtc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.smtc_sdpa_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                      ctypes.c_float, i, i, p]
        lib.smtc_sdpa_fwd.restype = i
        lib.smtc_sdpa_max_lk.argtypes = []
        lib.smtc_sdpa_max_lk.restype = i
        lib._smtc_typed = True
    return lib


def _bwd_lib():
    lib = _cuda.library("sdpa_bwd")
    if not getattr(lib, "_smtc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.smtc_sdpa_bwd.argtypes = [p] * 10 + [i, i, i, i, i, ctypes.c_float,
                                                  i, i, i, p]
        lib.smtc_sdpa_bwd_scratch_floats.argtypes = [i, i, i, i]
        lib.smtc_sdpa_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.smtc_sdpa_bwd.restype = i
        lib.smtc_sdpa_bwd_fits.argtypes = [i, i, i]
        lib.smtc_sdpa_bwd_fits.restype = i
        lib._smtc_typed = True
    return lib


def bwd_scratch(b: int, h: int, lq: int, lk: int, device) -> torch.Tensor:
    """The backward kernels' float32 scratch on the CUDA ``device``, of the
    size the kernels' library gives (``sdpa_bwd_scratch_floats`` of
    ``csrc/sdpa_bwd_core.cuh``): the query-tiled pairs' max, sum and
    rowsum(dP P) per query row, then, for at most four query rows, the row
    pair's score and dP per (query row, key), which its score pass writes and
    its column pass reads. Allocated on the current stream, where both of the
    row pair's launches run."""
    n = _bwd_lib().smtc_sdpa_bwd_scratch_floats(b, h, lq, lk)
    return torch.empty(n, dtype=torch.float32, device=device)


def backward_fits(lq: int, lk: int, d: int) -> bool:
    """Whether the backward kernels take this shape: the row pair (at
    most 4 query rows), the block kernel (the whole (Lq, Lk) problem in
    shared memory) or the query-tiled pair, which takes any Lq and every Lk
    the forward takes, so this is false only beyond ``max_key_length()``."""
    return bool(_bwd_lib().smtc_sdpa_bwd_fits(lq, lk, d))


def max_key_length() -> int:
    """Longest key sequence the kernel takes: a block holds its rows of
    scores in shared memory."""
    return _lib().smtc_sdpa_max_lk()


def tc_pair_takes(q, k, v) -> bool:
    """Whether the backward runs a tensor-core pair, which reads the
    forward's row statistics, for these inputs (``csrc/sdpa_bwd_core.cuh``'s
    ``sdpa_bwd_tc_fits`` for contiguous tensors): bfloat16 or float32, more
    than 4 query rows, head dim 32 or 64, every operand 16-byte aligned (the
    outputs are fresh allocations)."""
    lq, d = q.shape[2], q.shape[3]
    return (q.dtype in (torch.bfloat16, torch.float32) and lq > 4 and d in (32, 64)
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def sdpa_fwd_cuda(q, k, v, key_mask, scale: float, with_stats: bool = False):
    """Launch the forward kernel (TPU kernels 1 and 3). q: (B, H, Lq, D),
    k/v: (B, H, Lk, D), contiguous CUDA tensors of one dtype (float32 or
    bfloat16); key_mask: None or (B, Lk) int32 on the same device. Returns
    o: (B, H, Lq, D), or with ``with_stats`` (o, stats): each query row's
    float32 max and sum, (B, H, Lq, 2), which only the tensor-core kernels
    form (bf16 or float32, head dim 32 or 64, more than 4 query rows; the
    library refuses the call where another kernel runs)."""
    if q.device.type != "cuda":
        raise ValueError(f"sdpa_fwd_cuda needs CUDA tensors, got {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("sdpa_fwd_cuda returns no gradient: call sdpa(), "
                           "whose autograd function launches the backward kernel")
    _check_qkv(q, k, v, key_mask, "sdpa")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dtype = str(q.dtype).removeprefix("torch.")
    lib = _lib()
    if lk > lib.smtc_sdpa_max_lk():
        raise ValueError(f"sdpa kernel: Lk={lk} exceeds its shared-memory row "
                         f"of {lib.smtc_sdpa_max_lk()} keys")
    out = torch.empty_like(q)
    stats = (torch.empty(b, h, lq, 2, dtype=torch.float32, device=q.device)
             if with_stats else None)
    rc = lib.smtc_sdpa_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if key_mask is None else key_mask.data_ptr(), out.data_ptr(),
        None if stats is None else stats.data_ptr(),
        b, h, lq, lk, d, float(scale), _cuda.DTYPE_CODES[dtype],
        q.device.index or 0, _cuda.stream_of(q))
    _cuda.check(lib, rc, "sdpa_fwd")
    launches.add((dtype, b, h, lq, lk, d, key_mask is not None))
    return (out, stats) if with_stats else out


def _check_qkv(q, k, v, key_mask, what):
    """The checks both kernels make of q, k, v and the key mask."""
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
    if min(b, h, lq, lk, d) == 0:
        raise ValueError(f"{what} kernel: empty input")


BWD_KERNELS = {"auto": 0, "tiled": 1, "block": 2}


def sdpa_bwd_cuda(q, k, v, key_mask, do, scale: float, kernel: str = "auto",
                  stats=None):
    """Launch the backward kernels (TPU kernels 2 and 4): (dq, dk, dv) for
    the output gradient ``do``. Takes what ``sdpa_fwd_cuda`` takes, plus a
    contiguous ``do`` shaped like q. ``kernel="auto"`` picks the kernel by
    shape (at head dims 32 and 64 the tensor-core query-tiled pair);
    ``"tiled"`` asks for a query-tiled pair and ``"block"`` for the block
    kernel at any shape it holds, to time them against each other.
    ``stats``: the forward kernel's row statistics (``sdpa_fwd_cuda(...,
    with_stats=True)``), which a tensor-core pair reads instead of running
    the forward kernel for them (the library refuses them where another
    kernel runs); the gradients are the same, bit for bit."""
    if q.device.type != "cuda":
        raise ValueError(f"sdpa_bwd_cuda needs CUDA tensors, got {q.device}")
    _check_qkv(q, k, v, key_mask, "sdpa_bwd")
    if (do.shape != q.shape or do.dtype != q.dtype or do.device != q.device
            or not do.is_contiguous()):
        raise ValueError("do must be a contiguous tensor shaped and typed like q")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dtype = str(q.dtype).removeprefix("torch.")
    lib = _bwd_lib()
    if not lib.smtc_sdpa_bwd_fits(lq, lk, d):
        raise ValueError(f"sdpa backward kernel: (Lq, Lk, D) = ({lq}, {lk}, {d}) "
                         "does not fit one block's shared memory")
    if kernel not in BWD_KERNELS:
        raise ValueError(f"sdpa_bwd_cuda kernel {kernel!r}: one of {tuple(BWD_KERNELS)}")
    if stats is not None:
        if (tuple(stats.shape) != (b, h, lq, 2) or stats.dtype != torch.float32
                or stats.device != q.device or not stats.is_contiguous()):
            raise ValueError("stats must be the forward's contiguous (B, H, Lq, 2) "
                             "float32 row statistics")
        if do.data_ptr() % 16:
            do = do.clone()  # the tensor-core pair reads it by TMA: 16-byte aligned
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scratch = bwd_scratch(b, h, lq, lk, q.device)
    rc = lib.smtc_sdpa_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if key_mask is None else key_mask.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
        None if stats is None else stats.data_ptr(),
        b, h, lq, lk, d, float(scale), _cuda.DTYPE_CODES[dtype], BWD_KERNELS[kernel],
        q.device.index or 0, _cuda.stream_of(q))
    _cuda.check(lib, rc, "sdpa_bwd")
    bwd_launches.add((dtype, b, h, lq, lk, d, key_mask is not None))
    return dq, dk, dv


class _SdpaFunction(torch.autograd.Function):
    """``sdpa`` with a gradient: the kernels on CUDA, the plain versions on
    the CPU. Saves its inputs, as the JAX residuals do, and on CUDA, where
    the backward runs a tensor-core pair, the forward kernel's row
    statistics ((B, H, Lq, 2) float32: each query row's max and sum), which
    the pair reads in place of forming them again."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, scale):
        ctx.scale = scale
        stats = None
        if q.device.type == "cpu":
            out = sdpa_reference(q, k, v, key_mask, scale)
        elif any(ctx.needs_input_grad[:3]) and tc_pair_takes(q, k, v):
            out, stats = sdpa_fwd_cuda(q, k, v, key_mask, scale, with_stats=True)
        else:
            out = sdpa_fwd_cuda(q, k, v, key_mask, scale)
        ctx.save_for_backward(q, k, v, key_mask, stats)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, stats = ctx.saved_tensors
        do = do.contiguous()  # the head transpose of Attention hands a strided one
        if q.device.type == "cpu":
            grads = sdpa_bwd_reference(q, k, v, key_mask, do, ctx.scale)
        else:
            grads = sdpa_bwd_cuda(q, k, v, key_mask, do, ctx.scale, stats=stats)
        return (*grads, None, None)


@torch.library.custom_op("smtc::sdpa_fwd", mutates_args=(), device_types="cuda")
def sdpa_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                key_mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """``sdpa_fwd_cuda`` as the ``torch.library`` op ``smtc::sdpa_fwd``, the
    node ``torch.export`` records for the forward kernel (a traced tensor
    has no ``data_ptr``). Its CUDA implementation launches the kernel (and
    counts it); it has no CPU one."""
    return sdpa_fwd_cuda(q, k, v, key_mask, scale)


@sdpa_fwd_op.register_fake
def _sdpa_fwd_fake(q, k, v, key_mask, scale):
    return torch.empty_like(q)


def sdpa(q, k, v, key_mask=None, scale: Optional[float] = None,
         impl: str = "auto"):
    """Fused SDPA. ``impl``: one of ``IMPLS``, the JAX package's names.

    On a CUDA tensor every name but "jnp" launches the kernels (there is no
    interpret mode on the card): the forward now, the backward when a
    gradient is asked for. On a CPU tensor they are the plain versions.
    "jnp" is the plain forward with PyTorch's autograd. A CUDA call that
    needs a gradient at a shape the backward kernels do not take (a key
    row longer than the forward's) raises here, before the forward."""
    if impl not in IMPLS:
        raise ValueError(f"unknown sdpa impl {impl!r}; expected one of {IMPLS}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "jnp":
        return sdpa_reference(q, k, v, key_mask, scale)
    if key_mask is not None:
        key_mask = key_mask.to(torch.int32).contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.compiler.is_exporting():
        # torch.export (cli/export.py): the kernel as its op node on CUDA,
        # the plain forward on the CPU
        if q.device.type == "cuda":
            return sdpa_fwd_op(q, k, v, key_mask, scale)
        return sdpa_reference(q, k, v, key_mask, scale)
    if (q.device.type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))
            and not backward_fits(q.shape[2], k.shape[2], q.shape[3])):
        raise ValueError(f"sdpa: a gradient is needed at (Lq, Lk, D) = "
                         f"({q.shape[2]}, {k.shape[2]}, {q.shape[3]}), which the "
                         "backward kernels do not take")
    return _SdpaFunction.apply(q, k, v, key_mask, scale)

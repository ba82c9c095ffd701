"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernels have no CPU
mode) and skips without one. The file imports no JAX, so it also runs on a
host that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

Shapes go beyond the serving path's: ragged key tiles, several query tiles,
the bf16 tensor-core kernel at each head dim it is built for and at its
longest key row, the FMA kernel (float32, other head dims, the longest key
row it holds), the row kernel (at most 4 query rows) with and without a
mask, a fully masked row, the block kernel at a narrow width, and ViLT's
joint lengths (402 with a ragged last query tile, 185, and 296 = 2 x 128 + 40,
the JAX blocked kernel's padded tail). Tolerances: float32 1e-4 of the
output's scale (another summation order); bfloat16 2e-2 of it (the plain
version rounds its score product to bfloat16 where the kernels keep float32).

The backward kernels are held against their plain versions
(``sdpa_bwd_reference``, ``attn_block_bwd_reference``, op-for-op mirrors of
the JAX kernels with the same rounding points) at tiny shapes and at the
training path's (text 32x12x128x64 bf16 masked, the fusion head's one
768-wide query over 197 keys in float32, the fused block at 32x128x768 with
12 heads), and the query-tiled pair at the lengths the block kernel cannot
hold (296, 185, 402, the longest key row, ragged and wide head dims), the
tensor-core pair at its edges (Lq != Lk both ways, a fully masked row at
402, head dims 32 and 128), the query-tiled pair asked for at the block
kernel's own shape and the block kernel asked for at the pair's, every
gradient, with the same tolerances against each gradient's scale; and
autograd round trips through ``sdpa`` and ``attn_block`` (at 128 and at
ViLT's 402) show that the gradient on the card comes from the backward
kernels.

The per-head block (``impl="fused_perhead"``, kernels 5 and 6) is held the
same way: its forward, its backward kernel's dx and head-banked dq, dk, dv
and ctx, and the ten gradients through autograd, against the plain per-head
versions, from head dim 8 to ViLT's L = 402.
"""

import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attention as A
from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attn_block as AB

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _tol(ref, dtype):
    return (1e-4 if dtype == torch.float32 else 2e-2) * max(1.0, ref.abs().max().item())


def _mask(gen, b, lk, empty_row):
    lens = torch.randint(1, lk + 1, (b,), generator=gen, device="cuda")
    mask = (torch.arange(lk, device="cuda")[None] < lens[:, None]).to(torch.int32)
    if empty_row:
        mask[0] = 0
    return mask


SDPA_CASES = {
    # name: (b, h, lq, lk, d, masked, one fully masked row)
    "tiled_small": (2, 3, 16, 24, 8, True, False),
    "tiled_ragged": (3, 2, 37, 70, 40, True, True),
    "tiled_many_tiles": (2, 2, 65, 129, 64, False, False),
    "tiled_wide_head": (1, 2, 40, 50, 200, True, False),
    "tiled_longest_row": (1, 1, 33, 1600, 64, True, False),
    "mma_ragged": (2, 3, 70, 129, 64, True, True),
    "mma_head32": (2, 2, 65, 40, 32, True, False),
    "mma_head128": (2, 2, 80, 100, 128, False, False),
    "mma_long_row": (1, 2, 70, 768, 64, True, False),
    "row_fusion": (3, 1, 1, 197, 768, False, False),
    "row_masked": (2, 3, 4, 70, 64, True, True),
    "row_single_key": (2, 1, 1, 1, 8, False, False),
    "vilt_exact": (2, 3, 402, 402, 64, True, False),
    "blocked_tail": (2, 2, 296, 296, 64, True, False),
    # the tensor-core kernel's edges: Lq != Lk both ways, ragged tiles, a
    # fully masked row at 402, an odd number of key tiles
    "tc_short_q_long_k": (2, 3, 70, 402, 64, True, True),
    "tc_long_q_short_k": (2, 3, 402, 37, 64, True, False),
    "tc_vilt_masked_row": (2, 3, 402, 402, 64, True, True),
    "tc_head32_odd_tiles": (2, 2, 130, 321, 32, True, True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", sorted(SDPA_CASES))
def test_sdpa_kernel_matches_plain(cuda, case, dtype):
    b, h, lq, lk, d, masked, empty = SDPA_CASES[case]
    q = torch.randn(b, h, lq, d, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(b, h, lk, d, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(b, h, lk, d, generator=cuda, device="cuda").to(dtype)
    mask = _mask(cuda, b, lk, empty) if masked else None
    before = A.launches.count
    out = A.sdpa(q, k, v, mask)
    assert A.launches.count == before + 1
    ref = A.sdpa(q, k, v, mask, impl="jnp")
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= _tol(ref.float(), dtype)
    if empty:  # a fully masked row attends uniformly
        uniform = v[0].float().mean(dim=1, keepdim=True).expand(h, lq, d)
        assert (out[0].float() - uniform).abs().max().item() <= _tol(uniform, dtype)


def test_sdpa_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.zeros(1, 1, 4, 8, device="cuda")
    too_long = torch.zeros(1, 1, A.max_key_length() + 1, 8, device="cuda")
    with pytest.raises(ValueError, match="exceeds"):
        A.sdpa(x, too_long, too_long)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        A.sdpa(x.half(), x.half(), x.half())


BLOCK_CASES = {
    # name: (b, l, hidden, heads, masked)
    "text_width": (2, 128, 768, 12, True),
    "image_width": (2, 197, 768, 12, False),
    "narrow_ragged": (3, 37, 64, 2, True),
    "vilt_exact": (2, 402, 768, 12, True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_attn_block_kernel_matches_plain(cuda, case, dtype):
    b, l, hid, heads, masked = BLOCK_CASES[case]
    x = torch.randn(b, l, hid, generator=cuda, device="cuda").to(dtype)
    params = []
    for _ in range(4):
        params.append((torch.randn(hid, hid, generator=cuda, device="cuda")
                       * hid ** -0.5).to(dtype))
        params.append((0.1 * torch.randn(hid, generator=cuda, device="cuda")).to(dtype))
    mask = _mask(cuda, b, l, False) if masked else None
    before = AB.launches.count
    out = AB.attn_block(x, mask, *params, heads=heads)
    assert AB.launches.count == before + 1
    ref = AB.attn_block(x, mask, *params, heads=heads, impl="jnp")
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == x.shape
    assert (out.float() - ref.float()).abs().max().item() <= _tol(ref.float(), dtype)


def test_attn_block_takes_linear_weight_views(cuda):
    """``models/encoder.py`` passes ``linear.weight.t()``: the kernel reads
    the Linear's own (out, in) storage, transposed back without a copy."""
    lin = torch.nn.Linear(64, 64, device="cuda")
    x = torch.randn(2, 8, 64, generator=cuda, device="cuda")
    w, b = lin.weight.t(), lin.bias
    out = AB.attn_block(x, None, w, b, w, b, w, b, w, b, heads=2)
    ref = AB.attn_block(x, None, w, b, w, b, w, b, w, b, heads=2, impl="jnp")
    assert (out - ref).abs().max().item() <= 1e-4


SDPA_BWD_CASES = {
    # name: (b, h, lq, lk, d, masked, one fully masked row)
    "block_small": (2, 3, 16, 24, 8, True, False),
    "block_ragged": (3, 2, 37, 70, 40, True, True),
    "block_many_tiles": (2, 2, 65, 100, 64, False, False),
    "block_text_path": (32, 12, 128, 128, 64, True, True),
    "row_fusion_path": (32, 1, 1, 197, 768, False, False),
    "row_masked": (2, 3, 4, 70, 64, True, True),
    "row_single_key": (2, 1, 1, 1, 8, False, False),
    "tiled_blocked_tail": (2, 2, 296, 296, 64, True, False),
    "tiled_vilt_fixed": (2, 3, 185, 185, 64, True, True),
    "tiled_vilt_exact": (2, 3, 402, 402, 64, True, False),
    "tiled_ragged": (3, 2, 150, 70, 40, True, True),
    "tiled_wide_head": (1, 2, 130, 50, 200, True, False),
    "tiled_longest_row": (1, 1, 40, 1600, 64, True, False),
    # the tensor-core pair's edges: Lq != Lk both ways, a fully masked row at
    # 402, head dims 32 and 128 (128: the FMA kernels), a ragged last tile
    "tc_short_q_long_k": (2, 3, 70, 402, 64, True, True),
    "tc_long_q_short_k": (2, 3, 402, 37, 64, True, False),
    "tc_vilt_masked_row": (2, 3, 402, 402, 64, True, True),
    "tc_head32": (2, 3, 150, 201, 32, True, True),
    "tc_head128": (2, 3, 150, 201, 128, True, False),
    "tc_five_rows": (2, 2, 5, 130, 64, True, False),
}


def _close(out, ref, dtype, what):
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all(), what
    err = (out - ref).abs().max().item()
    assert err <= _tol(ref, dtype), (what, err, _tol(ref, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", sorted(SDPA_BWD_CASES))
def test_sdpa_bwd_kernel_matches_plain(cuda, case, dtype):
    b, h, lq, lk, d, masked, empty = SDPA_BWD_CASES[case]
    q = torch.randn(b, h, lq, d, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(b, h, lk, d, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(b, h, lk, d, generator=cuda, device="cuda").to(dtype)
    do = torch.randn(b, h, lq, d, generator=cuda, device="cuda").to(dtype)
    mask = _mask(cuda, b, lk, empty) if masked else None
    scale = d ** -0.5
    before = A.bwd_launches.count
    got = A.sdpa_bwd_cuda(q, k, v, mask, do, scale)
    assert A.bwd_launches.count == before + 1
    want = A.sdpa_bwd_reference(q, k, v, mask, do, scale)
    torch.cuda.synchronize()
    for name, g, r, x in zip("qkv", got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape
        _close(g, r, dtype, f"d{name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", ["block_ragged", "block_text_path"])
def test_sdpa_bwd_tiled_pair_at_block_shapes(cuda, case, dtype):
    """The query-tiled pair, asked for where the block kernel would run."""
    b, h, lq, lk, d, masked, empty = SDPA_BWD_CASES[case]
    q, k, v, do = (torch.randn(b, h, n, d, generator=cuda, device="cuda").to(dtype)
                   for n in (lq, lk, lk, lq))
    mask = _mask(cuda, b, lk, empty) if masked else None
    got = A.sdpa_bwd_cuda(q, k, v, mask, do, d ** -0.5, kernel="tiled")
    want = A.sdpa_bwd_reference(q, k, v, mask, do, d ** -0.5)
    torch.cuda.synchronize()
    for name, g, r in zip("qkv", got, want):
        _close(g, r, dtype, f"d{name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", ["block_many_tiles", "block_text_path"])
def test_sdpa_bwd_block_kernel_asked_for(cuda, case, dtype):
    """The block kernel, asked for where the tensor-core pair runs (bf16)."""
    b, h, lq, lk, d, masked, empty = SDPA_BWD_CASES[case]
    q, k, v, do = (torch.randn(b, h, n, d, generator=cuda, device="cuda").to(dtype)
                   for n in (lq, lk, lk, lq))
    mask = _mask(cuda, b, lk, empty) if masked else None
    got = A.sdpa_bwd_cuda(q, k, v, mask, do, d ** -0.5, kernel="block")
    want = A.sdpa_bwd_reference(q, k, v, mask, do, d ** -0.5)
    torch.cuda.synchronize()
    for name, g, r in zip("qkv", got, want):
        _close(g, r, dtype, f"d{name}")


BLOCK_BWD_CASES = {
    # name: (b, l, hidden, heads, masked)
    "narrow": (2, 16, 64, 2, True),
    "ragged": (3, 37, 96, 3, False),
    "text_path": (32, 128, 768, 12, True),
    "vilt_exact": (2, 402, 768, 12, True),
}


def _block_inputs(gen, b, l, hid, heads, masked, dtype, grad=False):
    x = torch.randn(b, l, hid, generator=gen, device="cuda").to(dtype)
    params = []
    for _ in range(4):
        params.append((torch.randn(hid, hid, generator=gen, device="cuda")
                       * hid ** -0.5).to(dtype))
        params.append((0.1 * torch.randn(hid, generator=gen, device="cuda")).to(dtype))
    mask = _mask(gen, b, l, False) if masked else None
    do = torch.randn(b, l, hid, generator=gen, device="cuda").to(dtype)
    if grad:
        x.requires_grad_(True)
        for p in params:
            p.requires_grad_(True)
    return x, mask, params, do


def _term_scales(x, dq, dk, dv, ctx, do):
    """The scale of each weight and bias gradient as the size of its terms:
    |a|^T |g| and the sum of |g| over the B*L rows. These sums cancel (the
    exact bias gradient of the keys is zero, since each row of dS sums to
    zero), so a tolerance against the size of the result would be one
    against rounding noise."""
    h = x.shape[-1]

    def w(a, g):
        return a.reshape(-1, h).float().abs().t() @ g.reshape(-1, h).float().abs()

    def b(g):
        return g.float().abs().sum(dim=(0, 1))

    return (w(x, dq), b(dq), w(x, dk), b(dk), w(x, dv), b(dv), w(ctx, do), b(do))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", sorted(BLOCK_BWD_CASES))
def test_attn_block_bwd_round_trip_matches_plain(cuda, case, dtype):
    """The gradient of ``attn_block`` on the card: one backward-kernel
    launch; the kernel's dx, dq, dk, dv and ctx against the plain kernel
    body, and all ten gradients against the plain backward (the weight and
    bias gradients against the size of their terms)."""
    b, l, hid, heads, masked = BLOCK_BWD_CASES[case]
    x, mask, params, do = _block_inputs(cuda, b, l, hid, heads, masked, dtype, grad=True)
    fwd0, bwd0 = AB.launches.count, AB.bwd_launches.count
    out = AB.attn_block(x, mask, *params, heads=heads)
    assert out.grad_fn is not None
    out.backward(do)
    assert (AB.launches.count, AB.bwd_launches.count) == (fwd0 + 1, bwd0 + 1)
    plain = [p.detach() for p in params]
    packed = AB.attn_block_bwd_packed_reference(x.detach(), mask, *plain[:7], do, heads)
    got = AB.attn_block_bwd_cuda(x.detach(), mask, *plain[:7], do, heads, (hid // heads) ** -0.5)
    want = AB.attn_block_bwd_reference(x.detach(), mask, *plain, do, heads)
    torch.cuda.synchronize()
    for name, g, r in zip(("dx", "dq", "dk", "dv", "ctx"), got, packed):
        _close(g, r, dtype, name)
    assert want[1] is None and len(want) == 10
    _close(x.grad, want[0], dtype, "dx")
    scales = _term_scales(x.detach(), *packed[1:], do)
    names = ["wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo"]
    for name, t, r, sc in zip(names, params, want[2:], scales):
        err = (t.grad.float() - r.float()).abs().max().item()
        tol = (1e-4 if dtype == torch.float32 else 2e-2) * max(1.0, sc.max().item())
        assert torch.isfinite(t.grad).all() and err <= tol, ("d" + name, err, tol)


@pytest.mark.parametrize("length", [128, 402])
def test_sdpa_round_trip_launches_the_backward_kernel(cuda, length):
    q, k, v = (torch.randn(4, 12, length, 64, generator=cuda, device="cuda")
               .bfloat16().requires_grad_(True) for _ in range(3))
    mask = _mask(cuda, 4, length, True)
    do = torch.randn(4, 12, length, 64, generator=cuda, device="cuda").bfloat16()
    before = A.bwd_launches.count
    out = A.sdpa(q, k, v, mask)
    assert out.grad_fn is not None
    out.backward(do)
    assert A.bwd_launches.count == before + 1
    want = A.sdpa_bwd_reference(q.detach(), k.detach(), v.detach(), mask, do, 64 ** -0.5)
    for t, r in zip((q, k, v), want):
        _close(t.grad, r, torch.bfloat16, "round trip")


def test_backward_takes_every_length_the_forward_takes(cuda):
    longest = A.max_key_length()
    assert A.backward_fits(402, 402, 64) and A.backward_fits(185, 185, 64)
    assert A.backward_fits(4096, longest, 64)
    assert not A.backward_fits(8, longest + 1, 64)
    q = torch.zeros(1, 1, 8, 64, device="cuda", requires_grad=True)
    kv = torch.zeros(1, 1, longest + 1, 64, device="cuda", requires_grad=True)
    with pytest.raises(ValueError, match="do not take"):
        A.sdpa(q, kv, kv)


def test_raw_wrappers_refuse_inputs_that_need_a_gradient(cuda):
    q = torch.randn(1, 1, 8, 8, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        A.sdpa_fwd_cuda(q, q, q, None, 1.0)
    x = torch.randn(1, 8, 16, device="cuda", requires_grad=True)
    w, b = torch.zeros(16, 16, device="cuda"), torch.zeros(16, device="cuda")
    with pytest.raises(RuntimeError, match="no gradient"):
        AB.attn_block_cuda(x, None, w, b, w, b, w, b, w, b, 2, 1.0)
    with pytest.raises(RuntimeError, match="no gradient"):
        AB.attn_block_perhead_cuda(x, None, w, b, w, b, w, b, w, b, 2, 1.0)


PERHEAD_CASES = {
    # name: (b, l, hidden, heads, masked)
    "head_dim_8": (2, 20, 16, 2, True),
    "narrow": (2, 16, 64, 2, True),
    "ragged": (3, 37, 96, 3, False),
    "text_path": (32, 128, 768, 12, True),
    "vilt_exact": (2, 402, 768, 12, True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", sorted(PERHEAD_CASES))
def test_attn_block_perhead_round_trip_matches_plain(cuda, case, dtype):
    """``attn_block(impl="fused_perhead")`` on the card: one launch of each
    per-head kernel; the forward against ``attn_block_perhead_reference``,
    the backward kernel's dx and banked dq, dk, dv, ctx against the plain
    kernel body, the ten gradients against the plain backward."""
    b, l, hid, heads, masked = PERHEAD_CASES[case]
    x, mask, params, do = _block_inputs(cuda, b, l, hid, heads, masked, dtype, grad=True)
    fwd0, bwd0 = AB.perhead_launches.count, AB.perhead_bwd_launches.count
    out = AB.attn_block(x, mask, *params, heads=heads, impl="fused_perhead")
    out.backward(do)
    assert (AB.perhead_launches.count, AB.perhead_bwd_launches.count) == (fwd0 + 1, bwd0 + 1)
    plain = [p.detach() for p in params]
    _close(out, AB.attn_block_perhead_reference(x.detach(), mask, *plain, heads), dtype, "out")
    banked = AB.attn_block_perhead_bwd_banked_reference(x.detach(), mask, *plain[:7], do, heads)
    got = AB.attn_block_perhead_bwd_cuda(x.detach(), mask, *plain[:7], do, heads,
                                         (hid // heads) ** -0.5)
    want = AB.attn_block_perhead_bwd_reference(x.detach(), mask, *plain, do, heads)
    torch.cuda.synchronize()
    for name, g, r in zip(("dx", "dq", "dk", "dv", "ctx"), got, banked):
        assert g.shape == r.shape, name
        _close(g, r, dtype, name)
    _close(x.grad, want[0], dtype, "dx")
    merged = [AB._merge_heads(t) for t in banked[1:]]
    scales = _term_scales(x.detach(), *merged, do)
    names = ["wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo"]
    for name, t, r, sc in zip(names, params, want[2:], scales):
        err = (t.grad.float() - r.float()).abs().max().item()
        tol = (1e-4 if dtype == torch.float32 else 2e-2) * max(1.0, sc.max().item())
        assert torch.isfinite(t.grad).all() and err <= tol, ("d" + name, err, tol)

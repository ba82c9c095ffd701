"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernels have no CPU
mode) and skips without one. The file imports no JAX, so it also runs on a
host that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

Shapes go beyond the serving path's: ragged key tiles, several query tiles,
the bf16 tensor-core kernel at each head dim it is built for and at its
longest key row, the FMA kernel (other head dims, the longest key row it
holds), the row kernel (at most 4 query rows) with and without a
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
gradient, with the same tolerances against each gradient's scale (also
the image-only runner's trained ViT and DeiT: the tensor-core pair at
16x12x197x197x64 and 198, unmasked; the fused block's backward at 16x197
and 16x198 x768, its TN weight gradients over 3,152 and 3,168 rows); and
autograd round trips through ``sdpa`` and ``attn_block`` (at 128 and at
ViLT's 402) show that the gradient on the card comes from the backward
kernels.

The bf16 forward and backward on wgmma fed by TMA are held at their branch
points: Lk = 197 (200 columns), 256 (one window), 257 and 402 (two sweeps of
128-key windows), Lq != Lk (36 x 128 and 128 x 36), a fully masked row, head
dims 32 and 128 in the forward, the fused block's packed (B, L, H * D)
column slices at 257; the backward given the forward's row statistics equals
the one that forms them, and two backward runs agree, bit for bit; the
autograd function hands its forward's statistics to the backward.

The float32 forward and backward on the tensor cores (three tf32 passes a
product) are held at their own branch points: a row of one 64-key chunk and
of several, 197 keys (three chunks and an 8-key piece), 402, a fully masked
row, Lq != Lk both ways, five query rows, head dim 32, and the per-head
block's packed column slices at 197; against the plain float32 version
(1e-4 of the scale) and against float64 (at most 4x the plain float32
version's error, ``chip_smoke.py``'s gate); their row statistics against
``row_stats``; the backward given the statistics equals the one that forms
them, and two runs, bit for bit.

The per-head block (``impl="fused_perhead"``, kernels 5 and 6) is held the
same way: its forward, its backward kernel's dx and head-banked dq, dk, dv
and ctx, and the ten gradients through autograd, against the plain per-head
versions, from head dim 8 to ViLT's L = 402.

The SDPA backward's row pair (at most 4 query rows) is held at head dims 8
to 768, one key to the longest key row it takes, masked, with a fully masked
row, with and without ctx, and its column blocks must agree bit for bit. The
bf16 NT GEMM of kernels 5-8 (wgmma fed by TMA) is held alone at M of 1 to
12,864 rows (ragged), hidden 16, 64 and 768, one and three weights, without a
bias and head-banked, each element within one bf16 step (plus 1e-3) of the
plain version's f32 sum; a shape TMA cannot describe is refused. Its NN
orientation (dctx and dx of kernel 8, the weight read MN-major) and TN
orientation (the weight gradients, both operands MN-major, K cut into
slices) are held the same way at M (NN) or K rows (TN) of 1, 63, 64, 65,
3,152, 3,168, 4,096 and 12,864 and widths 768 and 2,304; two TN runs with the K rows cut
into slices agree bit for bit, and misaligned or odd-width operands are
refused before any launch.
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
    # the wgmma kernel's branch points: the whole row in one window up to 256
    # keys (197 keys as 200 columns, 256 the last), two sweeps of 128-key
    # windows from 257, Lq != Lk (LXMERT's 36 x 128 and 128 x 36), a fully
    # masked row, head dims 32 and 128
    "wg_lk197": (2, 3, 197, 197, 64, True, False),
    "wg_lk197_masked_row": (2, 3, 197, 197, 64, True, True),
    "wg_lk256": (2, 3, 100, 256, 64, True, False),
    "wg_lk257": (2, 3, 100, 257, 64, True, True),
    "wg_lk402": (2, 3, 130, 402, 64, False, False),
    "wg_lxmert_36x128": (4, 12, 36, 128, 64, True, False),
    "wg_lxmert_128x36": (4, 12, 128, 36, 64, False, False),
    "wg_head32_197": (2, 3, 197, 197, 32, True, True),
    "wg_head32_257": (2, 2, 70, 257, 32, True, False),
    "wg_head128_197": (2, 3, 197, 197, 128, True, False),
    "wg_head128_402": (2, 2, 70, 402, 128, True, True),
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
    # the packed (B, L, H * D) column slices at the first two-sweep length
    "wg_packed_257": (2, 257, 768, 12, True),
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
    # the image-only runner's trained towers, unmasked: ViT-B/16 and DeiT-B/16
    "tc_image_train": (16, 12, 197, 197, 64, False, False),
    "tc_deit_train": (16, 12, 198, 198, 64, False, False),
    # the wgmma pair's branch points: the forward's one window (197, 256) and
    # two sweeps (257) for the stats, Lq != Lk, a fully masked row, head dim 32
    "wg_bwd_lk197_masked_row": (2, 3, 197, 197, 64, True, True),
    "wg_bwd_lk256": (2, 3, 130, 256, 64, True, False),
    "wg_bwd_lk257": (2, 3, 130, 257, 64, True, True),
    "wg_bwd_36x128": (4, 12, 36, 128, 64, True, False),
    "wg_bwd_128x36": (4, 12, 128, 36, 64, False, False),
    "wg_bwd_head32_197": (2, 3, 197, 197, 32, True, False),
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
    # name: (b, l, hidden, heads, masked); "empty" masks the first row fully.
    # Up to four tokens the SDPA backward runs the row pair, which writes ctx.
    "narrow": (2, 16, 64, 2, True),
    "ragged": (3, 37, 96, 3, False),
    "text_path": (32, 128, 768, 12, True),
    "vilt_exact": (2, 402, 768, 12, True),
    "row_pair_four_tokens": (2, 4, 64, 2, True),
    "row_pair_two_tokens_head768": (4, 2, 768, 1, True),
    "row_pair_one_token": (3, 1, 64, 1, False),
    "row_pair_masked_row": (3, 3, 96, 3, "empty"),
    # the image-only runner's ViT / DeiT under --attn_impl fused: 3,152 and
    # 3,168 rows, no multiple of the GEMMs' 128-row tile
    "image_train": (16, 197, 768, 12, False),
    "deit_train": (16, 198, 768, 12, False),
    # the packed column slices where the forward run inside the backward takes
    # two sweeps
    "wg_packed_257": (2, 257, 768, 12, True),
}


def _block_inputs(gen, b, l, hid, heads, masked, dtype, grad=False):
    x = torch.randn(b, l, hid, generator=gen, device="cuda").to(dtype)
    params = []
    for _ in range(4):
        params.append((torch.randn(hid, hid, generator=gen, device="cuda")
                       * hid ** -0.5).to(dtype))
        params.append((0.1 * torch.randn(hid, generator=gen, device="cuda")).to(dtype))
    mask = _mask(gen, b, l, masked == "empty") if masked else None
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
    fwd0, bwd0, tn0 = AB.launches.count, AB.bwd_launches.count, AB.wgrad_launches.count
    out = AB.attn_block(x, mask, *params, heads=heads)
    assert out.grad_fn is not None
    out.backward(do)
    assert (AB.launches.count, AB.bwd_launches.count) == (fwd0 + 1, bwd0 + 1)
    # bf16: the four weight gradients in one launch of the TN GEMM
    assert AB.wgrad_launches.count == tn0 + (dtype == torch.bfloat16)
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


STATS_CASES = ["tc_image_train", "wg_bwd_lk197_masked_row", "wg_bwd_lk256", "wg_bwd_lk257",
               "tc_vilt_masked_row", "wg_bwd_36x128", "wg_bwd_128x36", "wg_bwd_head32_197"]


@pytest.mark.parametrize("case", STATS_CASES)
def test_sdpa_bwd_with_forward_stats_is_bit_equal(cuda, case):
    """The forward's row statistics: the output of a forward that writes them
    is the one that does not, m and l match ``row_stats`` (1e-5 relative), and
    the tensor-core pair given them returns the gradients it forms without
    them (running the forward kernel for them), bit for bit; two runs of the
    backward agree bit for bit too."""
    b, h, lq, lk, d, masked, empty = SDPA_BWD_CASES[case]
    q, k, v, do = (torch.randn(b, h, n, d, generator=cuda, device="cuda").bfloat16()
                   for n in (lq, lk, lk, lq))
    mask = _mask(cuda, b, lk, empty) if masked else None
    scale = d ** -0.5
    out, stats = A.sdpa_fwd_cuda(q, k, v, mask, scale, with_stats=True)
    assert torch.equal(out, A.sdpa_fwd_cuda(q, k, v, mask, scale))
    want = A.row_stats(q, k, mask, scale)
    assert stats.shape == (b, h, lq, 2) and stats.dtype == torch.float32
    assert ((stats - want).abs() <= 1e-5 * want.abs()).all()
    given = A.sdpa_bwd_cuda(q, k, v, mask, do, scale, stats=stats)
    formed = A.sdpa_bwd_cuda(q, k, v, mask, do, scale)
    again = A.sdpa_bwd_cuda(q, k, v, mask, do, scale, stats=stats)
    torch.cuda.synchronize()
    for name, x, y, z in zip("qkv", given, formed, again):
        assert torch.equal(x, y), f"d{name}: the forward's stats change the gradient"
        assert torch.equal(x, z), f"d{name}: two runs disagree"


def test_sdpa_stats_refused_where_the_tensor_core_pair_does_not_run(cuda):
    q = torch.randn(1, 2, 4, 64, generator=cuda, device="cuda").bfloat16()  # four rows
    with pytest.raises(RuntimeError, match="CUDA error"):
        A.sdpa_fwd_cuda(q, q, q, None, 0.125, with_stats=True)
    x = torch.randn(1, 2, 40, 128, generator=cuda, device="cuda")  # float32 at head dim 128
    with pytest.raises(RuntimeError, match="CUDA error"):
        A.sdpa_bwd_cuda(x, x, x, None, x, 0.125,
                        stats=torch.zeros(1, 2, 40, 2, device="cuda"))


F32_TC_CASES = {
    # name: (b, h, lq, lk, d, masked, one fully masked row)
    "f32_one_chunk": (2, 3, 100, 37, 64, True, False),
    "f32_text_masked_row": (2, 3, 128, 128, 64, True, True),
    "f32_lk197": (2, 3, 197, 197, 64, False, False),
    "f32_lk197_masked_row": (2, 3, 197, 197, 64, True, True),
    "f32_short_q_long_k": (2, 3, 70, 402, 64, True, True),
    "f32_long_q_short_k": (2, 3, 402, 37, 64, False, False),
    "f32_vilt_exact": (2, 3, 402, 402, 64, True, False),
    "f32_head32": (2, 3, 150, 201, 32, True, True),
    "f32_five_rows": (2, 2, 5, 130, 64, True, False),
}


def _f64_gate(got, plain, want, what):
    """chip_smoke.py's float32 gate: the kernel at most 4x the plain float32
    version's error against float64."""
    err = (got.double() - want).abs().max().item()
    base = (plain.double() - want).abs().max().item()
    assert err <= 4 * base, (what, err, base)


def _f32_inputs(gen, case):
    b, h, lq, lk, d, masked, empty = F32_TC_CASES[case]
    q, k, v, do = (torch.randn(b, h, n, d, generator=gen, device="cuda")
                   for n in (lq, lk, lk, lq))
    return q, k, v, do, _mask(gen, b, lk, empty) if masked else None, d ** -0.5


@pytest.mark.parametrize("case", sorted(F32_TC_CASES))
def test_sdpa_f32_tensor_core_forward(cuda, case):
    """The float32 forward on the tensor cores: its output with and without
    row statistics alike, against the plain float32 version and float64, its
    statistics against ``row_stats``."""
    q, k, v, _, mask, scale = _f32_inputs(cuda, case)
    out, stats = A.sdpa_fwd_cuda(q, k, v, mask, scale, with_stats=True)
    assert torch.equal(out, A.sdpa_fwd_cuda(q, k, v, mask, scale))
    plain = A.sdpa_reference(q, k, v, mask, scale)
    want = A.sdpa_reference(q.double(), k.double(), v.double(), mask, scale)
    torch.cuda.synchronize()
    _close(out, plain, torch.float32, "o")
    _f64_gate(out, plain, want, "o")
    rows = A.row_stats(q, k, mask, scale)
    assert ((stats - rows).abs() <= 1e-5 * rows.abs()).all()


@pytest.mark.parametrize("case", sorted(F32_TC_CASES))
def test_sdpa_f32_tensor_core_backward(cuda, case):
    """The float32 pair: given the forward's statistics it returns what it
    forms without them, and two runs agree, bit for bit; each gradient
    against the plain float32 version and float64."""
    q, k, v, do, mask, scale = _f32_inputs(cuda, case)
    assert A.tc_pair_takes(q, k, v)
    _, stats = A.sdpa_fwd_cuda(q, k, v, mask, scale, with_stats=True)
    given = A.sdpa_bwd_cuda(q, k, v, mask, do, scale, stats=stats)
    formed = A.sdpa_bwd_cuda(q, k, v, mask, do, scale)
    again = A.sdpa_bwd_cuda(q, k, v, mask, do, scale, stats=stats)
    plain = A.sdpa_bwd_reference(q, k, v, mask, do, scale)
    want = A.sdpa_bwd_reference(q.double(), k.double(), v.double(), mask, do.double(), scale)
    torch.cuda.synchronize()
    for name, g, f, a, p, w in zip("qkv", given, formed, again, plain, want):
        assert torch.equal(g, f) and torch.equal(g, a), f"d{name} not bit for bit"
        _close(g, p, torch.float32, f"d{name}")
        _f64_gate(g, p, w, f"d{name}")


def test_sdpa_autograd_passes_the_forward_stats(cuda):
    """``sdpa``'s gradient at the image tower's shape: the forward keeps its
    row statistics and the backward reads them; the gradient is the one the
    pair forms alone, bit for bit."""
    q, k, v = (torch.randn(16, 12, 197, 64, generator=cuda, device="cuda").bfloat16()
               .requires_grad_(True) for _ in range(3))
    do = torch.randn(16, 12, 197, 64, generator=cuda, device="cuda").bfloat16()
    out = A.sdpa(q, k, v)
    assert out.grad_fn.saved_tensors[4] is not None  # the statistics
    out.backward(do)
    want = A.sdpa_bwd_cuda(q.detach(), k.detach(), v.detach(), None, do, 64 ** -0.5)
    for t, w in zip((q, k, v), want):
        assert torch.equal(t.grad, w)


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
    # head dim 64 column slices at 197 keys (the float32 tensor-core kernels'
    # pieces over the packed layout)
    "packed_197": (2, 197, 128, 2, True),
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


ROW_PAIR_CASES = {
    # name: (b, h, lq, lk, d, masked, one fully masked row); ctx, which only
    # the fused blocks ask for, is checked through BLOCK_BWD_CASES' row_pair_*
    "one_row_head8": (3, 2, 1, 197, 8, True, True),
    "two_rows_head64": (2, 3, 2, 197, 64, True, False),
    "three_rows_head768": (2, 1, 3, 197, 768, False, False),
    "four_rows_head64_masked_row": (2, 2, 4, 70, 64, True, True),
    "fusion_head": (32, 1, 1, 197, 768, False, False),
    "fusion_head_masked": (32, 1, 1, 197, 768, True, False),
    "single_key": (2, 1, 1, 1, 8, False, False),
    "single_key_four_rows": (2, 2, 4, 1, 768, True, True),
    "ragged_head": (2, 2, 3, 50, 42, True, False),
    "longest_one_row": (1, 1, 1, 29056, 8, True, False),
    "longest_four_rows": (1, 1, 4, 7264, 64, True, True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", sorted(ROW_PAIR_CASES))
def test_sdpa_bwd_row_pair_matches_plain(cuda, case, dtype):
    """The row pair (at most 4 query rows): dq, dk and dv against the plain
    version, at head dims 8 to 768, 1 to the longest key row it takes,
    masked and with a fully masked row."""
    b, h, lq, lk, d, masked, empty = ROW_PAIR_CASES[case]
    assert A.backward_fits(lq, lk, d)
    q, k, v, do = (torch.randn(b, h, n, d, generator=cuda, device="cuda").to(dtype)
                   for n in (lq, lk, lk, lq))
    mask = _mask(cuda, b, lk, empty) if masked else None
    scale = d ** -0.5
    before = A.bwd_launches.count
    got = A.sdpa_bwd_cuda(q, k, v, mask, do, scale)
    assert A.bwd_launches.count == before + 1
    want = A.sdpa_bwd_reference(q, k, v, mask, do, scale)
    torch.cuda.synchronize()
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == r.shape
        _close(g, r, dtype, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_sdpa_bwd_row_pair_column_blocks_agree(cuda, dtype):
    """Every column block of the row pair forms the row's P and dS itself:
    with head-dim columns 0-127 repeated at 128-255, the blocks that compute
    them must give bit-identical gradients, and, in the fused block's
    backward (one head of 768, two tokens: its SDPA runs in the row pair),
    bit-identical ctx."""
    b, h, lq, lk, d = 4, 1, 2, 197, 768
    q, k, v, do = (torch.randn(b, h, n, d, generator=cuda, device="cuda").to(dtype)
                   for n in (lq, lk, lk, lq))
    for t in (q, k, v, do):
        t[..., 128:256] = t[..., 0:128]
    mask = _mask(cuda, b, lk, False)
    got = A.sdpa_bwd_cuda(q, k, v, mask, do, d ** -0.5)
    torch.cuda.synchronize()
    for name, g in zip(("dq", "dk", "dv"), got):
        assert torch.equal(g[..., 0:128], g[..., 128:256]), name

    x, mask, params, do = _block_inputs(cuda, b, lq, d, 1, True, dtype)
    wq, bq, wk, bk, wv, bv, wo, _ = params  # (in, out): q = x wq + bq
    for w, bias in ((wq, bq), (wk, bk), (wv, bv)):
        w[:, 128:256] = w[:, 0:128]
        bias[128:256] = bias[0:128]
    wo[128:256] = wo[0:128]  # dctx = do wo^T
    got = AB.attn_block_bwd_cuda(x, mask, wq, bq, wk, bk, wv, bv, wo, do, 1, d ** -0.5)
    torch.cuda.synchronize()
    for name, g in zip(("dq", "dk", "dv", "ctx"), got[1:]):
        assert torch.equal(g[..., 0:128], g[..., 128:256]), name


GEMM_CASES = {
    # name: (m, hidden, count, bias, heads, length); N = K = hidden
    "one_row": (1, 768, 3, True, 0, None),
    "ragged_hidden64": (37 * 3, 64, 3, True, 0, None),
    "text_qkv": (2048, 768, 3, True, 0, None),
    "text_out_no_bias": (2048, 768, 1, False, 0, None),
    "image_qkv": (3152, 768, 3, True, 0, None),
    "image_out": (3152, 768, 1, True, 0, None),
    "vilt_qkv": (12864, 768, 3, True, 0, None),
    "hidden64_one": (2048, 64, 1, True, 0, None),
    "banked_image": (3152, 768, 3, True, 12, 197),
    "banked_ragged": (37 * 3, 64, 3, False, 2, 37),
    "banked_head8": (3 * 20, 16, 1, True, 2, 20),
}


@pytest.mark.parametrize("case", sorted(GEMM_CASES))
def test_gemm_nt_matches_plain(cuda, case):
    """The bf16 NT GEMM (wgmma fed by TMA) against its plain version: the
    same f32 sum rounded once, so each element within one bf16 step of it,
    plus 1e-3 (outputs of scale 1) for the f32 sums' other order."""
    m, hid, count, with_bias, heads, length = GEMM_CASES[case]
    a = torch.randn(m, hid, generator=cuda, device="cuda").bfloat16()
    ws = [(torch.randn(hid, hid, generator=cuda, device="cuda") * hid ** -0.5).bfloat16()
          for _ in range(count)]
    biases = [torch.randn(hid, generator=cuda, device="cuda").bfloat16() if with_bias else None
              for _ in range(count)]
    before = AB.gemm_launches.count
    got = AB.gemm_nt(a, ws, biases, heads, length)
    assert AB.gemm_launches.count == before + 1
    want = AB.gemm_nt_reference(a, ws, biases, heads, length)
    torch.cuda.synchronize()
    for z, (g, r) in enumerate(zip(got, want)):
        assert g.shape == r.shape and g.dtype == torch.bfloat16
        err = (g.float() - r.float()).abs()
        assert torch.isfinite(g).all()
        assert (err <= 2 ** -7 * r.float().abs() + 1e-3).all(), (z, err.max().item())


def test_gemm_nt_refuses_what_tma_cannot_describe(cuda):
    """A row stride that is not a multiple of 16 bytes, or a matrix that does
    not start on a 16-byte boundary, is refused before any launch."""
    w = torch.zeros(64, 36, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="invalid argument"):
        AB.gemm_nt(torch.zeros(8, 36, device="cuda", dtype=torch.bfloat16), [w], [None])
    flat = torch.zeros(8 * 64 + 1, device="cuda", dtype=torch.bfloat16)
    w = torch.zeros(64, 64, device="cuda", dtype=torch.bfloat16)
    before = AB.gemm_launches.count
    with pytest.raises(RuntimeError, match="invalid argument"):
        AB.gemm_nt(flat[1:].view(8, 64), [w], [None])
    assert AB.gemm_launches.count == before


NN_TN_ROWS = [1, 63, 64, 65, 3152, 3168, 4096, 12864]  # 3,152 / 3,168: ViT / DeiT x 16


def _within_a_bf16_step(got, want, what):
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got).all(), what
    assert (err <= 2 ** -7 * want.float().abs() + 1e-3).all(), (what, err.max().item())


@pytest.mark.parametrize("width", [768, 2304])
@pytest.mark.parametrize("m", NN_TN_ROWS)
def test_gemm_nn_matches_plain(cuda, m, width):
    """The bf16 NN GEMM (wgmma fed by TMA, W read MN-major) against its plain
    version: dctx's one pair at K = width, dx's three at N = width."""
    for pairs, k, n in ((1, width, 768), (3, 768, width)):
        as_ = [torch.randn(m, k, generator=cuda, device="cuda").bfloat16() for _ in range(pairs)]
        ws = [(torch.randn(k, n, generator=cuda, device="cuda") * (pairs * k) ** -0.5).bfloat16()
              for _ in range(pairs)]
        before = AB.gemm_nn_launches.count
        got = AB.gemm_nn(as_, ws)
        assert AB.gemm_nn_launches.count == before + 1
        want = AB.gemm_nn_reference(as_, ws)
        torch.cuda.synchronize()
        assert got.shape == (m, n) and got.dtype == torch.bfloat16
        _within_a_bf16_step(got, want, (pairs, k, n))


@pytest.mark.parametrize("width", [768, 2304])
@pytest.mark.parametrize("rows", NN_TN_ROWS)
def test_gemm_tn_matches_plain(cuda, rows, width):
    """The bf16 TN GEMM (both operands MN-major) against its plain version:
    four products over ``rows`` K rows, C_z (768, width), with the slices
    the library picks (none at short K, the last round's tiles at long K)."""
    xs = [torch.randn(rows, width, generator=cuda, device="cuda").bfloat16() for _ in range(4)]
    gs = [(torch.randn(rows, 768, generator=cuda, device="cuda") * rows ** -0.5).bfloat16()
          for _ in range(4)]
    want = AB.gemm_tn_reference(xs, gs)
    before = AB.wgrad_launches.count
    got = AB.gemm_tn(xs, gs)
    assert AB.wgrad_launches.count == before + 1
    torch.cuda.synchronize()
    for z, (g, r) in enumerate(zip(got, want)):
        assert g.shape == (768, width) and g.dtype == torch.bfloat16
        _within_a_bf16_step(g, r, z)


@pytest.mark.parametrize("rows", [64, 4096])
@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_gemm_tn_slices_agree_bit_for_bit(cuda, count, rows):
    """Two runs give the same bits and agree with the plain version within a
    bf16 step, on every route the library takes: at 64 rows no slices; at
    4096 rows every tile sliced (counts 1-3: fewer tiles than SMs) or the
    tiles past the last full round (count 4), the slices summed apart and
    then in slice order."""
    xs = [torch.randn(rows, 768, generator=cuda, device="cuda").bfloat16() for _ in range(count)]
    gs = [(torch.randn(rows, 768, generator=cuda, device="cuda") * rows ** -0.5).bfloat16()
          for _ in range(count)]
    first = AB.gemm_tn(xs, gs)
    again = AB.gemm_tn(xs, gs)
    want = AB.gemm_tn_reference(xs, gs)
    torch.cuda.synchronize()
    for z, (a, b, r) in enumerate(zip(first, again, want)):
        assert torch.equal(a, b), z
        _within_a_bf16_step(a, r, z)


def test_gemm_nn_tn_refuse_what_tma_cannot_describe(cuda):
    """An odd width (a row stride not a multiple of 16 bytes) or an operand
    not on a 16-byte boundary is refused before any launch."""
    bf = dict(device="cuda", dtype=torch.bfloat16)
    nn0, tn0 = AB.gemm_nn_launches.count, AB.wgrad_launches.count
    with pytest.raises(RuntimeError, match="invalid argument"):  # K = 36
        AB.gemm_nn([torch.zeros(8, 36, **bf)], [torch.zeros(36, 64, **bf)])
    with pytest.raises(RuntimeError, match="invalid argument"):  # N = 36
        AB.gemm_nn([torch.zeros(8, 64, **bf)], [torch.zeros(64, 36, **bf)])
    flat = torch.zeros(8 * 64 + 1, **bf)
    with pytest.raises(RuntimeError, match="invalid argument"):
        AB.gemm_nn([flat[1:].view(8, 64)], [torch.zeros(64, 64, **bf)])
    with pytest.raises(RuntimeError, match="invalid argument"):  # N = 36
        AB.gemm_tn([torch.zeros(8, 36, **bf)], [torch.zeros(8, 64, **bf)])
    with pytest.raises(RuntimeError, match="invalid argument"):  # M = 36
        AB.gemm_tn([torch.zeros(8, 64, **bf)], [torch.zeros(8, 36, **bf)])
    with pytest.raises(RuntimeError, match="invalid argument"):
        AB.gemm_tn([flat[1:].view(8, 64)], [torch.zeros(8, 64, **bf)])
    assert (AB.gemm_nn_launches.count, AB.wgrad_launches.count) == (nn0, tn0)

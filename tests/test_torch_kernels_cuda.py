"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernels have no CPU
mode) and skips without one. The file imports no JAX, so it also runs on a
host that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

Shapes go beyond the serving path's: ragged key tiles, several query tiles,
the bf16 tensor-core kernel at each head dim it is built for and at its
longest key row, the FMA kernel (float32, other head dims, the longest key
row it holds), the row kernel (at most 4 query rows) with and without a
mask, a fully masked row, and the block kernel at a narrow width. Tolerances: float32 1e-4 of the output's scale (another
summation order); bfloat16 2e-2 of it (the plain version rounds its score
product to bfloat16 where the kernels keep float32).
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

"""The Python side of the bf16 NT GEMM's wrapper, on the CPU.

The bf16 NT GEMM of the fused blocks (``ops/attn_block.py::gemm_nt``, on the
card ``csrc/gemm_core.cuh``'s wgmma kernel; here its plain version) is held
against the JAX package's projections (``_qkv_head`` over
``_split_weights``, the per-head body of the Pallas kernels, and the packed
kernel's full-width projection) in both of the layouts its epilogue writes:
(M, N) row-major and head-banked (B, heads, L, d). Tolerances: float32 1e-5
(the same products summed in another order); bfloat16 one bf16 step of the
result plus 1e-5, since both sides round one float32 sum once. Without a
bias, the JAX side gets zero biases and the GEMM none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.ops import attn_block as JB
from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attn_block as TB

B, L, H = 3, 5, 16


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [0, 2, 4])
def test_gemm_nt_matches_the_jax_projections(dtype, heads, with_bias):
    rng = np.random.RandomState(heads)
    x = rng.randn(B, L, H).astype(np.float32)
    ws = [(rng.randn(H, H) / np.sqrt(H)).astype(np.float32) for _ in range(3)]  # (in, out)
    bs = [(0.1 * rng.randn(H) * with_bias).astype(np.float32) for _ in range(3)]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    split = JB._split_weights(*(jnp.asarray(t, jdt) for t in
                                (ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], ws[0], bs[0])),
                              max(heads, 1))
    want = np.stack([np.stack([np.stack([np.asarray(t, np.float32) for t in
                                         JB._qkv_head(jnp.asarray(x[b], jdt), *split[:6], h)])
                               for h in range(max(heads, 1))]) for b in range(B)])
    want = want.transpose(2, 0, 1, 3, 4)  # (q|k|v, B, heads, L, d)

    xt = torch.from_numpy(x).to(tdt).reshape(B * L, H)
    wt = [torch.from_numpy(w).to(tdt).t().contiguous() for w in ws]  # the Linear (out, in)
    bt = [torch.from_numpy(b).to(tdt) if with_bias else None for b in bs]
    got = TB.gemm_nt(xt, wt, bt, heads, L if heads else None)
    for z, c in enumerate(got):
        assert c.dtype == tdt
        if heads:
            assert c.shape == (B, heads, L, H // heads)
        else:
            assert c.shape == (B * L, H)
            c = c.reshape(B, 1, L, H)
        c, r = c.float().numpy(), want[z]
        if dtype == "float32":
            np.testing.assert_allclose(c, r, atol=1e-5, rtol=0)
        else:
            assert (np.abs(c - r) <= 2.0 ** -7 * np.abs(r) + 1e-5).all()


def test_gemm_nt_refuses_what_it_cannot_take():
    a, w = torch.zeros(6, 8), torch.zeros(8, 8)
    with pytest.raises(ValueError, match="one to three"):
        TB.gemm_nt(a, [w] * 4, [None] * 4)
    with pytest.raises(ValueError, match="one to three"):
        TB.gemm_nt(a, [w, w], [None])
    with pytest.raises(ValueError, match="banked"):
        TB.gemm_nt(a, [w], [None], heads=2)
    with pytest.raises(ValueError, match="banked"):
        TB.gemm_nt(a, [w], [None], heads=3, length=3)

"""PyTorch port's ``ops/attn_block.py`` against the JAX package's fused
attention block (``_fwd_kernel2`` in Pallas interpret mode) on the CPU. (The
CUDA kernel is held against the plain version on the card by
``test_torch_kernels_cuda.py`` and ``chip_smoke.py``.)

Weights are handed to both in the flax (in, out) layout. Tolerances: float32
1e-5 (same arithmetic, other summation order); bfloat16 2e-2 of the output's
scale (q/k/v, probabilities and the context are each rounded to bfloat16,
at different places in XLA and PyTorch).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.ops import attn_block as JB
from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attn_block as TB

HEADS = 2
B, L, H = 2, 12, 16


def _inputs(rng, masked=True):
    x = rng.randn(B, L, H).astype(np.float32)
    ws = []
    for _ in range(4):
        ws.append((rng.randn(H, H) / np.sqrt(H)).astype(np.float32))
        ws.append((0.1 * rng.randn(H)).astype(np.float32))
    mask = None
    if masked:
        mask = np.ones((B, L), np.int32)
        mask[0, L // 2:] = 0
        mask[1, 3:] = 0
    return x, mask, ws


def _jax(x, mask, ws, dtype, impl):
    m = None if mask is None else jnp.asarray(mask)
    out = JB.attn_block(jnp.asarray(x, dtype), m,
                        *[jnp.asarray(w, dtype) for w in ws],
                        heads=HEADS, impl=impl)
    return np.asarray(out.astype(jnp.float32))


def _torch(x, mask, ws, dtype, impl="fused", device="cpu"):
    m = None if mask is None else torch.from_numpy(mask).to(device)
    out = TB.attn_block(torch.from_numpy(x).to(dtype).to(device), m,
                        *[torch.from_numpy(w).to(dtype).to(device) for w in ws],
                        heads=HEADS, impl=impl)
    return out.float().cpu().numpy()


@pytest.mark.parametrize("masked", [True, False])
def test_attn_block_f32_matches_fused_interpret(rng, masked):
    x, mask, ws = _inputs(rng, masked)
    ref = _jax(x, mask, ws, jnp.float32, "fused_interpret")
    out = _torch(x, mask, ws, torch.float32)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_attn_block_f32_matches_jax_reference(rng):
    x, mask, ws = _inputs(rng)
    ref = _jax(x, mask, ws, jnp.float32, "jnp")
    out = _torch(x, mask, ws, torch.float32, impl="jnp")
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_attn_block_bf16_matches_fused_interpret(rng):
    x, mask, ws = _inputs(rng)
    ref = _jax(x, mask, ws, jnp.bfloat16, "fused_interpret")
    out = _torch(x, mask, ws, torch.bfloat16)
    assert np.abs(out - ref).max() <= 2e-2 * max(1.0, np.abs(ref).max())


def test_fused_perhead_is_not_ported():
    x, mask, ws = _inputs(np.random.RandomState(0))
    with pytest.raises(ValueError, match="fused_perhead"):
        _torch(x, mask, ws, torch.float32, impl="fused_perhead")

"""PyTorch port's ``ops/attention.py`` against the JAX package's: the plain
version against JAX ``sdpa_reference`` and against the Pallas kernel in
interpret mode, on the CPU. (The CUDA kernel is held against the plain
version on the card by ``test_torch_kernels_cuda.py`` and ``chip_smoke.py``.)

Tolerances: float32 agrees to 1e-5 (the same arithmetic, summed in another
order). bfloat16 agrees to 2e-2 relative to the output's scale: both sides
round the scores and the probabilities to bfloat16 (8 bits of mantissa,
relative step 2**-8 = 3.9e-3), and XLA and PyTorch round at different
places, so a few steps of difference are expected.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.ops import attention as JA
from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attention as TA

CASES = {
    # name: (b, h, lq, lk, d, mask kind)
    "masked": (2, 3, 16, 24, 8, "right_pad"),
    "fully_masked_row": (2, 2, 8, 12, 8, "one_row_empty"),
    "no_mask": (2, 3, 16, 24, 8, None),
    "fusion_shape": (2, 1, 1, 197, 768, None),
}


def _inputs(rng, b, h, lq, lk, d, mask_kind):
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for n in (lq, lk, lk))
    mask = None
    if mask_kind is not None:
        mask = np.ones((b, lk), np.int32)
        mask[:, lk // 2:] = 0
        if mask_kind == "one_row_empty":
            mask[0] = 0
    return q, k, v, mask


def _jax(fn, q, k, v, mask, dtype, **kw):
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    m = None if mask is None else jnp.asarray(mask)
    return np.asarray(fn(*args, m, **kw).astype(jnp.float32))


def _torch(q, k, v, mask, dtype, **kw):
    args = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask)
    return TA.sdpa(*args, m, **kw).float().numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_sdpa_f32_matches_jax_reference(rng, case):
    q, k, v, mask = _inputs(rng, *CASES[case])
    ref = _jax(JA.sdpa_reference, q, k, v, mask, jnp.float32)
    out = _torch(q, k, v, mask, torch.float32)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sdpa_f32_matches_pallas_interpret(rng, case):
    q, k, v, mask = _inputs(rng, *CASES[case])
    ref = _jax(JA.sdpa, q, k, v, mask, jnp.float32, impl="pallas_interpret")
    out = _torch(q, k, v, mask, torch.float32, impl="pallas_interpret")
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sdpa_bf16_matches_jax_reference(rng, case):
    q, k, v, mask = _inputs(rng, *CASES[case])
    ref = _jax(JA.sdpa_reference, q, k, v, mask, jnp.bfloat16)
    out = _torch(q, k, v, mask, torch.bfloat16)
    assert np.abs(out - ref).max() <= 2e-2 * max(1.0, np.abs(ref).max())


def test_fully_masked_row_is_uniform(rng):
    q, k, v, mask = _inputs(rng, *CASES["fully_masked_row"])
    out = _torch(q, k, v, mask, torch.float32)
    mean_v = v[0].mean(axis=1, keepdims=True)  # uniform weights over all keys
    np.testing.assert_allclose(out[0], np.broadcast_to(mean_v, out[0].shape),
                               atol=1e-5)
    assert np.isfinite(out).all()


def test_unknown_impl_raises():
    x = torch.zeros(1, 1, 2, 4)
    with pytest.raises(ValueError):
        TA.sdpa(x, x, x, impl="nonsense")

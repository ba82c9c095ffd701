"""PyTorch port's ``ops/attn_block.py`` against the JAX package's fused
attention block (``_fwd_kernel2`` in Pallas interpret mode) on the CPU. (The
CUDA kernel is held against the plain version on the card by
``test_torch_kernels_cuda.py`` and ``chip_smoke.py``.)

Weights are handed to both in the flax (in, out) layout. Tolerances: float32
1e-5 (same arithmetic, other summation order); bfloat16 2e-2 of the output's
scale (q/k/v, probabilities and the context are each rounded to bfloat16,
at different places in XLA and PyTorch).

The per-head variant (``impl="fused_perhead"``, TPU kernels 5 and 6) is held
against the JAX ``fused_perhead_interpret`` at the JAX tests' size (B=3,
L=16, H=32, 4 heads) and tolerances: float32 forward 2e-5, the ten gradients
5e-5 absolute + 5e-4 relative; bfloat16 2e-2 of each result's scale (the
same rounding points on both sides, but a float32 sum taken in another order
can round a bfloat16 value the other way). The banked outputs of its plain
backward are held against the Pallas ``_run_bwd``'s.
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


P_B, P_L, P_H, P_HEADS = 3, 16, 32, 4
GRAD_NAMES = ("x", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")


def _perhead_inputs(rng, masked=True):
    x = (rng.randn(P_B, P_L, P_H) * 0.5).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.rand(P_B, P_L) > 0.25).astype(np.int32)
        mask[:, 0] = 1
    ws = []
    for _ in range(4):
        ws.append((rng.randn(P_H, P_H) / np.sqrt(P_H)).astype(np.float32))
        ws.append((rng.randn(P_H) * 0.1).astype(np.float32))
    do = np.random.RandomState(1).randn(P_B, P_L, P_H).astype(np.float32)
    return x, mask, ws, do


def _jax_perhead_grads(x, mask, ws, do, dtype):
    """Output and the nine array gradients of the JAX per-head block."""
    import jax

    m = None if mask is None else jnp.asarray(mask)
    args = [jnp.asarray(a, dtype) for a in [x] + ws]

    def loss(*a):
        out = JB.attn_block(a[0], m, *a[1:], heads=P_HEADS, impl="fused_perhead_interpret")
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do)), out

    (_, out), grads = jax.value_and_grad(loss, argnums=tuple(range(9)), has_aux=True)(*args)
    return [np.asarray(t.astype(jnp.float32)) for t in (out,) + tuple(grads)]


def _torch_perhead_grads(x, mask, ws, do, dtype):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in [x] + ws]
    m = None if mask is None else torch.from_numpy(mask)
    out = TB.attn_block(leaves[0], m, *leaves[1:], heads=P_HEADS, impl="fused_perhead")
    out.backward(torch.from_numpy(do).to(dtype))
    return [t.detach().float().numpy() for t in [out] + [t.grad for t in leaves]]


@pytest.mark.parametrize("masked", [True, False])
def test_fused_perhead_f32_forward_matches_perhead_interpret(rng, masked):
    x, mask, ws, _ = _perhead_inputs(rng, masked)
    m = None if mask is None else jnp.asarray(mask)
    ref = np.asarray(JB.attn_block(jnp.asarray(x), m, *[jnp.asarray(w) for w in ws],
                                   heads=P_HEADS, impl="fused_perhead_interpret"))
    for impl in ("fused_perhead", "fused_perhead_interpret"):
        out = TB.attn_block(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask),
                            *[torch.from_numpy(w) for w in ws], heads=P_HEADS, impl=impl)
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5, err_msg=impl)


def test_fused_perhead_f32_ten_gradients_match_perhead_interpret(rng):
    x, mask, ws, do = _perhead_inputs(rng)
    want = _jax_perhead_grads(x, mask, ws, do, jnp.float32)
    got = _torch_perhead_grads(x, mask, ws, do, torch.float32)
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=2e-5, err_msg="out")
    for name, g, w in zip(GRAD_NAMES, got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=5e-5, rtol=5e-4, err_msg="d" + name)


def test_fused_perhead_bf16_matches_perhead_interpret(rng):
    x, mask, ws, do = _perhead_inputs(rng)
    want = _jax_perhead_grads(x, mask, ws, do, jnp.bfloat16)
    got = _torch_perhead_grads(x, mask, ws, do, torch.bfloat16)
    for name, g, w in zip(("out",) + GRAD_NAMES, got, want):
        scale = max(1.0, np.abs(w).max())
        assert np.abs(g - w).max() <= 2e-2 * scale, name


def test_fused_perhead_plain_banked_bwd_matches_run_bwd(rng):
    """The plain kernel body's dx and head-banked dq, dk, dv, ctx against the
    Pallas ``_run_bwd`` (interpret mode) on the same pre-split weights."""
    x, mask, ws, do = _perhead_inputs(rng)
    scale = (P_H // P_HEADS) ** -0.5
    split = JB._split_weights(*[jnp.asarray(w) for w in ws], P_HEADS)
    want = JB._run_bwd(jnp.asarray(x), jnp.asarray(mask)[:, None, :], split, jnp.asarray(do),
                       P_HEADS, scale, True)
    t = [torch.from_numpy(a) for a in [x] + ws]
    got = TB.attn_block_perhead_bwd_banked_reference(
        t[0], torch.from_numpy(mask), *t[1:8], torch.from_numpy(do), P_HEADS, scale)
    assert got[1].shape == (P_B, P_HEADS, P_L, P_H // P_HEADS)
    for name, g, w in zip(("dx", "dq", "dk", "dv", "ctx"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=2e-5, err_msg=name)


def test_fused_perhead_equals_packed_block_in_float64():
    """The per-head and packed variants differ only in the order of their
    float32 sums: carried out in float64, the two forwards agree to 1e-12."""
    rng = np.random.RandomState(2)
    x, mask, ws, _ = _perhead_inputs(rng)
    args = [torch.from_numpy(a).double() for a in [x] + ws]
    m = torch.from_numpy(mask)
    got = TB.attn_block(args[0], m, *args[1:], heads=P_HEADS, impl="fused_perhead")
    want = TB.attn_block(args[0], m, *args[1:], heads=P_HEADS, impl="fused")
    torch.testing.assert_close(got, want, atol=1e-12, rtol=0)

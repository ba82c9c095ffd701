"""The backward of the PyTorch port's ``sdpa`` and ``attn_block`` against
the JAX package's, on the CPU: ``torch.autograd`` through the port's autograd
functions (which take the plain backward, ``sdpa_bwd_reference`` /
``attn_block_bwd_reference``, on a CPU tensor) against ``jax.vjp`` of the
JAX ``sdpa(..., impl="pallas_interpret")`` / ``attn_block(...,
impl="fused_interpret")``, which runs the Pallas kernels ``_bwd_kernel`` /
``_bwd_kernel2`` in interpret mode. The same inputs and output gradient,
made with numpy, go to both. The long sequences of ViLT's joint encoder are
covered too: Lq = 2 x 128 + 40, where the JAX package takes its blocked
kernels (``_fwd_kernel_blocked``, ``_bwd_kernel_blocked``, a padded query
tail) and the port its query-tiled backward on the card, and Lq = 185, the
unblocked kernels above the port's block-kernel range. (The CUDA kernels are held against the same
plain versions on the card by ``test_torch_kernels_cuda.py`` and
``chip_smoke.py``.)

Tolerances: float32 1e-5 of each gradient's scale (the same arithmetic,
summed in another order), 2e-4 at the long sequences (sums over hundreds of
keys and query tiles, in another order); bfloat16 2e-2 of it (P, dS and the outputs are
rounded to bfloat16, 2**-8 relative, at the same points, but the float32
values rounded differ in their last bits). The weight and bias gradients of
the block are sums over every row whose exact values partly cancel (a key
bias's gradient is exactly zero); in bfloat16 they are held to 2e-2 of the
size of their terms. ``gradcheck`` holds each plain backward against the
finite differences of its forward in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.ops import attention as JA
from socialmedia_textimage_classification_auxlosses_tpu.ops import attn_block as JB
from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attention as TA
from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attn_block as TB

SDPA_CASES = {
    # name: (b, h, lq, lk, d, mask kind)
    "masked": (2, 3, 16, 24, 8, "right_pad"),
    "no_mask": (2, 3, 16, 24, 8, None),
    "fully_masked_row": (2, 2, 8, 12, 8, "one_row_empty"),
    "fusion_shape": (3, 1, 1, 40, 64, None),
}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _mask(b, lk, kind):
    if kind is None:
        return None
    mask = np.ones((b, lk), np.int32)
    mask[:, lk // 2:] = 0
    if kind == "one_row_empty":
        mask[0] = 0
    return mask


def _close(out, ref, dtype, scale=None, what=""):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    assert np.isfinite(out).all(), what
    scale = np.abs(ref).max() if scale is None else scale
    err = np.abs(out - ref).max()
    assert err <= TOL[dtype] * max(1.0, scale), (what, err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SDPA_CASES))
def test_sdpa_backward_matches_pallas_bwd_kernel(rng, case, dtype):
    b, h, lq, lk, d, kind = SDPA_CASES[case]
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for n in (lq, lk, lk))
    do = rng.randn(b, h, lq, d).astype(np.float32)
    mask = _mask(b, lk, kind)
    jm = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda q_, k_, v_: JA.sdpa(q_, k_, v_, jm, impl="pallas_interpret"),
                     *[jnp.asarray(a, JDT[dtype]) for a in (q, k, v)])
    want = vjp(jnp.asarray(do, JDT[dtype]))
    leaves = [torch.from_numpy(a).to(TDT[dtype]).requires_grad_(True) for a in (q, k, v)]
    tm = None if mask is None else torch.from_numpy(mask)
    out = TA.sdpa(*leaves, tm)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do).to(TDT[dtype]))
    for name, leaf, w in zip("qkv", leaves, want):
        assert leaf.grad.dtype == TDT[dtype]
        _close(leaf.grad.float().numpy(), w.astype(jnp.float32), dtype, what="d" + name)


LONG_CASES = {
    # name: (b, h, lq, lk, d): lq > 2 x 128 takes the JAX blocked kernels
    "blocked_padded_tail": (1, 2, 2 * JA._Q_BLOCK + 40, 96, 8),
    "vilt_fixed_length": (1, 2, 185, 185, 8),
}


@pytest.mark.parametrize("case", sorted(LONG_CASES))
def test_sdpa_long_sequences_match_pallas_kernels(rng, case):
    b, h, lq, lk, d = LONG_CASES[case]
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for n in (lq, lk, lk))
    do = rng.randn(b, h, lq, d).astype(np.float32)
    mask = _mask(b, lk, "right_pad")
    out, vjp = jax.vjp(lambda q_, k_, v_: JA.sdpa(q_, k_, v_, jnp.asarray(mask),
                                                  impl="pallas_interpret"),
                       *[jnp.asarray(a) for a in (q, k, v)])
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = TA.sdpa(*leaves, torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=0,
                               atol=2e-4 * max(1.0, np.abs(np.asarray(out)).max()))
    got.backward(torch.from_numpy(do))
    for name, leaf, w in zip("qkv", leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0,
                                   atol=2e-4 * max(1.0, np.abs(w).max()), err_msg="d" + name)


def test_sdpa_plain_backward_is_the_function_backward(rng):
    """``sdpa_bwd_reference`` is what the autograd function returns on the
    CPU; the plain path (``impl="jnp"``) differentiates the forward's ops."""
    q, k, v, do = (torch.from_numpy(rng.randn(2, 2, 6, 8).astype(np.float32))
                   for _ in range(4))
    mask = torch.from_numpy(_mask(2, 6, "right_pad"))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    TA.sdpa(*leaves, mask).backward(do)
    want = TA.sdpa_bwd_reference(q, k, v, mask, do)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    TA.sdpa(*plain, mask, impl="jnp").backward(do)
    for a, b in zip(plain, leaves):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=0)


# Not on a fully masked row: there the forward is the mean of V whatever q
# and k are, but the JAX kernel (and so the port) still returns
# dS = P (dP - rowsum(dP P)) with the uniform P, a nonzero dQ/dK; the
# parity test above holds the port to that value. The text tower never has
# such a row (its CLS key is always kept).
@pytest.mark.parametrize("kind", [None, "right_pad"])
def test_sdpa_plain_backward_gradcheck(rng, kind):
    q, k, v = (torch.from_numpy(rng.randn(2, 2, n, 4)).requires_grad_(True)
               for n in (3, 5, 5))
    mask = None if kind is None else torch.from_numpy(_mask(2, 5, kind))
    assert torch.autograd.gradcheck(lambda *a: TA.sdpa(*a, mask), (q, k, v))


HEADS, B, L, H = 2, 2, 12, 16


def _block_inputs(rng, masked):
    x = rng.randn(B, L, H).astype(np.float32)
    ws = []
    for _ in range(4):
        ws.append((rng.randn(H, H) / np.sqrt(H)).astype(np.float32))
        ws.append((0.1 * rng.randn(H)).astype(np.float32))
    mask = _mask(B, L, "right_pad") if masked else None
    return x, mask, ws, rng.randn(B, L, H).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [True, False])
def test_attn_block_backward_matches_pallas_bwd_kernel2(rng, masked, dtype):
    x, mask, ws, do = _block_inputs(rng, masked)
    jm = None if mask is None else jnp.asarray(mask)
    jargs = [jnp.asarray(a, JDT[dtype]) for a in [x] + ws]
    _, vjp = jax.vjp(lambda x_, *w_: JB.attn_block(x_, jm, *w_, heads=HEADS,
                                                   impl="fused_interpret"), *jargs)
    want = vjp(jnp.asarray(do, JDT[dtype]))  # dx, dwq, dbq, ..., dwo, dbo
    leaves = [torch.from_numpy(a).to(TDT[dtype]).requires_grad_(True) for a in [x] + ws]
    tm = None if mask is None else torch.from_numpy(mask)
    out = TB.attn_block(leaves[0], tm, *leaves[1:], heads=HEADS)
    tdo = torch.from_numpy(do).to(TDT[dtype])
    out.backward(tdo)
    # the size of each weight and bias gradient's terms, |a|^T |g| and sum |g|
    _, dq, dk, dv, ctx = TB.attn_block_bwd_packed_reference(
        *[l.detach().float() for l in leaves[:1]], tm,
        *[l.detach().float() for l in leaves[1:8]], tdo.float(), HEADS)
    xa, ca, da = (a.abs().reshape(-1, H) for a in (leaves[0].detach().float(), ctx, tdo.float()))
    terms = [None]
    for a, g in ((xa, dq), (xa, dk), (xa, dv), (ca, da)):
        g = g.abs().reshape(-1, H)
        terms += [(a.t() @ g).max().item(), g.sum(0).max().item()]
    names = ["x", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo"]
    for name, leaf, w, scale in zip(names, leaves, want, terms):
        if dtype == "float32":
            scale = None
        _close(leaf.grad.float().numpy(), w.astype(jnp.float32), dtype, scale, "d" + name)


def test_attn_block_plain_backward_returns_ten_gradients(rng):
    x, mask, ws, do = _block_inputs(rng, True)
    args = [torch.from_numpy(a) for a in [x] + ws]
    grads = TB.attn_block_bwd_reference(args[0], torch.from_numpy(mask), *args[1:],
                                        torch.from_numpy(do), HEADS)
    assert len(grads) == 10 and grads[1] is None
    for g, a in zip(grads[:1] + grads[2:], args):
        assert g.shape == a.shape and g.dtype == a.dtype


@pytest.mark.parametrize("masked", [True, False])
def test_attn_block_plain_backward_gradcheck(rng, masked):
    b, l, h, heads = 2, 4, 8, 2
    x = torch.from_numpy(rng.randn(b, l, h)).requires_grad_(True)
    ws = []
    for _ in range(4):
        ws.append(torch.from_numpy(rng.randn(h, h) / np.sqrt(h)).requires_grad_(True))
        ws.append(torch.from_numpy(0.1 * rng.randn(h)).requires_grad_(True))
    mask = torch.from_numpy(_mask(b, l, "right_pad")) if masked else None
    assert torch.autograd.gradcheck(
        lambda x_, *w_: TB.attn_block(x_, mask, *w_, heads=heads), (x, *ws))

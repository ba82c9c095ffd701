"""The fused block's backward GEMMs, held against the JAX package on the CPU.

Two orientations of the blocks' bf16 GEMM serve the backward
(``ops/attn_block.py``; on the card ``csrc/gemm_core.cuh``'s wgmma kernel,
here their plain versions): ``gemm_nn``, the dctx and dx products of the
backward kernel (TPU kernel 8), and ``gemm_tn``, the weight gradients that
``_param_grads`` forms outside it. They are held against the JAX package's
fused block backward, run as its own tests run it on the CPU
(``interpret=True``), on the same inputs made with numpy:

* ``gemm_tn`` and the bias sums against the weight and bias gradients of
  ``_attn_block2_bwd`` (the custom VJP's backward), fed the packed dq, dk, dv
  and ctx that its Pallas kernel ``_bwd_kernel2`` returns (``_run_bwd2``);
* ``gemm_nn`` against the dctx and dx that ``_run_bwd2`` implies: dctx =
  round(dO . Wo^T), as the kernel forms it, and dx, the kernel's output from
  its own dq, dk and dv (fewer pairs: their float32 sum, rounded once).

Each pair count the wrappers take is covered (NN 1-3, TN 1-4), and so are
the refusals of malformed arguments. Tolerances: float32 1e-5 (the same
products summed in another order); bfloat16 one bf16 step of the result plus
1e-5, since both sides round one float32 sum once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.ops import attn_block as JB
from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attn_block as TB

B, L, H = 3, 5, 16
HEADS = {"float32": 2, "bfloat16": 4}  # one Pallas run per dtype keeps the file quick


@functools.lru_cache(maxsize=None)
def _jax_backward(dtype):
    """The inputs (float32 numpy, rounded to ``dtype``), the packed outputs
    of ``_run_bwd2`` (dx, dq, dk, dv, ctx) and the ten gradients of
    ``_attn_block2_bwd``, all as float32 numpy, at ``HEADS[dtype]`` heads."""
    heads = HEADS[dtype]
    rng = np.random.RandomState(heads)
    jdt = getattr(jnp, dtype)
    x = rng.randn(B, L, H)
    ws = []
    for _ in range(4):
        ws += [rng.randn(H, H) / np.sqrt(H), 0.1 * rng.randn(H)]  # (in, out), bias
    do = rng.randn(B, L, H)
    mask = np.ones((B, L), np.int32)
    mask[1, 3:] = 0
    jx, jdo, *jws = (jnp.asarray(a, jdt) for a in [x, do] + ws)
    jmask = jnp.asarray(mask)[:, None, :]
    scale = (H // heads) ** -0.5
    packed = JB._run_bwd2(jx, jmask, JB._full_weights(*jws), jdo, heads, scale, True)
    grads = JB._attn_block2_bwd(heads, scale, True, (jx, jmask, *jws), jdo)

    def f32(a):
        return np.asarray(jnp.asarray(a, jnp.float32))

    return dict(x=f32(jx), do=f32(jdo), ws=[f32(w) for w in jws],
                packed=[f32(t) for t in packed], grads=[None if g is None else f32(g) for g in grads])


def _t(a, dtype):
    return torch.from_numpy(np.array(a)).to(getattr(torch, dtype))


def _close(got, want, dtype, what):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=what)
    else:
        assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-5).all(), what


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_grads_match_attn_block2_bwd(dtype):
    """The eight weight and bias gradients from the kernel's packed outputs:
    each weight gradient the ``.t()`` view of its (out, in) product."""
    j = _jax_backward(dtype)
    _, dq, dk, dv, ctx = (_t(a, dtype) for a in j["packed"])
    tdt = getattr(torch, dtype)
    got = TB._param_grads(_t(j["x"], dtype), dq, dk, dv, ctx, _t(j["do"], dtype), tdt, tdt)
    names = ["wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo"]
    for name, g, want in zip(names, got, j["grads"][2:]):
        assert g.dtype == tdt
        if name.startswith("w"):
            assert g.t().is_contiguous()  # the nn.Linear (out, in) layout
        _close(g, want, dtype, "d" + name)


@pytest.mark.parametrize("count", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_tn_matches_jax_weight_gradients(dtype, count):
    """C_z = g_z^T . x_z over the B * L rows, (out, in), for the first
    ``count`` of the block's pairs (x, dq), (x, dk), (x, dv), (ctx, dO)."""
    j = _jax_backward(dtype)
    _, dq, dk, dv, ctx = (_t(a, dtype).reshape(-1, H) for a in j["packed"])
    x, do = (_t(j[k], dtype).reshape(-1, H) for k in ("x", "do"))
    pairs = [(x, dq), (x, dk), (x, dv), (ctx, do)][:count]
    got = TB.gemm_tn([p[0] for p in pairs], [p[1] for p in pairs])
    assert len(got) == count
    for z, c in enumerate(got):
        assert c.dtype == getattr(torch, dtype) and c.shape == (H, H)
        _close(c.t(), j["grads"][2 + 2 * z], dtype, f"pair {z}")


@pytest.mark.parametrize("count", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_nn_matches_run_bwd2(dtype, count):
    """One pair: dctx = dO . Wo^T, rounded once, as ``_bwd_kernel2`` forms it;
    three pairs: the kernel's dx = dq Wq^T + dk Wk^T + dv Wv^T from its own
    dq, dk, dv; two: the float32 sum of the first two, rounded once. The
    weight goes in as the Linear's (out, in) matrix read as (K, N)."""
    j = _jax_backward(dtype)
    jdt = getattr(jnp, dtype)
    wq, wk, wv, wo = (j["ws"][i] for i in (0, 2, 4, 6))
    _, dq, dk, dv, _ = j["packed"]
    if count == 1:
        as_, ws = [j["do"]], [wo]
    else:
        as_, ws = [dq, dk, dv][:count], [wq, wk, wv][:count]
    if count == 3:
        want = j["packed"][0]
    else:
        acc = sum(jax.lax.dot_general(jnp.asarray(a, jdt), jnp.asarray(w, jdt),
                                      (((2,), (1,)), ((), ())),
                                      preferred_element_type=jnp.float32)
                  for a, w in zip(as_, ws))
        want = np.asarray(jnp.asarray(acc.astype(jdt), jnp.float32))
    got = TB.gemm_nn([_t(a, dtype).reshape(-1, H) for a in as_],
                     [_t(w, dtype).t().contiguous() for w in ws])
    assert got.dtype == getattr(torch, dtype) and got.shape == (B * L, H)
    _close(got.reshape(B, L, H), want, dtype, f"{count} pairs")


def test_gemm_nn_tn_refuse_malformed_arguments():
    a, w = torch.zeros(6, 8), torch.zeros(8, 4)
    with pytest.raises(ValueError, match="one to three"):
        TB.gemm_nn([a] * 4, [w] * 4)
    with pytest.raises(ValueError, match="one to three"):
        TB.gemm_nn([a, a], [w])
    with pytest.raises(ValueError, match="one to three"):
        TB.gemm_nn([], [])
    with pytest.raises(ValueError, match="each pair"):  # K of a and W differ
        TB.gemm_nn([a], [torch.zeros(4, 8)])
    with pytest.raises(ValueError, match="each pair"):  # two a's of other shapes
        TB.gemm_nn([a, torch.zeros(5, 8)], [w, w])
    x, g = torch.zeros(6, 8), torch.zeros(6, 4)
    with pytest.raises(ValueError, match="one to four"):
        TB.gemm_tn([x] * 5, [g] * 5)
    with pytest.raises(ValueError, match="one to four"):
        TB.gemm_tn([x], [g, g])
    with pytest.raises(ValueError, match="each pair"):  # K rows differ
        TB.gemm_tn([x], [torch.zeros(5, 4)])
    with pytest.raises(ValueError, match="each pair"):
        TB.gemm_tn([x, torch.zeros(6, 7)], [g, g])

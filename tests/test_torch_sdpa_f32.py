"""The float32 SDPA kernels' three-pass tf32 arithmetic, emulated on the CPU.

On the card the float32 forward and backward (``csrc/sdpa_core.cuh``,
``csrc/sdpa_bwd_core.cuh``) run every product on the tensor cores in tf32
(10 mantissa bits), three times: each operand x is split into big =
tf32_rna(x) (round to nearest, ties away: ``cvt.rna.tf32.f32``) and small =
tf32_rna(x - big), and a b is taken as a_s b_b + a_b b_s + a_b b_b with
float32 sums (the cross terms first, as the kernels issue them); only
a_s b_s, about 2^-22 of a b, is dropped. The products of tf32 values are
exact in float32, so a float32 matmul of the halves reproduces each term.

These tests hold that emulation, built from the port's plain softmax
formulas, to:

* a float64 SDPA (``sdpa_reference`` / ``sdpa_bwd_reference`` in float64):
  its error at most 2x the plain float32 version's, forward and each of the
  backward's three gradients (the five products S, dP, dV, dQ, dK);
* the JAX package's ``_sdpa_pallas`` in interpret mode (the Pallas forward
  and backward kernels), 1e-5 of each output's scale, as
  ``test_torch_attention.py`` and ``test_torch_sdpa_stats.py`` hold the plain
  float32 versions;
* and it shows why the kernels pay for three passes: a single tf32 pass
  misses ``chip_smoke.py``'s float32 gate (1e-4 of the output's scale).

The card's own accuracy gate (``chip_smoke.py``) holds the kernels to 4x the
plain float32 version's error against float64: the tensor cores also
truncate as they accumulate, which no CPU emulation reproduces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.ops import attention as JA
from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attention as TA

CASES = {
    # name: (b, h, lq, lk, d, mask kind); head dims 32 and 64, the kernels'
    "text_like": (2, 2, 32, 64, 64, "right_pad"),
    "ragged_keys": (1, 2, 24, 70, 64, None),
    "head32_masked_row": (2, 2, 20, 72, 32, "one_row_empty"),
}


def tf32_rna(x):
    """x rounded to tf32, to nearest with ties away from zero, as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def mm3(a, b):
    """a @ b as the kernels form it: three tf32 products, cross terms first."""
    (ab, as_), (bb, bs) = split(a), split(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def mm1(a, b):
    """a @ b in a single tf32 pass."""
    return tf32_rna(a) @ tf32_rna(b)


def _probs(q, k, mask, scale, mm):
    s = mm(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        s = torch.where(mask[:, None, None, :] > 0, s, TA._NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return e * (1 / e.sum(dim=-1, keepdim=True))


def emulated_fwd(q, k, v, mask, scale, mm=mm3):
    return mm(_probs(q, k, mask, scale, mm), v)


def emulated_bwd(q, k, v, mask, do, scale, mm=mm3):
    """(dq, dk, dv) with the five products of the kernels' backward."""
    p = _probs(q, k, mask, scale, mm)
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    return (mm(ds, k) * scale, mm(ds.transpose(-1, -2), q) * scale,
            mm(p.transpose(-1, -2), do))


def _inputs(case):
    b, h, lq, lk, d, kind = CASES[case]
    rng = np.random.RandomState(20)
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, n, d).astype(np.float32))
                   for n in (lq, lk, lk, lq))
    mask = None
    if kind is not None:
        m = np.ones((b, lk), np.int32)
        m[:, lk // 2:] = 0
        if kind == "one_row_empty":
            m[0] = 0
        mask = torch.from_numpy(m)
    return q, k, v, do, mask, d ** -0.5


def _err(x, ref):
    return (x.double() - ref).abs().max().item()


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_pass_forward_keeps_float32_accuracy(case):
    q, k, v, _, mask, scale = _inputs(case)
    want = TA.sdpa_reference(q.double(), k.double(), v.double(), mask, scale)
    plain = _err(TA.sdpa_reference(q, k, v, mask, scale), want)
    assert _err(emulated_fwd(q, k, v, mask, scale), want) <= 2 * plain
    # one tf32 pass keeps three digits: it fails the card's float32 gate
    assert _err(emulated_fwd(q, k, v, mask, scale, mm1), want) > 1e-4 * max(
        1.0, want.abs().max().item())


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_pass_backward_keeps_float32_accuracy(case):
    q, k, v, do, mask, scale = _inputs(case)
    want = TA.sdpa_bwd_reference(q.double(), k.double(), v.double(), mask, do.double(), scale)
    plain = TA.sdpa_bwd_reference(q, k, v, mask, do, scale)
    got = emulated_bwd(q, k, v, mask, do, scale)
    single = emulated_bwd(q, k, v, mask, do, scale, mm1)
    for name, g, p, s, w in zip(("dq", "dk", "dv"), got, plain, single, want):
        assert _err(g, w) <= 2 * _err(p, w), name
        assert _err(s, w) > 1e-4 * max(1.0, w.abs().max().item()), name


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_pass_matches_the_pallas_kernels(case):
    """Forward and backward against ``jax.vjp`` of the JAX ``sdpa`` in
    interpret mode (``_fwd_kernel`` and ``_bwd_kernel``)."""
    q, k, v, do, mask, scale = _inputs(case)
    jm = None if mask is None else jnp.asarray(mask.numpy())
    out, vjp = jax.vjp(lambda q_, k_, v_: JA.sdpa(q_, k_, v_, jm, impl="pallas_interpret"),
                       *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    grads = vjp(jnp.asarray(do.numpy()))
    got = (emulated_fwd(q, k, v, mask, scale),) + emulated_bwd(q, k, v, mask, do, scale)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, (out,) + tuple(grads)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w).max()), err_msg=name)


@pytest.mark.parametrize("dtype,lq,d,takes", [
    (torch.float32, 128, 64, True),
    (torch.float32, 197, 32, True),
    (torch.bfloat16, 128, 64, True),
    (torch.float32, 128, 128, False),
    (torch.float32, 4, 64, False),
    (torch.float32, 1, 768, False),
    (torch.float16, 128, 64, False),
])
def test_tc_pair_takes_float32_at_head_dims_32_and_64(dtype, lq, d, takes):
    q = torch.zeros(2, 3, lq, d, dtype=dtype)
    kv = torch.zeros(2, 3, 70, d, dtype=dtype)
    assert TA.tc_pair_takes(q, kv, kv) is takes

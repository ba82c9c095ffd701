"""The row statistics that the port's SDPA forward hands its backward, on the
CPU, against the JAX package.

On the card the bf16 tensor-core forward writes each query row's float32 max
m and sum l of exp(s - m) (``(B, H, Lq, 2)``), and the backward's first pass
forms P = exp(s - m) / l from them instead of forming them again. Their
plain versions are ``row_stats`` (``sdpa_reference(..., with_stats=True)``)
and ``sdpa_bwd_reference(..., stats=...)``; these tests hold them to the JAX
package, with inputs made from a numpy seed:

* m and l against the max and the sum of the JAX ``_probs`` formula (its
  float32 scores, masked at -1e30, in jnp), and P = exp(s - m) / l against
  ``_probs`` itself, 1e-5 relative (float32 sums in another order);
* the plain backward given those statistics against ``jax.vjp`` of the JAX
  ``sdpa(..., impl="pallas_interpret")``, which runs ``_bwd_kernel`` (and
  ``_bwd_kernel_blocked`` past 256 query rows) in interpret mode, at the
  tolerances of ``test_torch_ops_bwd.py``: float32 1e-5 of each gradient's
  scale (2e-4 at the long sequence), bfloat16 2e-2 of it;
* the plain backward with the statistics and without them, bit for bit (the
  same float32 operations either way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.ops import attention as JA
from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attention as TA

CASES = {
    # name: (b, h, lq, lk, d, mask kind)
    "masked": (2, 3, 16, 24, 8, "right_pad"),
    "no_mask": (2, 3, 16, 24, 8, None),
    "fully_masked_row": (2, 2, 8, 12, 8, "one_row_empty"),
    "lq_ne_lk": (2, 2, 9, 40, 16, "right_pad"),
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


def _inputs(rng, b, h, lq, lk, d, dtype):
    """q, k, v, dO from the seed, rounded to ``dtype`` once (as float32
    arrays), so both frameworks read the same values."""
    arrs = [rng.randn(b, h, n, d).astype(np.float32) for n in (lq, lk, lk, lq)]
    return [np.array(jnp.asarray(a, JDT[dtype]).astype(jnp.float32)) for a in arrs]


def _jax_stats(q, k, mask, scale):
    """The max and sum of the JAX ``_probs`` formula, per (batch, head, query
    row): float32 scores (the products summed in float32), masked keys at
    -1e30, then m = max and l = sum of exp(s - m)."""
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), jnp.asarray(k),
                   preferred_element_type=jnp.float32) * scale
    if mask is not None:
        s = jnp.where(jnp.asarray(mask)[:, None, None, :] > 0, s, JA._NEG_INF)
    m = jnp.max(s, axis=-1, keepdims=True)
    return np.asarray(m[..., 0]), np.asarray(jnp.sum(jnp.exp(s - m), axis=-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_row_stats_match_the_jax_probs_formula(rng, case, dtype):
    b, h, lq, lk, d, kind = CASES[case]
    q, k, v, _ = _inputs(rng, b, h, lq, lk, d, dtype)
    mask = _mask(b, lk, kind)
    scale = d ** -0.5
    tq, tk, tv = (torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    out, stats = TA.sdpa_reference(tq, tk, tv, tm, scale, with_stats=True)
    assert torch.equal(out, TA.sdpa_reference(tq, tk, tv, tm, scale))
    assert stats.shape == (b, h, lq, 2) and stats.dtype == torch.float32
    assert torch.equal(stats, TA.row_stats(tq, tk, tm, scale))
    m, l = _jax_stats(q, k, mask, scale)
    np.testing.assert_allclose(stats[..., 0].numpy(), m, rtol=1e-5, atol=0)
    np.testing.assert_allclose(stats[..., 1].numpy(), l, rtol=1e-5, atol=0)
    if kind == "one_row_empty":  # every real key at -1e30: a uniform row
        np.testing.assert_array_equal(stats[0, ..., 0].numpy(), np.float32(JA._NEG_INF))
        np.testing.assert_array_equal(stats[0, ..., 1].numpy(), np.float32(lk))
    # P = exp(s - m) / l is the JAX kernels' _probs, batch row by batch row
    s = TA._scores(tq, tk, tm, scale)
    p = torch.exp(s - stats[..., :1]) / stats[..., 1:]
    ones = np.ones((1, lk), np.int32)
    for i in range(b):
        want = JA._probs(jnp.asarray(q[i]), jnp.asarray(k[i]),
                         jnp.asarray(mask[i:i + 1] if mask is not None else ones), scale)
        np.testing.assert_allclose(p[i].numpy(), np.asarray(want), rtol=0, atol=1e-6)


def _jax_grads(q, k, v, do, mask, dtype):
    jm = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda q_, k_, v_: JA.sdpa(q_, k_, v_, jm, impl="pallas_interpret"),
                     *[jnp.asarray(a, JDT[dtype]) for a in (q, k, v)])
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do, JDT[dtype]))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_given_stats_matches_pallas_bwd_kernel(rng, case, dtype):
    b, h, lq, lk, d, kind = CASES[case]
    q, k, v, do = _inputs(rng, b, h, lq, lk, d, dtype)
    mask = _mask(b, lk, kind)
    scale = d ** -0.5
    want = _jax_grads(q, k, v, do, mask, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v, do))
    tm = None if mask is None else torch.from_numpy(mask)
    stats = TA.row_stats(tq, tk, tm, scale)
    got = TA.sdpa_bwd_reference(tq, tk, tv, tm, tdo, scale, stats=stats)
    plain = TA.sdpa_bwd_reference(tq, tk, tv, tm, tdo, scale)
    for name, g, p, w in zip("qkv", got, plain, want):
        assert g.dtype == TDT[dtype]
        assert torch.equal(g, p), f"d{name}: the stats change the plain backward"
        err = np.abs(g.float().numpy() - w).max()
        assert err <= TOL[dtype] * max(1.0, np.abs(w).max()), (f"d{name}", err)


def test_backward_given_stats_at_a_long_sequence(rng):
    """Lq = 2 x 128 + 40: the JAX package takes its blocked kernels, 128-row
    query tiles with a padded tail (float32, 2e-4 as in
    ``test_torch_ops_bwd.py``)."""
    b, h, lq, lk, d = 1, 2, 2 * JA._Q_BLOCK + 40, 96, 8
    q, k, v, do = _inputs(rng, b, h, lq, lk, d, "float32")
    mask = _mask(b, lk, "right_pad")
    want = _jax_grads(q, k, v, do, mask, "float32")
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tm = torch.from_numpy(mask)
    _, stats = TA.sdpa_reference(tq, tk, tv, tm, d ** -0.5, with_stats=True)
    got = TA.sdpa_bwd_reference(tq, tk, tv, tm, tdo, d ** -0.5, stats=stats)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-4 * max(1.0, np.abs(w).max()),
                                   err_msg="d" + name)


def test_cpu_autograd_keeps_the_plain_backward(rng):
    """On the CPU ``sdpa``'s gradient is ``sdpa_bwd_reference`` without
    statistics (only the card's tensor-core pair reads them)."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(rng, 2, 2, 6, 6, 8, "bfloat16"))
    q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    TA.sdpa(*leaves).backward(do)
    for leaf, w in zip(leaves, TA.sdpa_bwd_reference(q, k, v, None, do)):
        assert torch.equal(leaf.grad, w)
    assert not TA.tc_pair_takes(q[:, :, :4], k, v)  # four query rows: the row pair

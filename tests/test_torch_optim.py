"""The port's multi-tensor AdamW against the JAX package's ``optax.adamw``
(``--opt_kernel optax``) on the CPU, under the vision-frozen mask, over three
steps, with float32 and with bfloat16 first moments (b1 rounded to bfloat16
before it multiplies m, as JAX's weakly typed 0.9 is). Inputs are made with
numpy from a seed; an unused head gets no gradient in the port and a zero
one in JAX. (``tests/test_torch_train.py`` holds it against ``fused_adamw``,
``--opt_kernel fused``, over five steps.)

Tolerance: 1e-6 relative (and 1e-7 absolute) on every parameter: the same
expressions in the same order; the last bit of the float32 power in the bias
correction may differ. The step count and bias corrections stay on the
parameters' device, and ``reset`` / ``load_state_dict`` write the optimizer's
own tensors in place (a CUDA graph reads them by address).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.train import optim as JO
from socialmedia_textimage_classification_auxlosses_tpu_torch.train import optim as TO

NAMES = ("dual.vision.w", "dual.text.w", "dual.text.b", "linear_iadds.bias")


def _tree(rng):
    return {"params": {"dual": {"vision": {"w": rng.randn(3, 4).astype(np.float32)},
                                "text": {"w": rng.randn(5, 6).astype(np.float32),
                                         "b": rng.randn(6).astype(np.float32)}},
                       "linear_iadds": {"bias": rng.randn(2).astype(np.float32)}}}


def _flat(tree):
    p = tree["params"]
    return {"dual.vision.w": p["dual"]["vision"]["w"], "dual.text.w": p["dual"]["text"]["w"],
            "dual.text.b": p["dual"]["text"]["b"], "linear_iadds.bias": p["linear_iadds"]["bias"]}


def _jax_tx(mu):
    adamw = optax.adamw(learning_rate=1e-2, weight_decay=0.01, b1=0.9, b2=0.999, eps=1e-8,
                        mu_dtype=mu)

    def label(params):
        return jax.tree_util.tree_map_with_path(
            lambda path, x: "frozen" if JO.vision_frozen_predicate(path, x) else "train", params)

    return optax.multi_transform({"train": adamw, "frozen": optax.set_to_zero()}, label)


@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_foreach_adamw_matches_optax_adamw(moments):
    rng = np.random.RandomState(11)
    tree = _tree(rng)
    mu = "bfloat16" if moments == "bf16" else None
    tx = _jax_tx(mu)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(jparams)
    tparams = {n: torch.nn.Parameter(torch.from_numpy(a.copy())) for n, a in _flat(tree).items()}
    opt = TO.AdamW(tparams.items(), 1e-2, 0.01, mu_dtype=torch.bfloat16 if mu else None,
                   frozen=TO.vision_frozen)
    for _ in range(3):
        g = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32), tree)
        g["params"]["linear_iadds"]["bias"] = np.zeros(2, np.float32)  # an unused head
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        gf = _flat(g)
        opt.step({"dual.text.w": torch.from_numpy(gf["dual.text.w"]),
                  "dual.text.b": torch.from_numpy(gf["dual.text.b"]),
                  "linear_iadds.bias": None})
    want = _flat(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams))
    for name in NAMES:
        np.testing.assert_allclose(tparams[name].detach().numpy(), want[name], rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    assert int(opt.count) == 3 and opt.count.dtype == torch.int32
    assert opt.mu["dual.text.w"].dtype == (torch.bfloat16 if mu else torch.float32)


def test_state_is_written_in_place():
    rng = np.random.RandomState(3)
    params = {n: torch.nn.Parameter(torch.from_numpy(a.copy()))
              for n, a in _flat(_tree(rng)).items()}
    opt = TO.AdamW(params.items(), 1e-2, 0.01, frozen=TO.vision_frozen)
    grads = {n: torch.ones_like(p) for n, p in params.items()}
    addresses = {n: (m.data_ptr(), opt.nu[n].data_ptr()) for n, m in opt.mu.items()}
    count = opt.count.data_ptr()
    opt.step(grads)
    saved = opt.state_dict()
    opt.step(grads)
    opt.load_state_dict(saved)
    assert int(opt.count) == 1
    torch.testing.assert_close(opt.mu["dual.text.w"], saved["mu"]["dual.text.w"])
    opt.reset()
    assert int(opt.count) == 0 and all(float(m.abs().sum()) == 0 for m in opt.mu.values())
    assert {n: (m.data_ptr(), opt.nu[n].data_ptr()) for n, m in opt.mu.items()} == addresses
    assert opt.count.data_ptr() == count

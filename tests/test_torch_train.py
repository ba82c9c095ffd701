"""The PyTorch port's training modules against the JAX package's, on the CPU:
the losses and metrics, the ITM swap's contract, the masked AdamW (float32
and bfloat16 first moments, and the frozen set) and one train step of the
tiny late-fusion model with ITC + TIM, the swap injected and dropout 0.

Tolerances: losses and metrics float32 1e-6 (the same expressions); AdamW
1e-6 relative over five steps (the same expression order; the last bit of
the float32 power in the bias correction may differ); the train step's
losses 1e-5 and gradients 1e-4 of each tensor's scale (float32 through two
layers of each tower, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.models import fusion as JF
from socialmedia_textimage_classification_auxlosses_tpu.models.text import (
    text_encoder_config as jax_text_cfg,
)
from socialmedia_textimage_classification_auxlosses_tpu.models.vision import (
    vision_encoder_config as jax_vision_cfg,
)
from socialmedia_textimage_classification_auxlosses_tpu.train import losses as JL
from socialmedia_textimage_classification_auxlosses_tpu.train import metrics as JM
from socialmedia_textimage_classification_auxlosses_tpu.train import optim as JO
from socialmedia_textimage_classification_auxlosses_tpu.train import steps as JS
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import fusion as TF
from socialmedia_textimage_classification_auxlosses_tpu_torch.models.from_jax import (
    torch_state_from_jax,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.train import itm as TI
from socialmedia_textimage_classification_auxlosses_tpu_torch.train import losses as TL
from socialmedia_textimage_classification_auxlosses_tpu_torch.train import metrics as TM
from socialmedia_textimage_classification_auxlosses_tpu_torch.train import optim as TO
from socialmedia_textimage_classification_auxlosses_tpu_torch.train import steps as TS

from test_torch_from_jax import TINY, carry, t, text_batch, torch_cfg


def _n(x):
    return np.asarray(x, np.float32)


@pytest.fixture
def loss_inputs(rng):
    b, c = 6, 3
    return dict(
        logits=rng.randn(b, c).astype(np.float32) * 2,
        onehot=np.eye(c, dtype=np.float32)[rng.randint(0, c, b)],
        labels=rng.randint(0, 2, b).astype(np.int32),
        multi=rng.randint(0, 2, (b, c)).astype(np.float32),
        weights=rng.rand(c).astype(np.float32) + 0.5,
        sim=rng.randn(b, b).astype(np.float32) * 3,
        valid=np.array([1, 1, 1, 1, 0, 0], np.float32),
        two=rng.randn(b, 2).astype(np.float32),
    )


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("loss", ["weighted_ce", "int_ce", "bce_with_logits",
                                  "clip_loss", "loss_correction"])
def test_losses_match_jax(loss_inputs, loss, masked):
    d = loss_inputs
    m = d["valid"] if masked else None
    jm = None if m is None else jnp.asarray(m)
    tm = None if m is None else t(m)
    if loss == "weighted_ce":
        want = JL.weighted_ce(d["logits"], d["onehot"], d["weights"], mask=jm)
        got = TL.weighted_ce(t(d["logits"]), t(d["onehot"]), t(d["weights"]), mask=tm)
    elif loss == "int_ce":
        want = JL.int_ce(d["two"], d["labels"], mask=jm)
        got = TL.int_ce(t(d["two"]), t(d["labels"]), mask=tm)
    elif loss == "bce_with_logits":
        want = JL.bce_with_logits(d["logits"], d["multi"], d["weights"], mask=jm)
        got = TL.bce_with_logits(t(d["logits"]), t(d["multi"]), t(d["weights"]), mask=tm)
    elif loss == "clip_loss":
        want = JL.clip_loss(d["sim"], mask=jm)
        got = TL.clip_loss(t(d["sim"]), mask=tm)
    else:
        onehot2 = np.eye(2, dtype=np.float32)[d["labels"]]
        T = [[0.9, 0.1], [0.1, 0.9]]
        want = JL.loss_correction(T, d["two"], onehot2, d["weights"][:2], mask=jm)
        got = TL.loss_correction(T, t(d["two"]), t(onehot2), t(d["weights"][:2]), mask=tm)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("terms", [(True, True), (True, False), (False, True), (False, False)])
def test_combined_loss_matches_jax(terms):
    itc = 0.7 if terms[0] else None
    itm = 0.3 if terms[1] else None
    want = JL.combined_loss(jnp.float32(1.5), itc, itm, 0.1, 0.2)
    got = TL.combined_loss(torch.tensor(1.5), None if itc is None else torch.tensor(itc),
                           None if itm is None else torch.tensor(itm), 0.1, 0.2)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_metrics_match_jax(rng):
    preds = rng.randint(0, 3, 20).astype(np.int32)
    targets = rng.randint(0, 3, 20).astype(np.int32)
    valid = (rng.rand(20) > 0.2).astype(np.float32)
    np.testing.assert_array_equal(
        TM.confusion_matrix_update(t(preds), t(targets), 3, t(valid)).numpy(),
        _n(JM.confusion_matrix_update(jnp.asarray(preds), jnp.asarray(targets), 3,
                                      jnp.asarray(valid))))
    mp = rng.randint(0, 2, (20, 4)).astype(np.int32)
    mt = rng.randint(0, 2, (20, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        TM.multilabel_counts_update(t(mp), t(mt), t(valid)).numpy(),
        _n(JM.multilabel_counts_update(jnp.asarray(mp), jnp.asarray(mt), jnp.asarray(valid))))
    res = {"predictions": preds, "labels": targets, "loss": 0.5, "epoch": 0}
    assert TM.compute_metrics(res, 3) == JM.compute_metrics(res, 3)
    names = ["f1_weighted", "f1_macro", "loss"]
    assert TM.agg_metrics_val([res], names, 3) == JM.agg_metrics_val([res], names, 3)


def test_itm_swap_contract():
    gen = torch.Generator().manual_seed(0)
    b = 8
    ids = torch.arange(b)[:, None].repeat(1, 5)
    mask = torch.ones(b, 5, dtype=torch.int32)
    valid = torch.tensor([1.0] * 6 + [0.0] * 2)
    flips, partners = 0, np.zeros((b, b))
    for _ in range(400):
        tim_ids, tim_mask, tt, labels, src = TI.itm_swap(gen, ids, mask, None, valid)
        assert tt is None
        assert torch.equal(tim_ids[:, 0], src) and torch.equal(tim_mask, mask[src])
        assert torch.equal(labels == 1, src == torch.arange(b))  # 1 = match
        assert (src[6:] == torch.arange(6, 8)).all()  # padded rows never swap
        swapped = labels == 0
        flips += int(swapped[:6].sum())
        for i in torch.nonzero(swapped)[:, 0].tolist():
            partners[i, src[i]] += 1
    assert 0.4 < flips / (400 * 6) < 0.6
    assert np.all(np.diag(partners) == 0)  # a partner is another row
    rows = partners[:6] / partners[:6].sum(1, keepdims=True)
    off = rows[~np.eye(b, dtype=bool)[:6]]
    assert np.all(np.abs(off - 1 / (b - 1)) < 0.08)  # drawn uniformly
    one = TI.itm_swap(gen, ids[:1], mask[:1])
    assert one[3].tolist() == [1] and one[4].tolist() == [0]  # a batch of one matches


def _adam_tree(rng):
    return {"params": {
        "dual": {"vision": {"w": rng.randn(3, 4).astype(np.float32)},
                 "text": {"w": rng.randn(4, 5).astype(np.float32),
                          "b": rng.randn(5).astype(np.float32)}},
        "linear_iadds": {"bias": rng.randn(2).astype(np.float32)}}}


@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_adamw_matches_jax_make_optimizer(rng, moments):
    tree = _adam_tree(rng)
    mu = "bfloat16" if moments == "bf16" else None
    tx = JO.make_optimizer(1e-2, 0.01, JO.vision_frozen_predicate, mu_dtype=mu, fused=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(jparams)
    named = {"dual.vision.w": tree["params"]["dual"]["vision"]["w"],
             "dual.text.w": tree["params"]["dual"]["text"]["w"],
             "dual.text.b": tree["params"]["dual"]["text"]["b"],
             "linear_iadds.bias": tree["params"]["linear_iadds"]["bias"]}
    tparams = {n: torch.nn.Parameter(t(a).clone()) for n, a in named.items()}
    opt = TO.AdamW(tparams.items(), 1e-2, 0.01,
                   mu_dtype=torch.bfloat16 if mu else None, frozen=TO.vision_frozen)
    assert opt.frozen_names == ["dual.vision.w"]
    for _ in range(5):
        g = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32), tree)
        g["params"]["linear_iadds"]["bias"] = np.zeros(2, np.float32)  # unused head
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, upd)
        gp = g["params"]
        opt.step({"dual.text.w": t(gp["dual"]["text"]["w"]),
                  "dual.text.b": t(gp["dual"]["text"]["b"]),
                  "linear_iadds.bias": None})
    jp = jparams["params"]
    for name, want in (("dual.vision.w", jp["dual"]["vision"]["w"]),
                       ("dual.text.w", jp["dual"]["text"]["w"]),
                       ("dual.text.b", jp["dual"]["text"]["b"]),
                       ("linear_iadds.bias", jp["linear_iadds"]["bias"])):
        np.testing.assert_allclose(tparams[name].detach().numpy(), _n(want),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    assert opt.mu["dual.text.w"].dtype == (torch.bfloat16 if mu else torch.float32)
    np.testing.assert_array_equal(tparams["dual.vision.w"].detach().numpy(),
                                  named["dual.vision.w"])


LABELS = 3


def _models(dropout=0.0):
    text_cfg = jax_text_cfg("bernice", None, dtype="float32", dropout=dropout,
                            vocab_size=1000, **TINY)
    vis_cfg = jax_vision_cfg("vit", None, dtype="float32", dropout=dropout, **TINY)
    kw = dict(fusion_name="attention", patch=16, image_size=32, dropout=dropout)
    return (JF.MMLateModel(text_cfg, vis_cfg, LABELS, **kw),
            TF.MMLateModel(torch_cfg(text_cfg), torch_cfg(vis_cfg), LABELS, **kw))


@pytest.fixture(scope="module")
def tiny_pair():
    rng = np.random.RandomState(5)
    jm, tm = _models()
    ids, mask = text_batch(rng, b=4, vocab=1000, pad_id=1)
    px = rng.randn(4, 32, 32, 3).astype(np.float32)
    # one compiled init (eager, every initialiser compiles on its own)
    params = jax.jit(lambda k, *a: JF.init_mm_late_params(jm, k, *a))(
        jax.random.PRNGKey(1), jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(px))
    carry(params, tm)
    return jm, tm, params, rng


def test_frozen_set_equals_the_jax_mask(tiny_pair):
    jm, tm, params, _ = tiny_pair
    marks = jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(np.shape(x), float(JO.vision_frozen_predicate(path, x)),
                        np.float32), params)
    jax_frozen = {n for n, a in torch_state_from_jax(marks).items() if a.all()}
    port_frozen = {n for n, _ in tm.named_parameters() if TO.vision_frozen(n)}
    assert jax_frozen == port_frozen and port_frozen
    assert all(n.startswith("dual.vision.") for n in port_frozen)


def test_train_step_matches_jax(tiny_pair):
    """One step with ITC + TIM, the swap injected and a padded row: the loss
    parts, the gradients of every trainable tensor and the parameters after
    AdamW against ``make_train_step_fn``."""
    jm, _, params, rng = tiny_pair
    _, tm = _models()
    carry(params, tm)
    b = 4
    ids, mask = text_batch(rng, b=b, vocab=1000, pad_id=1)
    px = rng.randn(b, 32, 32, 3).astype(np.float32)
    batch = {"ids": ids, "mask": mask, "pixel_values": px,
             "labels": np.eye(LABELS, dtype=np.float32)[[0, 2, 1, 1]],
             "valid": np.array([1, 1, 1, 0], np.float32),
             "tim_src": np.array([2, 1, 0, 3], np.int32),
             "tim_labels": np.array([0, 1, 0, 1], np.int32)}
    cw = np.array([1.0, 0.5, 2.0], np.float32)
    loss_kw = dict(num_labels=LABELS, use_clip_loss=True, use_tim_loss=True,
                   beta_itc=0.1, beta_itm=0.1)
    lr, wd = 1e-3, 0.01

    def jfwd(p, bt, tim, rng_, det):
        kw = ({"tim_src": tim["src"]} if det else
              {"tim_ids": tim["ids"], "tim_mask": tim["mask"]})
        return jm.apply(p, bt["ids"], bt["mask"], bt["pixel_values"], deterministic=det,
                        rngs=None if det else {"dropout": rng_}, **kw)

    jcfg = JS.LossConfig(**loss_kw)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tim, tim_labels = JS._maybe_tim(jcfg, None, jbatch)
    tx = JO.make_optimizer(lr, wd, JO.vision_frozen_predicate, fused=True)
    step = JS.make_train_step_fn(jfwd, jcfg, tx, class_weights=jnp.asarray(cw))

    @jax.jit
    def grads_and_step(p, bt):  # one compile for both
        grads = jax.grad(lambda q: JS.assemble_loss(
            jcfg, jfwd(q, bt, tim, jax.random.PRNGKey(0), False), bt, tim_labels,
            jnp.asarray(cw))[0])(p)
        return grads, step(p, tx.init(p), bt, jax.random.PRNGKey(0))

    jgrads, (jnew, _, jmetrics) = grads_and_step(params, jbatch)

    for n, p in tm.named_parameters():
        p.requires_grad_(not TO.vision_frozen(n))
    opt = TO.AdamW(tm.named_parameters(), lr, wd, frozen=TO.vision_frozen)

    def tfwd(bt, tim_, gen, det):
        kw = ({"tim_src": tim_["src"]} if det else
              {"tim_ids": tim_["ids"], "tim_mask": tim_["mask"]})
        return tm(bt["ids"].long(), bt["mask"], bt["pixel_values"], gen=gen, **kw)

    tstep = TS.TrainStep(tm, tfwd, TS.LossConfig(**loss_kw), opt, t(cw), keep_grads=True)
    tbatch = {k: t(v) for k, v in batch.items()}
    metrics = tstep(tbatch, torch.Generator().manual_seed(0))
    for key in ("loss", "cls_loss", "itc_loss", "itm_loss", "correct", "n"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    jg = torch_state_from_jax(jax.tree_util.tree_map(_n, jgrads))
    jp = torch_state_from_jax(jax.tree_util.tree_map(_n, jnew))
    p0 = torch_state_from_jax(jax.tree_util.tree_map(_n, params))
    assert set(tstep.last_grads) == {n for n in jg if not TO.vision_frozen(n)}
    gmax = max(np.abs(g).max() for n, g in jg.items() if not TO.vision_frozen(n))
    for name, g in tstep.last_grads.items():
        want = jg[name]
        got = np.zeros_like(want) if g is None else g.numpy()
        assert np.abs(got - want).max() <= 1e-4 * max(1e-3, np.abs(want).max()), name
        # Adam moves each entry by about lr; where the gradient is far from
        # zero its sign, and so the update, agree to float32 precision (a key
        # bias's exact gradient is zero: all of it is rounding noise)
        new = dict(tm.named_parameters())[name].detach().numpy()
        firm = np.abs(want) > 1e-4 * gmax
        np.testing.assert_allclose(new[firm], jp[name][firm], rtol=0, atol=1e-6, err_msg=name)
        assert np.abs(new - jp[name]).max() <= 2 * lr + 1e-6, name
    for name, p in tm.named_parameters():
        if TO.vision_frozen(name):
            np.testing.assert_array_equal(p.detach().numpy(), p0[name])

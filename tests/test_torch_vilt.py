"""The PyTorch port's ViLT (``models/vilt.py``) against the JAX package's, on
the CPU, with the JAX initial weights carried across by ``models/from_jax.py``
(``patch_proj`` HWIO -> OIHW, ``image_cls``, ``image_pos``,
``modality_type``, the stack, ``ln_final``, ``pooler``, ``linear``,
``linear_tim``, ``logit_scale``): ``interp_pos_grid``; the classifier's
outputs in the fixed-square mode and under ``--vilt_exact_resize`` (2 layers,
hidden 32, image_size 384: the exact joint sequence is 40 + 1 + 19 x 19 = 402
long, with a different image extent per row), with TIM batched and in two
passes; and the first train step's loss parts and gradients with the TIM
swap pinned and dropout 0. The JAX side runs its plain attention; the port's
runs ``sdpa`` with its autograd function, whose backward on the CPU is the
plain ``sdpa_bwd_reference``.

Tolerances: the position grid 1e-6 (the same float32 formula); outputs 1e-4
of their scale and gradients 1e-4 of each tensor's scale (float32 through
two layers of 402 tokens, summed in another order); losses 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.data.images import vilt_exact_geometry
from socialmedia_textimage_classification_auxlosses_tpu.models import vilt as JV
from socialmedia_textimage_classification_auxlosses_tpu.models.encoder import EncoderConfig
from socialmedia_textimage_classification_auxlosses_tpu.train import steps as JS
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import vilt as TV
from socialmedia_textimage_classification_auxlosses_tpu_torch.models.from_jax import (
    torch_state_from_jax,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.train import optim as TO
from socialmedia_textimage_classification_auxlosses_tpu_torch.train import steps as TS

from test_torch_from_jax import carry, t, torch_cfg

B, TEXT_LEN, LABELS, CANVAS = 3, 40, 3, 608
# photo sizes of 4:3, 3:4, 16:9 and 1:1: every row its own patch extent
PHOTOS = [(480, 640), (640, 480), (720, 1280), (500, 500)]


def _cfg():
    return EncoderConfig(vocab_size=97, hidden=32, layers=2, heads=2, mlp_dim=64,
                         max_positions=TEXT_LEN, type_vocab=2, ln_style="pre",
                         dropout=0.0, dtype="float32", attn_impl="jnp")


def _pair(exact, tim_batched=True):
    kw = dict(patch=32, image_size=384, dropout=0.0, tim_batched=tim_batched,
              canvas_size=CANVAS if exact else None)
    port_cfg = dataclasses.replace(torch_cfg(_cfg()), attn_impl="auto")
    return JV.ViltClassifier(_cfg(), LABELS, **kw), TV.ViltClassifier(port_cfg, LABELS, **kw)


def _batch(rng, exact):
    ids = rng.randint(4, 97, (B, TEXT_LEN)).astype(np.int32)
    mask = np.ones((B, TEXT_LEN), np.int32)
    for i, n in enumerate((TEXT_LEN, 17, 5)):
        ids[i, n:] = 0
        mask[i, n:] = 0
    side = CANVAS if exact else 384
    px = np.zeros((B, side, side, 3), np.float32)
    grid = np.array([vilt_exact_geometry(*PHOTOS[i]) for i in range(B)], np.int32)
    for i, (h, w) in enumerate(grid if exact else [(side, side)] * B):
        px[i, :h, :w] = rng.randn(h, w, 3)
    batch = {"ids": ids, "mask": mask, "token_type_ids": np.zeros_like(ids),
             "pixel_values": px,
             "labels": np.eye(LABELS, dtype=np.float32)[[0, 2, 1]],
             "valid": np.array([1, 1, 0], np.float32),
             "tim_src": np.array([1, 2, 2], np.int32),
             "tim_labels": np.array([0, 0, 1], np.int32)}
    if exact:
        batch["grid_hw"] = grid
    return batch


@pytest.fixture(scope="module", params=["fixed", "exact"])
def models(request):
    exact = request.param == "exact"
    rng = np.random.RandomState(7)
    batch = _batch(rng, exact)
    jm, _ = _pair(exact)
    # one compiled init (eager, every initialiser compiles on its own)
    params = jax.jit(lambda k, *a, grid_hw: JV.init_vilt_params(jm, k, *a, grid_hw=grid_hw))(
        jax.random.PRNGKey(3), jnp.asarray(batch["ids"]), jnp.asarray(batch["mask"]),
        jnp.asarray(batch["token_type_ids"]), jnp.asarray(batch["pixel_values"]),
        grid_hw=jnp.asarray(batch["grid_hw"]) if exact else None)
    return exact, params, batch


def test_interp_pos_grid_matches_jax(rng):
    spatial = rng.randn(12, 12, 16).astype(np.float32)
    extents = [(12, 12), (12, 19), (19, 12), (7, 19), (1, 5), (19, 19)]
    gh, gw = (np.array(e, np.int32) for e in zip(*extents))
    got = TV.interp_pos_grid(t(spatial), t(gh), t(gw), 19).numpy()
    for i, (h, w) in enumerate(extents):
        want = np.asarray(JV.interp_pos_grid(jnp.asarray(spatial), h, w, 19))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-6, err_msg=f"{h}x{w}")


def _jax_forward(jm, params, batch, tim=None, deterministic=True):
    tim = tim or {}
    return jm.apply(params, batch["ids"], batch["mask"], batch["token_type_ids"],
                    batch["pixel_values"], grid_hw=batch.get("grid_hw"),
                    tim_ids=tim.get("ids"), tim_mask=tim.get("mask"),
                    tim_token_type_ids=tim.get("token_type_ids"),
                    deterministic=deterministic)


def _port_forward(tm, batch, tim=None, gen=None):
    tim = tim or {}
    return tm(batch["ids"].long(), batch["mask"], batch["token_type_ids"].long(),
              batch["pixel_values"], grid_hw=batch.get("grid_hw"),
              tim_ids=None if "ids" not in tim else tim["ids"].long(),
              tim_mask=tim.get("mask"),
              tim_token_type_ids=None if "token_type_ids" not in tim
              else tim["token_type_ids"].long(), gen=gen)


@pytest.mark.parametrize("tim_batched", [True, False], ids=["tim_batched", "tim_two_pass"])
def test_classifier_outputs_match_jax(models, tim_batched):
    exact, params, batch = models
    jm, tm = _pair(exact, tim_batched)
    carry(params, tm)
    src = batch["tim_src"]
    jtim = {k: jnp.asarray(batch[k][src]) for k in ("ids", "mask", "token_type_ids")}
    want = jax.jit(lambda p, b, tm_: _jax_forward(jm, p, b, tm_))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jtim)
    tbatch = {k: t(v) for k, v in batch.items()}
    ttim = {k: t(batch[k][src]) for k in ("ids", "mask", "token_type_ids")}
    with torch.no_grad():
        got = _port_forward(tm, tbatch, ttim)
    for key in ("out_cls", "logits_per_text", "out_tim", "mm_features"):
        w = np.asarray(want[key], np.float32)
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(w).max()), err_msg=key)
    assert got["out_iadds"] is None


def test_image_mask_follows_the_resize_mode(models):
    """Exact mode masks the canvas past each image's extent; the fixed
    square attends its whole 12 x 12 grid."""
    exact, params, batch = models
    _, tm = _pair(exact)
    carry(params, tm)
    seen = {}

    def hook(mod, args, out):
        seen["mask"] = args[1]

    tm.backbone.encoder.register_forward_hook(hook)
    with torch.no_grad():
        _port_forward(tm, {k: t(v) for k, v in batch.items()})
    mask = seen["mask"].numpy()
    np.testing.assert_array_equal(mask[:, :TEXT_LEN], batch["mask"])
    if not exact:
        assert mask.shape == (B, TEXT_LEN + 1 + 12 * 12) and mask[:, TEXT_LEN:].all()
        return
    assert mask.shape == (B, TEXT_LEN + 1 + 19 * 19)
    for i, (h, w) in enumerate(batch["grid_hw"]):
        grid = mask[i, TEXT_LEN + 1:].reshape(19, 19)
        assert grid[:h // 32, :w // 32].all() and grid.sum() == (h // 32) * (w // 32)


def test_first_step_gradients_match_jax(models):
    """Loss parts and the gradient of every parameter (nothing is frozen in
    early fusion), TIM pinned through ``tim_src``/``tim_labels``."""
    exact, params, batch = models
    jm, tm = _pair(exact)
    carry(params, tm)
    loss_kw = dict(num_labels=LABELS, use_clip_loss=True, use_tim_loss=True,
                   beta_itc=0.1, beta_itm=0.1)
    cw = np.array([1.0, 0.5, 2.0], np.float32)
    jcfg = JS.LossConfig(**loss_kw)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tim, tim_labels = JS._maybe_tim(jcfg, None, jbatch)
    (_, jparts), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JS.assemble_loss(jcfg, _jax_forward(jm, p, jbatch, tim, False), jbatch,
                                   tim_labels, jnp.asarray(cw)), has_aux=True))(params)

    opt = TO.AdamW(tm.named_parameters(), 1e-3, 0.01)
    step = TS.TrainStep(tm, lambda bt, tim_, gen, det: _port_forward(tm, bt, tim_, gen),
                        TS.LossConfig(**loss_kw), opt, t(cw))
    grads, parts, _ = step.gradients({k: t(v) for k, v in batch.items()},
                                     torch.Generator().manual_seed(0))
    for key in ("loss", "cls_loss", "itc_loss", "itm_loss"):
        np.testing.assert_allclose(float(parts[key].detach()), float(jparts[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    jg = torch_state_from_jax(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                                     jgrads))
    assert set(grads) == set(jg) and len(grads) == len(list(tm.parameters()))
    assert opt.frozen_names == []
    for name, g in grads.items():
        want = jg[name]
        got = np.zeros_like(want) if g is None else g.numpy()
        assert np.abs(got - want).max() <= 1e-4 * max(1e-3, np.abs(want).max()), name

"""The PyTorch port's image-only classifiers and BEiT tower against the JAX
package's, on the CPU at a small size (two layers of width 64, 32-px images,
patch 16): the relative-position index, ``BeitClassifier`` (its
``BeitEncoder``) and the ViT / DeiT ``VisionClassifier`` (logits and every
parameter's gradient of a fixed linear function of them), the late-fusion
model with the BEiT tower (``DualEncoder(vision_arch="beit")``), and the
HF BEiT importer against the JAX importer. The JAX parameters are
carried across with ``models/from_jax.py``, every parameter drawn at random
(``_random_params``) so that no gradient is degenerate.

Tolerances: float32 outputs 1e-5 absolute at these O(1) scales, gradients
1e-4 relative to each gradient's largest entry; bfloat16 the whole-model
``BF16_TOL`` of ``test_torch_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.models import beit as JB
from socialmedia_textimage_classification_auxlosses_tpu.models import fusion as JF
from socialmedia_textimage_classification_auxlosses_tpu.models import vision as JV
from socialmedia_textimage_classification_auxlosses_tpu.models.text import (
    text_encoder_config as jax_text_cfg,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import beit as TB
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import fusion as TF
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import vision as TV
from socialmedia_textimage_classification_auxlosses_tpu_torch.models.from_jax import (
    jax_tree_from_torch,
    torch_state_from_jax,
)

from test_torch_from_jax import TINY, carry, close, j, t, text_batch, torch_cfg

LABELS = 3
SIZE = 32  # a 2x2 patch grid at patch 16
GEO = dict(patch=16, image_size=SIZE)


@pytest.mark.parametrize("grid", [1, 2, 3, 14])
def test_relative_position_index_matches_jax(grid):
    np.testing.assert_array_equal(TB.beit_relative_position_index(grid),
                                  JB.beit_relative_position_index(grid))


def _random_params(init, *args, seed=5):
    """Parameters of ``init(key, *args)`` without compiling it: the shapes
    from ``jax.eval_shape``; kernels and embeddings normal with std 1/sqrt(fan
    in), LayerNorm scales near 1, biases small, the BEiT tables, tokens, layer
    scales and position embeddings normal 0.5 (flax starts several of them at
    constants, whose gradients and effects would be degenerate), the ITC
    temperature at its init value."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda k: init(k, *args), jax.random.PRNGKey(0))

    def draw(path, sd):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = sd.shape
        if name == "logit_scale":
            return jnp.full(shape, 2.6592, sd.dtype)
        if name in ("kernel", "embedding"):
            fan_in = int(np.prod(shape[:-1])) if name == "kernel" else shape[-1]
            x = rng.randn(*shape) / np.sqrt(fan_in)
        elif name == "scale":
            x = 1.0 + 0.1 * rng.randn(*shape)
        elif name == "bias":
            x = 0.1 * rng.randn(*shape)
        else:
            x = 0.5 * rng.randn(*shape)
        return jnp.asarray(x.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _classifier(name, dtype):
    cfg = JV.vision_encoder_config(name, None, dtype=dtype, dropout=0.0, **TINY)
    jm = JV.build_vision_classifier(name, LABELS, dtype=dtype, dropout=0.0, **TINY)
    jm = jm.clone(image_size=SIZE)
    kw = dict(head_on=jm.head_on, num_prefix_tokens=jm.num_prefix_tokens,
              pooling=jm.pooling) if name != "beit" else {}
    cls = TV.BeitClassifier if name == "beit" else TV.VisionClassifier
    tm = cls(torch_cfg(cfg), LABELS, **GEO, **kw)
    return jm, tm


def _grads_close(tgrads, jgrads, tol=1e-4):
    """Every gradient within ``tol`` of its largest entry; a key bias (whose
    exact gradient is zero: it shifts a row's scores alike) within ``tol``
    of the largest gradient of the model."""
    want = torch_state_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(tgrads) == set(want), sorted(set(tgrads) ^ set(want))
    scale = max(np.abs(np.asarray(v)).max() for v in want.values())
    for k, g in tgrads.items():
        ref = np.asarray(want[k], np.float32)
        err = np.abs(g.numpy() - ref).max()
        of = scale if k.endswith("attention.key.bias") else np.abs(ref).max()
        assert err <= tol * of, (k, err, of)


@pytest.mark.parametrize("name", ["vit", "deit", "beit"])
def test_classifier_logits_and_gradients_match_jax(rng, name):
    jm, tm = _classifier(name, "float32")
    px = rng.randn(2, SIZE, SIZE, 3).astype(np.float32)
    w = rng.randn(2, LABELS).astype(np.float32)
    params = _random_params(jm.init, j(px), seed=1)

    def loss(p):
        logits = jm.apply(p, j(px))
        return jnp.sum(logits * w), logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    jgrads = jgrads["params"]
    carry(params, tm)
    tlogits = tm(t(px))
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), atol=1e-5)
    named = dict(tm.named_parameters())
    grads = torch.autograd.grad((tlogits * t(w)).sum(), list(named.values()),
                                allow_unused=True)
    tgrads = {k: (torch.zeros_like(p) if g is None else g)
              for (k, p), g in zip(named.items(), grads)}
    _grads_close(tgrads, jgrads)


@pytest.mark.parametrize("name", ["vit", "beit"])
def test_classifier_bfloat16_matches_jax(rng, name):
    jm, tm = _classifier(name, "bfloat16")
    px = rng.randn(2, SIZE, SIZE, 3).astype(np.float32)
    params = _random_params(jm.init, j(px), seed=2)
    jlogits = jax.jit(jm.apply)(params, j(px, jnp.bfloat16))
    carry(params, tm)
    with torch.no_grad():
        close(tm(t(px).bfloat16()), jlogits, "bfloat16")


def test_beit_encoder_takes_nchw_and_writes_the_jax_tree(rng):
    """NCHW pixels give the NHWC result; the tree written back has the JAX
    ``BeitEncoder``'s structure (``layer_{i}``, ``rel_pos_table``,
    ``lambda_*``, ``pool_ln``, a key without bias)."""
    cfg = JV.vision_encoder_config("beit", None, dropout=0.0, **TINY)
    tm = TB.BeitEncoder(torch_cfg(cfg), **GEO).eval()
    px = t(rng.randn(2, SIZE, SIZE, 3).astype(np.float32))
    with torch.no_grad():
        h1, p1 = tm(px)
        h2, p2 = tm(px.permute(0, 3, 1, 2))
    assert torch.equal(h1, h2) and torch.equal(p1, p2)
    jm = JB.BeitEncoder(cfg, patch=16, image_size=SIZE)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), j(np.zeros((1, SIZE, SIZE, 3))))
    back = jax_tree_from_torch(tm)
    assert (jax.tree_util.tree_map(lambda v: tuple(v.shape), back)
            == jax.tree_util.tree_map(lambda v: tuple(v.shape), shapes))


def _hf_beit_state(rng, layers=2, h=64, m=128, heads=2, grid=2):
    """A small HF ``BeitModel`` state dict (``beit.`` prefixed, as a
    checkpoint of the classification model's backbone names it)."""
    def a(*shape):
        return rng.randn(*shape).astype(np.float32)

    state = {"beit.embeddings.cls_token": a(1, 1, h),
             "beit.embeddings.patch_embeddings.projection.weight": a(h, 3, 16, 16),
             "beit.embeddings.patch_embeddings.projection.bias": a(h),
             "beit.pooler.layernorm.weight": a(h), "beit.pooler.layernorm.bias": a(h)}
    for i in range(layers):
        p = f"beit.encoder.layer.{i}"
        att = f"{p}.attention.attention"
        state.update({f"{p}.lambda_1": a(h), f"{p}.lambda_2": a(h),
                      f"{att}.key.weight": a(h, h),
                      f"{att}.relative_position_bias.relative_position_bias_table":
                          a((2 * grid - 1) ** 2 + 3, heads)})
        for name, out, inp in ((f"{att}.query", h, h), (f"{att}.value", h, h),
                               (f"{p}.attention.output.dense", h, h),
                               (f"{p}.intermediate.dense", m, h), (f"{p}.output.dense", h, m),
                               (f"{p}.layernorm_before", h, None),
                               (f"{p}.layernorm_after", h, None)):
            state[f"{name}.weight"] = a(out, inp) if inp else a(out)
            state[f"{name}.bias"] = a(out)
    return state


def test_beit_importer_matches_jax(rng, tmp_path):
    """The port's ``import_beit_tower`` gives the JAX importer's tree, and
    ``maybe_import_beit_tower`` lands it in the tower from a
    ``pytorch_model.bin`` directory (an empty directory leaves it)."""
    from socialmedia_textimage_classification_auxlosses_tpu.models import hf_import as JH
    from socialmedia_textimage_classification_auxlosses_tpu_torch.models import hf_import as TH

    state = _hf_beit_state(rng)
    want = torch_state_from_jax(JH.import_beit_tower(dict(state), 2))
    got = torch_state_from_jax(TH.import_beit_tower(dict(state), 2))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    torch.save({k: torch.from_numpy(v) for k, v in state.items()},
               str(tmp_path / "pytorch_model.bin"))
    cfg = JV.vision_encoder_config("beit", None, **TINY)
    tm = TV.BeitClassifier(torch_cfg(cfg), LABELS, **GEO)
    keys = TH.maybe_import_beit_tower(tm, str(tmp_path), 2, prefix="tower.")
    own = tm.state_dict()
    assert sorted(keys) == sorted("tower." + k for k in want)
    for k in want:
        np.testing.assert_array_equal(own["tower." + k].numpy(), want[k], err_msg=k)
    (tmp_path / "empty").mkdir()
    assert TH.maybe_import_beit_tower(tm, str(tmp_path / "empty"), 2, prefix="tower.") == []


@pytest.mark.parametrize("fusion", ["attention", "concat"])
def test_mm_late_with_beit_tower_matches_jax(rng, fusion):
    text_cfg = jax_text_cfg("bernice", None, vocab_size=1000, **TINY)
    vis_cfg = JV.vision_encoder_config("beit", None, dropout=0.0, **TINY)
    kw = dict(fusion_name=fusion, vision_arch="beit", vision_pooling="mean", **GEO)
    jm = JF.MMLateModel(text_cfg, vis_cfg, LABELS, **kw)
    tm = TF.MMLateModel(torch_cfg(text_cfg), torch_cfg(vis_cfg), LABELS, **kw)
    ids, mask = text_batch(rng, b=3, vocab=1000)
    px = rng.randn(3, SIZE, SIZE, 3).astype(np.float32)
    tim_src = np.array([1, 2, 0], np.int32)
    params = _random_params(lambda *a: JF.init_mm_late_params(jm, *a), j(ids, "int32"),
                            j(mask, "int32"), j(px), seed=4)
    jout = jax.jit(lambda p, *a: jm.apply(p, *a[:3], tim_src=a[3]))(
        params, j(ids, "int32"), j(mask, "int32"), j(px), j(tim_src, "int32"))
    carry(params, tm)
    with torch.no_grad():
        tout = tm(t(ids).long(), t(mask), t(px), tim_src=t(tim_src).long())
    for key in ("out_cls", "logits_per_text", "out_tim", "mm_features"):
        close(tout[key], jout[key], "float32", atol=1e-5)

"""PyTorch port's ``MMLateModel`` against the JAX package's, on the CPU at a
small size (Bernice + ViT towers, two layers of width 64), in all four
fusion modes, with the JAX parameters carried across: ``out_cls``,
``logits_per_text``, ``mm_features``, ``out_iadds`` and the ``tim_src``
path's ``out_tim``. Tolerances: float32 1e-4 (whole model); bfloat16 see
``test_torch_from_jax.BF16_TOL``."""

import jax
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
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import fusion as TF

from test_torch_from_jax import TINY, carry, close, j, t, text_batch, torch_cfg

LABELS = 3


def _models(fusion, dtype, attn_impl="auto"):
    text_cfg = jax_text_cfg("bernice", None, dtype=dtype, attn_impl=attn_impl,
                            vocab_size=1000, **TINY)
    vis_cfg = jax_vision_cfg("vit", None, dtype=dtype, attn_impl=attn_impl, **TINY)
    kw = dict(fusion_name=fusion, patch=16, image_size=32)
    jm = JF.MMLateModel(text_cfg, vis_cfg, LABELS, **kw)
    tm = TF.MMLateModel(torch_cfg(text_cfg), torch_cfg(vis_cfg), LABELS, **kw)
    return jm, tm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fusion", ["concat", "attention", "aspect-att", "gmu"])
def test_mm_late_matches_jax(rng, fusion, dtype):
    jm, tm = _models(fusion, dtype)
    ids, mask = text_batch(rng, b=3, vocab=1000)
    px = rng.randn(3, 32, 32, 3).astype(np.float32)
    tim_src = np.array([2, 0, 1], np.int32)
    params = JF.init_mm_late_params(jm, jax.random.PRNGKey(2), j(ids, "int32"),
                                    j(mask, "int32"), j(px))
    jout = jm.apply(params, j(ids, "int32"), j(mask, "int32"), j(px, dtype),
                    iadds_task=True, tim_src=j(tim_src, "int32"))
    carry(params, tm)
    with torch.no_grad():
        tout = tm(t(ids).long(), t(mask), t(px).to(getattr(torch, dtype)),
                  iadds_task=True, tim_src=t(tim_src).long())
    for key in ("out_cls", "logits_per_text", "mm_features", "out_iadds", "out_tim"):
        close(tout[key].float(), jout[key], dtype)


def test_mm_late_without_tim_has_no_tim_logits(rng):
    jm, tm = _models("attention", "float32")
    ids, mask = text_batch(rng, b=2, vocab=1000)
    px = rng.randn(2, 32, 32, 3).astype(np.float32)
    params = JF.init_mm_late_params(jm, jax.random.PRNGKey(3), j(ids, "int32"),
                                    j(mask, "int32"), j(px))
    jout = jm.apply(params, j(ids, "int32"), j(mask, "int32"), j(px))
    carry(params, tm)
    with torch.no_grad():
        tout = tm(t(ids).long(), t(mask), t(px))
    assert tout["out_tim"] is None and tout["out_iadds"] is None
    close(tout["out_cls"], jout["out_cls"], "float32")


def test_fused_attention_impl_matches_jax(rng):
    """``--attn_impl fused``: the encoder self-attention takes the block path
    (the Pallas kernel in interpret mode on the JAX side)."""
    jm, tm = _models("concat", "float32", attn_impl="fused_interpret")
    ids, mask = text_batch(rng, b=2, vocab=1000)
    px = rng.randn(2, 32, 32, 3).astype(np.float32)
    params = JF.init_mm_late_params(jm, jax.random.PRNGKey(4), j(ids, "int32"),
                                    j(mask, "int32"), j(px))
    jout = jm.apply(params, j(ids, "int32"), j(mask, "int32"), j(px))
    carry(params, tm)
    with torch.no_grad():
        tout = tm(t(ids).long(), t(mask), t(px))
    close(tout["out_cls"], jout["out_cls"], "float32")

"""PyTorch port's ``models/encoder.py`` towers against the JAX package's, on
the CPU at a small size: the Bernice text tower (small vocabulary) and the
ViT tower, unrolled and in the ``scan_layers`` parameter layout, carried
across by ``models/from_jax.py``. Tolerances: float32 1e-4 for whole towers
(several layers of float32 rounding in another order); bfloat16 see
``test_torch_from_jax.BF16_TOL``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.models import encoder as JE
from socialmedia_textimage_classification_auxlosses_tpu.models.vision import (
    vision_encoder_config as jax_vision_cfg,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import encoder as TE

from test_torch_from_jax import TINY, carry, close, j, t, text_batch, text_cfg, torch_cfg

VOCAB = 1000


@pytest.mark.parametrize("dtype,attn_impl,scan", [
    ("float32", "auto", False),
    ("float32", "fused_interpret", False),
    ("float32", "auto", True),
    ("bfloat16", "auto", False),
    ("bfloat16", "fused_interpret", False),
])
def test_bert_encoder_matches_jax(rng, dtype, attn_impl, scan):
    cfg = text_cfg(dtype, attn_impl, scan)
    ids, mask = text_batch(rng, vocab=VOCAB)
    jm = JE.BertEncoder(cfg)
    params = jm.init(jax.random.PRNGKey(0), j(ids, "int32"), j(mask, "int32"))
    jh, jp = jm.apply(params, j(ids, "int32"), j(mask, "int32"))
    tm = carry(params, TE.BertEncoder(torch_cfg(cfg)))
    with torch.no_grad():
        th, tp = tm(t(ids).long(), t(mask))
    assert th.dtype == torch.float32  # post-LN stream ends in a float32 LayerNorm
    assert tp.dtype == getattr(torch, dtype)
    close(th.float(), jh, dtype)
    close(tp.float(), jp, dtype)


@pytest.mark.parametrize("dtype,attn_impl,scan", [
    ("float32", "auto", False),
    ("float32", "fused_interpret", True),
    ("bfloat16", "auto", False),
])
def test_vit_encoder_matches_jax(rng, dtype, attn_impl, scan):
    cfg = jax_vision_cfg("vit", None, dtype=dtype, attn_impl=attn_impl,
                         scan_layers=scan, **TINY)
    px = rng.randn(2, 32, 32, 3).astype(np.float32)  # NHWC, 4 patches of 16
    jm = JE.ViTEncoder(cfg, patch=16, image_size=32)
    params = jm.init(jax.random.PRNGKey(1), j(px))
    jh, jp = jm.apply(params, j(px, dtype))
    tm = carry(params, TE.ViTEncoder(torch_cfg(cfg), patch=16, image_size=32))
    with torch.no_grad():
        th, tp = tm(t(px).to(getattr(torch, dtype)))
    close(th, jh, dtype)
    close(tp.float(), jp, dtype)


def test_roberta_positions_follow_the_jax_formula():
    """Padding slots (id 0 from the hashing tokenizer, pad_token_id 1) take
    increasing positions: the JAX formula is reproduced, not corrected."""
    cfg = dataclasses.replace(torch_cfg(text_cfg("float32")), max_positions=16)
    emb = TE.TextEmbeddings(cfg)
    with torch.no_grad():  # position p embeds as the one-hot of p
        emb.word.weight.zero_()
        emb.token_type.weight.zero_()
        emb.position.weight.copy_(torch.eye(16, cfg.hidden))
        emb.ln.weight.fill_(1.0)
        emb.ln.bias.zero_()
        out = emb(torch.tensor([[2, 7, 3, 0, 0]]))
    assert out.argmax(-1).tolist() == [[2, 3, 4, 5, 6]]

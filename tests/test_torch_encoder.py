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
    emb = TE.TextEmbeddings(cfg).eval()  # no dropout: it would draw from the global RNG
    with torch.no_grad():  # position p embeds as the one-hot of p
        emb.word.weight.zero_()
        emb.token_type.weight.zero_()
        emb.position.weight.copy_(torch.eye(16, cfg.hidden))
        emb.ln.weight.fill_(1.0)
        emb.ln.bias.zero_()
        out = emb(torch.tensor([[2, 7, 3, 0, 0]]))
    assert out.argmax(-1).tolist() == [[2, 3, 4, 5, 6]]


@pytest.mark.parametrize("seeds", [0, 3], ids=["plain", "seed_stacked"])
def test_token_type_product_is_the_gather(seeds):
    """``embed_few`` (the token-type lookup as a one-hot product, whose
    backward sums in a fixed order) gives the gather's values bit for bit
    and its table gradient within 1e-6, plain and seed-stacked."""
    gen = torch.Generator().manual_seed(0)
    shape = (seeds, 2, 8) if seeds else (2, 8)
    table = torch.randn(shape, generator=gen, requires_grad=True)
    ids = torch.randint(0, 2, (max(seeds, 1) * 4, 6), generator=gen)
    up = torch.randn(ids.shape + (8,), generator=gen)
    got, want = TE.embed_few(ids, table), TE.embed(ids, table)
    assert torch.equal(got, want)
    g_got, = torch.autograd.grad((got * up).sum(), table)
    g_want, = torch.autograd.grad((want * up).sum(), table)
    torch.testing.assert_close(g_got, g_want, rtol=0, atol=1e-6)

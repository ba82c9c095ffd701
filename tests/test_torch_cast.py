"""PyTorch port's ``cast_params_for_eval`` keeps exactly the parameters
float32 that the JAX package's keeps, on the full late-fusion tree of every
fusion head (mapped to torch names by ``models/from_jax.py``), and the cast
model computes what the float32-parameter model computes."""

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
from socialmedia_textimage_classification_auxlosses_tpu.utils.cast import (
    cast_params_for_eval as jax_cast,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import fusion as TF
from socialmedia_textimage_classification_auxlosses_tpu_torch.models.from_jax import (
    torch_state_from_jax,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.utils.cast import (
    cast_params_for_eval,
)

from test_torch_from_jax import TINY, carry, j, t, text_batch, torch_cfg


def _pair(fusion):
    text_cfg = jax_text_cfg("bernice", None, dtype="bfloat16", vocab_size=1000, **TINY)
    vis_cfg = jax_vision_cfg("vit", None, dtype="bfloat16", **TINY)
    kw = dict(fusion_name=fusion, patch=16, image_size=32)
    jm = JF.MMLateModel(text_cfg, vis_cfg, 3, **kw)
    ids = j(np.zeros((2, 8)), "int32")
    params = JF.init_mm_late_params(jm, jax.random.PRNGKey(0), ids, ids,
                                    j(np.zeros((2, 32, 32, 3))))
    tm = TF.MMLateModel(torch_cfg(text_cfg), torch_cfg(vis_cfg), 3, **kw)
    return jm, params, carry(params, tm)


@pytest.mark.parametrize("fusion", ["concat", "attention", "aspect-att", "gmu"])
def test_same_parameters_stay_float32(fusion):
    _, params, tm = _pair(fusion)
    jax_f32 = jax.tree_util.tree_map(
        lambda a: np.full(a.shape, float(a.dtype == jnp.float32), np.float32),
        jax_cast(params, "bfloat16"))
    expected = {k for k, v in torch_state_from_jax(jax_f32).items() if v.all()}
    cast_params_for_eval(tm, "bfloat16")
    kept = {k for k, v in tm.state_dict().items() if v.dtype == torch.float32}
    assert kept == expected
    assert any(k.startswith("dual.text.encoder") for k in tm.state_dict()
               if k not in kept)


def test_cast_model_computes_the_same(rng):
    _, params, tm = _pair("attention")
    ids, mask = text_batch(rng, b=2, vocab=1000)
    px = t(rng.randn(2, 32, 32, 3).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        ref = tm(t(ids).long(), t(mask), px)["out_cls"]
        cast_params_for_eval(tm, "bfloat16")
        out = tm(t(ids).long(), t(mask), px)["out_cls"]
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_float32_is_a_no_op():
    _, _, tm = _pair("concat")
    before = {k: v.dtype for k, v in tm.state_dict().items()}
    cast_params_for_eval(tm, "float32")
    assert {k: v.dtype for k, v in tm.state_dict().items()} == before

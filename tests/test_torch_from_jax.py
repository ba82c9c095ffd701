"""The PyTorch port's weight carrier, ``models/from_jax.py``: a JAX
parameter tree (unrolled or in the ``scan_layers`` layout) lands in the
port's modules key for key, and a tree that does not fit raises. The helpers
here carry weights for the other ``test_torch_*`` parity tests."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.models import encoder as JE
from socialmedia_textimage_classification_auxlosses_tpu.models.text import (
    text_encoder_config as jax_text_cfg,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import encoder as TE
from socialmedia_textimage_classification_auxlosses_tpu_torch.models.from_jax import (
    load_jax_params,
    torch_state_from_jax,
)

TINY = dict(hidden=64, layers=2, heads=2, mlp_dim=128)

# The suite runs in several pytest-xdist workers on one host, and each worker
# imports every test module. At torch's default of one intra-op thread per
# core in every worker, the workers' OpenMP threads outnumber the cores and
# spin against each other, so torch computes on at most two threads here.
torch.set_num_threads(min(2, torch.get_num_threads()))

# bfloat16 whole-model tolerance, relative to the output's scale: every dense
# layer rounds its product and bias sum to bfloat16 (relative step 3.9e-3),
# XLA and PyTorch round at different places, and a few layers compound it.
BF16_TOL = 3e-2


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def torch_cfg(jax_cfg):
    """The port's EncoderConfig with the same field values."""
    fields = {f.name for f in dataclasses.fields(TE.EncoderConfig)}
    return TE.EncoderConfig(**{k: v for k, v in dataclasses.asdict(jax_cfg).items()
                               if k in fields})


def carry(jax_params, torch_module):
    """Load a JAX parameter tree into ``torch_module`` (float32, eval)."""
    return load_jax_params(torch_module.float().eval(), to_numpy_tree(jax_params))


def text_batch(rng, b=3, length=12, vocab=1000, pad_id=0):
    """Ids padded with ``pad_id`` at the end, as the hashing tokenizer pads."""
    ids = rng.randint(4, vocab, size=(b, length)).astype(np.int32)
    mask = np.ones((b, length), np.int32)
    for i in range(b):
        n = rng.randint(3, length + 1)
        ids[i, n:] = pad_id
        mask[i, n:] = 0
    ids[:, 0] = 2
    return ids, mask


def close(out, ref, dtype, atol=1e-4):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    tol = atol if dtype == "float32" else BF16_TOL * max(1.0, np.abs(ref).max())
    assert err <= tol, f"max abs err {err} > {tol}"


def t(a, dtype=None):
    x = torch.from_numpy(np.asarray(a))
    return x if dtype is None else x.to(dtype)


def j(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype)


def text_cfg(dtype="float32", attn_impl="auto", scan=False, vocab=1000):
    """The JAX Bernice tower's config at the tiny size and a small vocab."""
    return jax_text_cfg("bernice", None, dtype=dtype, attn_impl=attn_impl,
                        vocab_size=vocab, scan_layers=scan, **TINY)


def test_scan_layout_converts_to_unrolled_keys():
    cfg = text_cfg("float32", scan=True)
    jm = JE.BertEncoder(cfg)
    ids = j(np.zeros((1, 4)), "int32")
    tree = to_numpy_tree(jm.init(jax.random.PRNGKey(0), ids, ids))
    state = torch_state_from_jax(tree)
    own = TE.BertEncoder(torch_cfg(cfg)).state_dict()
    assert set(state) == set(own)
    stacked = tree["params"]["encoder"]["layers"]["layer"]["attention"]["query"]["kernel"]
    np.testing.assert_array_equal(state["encoder.layers.1.attention.query.weight"],
                                  stacked[1].T)


def test_converter_raises_on_missing_and_extra_keys():
    cfg = text_cfg("float32")
    ids = j(np.zeros((1, 4)), "int32")
    tree = to_numpy_tree(JE.BertEncoder(cfg).init(jax.random.PRNGKey(0), ids, ids))
    module = TE.BertEncoder(torch_cfg(cfg))
    missing = {"params": {k: v for k, v in tree["params"].items() if k != "pooler"}}
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(module, missing)
    extra = {"params": dict(tree["params"], stray={"kernel": np.zeros((2, 2))})}
    with pytest.raises(ValueError, match="left over"):
        load_jax_params(module, extra)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["params"]["pooler"]["dense"]["kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(module, bad)



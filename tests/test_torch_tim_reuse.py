"""``--tim_reuse_text`` on the CPU: the JAX package's three cases of
``tests/test_tim_reuse.py`` for the port. The TIM rows are a permutation of
the batch's own rows (``train/itm.py``), so taking them from the first text
pass (``tim_src``) is the re-encoding path exactly in eval mode: outputs
bit-equal, gradients within rtol 1e-5 / atol 1e-6 (the gather sums its
rows' gradients in another order), each also against the JAX model on the
same weights (outputs 1e-5 and gradients 1e-4 of their scale, float32). In
training the reused rows share the first pass's dropout masks (the flag's
documented deviation); ``run_mm_late --tim_reuse_text`` trains end to end,
and its text tower takes B rows a step where the plain run's takes 2B.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.cli._common import ARCH_PRESETS
from socialmedia_textimage_classification_auxlosses_tpu.models import fusion as JF
from socialmedia_textimage_classification_auxlosses_tpu.models.text import (
    text_encoder_config as jax_text_cfg)
from socialmedia_textimage_classification_auxlosses_tpu.models.vision import (
    vision_encoder_config as jax_vision_cfg)
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_mm_late
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as C
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import encoder as TE
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import fusion as TF
from socialmedia_textimage_classification_auxlosses_tpu_torch.models.from_jax import (
    torch_state_from_jax)

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import make_task_fixture  # noqa: E402
from test_torch_from_jax import carry, t, torch_cfg  # noqa: E402
from test_torch_resnet import _random_variables  # noqa: E402

B, SEQ, IMG, VOCAB = 6, 10, 16, 64
KEYS = ("out_cls", "logits_per_text", "out_tim", "mm_features")


@pytest.fixture(scope="module")
def pair():
    """The JAX test's tiny model (dropout 0.1, 8-px patches of 16-px
    images), its weights drawn over ``jax.eval_shape`` and carried into the
    port's, and the JAX test's batch."""
    overrides = dict(ARCH_PRESETS["tiny"])
    text_cfg = jax_text_cfg("bernice", None, dtype="float32", attn_impl="jnp", **overrides)
    vis_cfg = jax_vision_cfg("vit", None, dtype="float32", attn_impl="jnp", **overrides)
    kw = dict(fusion_name="attention", dropout=0.1, patch=8, image_size=IMG)
    jm = JF.MMLateModel(text_cfg, vis_cfg, num_labels=3, **kw)
    tm = TF.MMLateModel(torch_cfg(text_cfg), torch_cfg(vis_cfg), 3, **kw)
    rng = np.random.RandomState(0)
    ids = rng.randint(4, VOCAB, (B, SEQ)).astype(np.int32)
    mask = np.ones((B, SEQ), np.int32)
    px = rng.rand(B, IMG, IMG, 3).astype(np.float32)
    a = [jnp.asarray(x) for x in (ids, mask, px)]
    params = _random_variables(jm, a[0][:2], a[1][:2], a[2][:2], tim_ids=a[0][:2],
                               tim_mask=a[1][:2], iadds_task=True, seed=3)
    carry(params, tm)
    return jm, tm, params, (ids, mask, px), rng


def _port(tm, data, src, reuse):
    ids, mask, px = (t(x) for x in data)
    kw = ({"tim_src": t(src).long()} if reuse else
          {"tim_ids": ids.long()[t(src).long()], "tim_mask": mask[t(src).long()]})
    return tm(ids.long(), mask, px, **kw)


def _jax(jm, params, data, src, reuse):
    ids, mask, px = (jnp.asarray(x) for x in data)
    s = jnp.asarray(src)
    kw = ({"tim_src": s} if reuse else
          {"tim_ids": jnp.take(ids, s, axis=0), "tim_mask": jnp.take(mask, s, axis=0)})
    return jm.apply(params, ids, mask, px, deterministic=True, **kw)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    assert np.abs(np.asarray(got, np.float32) - want).max() <= tol * max(1.0, np.abs(want).max())


def test_deterministic_outputs_identical(pair):
    jm, tm, params, data, _ = pair
    src = np.array([2, 1, 0, 3, 5, 4], np.int32)
    tm.eval()
    with torch.no_grad():
        ref = _port(tm, data, src, reuse=False)
        fast = _port(tm, data, src, reuse=True)
    want = jax.jit(lambda p: _jax(jm, p, data, src, reuse=True))(params)
    for k in KEYS:
        assert torch.equal(ref[k], fast[k]), k
        _close(fast[k].numpy(), want[k], 1e-5)


def test_gradients_identical_deterministic(pair):
    jm, tm, params, data, rng = pair
    src = np.array([1, 0, 3, 2, 5, 4], np.int32)
    labels = np.eye(3, dtype=np.float32)[rng.randint(0, 3, B)]
    tim_labels = rng.randint(0, 2, B).astype(np.int32)

    def port_grads(reuse):
        tm.eval()
        out = _port(tm, data, src, reuse)
        ce = -(torch.log_softmax(out["out_cls"], -1) * t(labels)).sum(-1).mean()
        itm = -torch.log_softmax(out["out_tim"], -1).gather(
            1, t(tim_labels).long()[:, None]).mean()
        names = [n for n, _ in tm.named_parameters()]
        grads = torch.autograd.grad(0.8 * ce + 0.2 * itm, list(tm.parameters()),
                                    allow_unused=True)
        return {n: g for n, g in zip(names, grads) if g is not None}

    def jax_loss(p):
        out = _jax(jm, p, data, src, reuse=True)
        ce = -jnp.mean(jnp.sum(jax.nn.log_softmax(out["out_cls"]) * labels, -1))
        itm = -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(out["out_tim"]),
                                            jnp.asarray(tim_labels)[:, None], 1))
        return 0.8 * ce + 0.2 * itm

    ref, fast = port_grads(False), port_grads(True)
    want = torch_state_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jax.jit(jax.grad(jax_loss))(params)))
    assert set(ref) == set(fast)
    for name in ref:
        np.testing.assert_allclose(fast[name].numpy(), ref[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
        if name.endswith("key.bias"):  # zero up to rounding: a softmax ignores a shift
            continue
        _close(fast[name].numpy(), want[name], 1e-4)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """``run_mm_late`` with and without the flag, the rows each training
    forward hands the text tower recorded."""
    root = tmp_path_factory.mktemp("tim_reuse")
    csv_path, img_fmt, _ = make_task_fixture(root / "data", task=3, n=24)
    mp = pytest.MonkeyPatch()
    mp.setitem(C.PATH, 3, csv_path)
    mp.setitem(C.IMG_FMT, 3, img_fmt)
    mp.setattr(C, "DATA_PATH", str(root / "data") + os.sep)
    for name in ("bernice", "vit"):
        d = root / "hub" / name
        d.mkdir(parents=True)
        (d / "config.json").write_text(json.dumps(
            {"hidden_dropout_prob": 0.1, "vocab_size": 1000, "image_size": 32,
             "patch_size": 16}))
        mp.setitem(C.MODEL_DIR_DICT, name, str(d) + os.sep)
    real = TE.BertEncoder.forward
    rows = []

    def forward(self, ids, *a, **kw):
        if self.training:
            rows[-1].append(ids.shape[0])
        return real(self, ids, *a, **kw)

    mp.setattr(TE.BertEncoder, "forward", forward)
    out = {}
    try:
        for name, extra in (("reuse", ["--tim_reuse_text"]), ("plain", [])):
            rows.append([])
            mp.setattr(C, "results_dir_mm_late", str(root / name) + os.sep)
            run_mm_late.main([
                "--txt_model_name", "bernice", "--img_model_name", "vit", "--fusion_name",
                "attention", "--task", "3", "--use_tim_loss", "--use_clip_loss", "--arch",
                "tiny", "--dtype", "float32", "--epochs", "1", "--log_every", "1",
                "--device", "cpu"] + extra)
            out[name] = (rows[-1], C.results_dir_mm_late)
    finally:
        mp.undo()
    return out


def test_cli_flag_reaches_model(cli_runs):
    rows, results = cli_runs["reuse"]
    stem = os.path.join(results, "bernice-vit-attention_task3_seed30_itc0.1itm0.1_")
    assert os.path.isfile(stem + "metrics_test.csv")
    assert rows == [16]  # one training step of batch 16: the first pass's rows only
    assert cli_runs["plain"][0] == [32]  # the TIM texts re-encoded beside them

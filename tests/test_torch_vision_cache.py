"""``--cache_vision`` (``cli/_build.py::VisionCachedPipe``,
``enable_vision_cache``) on the CPU: the JAX package's three cases of
``tests/test_remat_savedfeat_freeze.py`` (cached against plain over two
epochs; ``--steps_per_dispatch 2`` against one step at a time; every batch
computed once, in epoch 1) through the port's ``run_mm_late``, the cached
features against the JAX ``MMLateModel.encode_vision`` at the same weights,
and the CNN tower's warning.

Which random-stream case applies: the towers' dropout is 0.1 here (the
models' ``config.json`` sets ``hidden_dropout_prob``, as ``EncoderConfig``'s
default would without one), so the frozen tower's training-mode forward
draws its dropout masks from the step's generator. The cached run has no
tower in its step, so it draws fewer values, and from the head dropout of
its first step on its masks and TIM swaps differ from the plain run's (the
JAX package derives each module's masks from its own key, so there only
the tower's own masks go). Either way the two runs are held to what JAX's
test holds them to: the validation metrics of both epochs within rtol
1e-3, atol 1e-5 (a learning rate of 1e-5 moves the evaluated model little).
The chunked run replays the cached per-step run's draws, so it is held to
rtol 1e-6, atol 1e-7 as in JAX (bit-identical on the CPU). The features:
within 1e-5 of the JAX tower's scale (float32).
"""

import csv
import json
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.data.images import (
    normalize_on_device as jax_normalize)
from socialmedia_textimage_classification_auxlosses_tpu.models import fusion as JF
from socialmedia_textimage_classification_auxlosses_tpu.models.text import (
    text_encoder_config as jax_text_cfg)
from socialmedia_textimage_classification_auxlosses_tpu.models.vision import (
    vision_encoder_config as jax_vision_cfg)
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import _build as TBuild
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_mm_late
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as C
from socialmedia_textimage_classification_auxlosses_tpu_torch.models.from_jax import (
    jax_tree_from_torch)
from socialmedia_textimage_classification_auxlosses_tpu_torch.models.vision import IMAGE_NORM

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import make_task_fixture  # noqa: E402
from test_torch_from_jax import TINY  # noqa: E402

BASE = ["--txt_model_name", "bernice", "--img_model_name", "vit", "--fusion_name",
        "attention", "--task", "3", "--arch", "tiny", "--dtype", "float32", "--epochs", "2",
        "--use_clip_loss", "--use_tim_loss", "--log_every", "100", "--device", "cpu"]
STEM = "bernice-vit-attention_task3_seed30_itc0.1itm0.1_"
HUB = {"hidden_dropout_prob": 0.1, "vocab_size": 1000, "image_size": 32, "patch_size": 16}


def _val_metrics(results):
    with open(os.path.join(results, STEM + "metrics_val.csv"), newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["metric", "epoch-1", "epoch-2"]
    return np.array([r[1:] for r in rows[1:]], float)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("vision_cache")
    csv_path, img_fmt, _ = make_task_fixture(root / "data", task=3, n=40)
    mp = pytest.MonkeyPatch()
    mp.setitem(C.PATH, 3, csv_path)
    mp.setitem(C.IMG_FMT, 3, img_fmt)
    mp.setattr(C, "DATA_PATH", str(root / "data") + os.sep)
    hub = {}
    for name in ("bernice", "vit"):
        d = root / "hub" / name
        d.mkdir(parents=True)
        (d / "config.json").write_text(json.dumps(HUB))
        hub[name] = str(d) + os.sep
        mp.setitem(C.MODEL_DIR_DICT, name, hub[name])
    out = {"hub": hub}
    try:
        for name, extra in (("plain", []), ("cached", ["--cache_vision"]),
                            ("chunked", ["--cache_vision", "--steps_per_dispatch", "2"])):
            results = str(root / name) + os.sep
            mp.setattr(C, "results_dir_mm_late", results)
            _, setup = run_mm_late.main(BASE + extra)
            out[name] = (_val_metrics(results), setup)
    finally:
        mp.undo()
    return out


def test_cache_vision_equivalence(runs):
    plain, _ = runs["plain"]
    cached, setup = runs["cached"]
    assert all(isinstance(p, TBuild.VisionCachedPipe) for p in setup.pipes.values())
    assert not isinstance(runs["plain"][1].pipes["train"], TBuild.VisionCachedPipe)
    np.testing.assert_allclose(cached, plain, rtol=1e-3, atol=1e-5)


def test_cache_vision_with_chunked_dispatch(runs):
    np.testing.assert_allclose(runs["chunked"][0], runs["cached"][0], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("run", ["cached", "chunked"])
def test_vision_cache_hits_after_first_epoch(runs, run):
    """Each split's tower ran once per batch of epoch 1 (the batches
    partition the split, so each holds an image not seen before) and never
    in epoch 2; the cached batches carry no pixels."""
    _, setup = runs[run]
    for name, pipe in setup.pipes.items():
        assert pipe.num_batches > 0
        assert pipe.compute_calls == pipe.num_batches, name
    batch = next(setup.pipes["train"].device_iter("cpu"))
    assert "pixel_values" not in batch
    assert batch["vision_hidden"].shape == (16, 5, TINY["hidden"])  # (32 / 16)^2 + CLS
    assert batch["vision_pooled"].shape == (16, TINY["hidden"])
    assert setup.pipes["train"].compute_calls == setup.pipes["train"].num_batches


def test_cached_features_are_the_jax_towers(runs):
    """The cache's features of a batch against the JAX ``encode_vision`` of
    the same weights (the port's tree carried across) on its pixels."""
    _, setup = runs["cached"]
    pipe = setup.pipes["val"]
    batch = next(pipe.inner.batches())
    got = pipe._with_features(dict(batch))
    hub = runs["hub"]
    jm = JF.MMLateModel(jax_text_cfg("bernice", hub["bernice"], dtype="float32", **TINY),
                        jax_vision_cfg("vit", hub["vit"], dtype="float32", **TINY), 3,
                        fusion_name="attention", patch=16, image_size=32)
    tree = jax.tree_util.tree_map(lambda v: jnp.asarray(v.float().numpy()),
                                  jax_tree_from_torch(setup.model))
    mean, std = IMAGE_NORM["vit"]
    px = jax_normalize(jnp.asarray(batch["pixel_values"]), mean, std, jnp.float32)
    hidden, pooled = jax.jit(lambda p, x: jm.apply(p, x, method=JF.MMLateModel.encode_vision))(
        tree, px)
    for mine, want in ((got["vision_hidden"], hidden), (got["vision_pooled"], pooled)):
        want = np.asarray(want, np.float32)
        assert np.abs(mine.float().numpy() - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def test_cnn_tower_warns_and_runs_uncached(tmp_path, monkeypatch, caplog):
    csv_path, img_fmt, _ = make_task_fixture(tmp_path / "data", task=3, n=12)
    monkeypatch.setitem(C.PATH, 3, csv_path)
    monkeypatch.setitem(C.IMG_FMT, 3, img_fmt)
    monkeypatch.setattr(C, "DATA_PATH", str(tmp_path / "data") + os.sep)
    monkeypatch.setattr(C, "results_dir_mm_late", str(tmp_path / "res") + os.sep)
    argv = ["--txt_model_name", "bert", "--img_model_name", "resnet50", "--fusion_name",
            "concat_cnn", "--task", "3", "--arch", "tiny", "--dtype", "float32",
            "--image_size", "32", "--epochs", "0", "--cache_vision", "--device", "cpu"]
    with caplog.at_level(logging.WARNING):
        _, setup = run_mm_late.main(argv)
    assert "--cache_vision requires a (frozen) transformer vision tower" in caplog.text
    assert not any(isinstance(p, TBuild.VisionCachedPipe) for p in setup.pipes.values())
    assert torch.is_tensor(next(setup.pipes["train"].device_iter("cpu"))["pixel_values"])

"""The PyTorch port's trainer end to end against the JAX package's, on the
CPU: ``cli/run_mm_late.main`` of both packages on the generated task-3
fixture at ``--arch tiny --dtype float32 --dropout 0 --epochs 2
--use_clip_loss --use_saved_features --save_preds``, the port with
``--device cpu``, both starting from the JAX package's initial parameters
(carried into the port's ``build_mm_late_setup`` by the test). Tower dropout follows a model
directory's ``config.json`` in both packages, so the test points both at
directories whose config sets it to 0 (and 32-pixel images). TIM is left
out: its swaps are drawn from generators that cannot match (the step test in
``test_torch_train.py`` pins it). Both read the same batches in the same
order and the same pixel cache.

Compared: the metric CSVs of val and test (every metric and epoch within
1e-4 absolute: float32 through two tiny towers, two AdamW steps, summed in
another order) and the prediction CSV (the same ids, labels and
predictions). Besides, the flags the port does not carry yet exit with
``SystemExit``, those it carries are accepted, and asking for CUDA on a host
without it raises.
"""

import csv
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.cli import _build as JBuild
from socialmedia_textimage_classification_auxlosses_tpu.cli import run_mm_late as JRun
from socialmedia_textimage_classification_auxlosses_tpu.core import config as JC
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import _build as TBuild
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_mm_late as TRun
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as TC
from socialmedia_textimage_classification_auxlosses_tpu_torch.models.from_jax import (
    load_jax_params,
)

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import make_task_fixture  # noqa: E402
from test_torch_from_jax import to_numpy_tree  # noqa: E402

ARGS = ["--txt_model_name", "bernice", "--img_model_name", "vit",
        "--fusion_name", "attention", "--task", "3", "--epochs", "2", "--seed", "30",
        "--arch", "tiny", "--dtype", "float32", "--dropout", "0", "--use_clip_loss",
        "--use_saved_features", "--save_preds", "--log_every", "100"]
STEM = "bernice-vit-attention_task3_seed30_itc0.1_"


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e")
    csv_path, img_fmt, _ = make_task_fixture(root / "data", task=3, n=40)
    data = str(root / "data") + os.sep
    hub = {}
    for name in ("bernice", "vit"):
        d = root / "hub" / name
        d.mkdir(parents=True)
        (d / "config.json").write_text(json.dumps(
            {"hidden_dropout_prob": 0.0, "vocab_size": 1000, "image_size": 32,
             "patch_size": 16}))
        hub[name] = str(d) + os.sep
    mp = pytest.MonkeyPatch()
    mp.setenv("SMTC_COMPILE_CACHE", "0")
    out = {}
    captured = {}
    real_init = JBuild.init_mm_late_params

    def capture_init(model, *a, **k):  # jitted: one compile instead of one per initialiser
        params = jax.jit(lambda *arrays: real_init(model, *arrays, **k))(*a)
        captured["tree"] = to_numpy_tree(params)
        return params

    def carried_init(model, generator):
        load_jax_params(model, captured["tree"])

    try:
        for pkg, C in (("jax", JC), ("torch", TC)):
            mp.setitem(C.PATH, 3, csv_path)
            mp.setitem(C.IMG_FMT, 3, img_fmt)
            mp.setattr(C, "DATA_PATH", data)
            mp.setattr(C, "results_dir_mm_late", str(root / pkg) + os.sep)
            for name, d in hub.items():
                mp.setitem(C.MODEL_DIR_DICT, name, d)
        mp.setattr(JBuild, "init_mm_late_params", capture_init)
        JRun.main(ARGS)
        mp.setattr(TBuild, "init_weights", carried_init)
        TRun.main(ARGS + ["--device", "cpu"])
        for pkg in ("jax", "torch"):
            out[pkg] = {suffix: _read(str(root / pkg / (STEM + suffix)))
                        for suffix in ("metrics_val.csv", "metrics_test.csv", "preds.csv")}
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("table", ["metrics_val.csv", "metrics_test.csv"])
def test_metric_csvs_match_jax(runs, table):
    want, got = runs["jax"][table], runs["torch"][table]
    assert got[0] == want[0] == ["metric", "epoch-1", "epoch-2"]
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose(np.array([r[1:] for r in got[1:]], float),
                               np.array([r[1:] for r in want[1:]], float), rtol=0, atol=1e-4)


def test_prediction_csv_matches_jax(runs):
    want, got = runs["jax"]["preds.csv"], runs["torch"]["preds.csv"]
    assert got[0] == ["data_id", "label", "prediction"]
    assert got == want


REFUSED = [
    ["--mesh_pipe", "2"], ["--mesh_data", "2"],
    ["--mesh_model", "2"], ["--bucket_seq", "1"],
    ["--bucket_group"],
]
# the bucketing flags are ported: what they refuse is a bad value, with the
# JAX package's messages
REFUSED_AS = {"--bucket_seq": "buckets must be >= 2", "--bucket_group": "requires --bucket_seq"}
# refused until the port carried them; tests/test_torch_run_control.py runs the
# run-control flags, test_torch_lazy_emb.py, test_torch_vision_cache.py and
# test_torch_tim_reuse.py the next four, test_torch_quant.py and
# test_torch_imgdec.py the two after them, test_torch_scan_layers.py the last
PORTED = [
    ["--remat"], ["--steps_per_dispatch", "4"], ["--ckpt_every", "10"], ["--resume"],
    ["--profile", "p"], ["--extract_features"], ["--eval_txt_test"],
    ["--opt_impl", "lazy_emb"], ["--tim_reuse_text"], ["--cache_vision"],
    ["--img_model_name", "beit", "--cache_vision"],
    ["--bucket_seq"], ["--bucket_group", "--bucket_seq", "16,32"],
    ["--quantize", "w8"], ["--img_decoder", "native"], ["--scan_layers"],
]


@pytest.mark.parametrize("extra", REFUSED, ids=lambda e: e[0].lstrip("-"))
def test_unported_flags_exit(extra):
    args = TRun.parse_args(ARGS + ["--device", "cpu"] + extra)
    with pytest.raises(SystemExit, match=REFUSED_AS.get(extra[0], "not ported")):
        TRun.check_supported(args)


@pytest.mark.parametrize("extra", PORTED, ids=lambda e: e[0].lstrip("-"))
def test_ported_flags_are_accepted(extra, monkeypatch):
    monkeypatch.setenv("SMTC_IMG_DECODER", "pil")  # the check publishes --img_decoder
    TRun.check_supported(TRun.parse_args(ARGS + ["--device", "cpu"] + extra))


def test_asking_for_cuda_without_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TRun.main(ARGS)

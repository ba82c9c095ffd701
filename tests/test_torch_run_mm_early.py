"""The PyTorch port's ViLT trainer end to end against the JAX package's, on
the CPU: ``cli/run_mm_early.main`` of both packages on the generated task-3
fixture at ``--model vilt --arch tiny --dtype float32 --dropout 0 --epochs 2
--use_clip_loss --evaltest``, with ``--vilt_exact_resize`` and without, the port with
``--device cpu``, both starting from the JAX package's initial parameters
(carried into the port's ``build_mm_early_train_setup`` by the test). The
backbone's dropout follows the model directory's ``config.json`` in both
packages, so the test points both at a directory whose config sets it to 0.
Under ``--vilt_exact_resize`` each image is resized per sample onto the 608-px
canvas (the joint sequence is 40 + 1 + 19 x 19 = 402 tokens); without it,
onto the tiny preset's 64-px square. TIM is left out: its swaps are drawn from
generators that cannot match (``test_torch_vilt.py`` pins it). Both read the
same batches in the same order.

Compared: the metric CSVs of val and test (every metric and epoch within
1e-4 absolute: float32 through two tiny layers of up to 402 tokens, two AdamW
steps, summed in another order) and the prediction CSV (the same ids, labels
and predictions). Besides, the flags the port does not carry yet exit with
``SystemExit``, the flags and models it carries are accepted, asking for
CUDA on a host without it raises, and resolving a device sets the port's
float32 policy (TF32 off for matrix products and convolutions).
"""

import csv
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.cli import _build_early as JBuild
from socialmedia_textimage_classification_auxlosses_tpu.cli import run_mm_early as JRun
from socialmedia_textimage_classification_auxlosses_tpu.core import config as JC
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import _build_early as TBuild
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_mm_early as TRun
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as TC
from socialmedia_textimage_classification_auxlosses_tpu_torch.models.from_jax import (
    load_jax_params,
)

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import make_task_fixture  # noqa: E402
from test_torch_from_jax import to_numpy_tree  # noqa: E402

ARGS = ["--model", "vilt", "--task", "3", "--epochs", "2", "--seed", "30",
        "--vilt_exact_resize", "--arch", "tiny", "--dtype", "float32", "--dropout", "0",
        "--use_clip_loss", "--evaltest", "--log_every", "100"]
MODES = {"exact": ARGS, "fixed": [a for a in ARGS if a != "--vilt_exact_resize"]}
STEM = "vilt_task3_seed30_itc0.1_"


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module", params=sorted(MODES))
def runs(request, tmp_path_factory):
    argv = MODES[request.param]
    root = tmp_path_factory.mktemp(f"e2e_early_{request.param}")
    csv_path, img_fmt, _ = make_task_fixture(root / "data", task=3, n=40)
    data = str(root / "data") + os.sep
    hub = root / "hub" / "vilt"
    hub.mkdir(parents=True)
    (hub / "config.json").write_text(json.dumps({"hidden_dropout_prob": 0.0,
                                                 "vocab_size": 1000}))
    mp = pytest.MonkeyPatch()
    mp.setenv("SMTC_COMPILE_CACHE", "0")
    out = {}
    captured = {}
    real_init = JBuild.init_vilt_params

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
            mp.setattr(C, "results_dir_mm_early", str(root / pkg) + os.sep)
            mp.setitem(C.MODEL_DIR_DICT, "vilt", str(hub) + os.sep)
        mp.setattr(JBuild, "init_vilt_params", capture_init)
        JRun.main(argv)
        mp.setattr(TBuild, "init_vilt_weights", carried_init)
        TRun.main(argv + ["--device", "cpu"])
        for pkg in ("jax", "torch"):
            out[pkg] = {suffix: _read(str(root / pkg / (STEM + suffix)))
                        for suffix in ("metrics_val.csv", "metrics_test.csv", "preds.csv",
                                       "metrics.csv")}
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


def test_evaltest_artifacts_match_jax(runs):
    want, got = runs["jax"]["preds.csv"], runs["torch"]["preds.csv"]
    assert got[0] == ["data_id", "label", "prediction"]
    assert got == want
    want, got = runs["jax"]["metrics.csv"], runs["torch"]["metrics.csv"]
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose(np.array([r[1:] for r in got[1:]], float),
                               np.array([r[1:] for r in want[1:]], float), rtol=0, atol=1e-4)


REFUSED = [
    ["--mesh_pipe", "2"], ["--bucket_seq", "1"],
    ["--tim_reuse_text"], ["--cache_vision"],  # late-fusion flags the JAX runner ignores
]
# --bucket_seq is ported: what it refuses is a bad value, with the JAX package's message
REFUSED_AS = {"--bucket_seq": "buckets must be >= 2"}
# refused until the port carried them; tests/test_torch_run_control.py runs the
# flags, tests/test_torch_lxmert.py and tests/test_torch_mmbt.py the models,
# tests/test_torch_scan_layers.py --scan_layers
PORTED = [["--remat"], ["--ckpt_every", "10"], ["--profile", "p"],
          ["--model", "lxmert"], ["--model", "mmbt"], ["--opt_impl", "lazy_emb"],
          ["--bucket_seq"], ["--bucket_seq", "--bucket_group", "--steps_per_dispatch", "2"],
          ["--scan_layers"]]


@pytest.mark.parametrize("extra", REFUSED, ids=lambda e: "_".join(
    e if e[0] not in REFUSED_AS else e[:1]).lstrip("-"))
def test_unported_flags_exit(extra):
    args = TRun.parse_args(ARGS + ["--device", "cpu"] + extra)
    with pytest.raises(SystemExit, match=REFUSED_AS.get(extra[0], "not ported")):
        TRun.check_supported(args)


@pytest.mark.parametrize("extra", PORTED, ids=lambda e: "_".join(e).lstrip("-"))
def test_ported_flags_are_accepted(extra):
    TRun.check_supported(TRun.parse_args(ARGS + ["--device", "cpu"] + extra))


def test_asking_for_cuda_without_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TRun.main(ARGS)


def test_resolving_a_device_turns_tf32_off(monkeypatch):
    """Every entry point resolves its device through ``resolve_device``,
    which sets the float32 policy: TF32 off for cuBLAS and cuDNN."""
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._common import (
        resolve_device)

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False

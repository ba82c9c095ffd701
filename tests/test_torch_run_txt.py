"""The port's text-only runner on the CPU.

* ``models/text.py::TextClassifier`` against the JAX module on the same
  parameters (carried with ``models/from_jax.py``), float32, eval mode: the
  CLS head (bert) and the pooled head (roberta), logits within 1e-5.
* ``cli/run_txt.main`` on a generated task-3 fixture (``--arch tiny``): the
  artifacts under the JAX runner's names (``{model}_task{t}_seed{s}`` +
  ``_metrics_val.csv``, ``_metrics_test.csv``, ``_net.pth``, ``_preds.csv``,
  ``_preds_txt.csv``, ``_metrics_txt.csv``, checkpoints in ``..._ckpt/``);
  ``--freeze`` leaves the tower as it started; the flags the port does not
  carry exit with ``SystemExit``, those it carries are accepted.
"""

import csv
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.models import text as JT
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import _build as TBuild
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_txt
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as C
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import text as TT

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import make_task_fixture  # noqa: E402
from test_torch_from_jax import TINY, carry, text_batch  # noqa: E402

ARGS = ["--model_name", "bernice", "--task", "3", "--epochs", "1", "--arch", "tiny",
        "--dtype", "float32", "--log_every", "1", "--device", "cpu"]


@pytest.mark.parametrize("name", ["bert", "roberta"])
def test_text_classifier_matches_jax(name):
    rng = np.random.RandomState(6)
    kw = dict(dropout=0.1, dtype="float32", vocab_size=1000, **dict(TINY, layers=1))
    jm = JT.build_text_classifier(name, 3, **kw)
    tm = TT.build_text_classifier(name, 3, **kw)
    assert tm.use_pooled == (name == "roberta")
    ids, mask = text_batch(rng, b=3, vocab=1000, pad_id=jm.cfg.pad_token_id)
    jids, jmask = jnp.asarray(ids), jnp.asarray(mask)
    params = jax.jit(lambda key: jm.init(key, jids, jmask))(jax.random.PRNGKey(3))
    want = jax.jit(lambda p: jm.apply(p, jids, jmask, deterministic=True))(params)
    carry(params, tm)
    got = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def txt_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("run_txt")
    csv_path, img_fmt, _ = make_task_fixture(root / "data", task=3, n=40)
    with open(root / "data" / "text_data_mic.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "text", "label"])
        for i in range(12):
            w.writerow([7000 + i, f"only words {i}", i % 3])
    hub = root / "hub"
    hub.mkdir()
    (hub / "config.json").write_text(json.dumps({"hidden_dropout_prob": 0.1,
                                                 "vocab_size": 1000}))
    mp = pytest.MonkeyPatch()
    mp.setitem(C.PATH, 3, csv_path)
    mp.setattr(C, "TDATA5", str(root / "data" / "text_data_mic.csv"))
    mp.setattr(C, "results_dir_txt", str(root / "results") + os.sep)
    mp.setitem(C.MODEL_DIR_DICT, "bernice", str(hub) + os.sep)
    init = {}
    real_build = TBuild.build_text_setup

    def build(*a, **k):  # keep the initial weights of the --freeze run
        setup = real_build(*a, **k)
        init["state"] = {n: v.clone() for n, v in setup.model.state_dict().items()}
        return setup

    try:
        run_txt.main(ARGS + ["--save_model", "--save_preds", "--eval_txt_test",
                             "--ckpt_every", "2"])
        files = sorted(os.listdir(C.results_dir_txt))
        mp.setattr(run_txt, "build_text_setup", build)
        trainer, setup = run_txt.main(ARGS + ["--freeze"])
        frozen = (init["state"], {n: v.clone() for n, v in setup.model.state_dict().items()},
                  setup.optimizer.names)
    finally:
        mp.undo()
    return files, frozen


def test_run_txt_writes_the_jax_runners_artifacts(txt_runs):
    files, _ = txt_runs
    stem = "bernice_task3_seed30"  # JAX cli/run_txt.py: f"{model_name}_task{task}_seed{seed}"
    assert files == sorted(stem + s for s in (
        "_ckpt", "_metrics_test.csv", "_metrics_txt.csv", "_metrics_val.csv", "_net.pth",
        "_preds.csv", "_preds_txt.csv"))


def test_freeze_keeps_the_tower(txt_runs):
    _, (before, after, trained) = txt_runs
    assert trained == ["classifier.weight", "classifier.bias"]
    assert all(torch.equal(before[n], after[n]) for n in before if n.startswith("tower."))
    assert not torch.equal(before["classifier.weight"], after["classifier.weight"])


# the bucketing flags are ported: what they refuse is a bad value, with the
# JAX package's messages
@pytest.mark.parametrize("extra,message", [
    pytest.param(extra, message, id=extra[0].lstrip("-")) for extra, message in (
        (["--bucket_group"], "requires --bucket_seq"), (["--bucket_seq", "1"], "must be >= 2"),
        (["--mesh_data", "2"], "not ported"))])
def test_unported_flags_exit(extra, message):
    with pytest.raises(SystemExit, match=message):
        run_txt.main(ARGS + extra)


# refused until the port carried it; tests/test_torch_scan_layers.py runs it
@pytest.mark.parametrize("extra", [["--scan_layers"]], ids=lambda e: e[0].lstrip("-"))
def test_ported_flags_are_accepted(extra, monkeypatch):
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._common import (
        check_training_supported)

    monkeypatch.setenv("SMTC_IMG_DECODER", "pil")  # the check publishes --img_decoder
    check_training_supported(run_txt.parse_args(ARGS + extra))

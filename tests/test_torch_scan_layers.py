"""``--scan_layers`` in the PyTorch port's trainers, on the CPU at ``--arch tiny``.

In the JAX package the flag changes only the parameter layout: ``nn.scan``
over a stacked ``layers/layer`` tree computes what the unrolled stack
computes. The port trains its unrolled modules and reads the stacked tree
into them (``models/from_jax.py``). Checked:

* ``cli/run_txt.main --scan_layers`` of both packages for one epoch on the
  generated task-3 posts, the port starting from the JAX runner's scanned
  initial parameters (captured and carried across), dropout 0: the metric
  CSVs within 1e-4 absolute and the prediction CSV equal. JAX's scanned
  random init and dropout draw other streams than its unrolled ones
  (``split_rngs``), and the port matches neither, hence the carried weights
  and dropout 0.
* The port's headline run (``run_mm_late``, attention fusion, ITC + TIM) with
  and without the flag from the same seed: the saved ``net.pth`` state dicts,
  the metric CSVs and the prediction CSV bit for bit.
* ViLT, LXMERT and MMBT in the JAX ``scan_layers`` layout (parameters drawn
  over ``jax.eval_shape``, no initialiser compiled) carried into the port's
  modules: the classifier logits and the ITC logits within 1e-4 of their
  scale (float32, another summation order).
"""

import csv
import dataclasses
import json
import os
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.cli import run_txt as JRunTxt
from socialmedia_textimage_classification_auxlosses_tpu.core import config as JC
from socialmedia_textimage_classification_auxlosses_tpu.models import lxmert as JL
from socialmedia_textimage_classification_auxlosses_tpu.models import mmbt as JM
from socialmedia_textimage_classification_auxlosses_tpu.models import resnet as JR
from socialmedia_textimage_classification_auxlosses_tpu.models import text as JT
from socialmedia_textimage_classification_auxlosses_tpu.models import vilt as JV
from socialmedia_textimage_classification_auxlosses_tpu.models.encoder import EncoderConfig
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_mm_late
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_txt
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as TC
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import lxmert as TL
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import mmbt as TM
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import resnet as TR
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import vilt as TV

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import make_task_fixture  # noqa: E402
from test_torch_from_jax import carry, to_numpy_tree, torch_cfg  # noqa: E402
from test_torch_resnet import _random_variables  # noqa: E402

TXT = ["--model_name", "bernice", "--task", "3", "--epochs", "1", "--arch", "tiny",
       "--dtype", "float32", "--dropout", "0", "--seed", "30", "--log_every", "100",
       "--save_preds", "--scan_layers"]
LATE = ["--txt_model_name", "bernice", "--img_model_name", "vit", "--fusion_name",
        "attention", "--task", "3", "--epochs", "1", "--seed", "30", "--arch", "tiny",
        "--dtype", "float32", "--use_clip_loss", "--use_tim_loss", "--use_saved_features",
        "--save_model", "--save_preds", "--log_every", "100", "--device", "cpu"]
LATE_STEM = "bernice-vit-attention_task3_seed30_itc0.1itm0.1_"


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    """The generated task-3 posts and model directories whose configs set
    the towers' dropout to 0 (and 32-pixel images), both packages' configs
    pointed at them; -> the root."""
    root = tmp_path_factory.mktemp("scan_layers")
    csv_path, img_fmt, _ = make_task_fixture(root / "data", task=3, n=40)
    mp = pytest.MonkeyPatch()
    for name in ("bernice", "vit"):
        d = root / "hub" / name
        d.mkdir(parents=True)
        (d / "config.json").write_text(json.dumps(
            {"hidden_dropout_prob": 0.0, "vocab_size": 1000, "image_size": 32,
             "patch_size": 16}))
        for C in (JC, TC):
            mp.setitem(C.MODEL_DIR_DICT, name, str(d) + os.sep)
    for C in (JC, TC):
        mp.setitem(C.PATH, 3, csv_path)
        mp.setitem(C.IMG_FMT, 3, img_fmt)
        mp.setattr(C, "DATA_PATH", str(root / "data") + os.sep)
    yield root
    mp.undo()


@pytest.fixture(scope="module")
def txt_runs(task):
    """Both packages' ``run_txt --scan_layers``: {package: {table: rows}}."""
    captured = {}
    real = JRunTxt.build_text_setup

    def jax_build(*a, **k):
        setup = real(*a, **k)
        captured["params"] = to_numpy_tree(setup.params)
        return setup

    def port_build(*a, **k):
        setup = real_port(*a, **k)
        carry(captured["params"], setup.model)
        return setup

    def jitted_init(self, key, *args):  # one compile instead of one per initialiser
        return jax.jit(lambda k, *a: nn.Module.init(self, k, *a))(key, *args)

    real_port = run_txt.build_text_setup
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT.TextClassifier, "init", jitted_init)
        for pkg, C in (("jax", JC), ("torch", TC)):
            mp.setattr(C, "results_dir_txt", str(task / pkg) + os.sep)
        mp.setattr(JRunTxt, "build_text_setup", jax_build)
        mp.setattr(run_txt, "build_text_setup", port_build)
        JRunTxt.main(TXT)
        run_txt.main(TXT + ["--device", "cpu"])
    assert "layers" in captured["params"]["params"]["tower"]["encoder"]  # the scanned tree
    for pkg in ("jax", "torch"):
        out[pkg] = {s: _read(str(task / pkg / f"bernice_task3_seed30_{s}"))
                    for s in ("metrics_val.csv", "metrics_test.csv", "preds.csv")}
    return out


@pytest.mark.parametrize("table", ["metrics_val.csv", "metrics_test.csv"])
def test_run_txt_scan_layers_metrics_match_jax(txt_runs, table):
    want, got = txt_runs["jax"][table], txt_runs["torch"][table]
    assert got[0] == want[0] == ["metric", "epoch-1"]
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose(np.array([r[1:] for r in got[1:]], float),
                               np.array([r[1:] for r in want[1:]], float), rtol=0, atol=1e-4)


def test_run_txt_scan_layers_predictions_match_jax(txt_runs):
    assert txt_runs["torch"]["preds.csv"] == txt_runs["jax"]["preds.csv"]


def test_headline_run_with_and_without_the_flag_is_bit_equal(task):
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, extra in (("unrolled", []), ("scan_layers", ["--scan_layers"])):
            mp.setattr(TC, "results_dir_mm_late", str(task / "late" / name) + os.sep)
            run_mm_late.main(LATE + extra)
            runs[name] = str(task / "late" / name / LATE_STEM)
    a, b = (torch.load(runs[n] + "net.pth", map_location="cpu", weights_only=True)
            for n in ("unrolled", "scan_layers"))
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    for suffix in ("metrics_val.csv", "metrics_test.csv", "preds.csv"):
        with open(runs["unrolled"] + suffix, "rb") as x, open(runs["scan_layers"] + suffix,
                                                              "rb") as y:
            assert x.read() == y.read(), suffix


# -- the early-fusion models in the scanned layout --------------------------------

B, L, LABELS, VOCAB, PX, BOXES, FEAT = 3, 12, 3, 97, 64, 5, 24


def _enc(ln_style):
    return EncoderConfig(vocab_size=VOCAB, hidden=32, layers=2, heads=2, mlp_dim=64,
                         max_positions=32, type_vocab=2, ln_style=ln_style, dropout=0.0,
                         dtype="float32", attn_impl="jnp", scan_layers=True)


def _batch(rng):
    ids = rng.randint(4, VOCAB, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    for i, n in enumerate((L, 7, 4)):
        ids[i, n - 1], ids[i, n:], mask[i, n:] = 3, 0, 0
    ids[:, 0] = 2
    return {"ids": ids, "mask": mask, "token_type_ids": np.zeros_like(ids),
            "pixel_values": rng.randn(B, PX, PX, 3).astype(np.float32),
            "roi_features": rng.rand(B, BOXES, FEAT).astype(np.float32) * 2,
            "roi_boxes": np.sort(rng.rand(B, BOXES, 4).astype(np.float32), -1)}


def _models(name):
    """(JAX module in the scanned layout, the port's module, the JAX call's
    positional input names)."""
    if name == "vilt":
        kw = dict(patch=32, image_size=PX, dropout=0.0)
        tcfg = dataclasses.replace(torch_cfg(_enc("pre")), attn_impl="auto")
        return (JV.ViltClassifier(_enc("pre"), LABELS, **kw),
                TV.ViltClassifier(tcfg, LABELS, **kw),
                ("ids", "mask", "token_type_ids", "pixel_values"))
    if name == "mmbt":
        tcfg = dataclasses.replace(torch_cfg(_enc("post")), attn_impl="auto")
        kw = dict(cnn_name="resnet_scan_test", dropout=0.0)
        return (JM.MmbtClassifier(_enc("post"), LABELS, **kw),
                TM.MmbtClassifier(tcfg, LABELS, **kw), ("ids", "mask", "pixel_values"))
    lx = dict(vocab_size=VOCAB, hidden=32, heads=2, mlp_dim=64, max_positions=L, l_layers=2,
              r_layers=1, x_layers=2, visual_feat_dim=FEAT, dropout=0.0, dtype="float32")
    return (JL.LxmertClassifier(JL.LxmertConfig(**lx, attn_impl="jnp", scan_layers=True),
                                LABELS, dropout=0.0),
            TL.LxmertClassifier(TL.LxmertConfig(**lx, attn_impl="auto"), LABELS, dropout=0.0),
            ("ids", "mask", "token_type_ids", "roi_features", "roi_boxes"))


@pytest.mark.parametrize("name", ["vilt", "lxmert", "mmbt"])
def test_early_model_loads_the_scanned_tree(name, monkeypatch):
    monkeypatch.setitem(JR.STAGE_SIZES, "resnet_scan_test", (1, 1))
    monkeypatch.setitem(TR.STAGE_SIZES, "resnet_scan_test", (1, 1))
    batch = _batch(np.random.RandomState(4))
    jm, tm, inputs = _models(name)
    args = [jnp.asarray(batch[k]) for k in inputs]
    tim = {"tim_ids": args[0], "tim_mask": args[1]}  # the TIM head's parameters too
    if name != "mmbt":
        tim["tim_token_type_ids"] = args[2]
    params = _random_variables(jm, *args, seed=9, **tim)
    stacks = [path for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]
              if any(getattr(p, "key", None) == "layer" for p in path)]
    assert stacks, "the JAX tree is not in the scanned layout"
    keys = ("out_cls", "logits_per_text")
    want = jax.jit(lambda p, a: {k: v for k, v in jm.apply(p, *a).items() if k in keys})(
        params, args)
    got = carry(params, tm)(*[torch.from_numpy(batch[k]).long() if batch[k].dtype == np.int32
                              and k != "mask" else torch.from_numpy(batch[k]) for k in inputs])
    for key in keys:
        w, g = np.asarray(want[key]), got[key].detach().numpy()
        assert np.abs(g - w).max() <= 1e-4 * max(1.0, np.abs(w).max()), key

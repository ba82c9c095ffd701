"""The PyTorch port's paper-grid runner (``cli/run_grid.py``) against the JAX
package's, on the CPU: the same plan and artifact paths for the same argv,
the same tables from the same metric CSVs (markdown text-identical; CSV
columns identical and values within 1e-12 relative: pandas' fast CSV float
parser may round a value's last bit another way), a missing run flagged,
the runners the port lacks refused, and at fixture scale the same tables
under ``--seed_backend sequential`` and ``vmap`` (as ``tests/test_grid.py``
holds the JAX grid runner: floats rtol 5e-3 / atol 1e-4, the rest equal);
the ``img`` family runs through ``run_img`` under both backends (``vmap``
runs its seeds one by one, as the JAX grid runner does)."""

import csv
import os

import numpy as np
import pandas as pd
import pytest

from socialmedia_textimage_classification_auxlosses_tpu.cli import run_grid as J
from socialmedia_textimage_classification_auxlosses_tpu.core import config as JC
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_grid as T
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as TC

from fixtures import make_task_fixture, patch_task

PLANS = [
    ["--families", "txt,mm_late,mm_early", "--tasks", "3,2", "--seeds", "30,40",
     "--aux", "none,itc,itm,itc+itm", "--mm_late", "bernice-vit-attention,bert-vit-aspect-att"],
    ["--families", "mm_late", "--mm_late", "bert-vit-concat", "--tasks", "3", "--seeds", "30",
     "--aux", "none,itc", "--", "--nsamples", "100", "--testing"],
    ["--families", "mm_early,txt", "--txt", "bert,bernice", "--tasks", "6", "--seeds", "1,2,3",
     "--aux", "itm", "--beta_itm", "0.3", "--epochs", "3", "--", "--testing"],
    ["--families", "img,mm_late", "--img", "vit,beit,resnet152", "--mm_late",
     "bernice-resnet50-xatt,bert-beit-gmu", "--tasks", "3,6", "--seeds", "30,40",
     "--aux", "none", "--", "--testing"],
]


@pytest.fixture
def results(tmp_path, monkeypatch):
    for C in (JC, TC):
        patch_task(monkeypatch, C, 3, "unused.csv", "unused/{}.jpg", tmp_path / "results")
    return tmp_path


@pytest.mark.parametrize("argv", PLANS, ids=["families", "runner_args", "txt_early", "img"])
def test_plan_and_paths_equal_the_jax_plan(results, argv):
    want, got = J.build_plan(J.parse_args(argv)), T.build_plan(T.parse_args(argv))
    assert [(r.family, r.model, r.task, r.seed, r.aux, r.argv, r.val_csv, r.test_csv)
            for r in got] == [(r.family, r.model, r.task, r.seed, r.aux, r.argv, r.val_csv,
                               r.test_csv) for r in want]


def _write_metric_csv(path, rng, epochs):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rows = {"metric": JC.metric_names}
    for e in range(epochs):
        rows[f"epoch-{e + 1}"] = [float(rng.rand()) for _ in JC.metric_names]
    pd.DataFrame(rows).to_csv(path, index=False)


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _same_csv(got, want, rtol):
    assert got[0] == want[0] and len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        for a, b in zip(g, w):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                assert a == b
                continue
            assert a == b or np.isclose(fa, fb, rtol=rtol, atol=0), (a, b)


@pytest.mark.parametrize("select", ["best_val", "last"])
def test_tables_equal_the_jax_tables(results, select):
    """The same metric CSVs (one run missing, three epochs) aggregate into
    the JAX grid runner's tables."""
    argv = PLANS[0] + ["--metrics", "f1_macro,f1_weighted,accuracy", "--select", select]
    plan = J.build_plan(J.parse_args(argv))
    rng = np.random.RandomState(4)
    for i, run in enumerate(plan):
        if i != 5:
            _write_metric_csv(run.val_csv, rng, 3)
            _write_metric_csv(run.test_csv, rng, 3)
    jlong, jtables = J.aggregate(plan, J.parse_args(argv))
    tlong, ttables = T.aggregate(T.build_plan(T.parse_args(argv)), T.parse_args(argv))
    out = results / "tables"
    out.mkdir()
    jlong.to_csv(out / "j_runs.csv", index=False)
    T.write_rows(tlong, out / "t_runs.csv")
    _same_csv(_read(out / "t_runs.csv"), _read(out / "j_runs.csv"), 1e-12)
    assert [r["status"] for r in tlong].count("missing") == 1
    assert set(ttables) == set(jtables) == {"f1_macro", "f1_weighted"}  # no accuracy row
    for metric, stat in jtables.items():
        stat.to_csv(out / "j.csv", index=False)
        T.write_rows(ttables[metric], out / "t.csv")
        _same_csv(_read(out / "t.csv"), _read(out / "j.csv"), 1e-12)
        assert T.render_markdown(metric, ttables[metric], select) == J.render_markdown(
            metric, stat, select)


def test_missing_run_is_flagged(results):
    argv = ["--families", "txt", "--txt", "bert", "--tasks", "3", "--seeds", "30",
            "--aux", "none"]
    records, tables = T.aggregate(T.build_plan(T.parse_args(argv)), T.parse_args(argv))
    assert [r["status"] for r in records] == ["missing"] and tables == {}
    assert T.main(argv + ["--aggregate_only", "--out", str(results / "g")]) == 1
    assert _read(results / "g" / "grid_runs.csv") == [
        ["family", "model", "task", "aux", "seed", "status"],
        ["txt", "bert", "3", "none", "30", "missing"]]


@pytest.mark.parametrize("argv, plan", [
    (["--families", "img,mm_early", "--mm_early", "mmbt"],
     ["img: --task 3 --seed 30 --epochs 7 --model_name vit",
      "mm_early: --task 3 --seed 30 --epochs 7 --model mmbt"]),
    (["--families", "mm_early", "--mm_early", "vilt,lxmert"],
     ["mm_early: --task 3 --seed 30 --epochs 7 --model vilt",
      "mm_early: --task 3 --seed 30 --epochs 7 --model lxmert"]),
    (["--families", "mm_early", "--mm_early", "mmbt"],
     ["mm_early: --task 3 --seed 30 --epochs 7 --model mmbt"]),
], ids=["img", "lxmert", "mmbt"])
def test_early_fusion_families_are_planned(argv, plan, capsys):
    """LXMERT and MMBT grids plan like ViLT's (refused until the port carried
    them); MMBT's artifacts are looked for under ``results_dir_mmbt``."""
    assert T.main(argv + ["--tasks", "3", "--seeds", "30", "--aux", "none", "--dry_run"]) == 0
    assert capsys.readouterr().out.strip().splitlines() == plan
    for run in T.build_plan(T.parse_args(argv + ["--tasks", "3", "--seeds", "30",
                                                 "--aux", "none"])):
        if run.family == "mm_early":
            base = TC.results_dir_mmbt if run.model == "mmbt" else TC.results_dir_mm_early
            assert run.val_csv == f"{base}{run.model}_task3_seed30__metrics_val.csv"


def test_dry_run_prints_the_plan(capsys):
    assert T.main(["--families", "mm_early,txt", "--tasks", "3", "--seeds", "30",
                   "--aux", "none,itm", "--dry_run"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == ["mm_early: --task 3 --seed 30 --epochs 7 --model vilt",
                     "mm_early: --task 3 --seed 30 --epochs 7 --use_tim_loss --beta_itm 0.1 "
                     "--model vilt",
                     "txt: --task 3 --seed 30 --epochs 7 --model_name bernice"]


FAST = ["--arch", "tiny", "--dtype", "float32", "--attn_impl", "jnp", "--log_every", "1",
        "--device", "cpu"]


def test_grid_backends_give_the_same_tables(tmp_path, monkeypatch):
    """Two seeds x aux {none, itc+itm} of a tiny mm_late config through the
    port's runners, one by one and as seed sweeps: the same tables; a rerun
    skips every run."""
    csv_path, img_fmt, _ = make_task_fixture(tmp_path / "data", task=3)
    patch_task(monkeypatch, TC, 3, csv_path, img_fmt, tmp_path / "results")
    base = ["--families", "mm_late", "--mm_late", "bert-vit-concat", "--tasks", "3",
            "--seeds", "30,40", "--aux", "none,itc+itm", "--epochs", "1"]
    outs = {}
    for backend in ("sequential", "vmap"):
        out = str(tmp_path / backend) + os.sep
        plan = T.build_plan(T.parse_args(base + ["--"] + FAST))
        for r in plan:  # the other backend's artifacts go: every run runs again
            for p in (r.val_csv, r.test_csv):
                if os.path.exists(p):
                    os.remove(p)
        assert T.main(base + ["--seed_backend", backend, "--out", out, "--"] + FAST) == 0
        outs[backend] = out
    before = {r.val_csv: os.path.getmtime(r.val_csv) for r in plan}
    assert T.main(base + ["--seed_backend", "vmap", "--out", outs["vmap"], "--"] + FAST) == 0
    assert before == {p: os.path.getmtime(p) for p in before}  # nothing ran again
    for name in ("grid_runs.csv", "grid_table_f1_macro.csv", "grid_table_f1_weighted.csv"):
        a, b = _read(outs["sequential"] + name), _read(outs["vmap"] + name)
        assert a[0] == b[0] and len(a) == len(b) > 1, name
        for ra, rb in zip(a[1:], b[1:]):
            for x, y in zip(ra, rb):
                try:
                    np.testing.assert_allclose(float(y), float(x), rtol=5e-3, atol=1e-4,
                                               err_msg=name)
                except ValueError:
                    assert x == y, name
    runs = _read(outs["vmap"] + "grid_runs.csv")
    assert len(runs) == 5 and all(r[5] == "ok" for r in runs[1:])
    md = {k: open(v + "grid_table_f1_macro.md").read() for k, v in outs.items()}
    assert "| bert-vit-concat [mm_late] +ITC+ITM |" in md["vmap"]


def test_img_family_runs_under_both_backends(tmp_path, monkeypatch):
    """Two seeds of a tiny ViT through ``run_img``: ``vmap`` runs them one by
    one (not a late-fusion family), so both backends write the same tables."""
    csv_path, img_fmt, _ = make_task_fixture(tmp_path / "data", task=3)
    patch_task(monkeypatch, TC, 3, csv_path, img_fmt, tmp_path / "results")
    hub = tmp_path / "hub"
    hub.mkdir()
    (hub / "config.json").write_text('{"image_size": 32, "patch_size": 16}')
    monkeypatch.setitem(TC.MODEL_DIR_DICT, "vit", str(hub) + os.sep)
    base = ["--families", "img", "--img", "vit", "--tasks", "3", "--seeds", "30,40",
            "--epochs", "1", "--force"]
    tables = {}
    for backend in ("sequential", "vmap"):
        out = str(tmp_path / backend) + os.sep
        assert T.main(base + ["--seed_backend", backend, "--out", out, "--"] + FAST) == 0
        runs = _read(out + "grid_runs.csv")
        assert [r[:3] + r[5:6] for r in runs[1:]] == [["img", "vit", "3", "ok"]] * 2
        tables[backend] = open(out + "grid_table_f1_macro.md").read()
    assert "| vit [img] |" in tables["vmap"] and tables["vmap"] == tables["sequential"]

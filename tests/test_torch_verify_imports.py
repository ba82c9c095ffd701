"""The PyTorch port's ``cli/verify_imports.py`` on the CPU.

The synthetic stage's list covers every importer of the port's
``models/hf_import.py`` (a directory wrapper ``maybe_import_*`` the list does
not name through the tree builder it calls; the real stage calls those
wrappers), and the ResNet, Faster R-CNN and JAX-artifact loaders, and names
tests that exist; its rows come from one pytest run (the
run itself is the port's importer suite, which the tier-1 run already runs,
so here its output is given). The real stage runs against tiny checkpoints
saved with ``transformers`` (BERT, ViT, ViLT, as the JAX package's test
does): the port's imported towers match ``from_pretrained`` within 1e-4;
``main --stage real`` prints the table (families with weights PASS, absent
ones SKIP, every row SKIP where ``transformers`` is missing) and exits 0
unless a check failed; a reference-trained ViLT wrapper imports.
"""

import ast
import importlib.util
import os
import subprocess
import types

import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import verify_imports as V
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as C
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import hf_import as H

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Tiny BERT, ViT and ViLT checkpoints written by ``save_pretrained``
    (the JAX package's test's geometry)."""
    tmp = tmp_path_factory.mktemp("hf")
    with pytest.MonkeyPatch.context() as m:
        m.setenv("USE_TF", "0")  # transformers need not import TensorFlow here
        import test_verify_imports as JT

        dirs = {"bert": str(tmp / "BERT-base"), "vit": str(tmp / "ViT"), "vilt": str(tmp / "ViLT")}
        JT._save_tiny_bert(dirs["bert"])
        JT._save_tiny_vit(dirs["vit"])
        JT._save_tiny_vilt(dirs["vilt"])
    return dirs


def _functions(path):
    return {n.name: n for n in ast.parse(open(path).read()).body
            if isinstance(n, ast.FunctionDef)}


def test_synthetic_suite_covers_every_importer():
    texts = {}
    for _, nodeid in V.SYNTHETIC_SUITE:
        path, _, test = nodeid.partition("::")
        assert os.path.isfile(os.path.join(REPO, path)), nodeid
        texts[path] = open(os.path.join(REPO, path)).read()
        if test:
            assert test in _functions(os.path.join(REPO, path)), nodeid
    suite = "\n".join(texts.values())
    importers = {name: node for name, node in _functions(H.__file__).items()
                 if name.startswith(("import_", "maybe_import_", "load_", "read_"))}
    calls = {name: {c.func.id for c in ast.walk(node)
                    if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)} & set(importers)
             for name, node in importers.items()}
    # an importer reached only through one the suite names counts too
    named = frontier = {name for name in importers if name in suite}
    while frontier:
        frontier = set().union(*(calls[n] for n in frontier)) - named
        named = named | frontier
    # the directory wrappers maybe_import_* that no suite test names are the
    # real stage's entry points; the tree builder each calls is covered
    wrappers = {n for n in set(importers) - named if n.startswith("maybe_import_")}
    assert all(calls[n] & named for n in wrappers), wrappers
    assert named | wrappers == set(importers), sorted(set(importers) - named - wrappers)
    for loader in ("load_frcnn", "load_params", "frcnn_state_from_jax"):
        assert loader in suite, loader


def test_synthetic_rows_and_exit_code(monkeypatch, capsys):
    """Rows from the pytest run's summary: a row fails when a failed test
    lies under its node id; an aborted run fails every row."""
    first, second = V.SYNTHETIC_SUITE[0][1], V.SYNTHETIC_SUITE[1][1]
    out = f"FAILED {second}[x] - AssertionError\n1 failed, 40 passed\n"
    monkeypatch.setattr(subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(returncode=1, stdout=out))
    rows = V.run_synthetic()
    status = {nodeid: s for _, _, s, nodeid in rows}
    assert status[second] == "FAIL" and status[first] == "PASS"
    assert sum(s == "FAIL" for s in status.values()) == 1
    assert V.main(["--stage", "synthetic"]) == 1
    assert "10/11 checks ok" in capsys.readouterr().out
    monkeypatch.setattr(subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(returncode=2, stdout="error"))
    assert all(s.startswith("FAIL") for _, _, s, _ in V.run_synthetic())


@pytest.mark.parametrize("family", ["bert", "vit", "vilt"])
def test_real_stage_against_saved_checkpoints(saved, family):
    if family == "bert":
        err = V.check_text_tower("bert", saved["bert"], atol=1e-4, seq=10)
    elif family == "vit":
        err = V.check_vision_tower("vit", saved["vit"], atol=1e-4)
    else:
        err = V.check_vilt(saved["vilt"], atol=1e-4, seq=8)
    assert err <= 1e-4


def test_real_stage_table_and_exit_code(saved, tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(C.MODEL_DIR_DICT, "bert", saved["bert"])
    for fam in ("bertweet", "roberta", "bernice", "vit", "beit", "deit", "vilt", "lxmert"):
        monkeypatch.setitem(C.MODEL_DIR_DICT, fam, str(tmp_path / "missing" / fam))
    assert V.main(["--stage", "real", "--atol", "1e-4"]) == 0
    out = capsys.readouterr().out
    assert "PASS" in out and out.count("SKIP (no weights)") == 8
    # where transformers is missing (the card's machine) a row is skipped
    real_find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "transformers" else real_find(name, *a))
    assert V.main(["--stage", "real"]) == 0
    assert "SKIP (no transformers)" in capsys.readouterr().out
    monkeypatch.undo()
    # a failed check fails the run: the ViT directory read as BERT's
    monkeypatch.setitem(C.MODEL_DIR_DICT, "bert", saved["vit"])
    assert V.main(["--stage", "real", "--families", "bert"]) == 1
    assert "FAIL" in capsys.readouterr().out


def test_reference_ckpt_check_vilt(tmp_path):
    """A reference-trained ViLT wrapper .pth imports cleanly."""
    from transformers import ViltConfig, ViltModel

    class Wrapper(torch.nn.Module):
        def __init__(self):
            super().__init__()
            torch.manual_seed(3)
            self.model = ViltModel(ViltConfig(
                vocab_size=50, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=64, image_size=32, patch_size=8, max_position_embeddings=20))
            self.linear = torch.nn.Linear(32, 3)
            self.linear_tim = torch.nn.Linear(32, 2)
            self.logit_scale = torch.nn.Parameter(torch.ones([]) * 2.6592)

    path = str(tmp_path / "vilt_task3_seed30__net.pth")
    torch.save(Wrapper().state_dict(), path)
    assert V.check_reference_ckpt("vilt", path, atol=1e-4) == len(Wrapper().state_dict())

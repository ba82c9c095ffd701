"""The PyTorch port's ``cli/export.py`` (``torch.export`` of the serving
predict) on the CPU at ``--arch tiny``.

Checked: the ``.json`` sidecar has the JAX package's keys (read from the JAX
``export_service``'s sidecar literal: lowering the JAX model to StableHLO
would only repeat what ``tests/test_export.py`` does); a ``cpu`` program
loads and runs in a subprocess in which the port's package cannot be
imported, and its probabilities match the live service at the JAX
package's tolerance (rtol 1e-5, atol 1e-7), with ``--quantize w8``, whose
int8 weights the loaded program holds; each ``torch.library`` op the ``cuda``
programs hold (``smtc::sdpa_fwd``, ``smtc::attn_block_fwd``) has a fake
implementation that gives its plain version's shape and dtype, and no CPU
implementation. ``--export_detector`` writes the tiny fused detector for the
CPU at ``--detector_batch 2``, one program per canvas orientation, each
loaded and held against the live detector's fused path on preprocessed
images (rtol 1e-5, atol 1e-4, the JAX package's ``test_detector_export_
matches_live``); its greedy NMS is the op ``smtc::nms_keep``, which equals
``nms_keep_device`` and the host ``greedy_nms`` on seeded boxes, and whose
fake gives its outputs' shapes and dtypes under ``torch.export``.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import socialmedia_textimage_classification_auxlosses_tpu.cli.export as jexport_module
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import export as TExport
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import frcnn as FR
from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attention as A
from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attn_block as AB

FLAGS = ["--task", "3", "--txt_model_name", "bert", "--img_model_name", "vit",
         "--fusion_name", "attention", "--arch", "tiny", "--max_batch", "2",
         "--random_init", "--seed", "11", "--device", "cpu"]


# a serving host with torch alone: the port's package is blocked from import;
# torch and the program loader are imported before the program exists, then
# it reads "program inputs" on stdin, loads the program and runs it on them
LOADER = textwrap.dedent("""
    import json, sys
    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.startswith("socialmedia_textimage_classification"):
                raise ImportError("blocked: " + name)
    sys.meta_path.insert(0, Block())
    import numpy as np, torch
    from torch._export.serde import serialize  # noqa: F401 (the loader's imports)
    exported, inputs = sys.stdin.readline().split()
    sidecar = json.load(open(exported + ".json"))
    batch = np.load(inputs)
    loaded = torch.export.load(exported)
    with torch.no_grad():
        probs = loaded.module()(*[torch.from_numpy(batch[k]) for k in sidecar["inputs"]])
    assert not any(m.startswith("socialmedia_textimage_classification") for m in sys.modules)
    state = {k: str(v.dtype) for k, v in loaded.state_dict.items()}
    print(json.dumps({"probs": probs.tolist(), "state": state}))
""")


@pytest.fixture(scope="module")
def loader(tmp_path_factory):
    """``LOADER`` started in a subprocess (killed at the end if it is still
    running)."""
    proc = subprocess.Popen([sys.executable, "-c", LOADER], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=str(tmp_path_factory.mktemp("loader")),
                            env={**os.environ, "PYTHONPATH": ""})
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def exported(loader, tmp_path_factory):
    """The tiny service exported for the CPU under ``--quantize w8`` (its
    two Dense kernels of 2^14 elements held in int8), checked against the
    live predict by ``--check``, while ``loader`` starts."""
    out = str(tmp_path_factory.mktemp("export") / "tiny.pt2")
    live = {}
    real = TExport.export_service

    def keep(args, platforms=None):  # the live service the CLI exported, for the tests
        live.update(real(args, platforms))
        return live

    with pytest.MonkeyPatch.context() as m:
        m.setattr(TExport, "export_service", keep)
        TExport.main(["--out", out, "--check", "--platforms", "cpu", "--quantize", "w8"]
                     + FLAGS)
    return out, live["cpu"][3]


def _jax_sidecar_keys():
    tree = ast.parse(open(jexport_module.__file__).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "sidecar" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no sidecar literal in the JAX export_service")


def test_sidecar_has_the_jax_keys(exported):
    sidecar = json.load(open(exported[0] + ".json"))
    assert set(sidecar) == _jax_sidecar_keys()
    assert sidecar["platforms"] == ["cpu"] and sidecar["format"].startswith("torch.export")
    assert sidecar["num_labels"] == 3 and sidecar["max_batch"] == 2
    assert set(sidecar["inputs"]) >= {"ids", "mask", "pixel_values"}
    assert sidecar["inputs"]["pixel_values"]["dtype"] == "uint8"


@pytest.fixture(scope="module")
def loaded_alone(exported, loader):
    """The program loaded and run by ``loader``: (its probabilities on two
    requests, the live service's on the same, the names and dtypes of its
    state dict)."""
    from PIL import Image

    exported, info = exported
    img = Image.fromarray(np.random.RandomState(3).randint(0, 255, (48, 64, 3), np.uint8))
    reqs = [("a tweet with a photo", img), ("text only", None)]
    batch = info["make_batch"](reqs)
    with torch.no_grad():
        live = info["predict"]({k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    inputs = str(os.path.join(os.path.dirname(exported), "inputs.npz"))
    np.savez(inputs, **batch)
    stdout, stderr = loader.communicate(f"{exported} {inputs}\n", timeout=300)
    assert loader.returncode == 0, stderr[-3000:]
    out = json.loads(stdout.strip().splitlines()[-1])
    return np.array(out["probs"]), live, out["state"]


def test_cpu_program_runs_without_the_port(loaded_alone):
    """A serving host with torch alone: the port's package is blocked from
    import, the program loads and gives probabilities; they match the live
    service the CLI exported on the same (text, image) requests."""
    probs, live, _ = loaded_alone
    assert probs.shape == (2, 3)
    np.testing.assert_allclose(probs, live, rtol=1e-5, atol=1e-7)


def test_w8_program_holds_the_int8_weights(exported, loaded_alone):
    int8 = [k for k, dtype in loaded_alone[2].items() if dtype == "torch.int8"]
    assert len(int8) == len(exported[1]["w8"].names) == 2
    assert all(".w8_weights.q" in k for k in int8)
    assert json.load(open(exported[0] + ".json"))["quantize"] == "w8"


@pytest.mark.parametrize("op", ["sdpa_fwd", "attn_block_fwd"])
def test_custom_op_fake_matches_the_plain_version(op):
    from torch._subclasses.fake_tensor import FakeTensorMode

    g = torch.Generator().manual_seed(0)
    if op == "sdpa_fwd":
        q, k, v = (torch.randn(2, 3, 5, 8, generator=g, dtype=torch.bfloat16) for _ in range(3))
        mask = torch.ones(2, 5, dtype=torch.int32)
        args, plain = (q, k, v, mask, 0.3), A.sdpa_reference(q, k, v, mask, 0.3)
        fn = A.sdpa_fwd_op
    else:
        x = torch.randn(2, 5, 16, generator=g, dtype=torch.bfloat16)
        ws = [torch.randn(16, 16, generator=g, dtype=torch.bfloat16) for _ in range(8)]
        ws[1::2] = [w[0] for w in ws[1::2]]  # biases (16,)
        mask = torch.ones(2, 5, dtype=torch.int32)
        args = (x, mask, *ws, 2, 0.5)
        plain, fn = AB.attn_block_reference(*args), AB.attn_block_fwd_op
    with FakeTensorMode() as mode:
        out = fn(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    assert out.shape == plain.shape and out.dtype == plain.dtype
    with pytest.raises(NotImplementedError):  # the op has only a CUDA implementation
        fn(*args)


def _sorted_boxes(n, seed, grouped):
    """``n`` seeded boxes sorted by score, the dead ones at the back (the
    scan's input contract), and their groups."""
    r = np.random.RandomState(seed)
    centers = r.rand(n, 2) * 20
    boxes = np.concatenate([centers, centers + 5 + r.rand(n, 2) * 4], 1).astype(np.float32)
    scores, alive = r.rand(n), r.rand(n) > 0.15
    group = r.randint(0, 3, n) if grouped else np.zeros(n, np.int64)
    order = np.argsort(np.where(alive, -scores, np.inf), kind="stable")
    return boxes[order], alive[order], group[order]


@pytest.mark.parametrize("grouped", [False, True], ids=["plain", "grouped"])
def test_nms_keep_op_equals_the_scan_and_greedy(grouped):
    """Two images in lockstep: the op's mask and counts are
    ``nms_keep_device``'s, and the kept rows are the host greedy scan's, one
    scan a group."""
    cases = [_sorted_boxes(70, s, grouped) for s in (1, 2)]
    boxes, alive, group = (torch.from_numpy(np.stack([c[i] for c in cases])) for i in range(3))
    g = group if grouped else None
    keep, cnt = FR.nms_keep(boxes, alive, 0.5, 70, g, 16)
    want_keep, want_cnt = FR.nms_keep_device(boxes, alive, 0.5, 70, g, 16)
    assert torch.equal(keep, want_keep) and torch.equal(cnt, want_cnt)
    for i, (b, a, gr) in enumerate(cases):
        kept = []
        for label in np.unique(gr[a]):
            rows = np.nonzero(a & (gr == label))[0]
            kept += rows[FR.greedy_nms(b[rows], -rows.astype(np.float32), 0.5)].tolist()
        assert np.nonzero(keep[i].numpy())[0].tolist() == sorted(kept)
        assert int(cnt[i]) == len(kept)


def test_nms_keep_fake_gives_the_shapes_under_export():
    class Scan(torch.nn.Module):
        def forward(self, boxes, alive, group):
            return FR.nms_keep(boxes, alive, 0.5, 9, group, 8)

    boxes, alive, group = (torch.from_numpy(np.stack([c[i] for c in (
        _sorted_boxes(30, 3, True), _sorted_boxes(30, 4, True))])) for i in range(3))
    with torch.no_grad():
        exported = torch.export.export(Scan(), (boxes, alive, group), strict=False)
    nodes = [n for n in exported.graph.nodes if str(n.target) == "smtc.nms_keep.default"]
    assert len(nodes) == 1
    keep, cnt = nodes[0].meta["val"]
    assert (keep.shape, keep.dtype, cnt.shape, cnt.dtype) == (
        (2, 30), torch.bool, (2,), torch.int64)
    for got, want in zip(exported.module()(boxes, alive, group),
                         FR.nms_keep_device(boxes, alive, 0.5, 9, group, 8)):
        assert torch.equal(got, want)


LXMERT = ["--task", "3", "--model", "lxmert", "--arch", "tiny", "--frcnn_arch", "tiny",
          "--max_batch", "2", "--random_init", "--device", "cpu"]


@pytest.fixture(scope="module")
def detector_programs(tmp_path_factory):
    """``export --export_detector --detector_batch 2`` of the tiny LXMERT
    service for the CPU: (the printed line, the live detector the CLI
    exported)."""
    import contextlib
    import io

    out = str(tmp_path_factory.mktemp("export_detector") / "lx.pt2")
    live = {}
    real = TExport.export_service

    def keep(args, platforms=None):
        live.update(real(args, platforms))
        return live

    printed = io.StringIO()
    with pytest.MonkeyPatch.context() as m, contextlib.redirect_stdout(printed):
        m.setattr(TExport, "export_service", keep)
        TExport.main(["--out", out, "--platforms", "cpu", "--export_detector",
                      "--detector_batch", "2"] + LXMERT)
    return json.loads(printed.getvalue().strip().splitlines()[-1]), live["cpu"][3]["detector"]


@pytest.mark.parametrize("orient", ["landscape", "portrait"])
def test_exported_detector_matches_live(detector_programs, orient):
    """The loaded program of each orientation gives the live fused
    detector's 36-region tensors on two preprocessed images."""
    line, det = detector_programs
    path = line["out"] + f".detector.{orient}.pt2"
    assert path in line["detectors"] and len(line["detectors"]) == 2
    meta = json.load(open(path + ".json"))
    assert set(meta) == {"canvas", "inputs", "outputs", "platforms"}
    batch, ph, pw, _ = meta["canvas"]
    assert batch == 2 and (ph < pw) == (orient == "landscape") and meta["platforms"] == ["cpu"]
    rng = np.random.RandomState(5)
    pre = [FR.preprocess_image(rng.randint(0, 255, hw + (3,), np.uint8), det.cfg)
           for hw in ((48, 80), (40, 72))]
    if orient == "portrait":
        pre = [FR.preprocess_image(rng.randint(0, 255, (80, 48, 3), np.uint8), det.cfg)
               for _ in range(2)]
    canvases = torch.from_numpy(np.stack([p[0] for p in pre]))
    sizes = torch.tensor([p[1] for p in pre], dtype=torch.float32)
    assert tuple(canvases.shape) == (batch, ph, pw, 3)
    with torch.no_grad():
        want = det._select_device(*det._dispatch(canvases, sizes))
        got = torch.export.load(path).module()(canvases, sizes)
    assert len(got) == 5
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-4)

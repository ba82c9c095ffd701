"""The PyTorch port's weight-only int8 quantization (``ops/quant.py``) against
the JAX package's, on the CPU at ``--arch tiny``.

From the same numpy weights (the port's tiny late-fusion model, random from
a seed, written as the JAX tree by ``models/from_jax.py``) both packages
quantize the same leaves to the same int8 values and float32 scales, exactly,
in the unrolled and the ``scan_layers`` layout, and dequantize them to the
same bfloat16 bits. The tiny towers hold only two Dense kernels of 2^14
elements, so the leaf threshold is lowered to 2^10 in both packages where
the services are compared: the port's ``serve --quantize w8`` answers as the
JAX service under w8 does, over one JAX-format artifact (float32 within
1e-4, bfloat16 within ``BF16_TOL``; the JAX predict compiled without XLA's
excess precision, which would keep the dequantized weights in float32);
``--model lxmert --quantize w8`` serves; ``run_mm_late --load_saved_model --quantize w8`` keeps the prediction CSV's
contract (the JAX ``tests/test_cli.py`` case).
"""

import copy
import csv
import os
import sys

import jax
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.cli import _build as JBuild
from socialmedia_textimage_classification_auxlosses_tpu.cli import serve as jserve
from socialmedia_textimage_classification_auxlosses_tpu.core import config as JC
from socialmedia_textimage_classification_auxlosses_tpu.ops import quant as JQ
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_mm_late as TRun
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import serve as tserve
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._build import (
    build_mm_late_setup,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as TC
from socialmedia_textimage_classification_auxlosses_tpu_torch.models.from_jax import (
    _flax_path, jax_tree_from_torch,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import quant as TQ

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import make_task_fixture  # noqa: E402
from test_torch_from_jax import BF16_TOL, to_numpy_tree  # noqa: E402
from test_torch_serve import BASE as SERVE_BASE, _requests  # noqa: E402

SMALL = 1 << 10  # the leaf threshold where the tiny towers are compared
# the serving tests' flags with BERT's 30,522-row word table (Bernice's 250,002 rows
# only slow the JAX init and the artifact down here)
BASE = [("bert" if a == "bernice" else a) for a in SERVE_BASE]


@pytest.fixture(scope="module")
def model():
    args = tserve.parse_args(BASE + ["--device", "cpu", "--dtype", "float32"])
    return build_mm_late_setup(args, TC.serving_config(args),
                               generator=torch.Generator().manual_seed(0)).model


def _jax_int8(tree, min_elems):
    """JAX's quantization of a numpy tree -> (QuantizedTree, {path: (q, scale)})."""
    qt = JQ.quantize_w8(tree, min_elems=min_elems)
    flat_q = jax.tree_util.tree_flatten_with_path(qt.q)[0]
    flat_s = jax.tree_util.tree_leaves(qt.scales)
    return qt, {tuple(str(p.key) for p in path): (np.asarray(q), np.asarray(s))
                for (path, q), s in zip(flat_q, flat_s) if q.dtype == np.int8}


def _jax_path(name):
    owner, _, _ = name.rpartition(".")
    return ("params", *_flax_path(owner), "kernel")


@pytest.mark.parametrize("scan_layers", [False, True], ids=["unrolled", "scan_layers"])
@pytest.mark.parametrize("min_elems", [SMALL, None], ids=["2^10", "default"])
def test_int8_values_and_scales_equal_jax(model, scan_layers, min_elems):
    tree = to_numpy_tree(jax_tree_from_torch(model, scan_layers=scan_layers))
    _, want = _jax_int8(tree, TQ.MIN_ELEMS if min_elems is None else min_elems)
    m = copy.deepcopy(model)
    w8 = TQ.quantize_w8(m, scan_layers=scan_layers, min_elems=min_elems)
    got = {_jax_path(n): (q.numpy(), s.numpy())
           for n, q, s in zip(w8.names, w8.qs(), w8.scales())}
    assert got.keys() == want.keys() and got
    for path, (q, s) in got.items():
        jq, js = want[path]
        np.testing.assert_array_equal(q.T, jq)  # Linear (out, in) vs Dense (in, out)
        np.testing.assert_array_equal(s.T, js)
    if scan_layers:  # the stacked layer kernels stay float32
        assert not any("layers" in n for n in w8.names)
    for n in w8.names:  # the float32 weight is gone; the int8 one is resident
        assert n not in dict(m.named_parameters())
    assert TQ.quantized_bytes(w8) == (sum(q.size for q, _ in got.values()),
                                      4 * sum(q.size for q, _ in got.values()))


def test_dequantize_is_bit_equal_in_bf16(model):
    tree = to_numpy_tree(jax_tree_from_torch(model))
    qt, want = _jax_int8(tree, SMALL)
    deq = JQ.dequantize(qt)  # its bfloat16 default
    flat = {tuple(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(deq)[0]}
    w8 = TQ.quantize_w8(copy.deepcopy(model), min_elems=SMALL)
    for name, t in zip(w8.names, TQ.dequantize(w8)):
        assert t.dtype == torch.bfloat16
        jbits = flat[_jax_path(name)].T.copy().view(np.uint16)
        np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16), jbits)


@pytest.fixture(scope="module")
def artifact(model, tmp_path_factory):
    """A JAX-format artifact of the port's random tiny model (``model``,
    written as the JAX tree: the JAX builder compiles no initialiser), and
    the builder's setups memoized by dtype (each JAX service reuses its
    own)."""
    import flax.serialization

    setups = {}
    real = JBuild.build_mm_late_setup
    tree = jax.tree_util.tree_map(jax.numpy.asarray,
                                  to_numpy_tree(jax_tree_from_torch(model)))
    mp = pytest.MonkeyPatch()
    mp.setattr(JBuild, "init_mm_late_params", lambda *a, **k: tree)

    def memo(args, cfg, *a, **k):
        if args.dtype not in setups:
            if setups:  # the same float32 parameters: no second init
                params = next(iter(setups.values())).params
                with pytest.MonkeyPatch.context() as m:
                    m.setattr(JBuild, "init_mm_late_params", lambda *a, **k: params)
                    setups[args.dtype] = real(args, cfg, *a, **k)
            else:
                setups[args.dtype] = real(args, cfg, *a, **k)
        return setups[args.dtype]

    try:
        jargs = jserve.parse_args(BASE + ["--dtype", "float32"])
        params = memo(jargs, JC.serving_config(jargs)).params
    finally:
        mp.undo()
    path = tmp_path_factory.mktemp("w8") / "jax_net.pth"
    path.write_bytes(flax.serialization.to_bytes(jax.tree_util.tree_map(np.asarray, params)))
    return str(path), memo


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8_service_matches_the_jax_w8_service(artifact, dtype, monkeypatch):
    path, memo = artifact
    monkeypatch.setattr(JBuild, "build_mm_late_setup", memo)
    real_q = JQ.quantize_w8
    monkeypatch.setattr(JQ, "quantize_w8", lambda p, min_elems=SMALL: real_q(p, min_elems))
    monkeypatch.setattr(TQ, "MIN_ELEMS", SMALL)
    argv = BASE + ["--dtype", dtype, "--quantize", "w8", "--model_path", path]
    # XLA may drop the bfloat16 rounding of the dequantized weights (its
    # xla_allow_excess_precision, on by default: the product stays float32);
    # compiled without it, the JAX service computes what its code says
    real_jit = jax.jit
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", lambda f, **k: real_jit(
            f, **k, compiler_options={"xla_allow_excess_precision": False}))
        jpredict, _ = jserve.build_service(jserve.parse_args(argv))
    tpredict, meta = tserve.build_service(tserve.parse_args(argv + ["--device", "cpu"]))
    assert meta["quantize"] == "w8"
    tol = 1e-4 if dtype == "float32" else BF16_TOL
    reqs = _requests()
    for window in (reqs, reqs[1:3]):
        for a, b in zip(jpredict(window), tpredict(window)):
            assert abs(sum(b["probs"]) - 1.0) < 1e-5
            assert np.abs(np.array(a["probs"]) - np.array(b["probs"])).max() <= tol


def test_lxmert_serves_under_w8(monkeypatch):
    """``--model lxmert --quantize w8`` serves (the detector stays as it
    is): finite probabilities, the LXMERT's large kernels held in int8."""
    monkeypatch.setattr(TQ, "MIN_ELEMS", SMALL)
    info = {}
    predict, _ = tserve.build_service(tserve.parse_args(
        BASE + ["--model", "lxmert", "--frcnn_arch", "tiny", "--random_init", "--device", "cpu",
                "--quantize", "w8"]), export_info=info)
    assert info["w8"].names and all(q.dtype == torch.int8 for q in info["w8"].qs())
    img = np.random.RandomState(2).randint(0, 256, (40, 56, 3), np.uint8)
    out = predict([("a photo", img), ("no photo", None)])
    assert all(np.isfinite(o["probs"]).all() and abs(sum(o["probs"]) - 1) < 1e-5 for o in out)


def test_run_mm_late_load_saved_model_w8_keeps_the_preds_contract(tmp_path, monkeypatch):
    csv_path, img_fmt, _ = make_task_fixture(tmp_path / "data", task=3, n=16)
    monkeypatch.setitem(TC.PATH, 3, csv_path)
    monkeypatch.setitem(TC.IMG_FMT, 3, img_fmt)
    monkeypatch.setattr(TC, "DATA_PATH", str(tmp_path / "data") + os.sep)
    monkeypatch.setattr(TC, "results_dir_mm_late", str(tmp_path / "results") + os.sep)
    monkeypatch.setattr(TQ, "MIN_ELEMS", SMALL)
    base = ["--txt_model_name", "bernice", "--img_model_name", "vit", "--fusion_name", "concat",
            "--task", "3", "--epochs", "1", "--arch", "tiny", "--dtype", "float32",
            "--device", "cpu", "--log_every", "100"]
    TRun.main(base + ["--save_model"])
    stem = str(tmp_path / "results" / "bernice-vit-concat_task3_seed30__")

    def read():
        with open(stem + "preds_lm.csv", newline="") as f:
            return list(csv.reader(f))

    TRun.main(base + ["--load_saved_model"])
    full = read()
    _, setup = TRun.main(base + ["--load_saved_model", "--quantize", "w8"])
    quant = read()
    assert quant[0] == full[0] == ["data_id", "label", "prediction"]
    assert [r[:2] for r in quant] == [r[:2] for r in full]
    assert setup.model.w8_weights.names and os.path.isfile(stem + "metrics_lm.csv")

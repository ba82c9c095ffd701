"""PyTorch port's serving endpoint against the JAX package's, on the CPU at
``--arch tiny``: the same weights (the JAX service's parameters, carried
into the port's artifact by ``models/from_jax.py``) and the same requests,
text-only and with images, give the same probabilities (float32 within
1e-4; bfloat16 within 3e-2, see ``test_torch_from_jax.BF16_TOL``). Then a
``MicroBatcher`` + HTTP round trip (``/classify``, ``/healthz``); the early
models ``--model vilt`` and ``--model mmbt`` against the JAX service the
same way (float32 within 1e-4); ``--model lxmert`` with the detector on every
window (``--frcnn_arch tiny``, one detector checkpoint written from the torch
twin ``tests/ref_frcnn.py``, a JAX-format LXMERT artifact written by flax and
read through ``train/flax_msgpack.py``) against the JAX service within 1e-4;
and the flag values the JAX service refuses refuse to start here too
(``tests/test_torch_serve_extras.py`` serves the extras)."""

import base64
import io
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest

from socialmedia_textimage_classification_auxlosses_tpu.cli import _build as JBuild
from socialmedia_textimage_classification_auxlosses_tpu.cli import _build_early as JBuildEarly
from socialmedia_textimage_classification_auxlosses_tpu.cli import serve as jserve
from socialmedia_textimage_classification_auxlosses_tpu.models import frcnn as JFrcnn
from socialmedia_textimage_classification_auxlosses_tpu.models import mmbt as JMmbt
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import serve as tserve
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._build import (
    build_mm_late_setup,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._build_early import (
    build_mm_early_setup,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as TC
from socialmedia_textimage_classification_auxlosses_tpu_torch.models.from_jax import (
    load_jax_params,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.train.checkpoint import (
    save_params,
)

from test_torch_from_jax import BF16_TOL, to_numpy_tree

BASE = ["--task", "3", "--txt_model_name", "bernice", "--img_model_name", "vit",
        "--fusion_name", "attention", "--arch", "tiny", "--max_batch", "4",
        "--batch_window_ms", "40"]


def _requests():
    from PIL import Image

    rng = np.random.RandomState(7)
    img = lambda h, w: Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8))
    return [("what a day 😍 https://t.co/x @friend", None),
            ("storm coming #weather", img(48, 64)),
            ("", img(224, 224)),
            ("I can't believe it!!! so happy", img(30, 90))]


# the parameters each initialiser returned, by its model and inputs: a test
# module that builds a service of the same model again (this one's or
# another's in the same run) reuses them instead of compiling the init anew
_INITS = {}


def _jitted(real):
    """``real(model, rng, *arrays, **kw)``, the JAX services' parameter
    initialiser, as one compiled call (eager, every initialiser compiles on
    its own), its result kept in ``_INITS``. Both services read the weights
    it returns."""
    def init(model, rng, *arrays, **kw):
        key = (real.__module__, real.__qualname__, repr(model), repr(sorted(kw.items())),
               np.asarray(jax.random.key_data(rng) if jax.dtypes.issubdtype(
                   rng.dtype, jax.dtypes.prng_key) else rng).tobytes(),
               tuple((np.shape(a), str(np.asarray(a).dtype), np.asarray(a).tobytes())
                     for a in arrays))
        if key not in _INITS:
            _INITS[key] = jax.jit(lambda r, *a: real(model, r, *a, **kw))(rng, *arrays)
        return _INITS[key]

    return init


@pytest.fixture(scope="module", autouse=True)
def jitted_inits():
    mp = pytest.MonkeyPatch()
    for owner, name in ((JBuild, "init_mm_late_params"), (JBuildEarly, "init_vilt_params"),
                        (JMmbt, "init_mmbt_params")):
        mp.setattr(owner, name, _jitted(getattr(owner, name)))
    yield
    mp.undo()


def _services(tmp_path, dtype):
    jargs = jserve.parse_args(BASE + ["--dtype", dtype, "--random_init",
                                      "--model_path", str(tmp_path / "unused")])
    info = {}
    jpredict, _ = jserve.build_service(jargs, export_info=info)
    targs = tserve.parse_args(BASE + ["--dtype", dtype, "--device", "cpu",
                                      "--model_path", str(tmp_path / "port.pth")])
    setup = build_mm_late_setup(targs, TC.serving_config(targs))
    load_jax_params(setup.model, to_numpy_tree(info["params"]))
    save_params(targs.model_path, setup.model)
    tpredict, tmeta = tserve.build_service(targs)
    return jpredict, tpredict, tmeta, targs


@pytest.fixture(scope="module")
def f32_services(tmp_path_factory):
    return _services(tmp_path_factory.mktemp("serve_f32"), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_probabilities_match_jax_service(tmp_path, f32_services, dtype):
    jpredict, tpredict, _, _ = (f32_services if dtype == "float32"
                                else _services(tmp_path, dtype))
    reqs = _requests()
    for window in (reqs, reqs[:1], reqs[1:3]):
        jout, tout = jpredict(window), tpredict(window)
        assert len(tout) == len(window)
        for a, b in zip(jout, tout):
            assert b["prediction"] in range(3) and b["class"] == TC.CLASSES[3][b["prediction"]]
            assert abs(sum(b["probs"]) - 1.0) < 1e-5
            tol = 1e-4 if dtype == "float32" else BF16_TOL
            assert np.abs(np.array(a["probs"]) - np.array(b["probs"])).max() <= tol


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def test_microbatcher_and_http_round_trip(f32_services):
    _, tpredict, meta, args = f32_services
    batcher = tserve.MicroBatcher(tpredict, args.max_batch, args.batch_window_ms)
    args.port = 0  # ephemeral
    server = tserve.make_server(args, batcher, meta)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        reqs = _requests()
        results = [None] * len(reqs)

        def submit(i):
            results[i] = batcher.submit(*reqs[i])

        workers = [threading.Thread(target=submit, args=(i,)) for i in range(len(reqs))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
            assert not w.is_alive()
        direct = tpredict(reqs)
        for got, want in zip(results, direct):
            np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-6)
            assert set(got["timing_ms"]) == {"queue", "dispatch"}

        buf = io.BytesIO()
        reqs[1][1].save(buf, format="PNG")
        body = json.dumps({"text": reqs[1][0],
                           "image_b64": base64.b64encode(buf.getvalue()).decode()})
        req = urllib.request.Request(f"http://127.0.0.1:{port}/classify",
                                     data=body.encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            answer = json.loads(r.read())
        np.testing.assert_allclose(answer["probs"], direct[1]["probs"], atol=1e-6)

        health = _get(port, "/healthz")
        assert health["status"] == "ok" and health["device"] == "cpu"
        assert health["errors"] == 0 and health["requests"] == len(reqs) + 1
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60) as r:
            assert r.headers["Content-Type"] == "text/plain; version=0.0.4"
            body = r.read().decode()
        m = dict(line.rsplit(" ", 1) for line in body.splitlines() if not line.startswith("#"))
        assert int(m["smtc_serving_requests_total"]) == health["requests"]
        assert (int(m['smtc_serving_dispatch_seconds_bucket{le="+Inf"}'])
                == int(m["smtc_serving_dispatch_seconds_count"])
                == int(m["smtc_serving_windows_total"]) == health["windows"])
    finally:
        server.shutdown()
        batcher.close()
        server.server_close()
        thread.join(timeout=10)


# each case: the function the JAX service raises it from, and its arguments
# (served since the port carried them, and so no longer here: --quantize w8,
# also with --model lxmert, --extra_model, --workers 2, --img_decoder native)
@pytest.mark.parametrize("extra", [
    ("parse_model_spec", "default:model=vilt"),
    ("parse_model_spec", "e:no_such_flag=1"),
    ("main", ["--workers", "2", "--port", "0"]),
    ("main", ["--extra_model", "e:seed=31", "--extra_model", "e:seed=32"]),
    ("build_service", ["--img_model_name", "resnet50", "--fusion_name", "attention"]),
    ("parse_model_spec", "e:model=nonsense"),
    ("build_service", ["--attn_impl", "nonsense"]),
])
def test_flags_jax_refuses_exit_here_too(extra, monkeypatch):
    """Flag values the JAX service refuses exit here too: the reserved name
    ``default``, an unknown key, a bad value, ``--workers`` without an
    explicit port, a duplicate ``--extra_model`` name, a fusion head the
    tower does not take, an unknown attention impl."""
    import signal

    monkeypatch.setenv("SMTC_IMG_DECODER", "pil")  # main() publishes the decoder flag
    monkeypatch.setattr(signal, "signal", lambda *a: None)  # main() keeps pytest's SIGTERM
    fn, arg = extra
    argv = BASE + ["--device", "cpu", "--random_init", "--port", "0"]
    with pytest.raises(SystemExit):
        if fn == "parse_model_spec":
            tserve.parse_model_spec(tserve.parse_args(argv), arg)
        elif fn == "main":
            tserve.main(argv + arg)
        else:
            tserve.build_service(tserve.parse_args(argv + arg))


def test_lxmert_names_what_it_waits_for(tmp_path):
    """Without ``--random_init`` a service whose detector weights do not
    load exits with the JAX service's words."""
    args = tserve.parse_args(BASE + ["--device", "cpu", "--model", "lxmert", "--frcnn_arch",
                                     "tiny", "--frcnn_ckpt", str(tmp_path / "none.bin")])
    with pytest.raises(SystemExit, match="cannot load FRCNN detector weights.*--frcnn_ckpt"):
        tserve.build_service(args)


# served since the port carried them (refused before): the early models, each
# request image resized to the model's square (ViLT 64 px at tiny; MMBT's
# ResNet-50 at --image_size 32)
@pytest.mark.parametrize("extra", [["--model", "vilt"], ["--model", "mmbt", "--image_size", "32"]],
                         ids=["vilt", "mmbt"])
def test_early_models_serve_as_the_jax_service(tmp_path, extra):
    """The JAX service's random weights carried into the port's artifact
    (MMBT's BatchNorm statistics too), the artifact path derived by name
    under the family's results directory: the same probabilities."""
    jargs = jserve.parse_args(BASE + extra + ["--dtype", "float32", "--random_init"])
    info = {}
    jpredict, jmeta = jserve.build_service(jargs, export_info=info)
    model = extra[1]
    base = {"vilt": "results_dir_mm_early", "mmbt": "results_dir_mmbt"}[model]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(TC, base, str(tmp_path / model) + "/")
        targs = tserve.parse_args(BASE + extra + ["--dtype", "float32", "--device", "cpu"])
        setup = build_mm_early_setup(targs, TC.serving_config(targs, model_name=model))
        load_jax_params(setup.model, to_numpy_tree(info["params"]))
        path = tmp_path / model / f"{model}_task3_seed30__net.pth"
        save_params(str(path), setup.model)
        tpredict, tmeta = tserve.build_service(targs)
    finally:
        mp.undo()
    assert tmeta["model"] == jmeta["model"] == model and tmeta["model_path"] == str(path)
    assert tmeta["resize_size"] == jmeta["resize_size"] and tmeta["center_crop_from"] is None
    reqs = _requests()
    for window in (reqs, reqs[2:3]):
        jout, tout = jpredict(window), tpredict(window)
        for a, b in zip(jout, tout):
            assert abs(sum(b["probs"]) - 1.0) < 1e-5
            assert np.abs(np.array(a["probs"]) - np.array(b["probs"])).max() <= 1e-4


LXMERT = ["--model", "lxmert", "--frcnn_arch", "tiny", "--dtype", "float32"]


@pytest.fixture(scope="module")
def lxmert_services(tmp_path_factory):
    """The JAX and the port's LXMERT services over one detector checkpoint
    (the twin's) and one JAX-format artifact (flax's msgpack of the JAX
    builder's random LXMERT), and the port's under ``--frcnn_ingest
    device``."""
    from types import SimpleNamespace

    import flax.serialization
    import torch

    from socialmedia_textimage_classification_auxlosses_tpu.core import config as JC
    from ref_frcnn import TwinFrcnn

    tmp = tmp_path_factory.mktemp("serve_lxmert")
    ckpt = tmp / "pytorch_model.bin"
    torch.save(TwinFrcnn(JFrcnn.TINY).state_dict(), ckpt)
    art = tmp / "lxmert_net.pth"
    argv = BASE + LXMERT + ["--frcnn_ckpt", str(ckpt), "--model_path", str(art)]
    jargs = jserve.parse_args(argv)
    mp = pytest.MonkeyPatch()
    mp.setattr(JBuildEarly, "init_lxmert_params", _jitted(JBuildEarly.init_lxmert_params))
    try:
        setup = JBuildEarly.build_mm_early_setup(
            jargs, JC.serving_config(jargs),
            roi_cache=SimpleNamespace(num_boxes=JFrcnn.TINY.max_detections,
                                      feat_dim=JFrcnn.TINY.feat_dim))
        art.write_bytes(flax.serialization.to_bytes(
            jax.tree_util.tree_map(np.asarray, setup.params)))
        jpredict, jmeta = jserve.build_service(jargs)
    finally:
        mp.undo()
    tpredict, tmeta = tserve.build_service(tserve.parse_args(argv + ["--device", "cpu"]))
    dpredict, _ = tserve.build_service(tserve.parse_args(
        argv + ["--device", "cpu", "--frcnn_ingest", "device"]))
    assert tmeta["model"] == jmeta["model"] == "lxmert" and tmeta["resize_size"] is None
    return jpredict, tpredict, dpredict


def _lxmert_requests():
    rng = np.random.RandomState(3)
    arr = lambda h, w: rng.randint(0, 256, (h, w, 3), np.uint8)
    return _requests()[:2] + [("portrait photo", arr(90, 40)), ("", arr(40, 56))]


def test_lxmert_serves_as_the_jax_service(lxmert_services):
    jpredict, tpredict, _ = lxmert_services
    reqs = _lxmert_requests()
    for window in (reqs, reqs[:1], reqs[1:3]):
        for a, b in zip(jpredict(window), tpredict(window)):
            assert abs(sum(b["probs"]) - 1.0) < 1e-5 and b["prediction"] == a["prediction"]
            assert np.abs(np.array(a["probs"]) - np.array(b["probs"])).max() <= 1e-4


def test_lxmert_image_changes_the_answer(lxmert_services):
    tpredict = lxmert_services[1]
    text, image = _lxmert_requests()[1]
    with_image, without = tpredict([(text, image), (text, None)])
    assert np.abs(np.array(with_image["probs"]) - np.array(without["probs"])).max() > 1e-3


def test_lxmert_device_ingest_stays_near_pil(lxmert_services):
    _, tpredict, dpredict = lxmert_services
    reqs = _lxmert_requests()
    for a, b in zip(tpredict(reqs), dpredict(reqs)):
        assert np.abs(np.array(a["probs"]) - np.array(b["probs"])).max() <= 0.05


def test_lxmert_warms_each_orientation_and_shares_its_detector(tmp_path):
    """The warm-up runs one window an orientation (one with
    ``--fast_start``); services with the same detector flags share one
    detector."""
    argv = BASE + LXMERT + ["--random_init", "--device", "cpu"]
    cache = {}
    first, _ = tserve.build_service(tserve.parse_args(argv), detector_cache=cache)
    tserve.build_service(tserve.parse_args(argv), detector_cache=cache)
    assert len(cache) == 1
    windows = []

    def counting(requests):
        windows.append([None if im is None else im.shape[:2] for _, im in requests])
        return first(requests)

    tserve.warm_service(tserve.parse_args(argv), counting)
    assert windows == [[(240, 320)], [(320, 240)]]
    windows.clear()
    tserve.warm_service(tserve.parse_args(argv + ["--fast_start"]), counting)
    assert windows == [[(240, 320)]]

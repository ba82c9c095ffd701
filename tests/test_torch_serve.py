"""PyTorch port's serving endpoint against the JAX package's, on the CPU at
``--arch tiny``: the same weights (the JAX service's parameters, carried
into the port's artifact by ``models/from_jax.py``) and the same requests,
text-only and with images, give the same probabilities (float32 within
1e-4; bfloat16 within 3e-2, see ``test_torch_from_jax.BF16_TOL``). Then a
``MicroBatcher`` + HTTP round trip (``/classify``, ``/healthz``); the early
models ``--model vilt`` and ``--model mmbt`` against the JAX service the
same way (float32 within 1e-4); and the flags this port does not have yet
refuse to start (``--model lxmert`` naming the detector it waits for)."""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from socialmedia_textimage_classification_auxlosses_tpu.cli import _build as JBuild
from socialmedia_textimage_classification_auxlosses_tpu.cli import _build_early as JBuildEarly
from socialmedia_textimage_classification_auxlosses_tpu.cli import serve as jserve
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


def _jitted(real):
    """``real(model, rng, *arrays, **kw)``, the JAX services' parameter
    initialiser, as one compiled call (eager, every initialiser compiles on
    its own). Both services read the weights it returns."""
    def init(model, rng, *arrays, **kw):
        return jax.jit(lambda r, *a: real(model, r, *a, **kw))(rng, *arrays)

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
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(port, "/metrics")
        assert err.value.code == 501
    finally:
        server.shutdown()
        batcher.close()
        server.server_close()
        thread.join(timeout=10)


@pytest.mark.parametrize("extra", [
    ["--quantize", "w8"], ["--extra_model", "e:model=vilt"],
    ["--workers", "2"], ["--img_decoder", "native"],
    ["--img_model_name", "resnet50", "--fusion_name", "attention"],
    ["--model", "lxmert"], ["--attn_impl", "nonsense"],
])
def test_unported_flags_refuse_to_start(extra):
    args = tserve.parse_args(BASE + ["--device", "cpu", "--random_init"] + extra)
    with pytest.raises(SystemExit):
        tserve.build_service(args)


def test_lxmert_names_what_it_waits_for():
    args = tserve.parse_args(BASE + ["--device", "cpu", "--random_init", "--model", "lxmert"])
    with pytest.raises(SystemExit, match="detector.*Queue 1 item 7"):
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

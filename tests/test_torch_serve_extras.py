"""The PyTorch port's serving extras against the JAX package's, on the CPU at
``--arch tiny``: ``GET /metrics``, ``--extra_model`` and ``--workers``.

* The Prometheus exposition of the same counter snapshot is the JAX
  package's byte for byte, one model (unlabelled series) and several
  (``model=`` labels), with label escaping; a scrape under traffic is
  lock-consistent (the histogram's count, its ``+Inf`` bucket and the
  windows agree within every scrape).
* ``parse_model_spec`` gives the namespaces the JAX package's gives and
  refuses the same specs with the same words.
* One server holding the primary and ``--extra_model`` routes each request
  to its model: each route's probabilities equal that model's single-model
  service, ``/healthz`` and ``/metrics`` report per model, an unknown route
  is a 404.
* ``--workers 2``: two worker processes on one explicit port behind a
  supervisor. The test waits until both workers log that they serve (a
  worker still building when SIGTERM comes exits 143, by design, so an
  earlier signal would test the race, not the supervisor), sees both pids
  answer, and SIGTERM ends the supervisor with code 0 and both workers
  reaped. The supervisor starts with the module's first test, so that its
  workers build while the in-process tests run; one deadline of 90 s from
  then, and the process group is killed at the end.
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from socialmedia_textimage_classification_auxlosses_tpu.cli import serve as jserve
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import serve as tserve

TINY = ["--task", "3", "--txt_model_name", "bert", "--img_model_name", "vit",
        "--fusion_name", "attention", "--arch", "tiny", "--max_batch", "2",
        "--batch_window_ms", "10", "--random_init", "--dtype", "float32"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Counters:
    def __init__(self, snap):
        self.snap = snap

    def snapshot(self):
        return dict(self.snap)


SNAPS = [
    {"requests": 7, "errors": 1, "windows": 3, "dispatch_seconds": 0.123456789,
     "latency_counts": [1, 0, 2, 0, 0, 0, 0, 0, 0, 0]},
    {"requests": 0, "errors": 0, "windows": 0, "dispatch_seconds": 0.0,
     "latency_counts": [0] * 10},
    {"requests": 91, "errors": 0, "windows": 12, "dispatch_seconds": 41.5,
     "latency_counts": [0, 0, 0, 0, 0, 1, 4, 3, 2, 2]},
]
WEIRD = {"model": 'we"ird\\mo\ndel', "task": 3}


@pytest.mark.parametrize("services", [
    [(None, 0, WEIRD)],
    [(None, 2, {"model": "bert-vit-attention", "task": 3})],
    [("default", 0, {"model": "bert-vit-attention", "task": 3}), ("alt", 2, WEIRD),
     ('q"uote', 1, {"model": "vilt", "task": 6})],
], ids=["escaped", "one", "several"])
def test_exposition_is_the_jax_packages(services):
    entries = [(name, _Counters(SNAPS[i]), meta) for name, i, meta in services]
    assert tserve.prometheus_text(entries) == jserve.prometheus_text(entries)
    assert tserve.MicroBatcher.LATENCY_BUCKETS == jserve.MicroBatcher.LATENCY_BUCKETS


def test_batcher_exposition_and_histogram_match_jax():
    """The same window timings land in the same buckets of both batchers."""
    batchers = [pkg.MicroBatcher(lambda reqs: [{} for _ in reqs], 2, 1.0)
                for pkg in (tserve, jserve)]
    try:
        for b in batchers:
            b.submit("a", None)
            b.submit("b", None)
        snaps = [b.snapshot() for b in batchers]
        for s in snaps:
            assert s["windows"] == sum(s["latency_counts"]) == 2 and s["requests"] == 2
        for b, s in zip(batchers, snaps):
            b.dispatch_seconds = 0.25  # the one float that differs between runs
        line = [l for l in batchers[0].prometheus_text(WEIRD).splitlines()
                if l.startswith("smtc_serving_info")][0]
        assert line == 'smtc_serving_info{model="we\\"ird\\\\mo\\ndel",task="3"} 1'
        assert batchers[0].prometheus_text(WEIRD) == batchers[1].prometheus_text(WEIRD)
    finally:
        for b in batchers:
            b.close()


def _parse(body):
    return {k: float(v) for k, v in (l.rsplit(" ", 1) for l in body.splitlines()
                                     if l.strip() and not l.startswith("#"))}


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(port, path, raw=False):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        body = r.read()
    return body.decode() if raw else json.loads(body)


def _serving(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread


def test_scrape_is_lock_consistent_under_traffic():
    def slow(reqs):
        time.sleep(0.002)
        return [{"prediction": 0, "probs": [1.0]} for _ in reqs]

    batcher = tserve.MicroBatcher(slow, 4, 1.0)
    args = tserve.parse_args(TINY + ["--port", "0"])
    server = tserve.make_server(args, batcher, {"model": "m", "task": 3, "resize_size": None})
    _serving(server)
    port = server.server_address[1]
    done = threading.Event()

    def traffic():
        while not done.is_set():
            _post(port, "/classify", {"text": "scrape race probe"})

    clients = [threading.Thread(target=traffic) for _ in range(3)]
    try:
        for c in clients:
            c.start()
        for _ in range(10):
            m = _parse(_get(port, "/metrics", raw=True))
            assert (m["smtc_serving_dispatch_seconds_count"]
                    == m['smtc_serving_dispatch_seconds_bucket{le="+Inf"}']
                    == m["smtc_serving_windows_total"])
    finally:
        done.set()
        for c in clients:
            c.join(timeout=30)
        server.shutdown()
        batcher.close()
        server.server_close()
    m = _parse(batcher.prometheus_text({"model": "m", "task": 3}))
    assert m["smtc_serving_requests_total"] == batcher.stats()["requests"] > 0


SPECS = [
    "early:model=vilt,max_batch=4,batch_window_ms=20,random_init=true,seed=7",
    "cnn:image_size=288", "alt:fusion_name=concat,seed=31,dtype=bfloat16",
    "q:quantize=w8,scan_layers=1,attn_impl=fused", "x:random_init=no",
    "det:model=lxmert,frcnn_arch=tiny,rpn_post_topk=64,frcnn_ingest=device",
    # refused
    "x:no_such_flag=1", ":model=vilt", "a/b:model=vilt", "x:port=1", "x:device=cpu",
    "x:model=nosuch", "x:max_batch=many", "default:model=vilt", "x:model",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_model_spec_matches_jax(spec):
    base = ["--task", "3", "--arch", "tiny"]
    jbase, tbase = jserve.parse_args(base), tserve.parse_args(base)
    try:
        jname, jargs = jserve.parse_model_spec(jbase, spec)
    except SystemExit as e:
        with pytest.raises(SystemExit) as got:
            tserve.parse_model_spec(tbase, spec)
        assert str(got.value) == str(e)
        return
    tname, targs = tserve.parse_model_spec(tbase, spec)
    assert tname == jname and targs.extra_model == [] == jargs.extra_model
    for key, value in vars(jargs).items():
        assert getattr(targs, key) == value and type(getattr(targs, key)) is type(value), key
    assert tbase.model == "mm_late" and tbase.max_batch == 16  # the base is untouched


def test_two_models_in_one_server_route_to_their_own():
    args = tserve.parse_args(TINY + ["--device", "cpu", "--port", "0",
                                     "--extra_model", "alt:fusion_name=concat,seed=31"])
    predict, meta = tserve.build_service(args)
    name, margs = tserve.parse_model_spec(args, args.extra_model[0])
    predict_alt, meta_alt = tserve.build_service(margs)
    batcher = tserve.MicroBatcher(predict, 2, 10.0)
    extra = {name: (tserve.MicroBatcher(predict_alt, 2, 10.0), meta_alt)}
    server = tserve.make_server(args, batcher, meta, extra)
    _serving(server)
    port = server.server_address[1]
    texts = [f"post {i} about the #weather" for i in range(8)]
    answers = {}
    try:
        def client(i):
            route = "/classify" if i % 2 else "/classify/alt"
            answers[i] = _post(port, route, {"text": texts[i]})

        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(texts))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=60)
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, "/classify/nope", {})
        assert err.value.code == 404
        health = _get(port, "/healthz")
        body = _get(port, "/metrics", raw=True)
    finally:
        server.shutdown()
        batcher.close()
        extra["alt"][0].close()
        server.server_close()
    # each route equals its model's own service called alone
    single = {"/classify": predict, "/classify/alt": predict_alt}
    for i, text in enumerate(texts):
        want = single["/classify" if i % 2 else "/classify/alt"]([(text, None)])[0]
        np.testing.assert_allclose(answers[i]["probs"], want["probs"], atol=1e-6)
    assert not np.allclose(answers[0]["probs"], answers[1]["probs"])
    assert health["requests"] == 4 and health["models"]["alt"]["requests"] == 4
    assert 'smtc_serving_requests_total{model="default"} 4' in body
    assert 'smtc_serving_requests_total{model="alt"} 4' in body
    assert 'smtc_serving_info{model="alt",artifact="bert-vit-concat",task="3"} 1' in body
    assert body.count("# TYPE smtc_serving_requests_total") == 1


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", autouse=True)
def supervisor():
    """``serve --workers 2`` on an explicit port, started with the module's
    first test so that its workers import and build while the tests before
    theirs run: (process, its stderr lines, port, deadline). The process
    group is killed at the end, whatever the test did."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "socialmedia_textimage_classification_auxlosses_tpu_torch.cli.serve",
         *TINY, "--attn_impl", "jnp", "--device", "cpu", "--workers", "2", "--port", str(port)],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(iter(proc.stderr.readline, "")),
                              daemon=True)
    reader.start()
    try:
        yield proc, lines, port, time.monotonic() + 90
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def test_workers_share_one_port_and_stop_on_sigterm(supervisor):
    proc, lines, port, deadline = supervisor
    try:
        def serving():
            return re.findall(r" - serving .* on 127\.0\.0\.1:\d+ \(pid (\d+),", "".join(lines))

        while len(serving()) < 2:  # both workers built, warmed and bound
            assert proc.poll() is None, "".join(lines)[-3000:]
            assert time.monotonic() < deadline, "".join(lines)[-3000:]
            time.sleep(0.2)
        workers = {int(m) for m in re.findall(r"worker \d/2 pid=(\d+)", "".join(lines))}
        assert len(workers) == 2 and {int(p) for p in serving()} == workers, serving()
        pids = set()
        while pids != workers:  # fresh connections: the kernel spreads them
            assert time.monotonic() < deadline, pids
            pids.add(_get(port, "/healthz")["pid"])
        assert proc.pid not in pids
        res = _post(port, "/classify", {"text": "multi-process smoke"})
        assert len(res["probs"]) == 3
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        assert rc == 0, "".join(lines)[-3000:]
        for pid in workers:  # reaped by the supervisor
            assert not os.path.exists(f"/proc/{pid}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()

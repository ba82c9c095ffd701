#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a host with a CUDA card, ``nvcc``
and the CUDA toolkit. It

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the port's CUDA kernels from ``csrc/`` (one ``nvcc`` per source,
   all at once) and prints the build seconds;
3. calls each kernel's wrapper at every shape the serving path gives it and
   holds the result against the plain PyTorch version on the same inputs
   (float32: 1e-4 of the output's scale; bfloat16: 2e-2 of it, because the
   plain version rounds its score product to bfloat16 where the kernel keeps
   float32), and times the kernel, the plain version and, as a yardstick the
   port never calls, one PyTorch library call computing the same function;
4. serves the full-width late-fusion model (Bernice-base + ViT-B/16, 12+12
   layers, hidden 768, vocab 250,002, 224 px, ``max_batch`` 16, random
   weights from a seed) through ``build_service`` + ``MicroBatcher`` + HTTP,
   once with ``--attn_impl auto`` (the SDPA kernel everywhere) and once with
   ``--attn_impl fused`` (the block kernel for self-attention), with the
   launch counts set to 0 before and read after each run;
5. checks that no request failed, that each answer's probabilities sum to 1,
   that every kernel of the path launched the expected number of times per
   window, and that the probabilities match a plain-path service built from
   the same state dict (within 2e-2: bfloat16 activations through 24 layers,
   rounded at other places than in the plain version);
6. prints one JSON line of per-kernel numbers, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero without the last line. Without CUDA, or
without the repository beside it, it exits non-zero at once.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request

PKG = "socialmedia_textimage_classification_auxlosses_tpu_torch"
JAX_PKG = "socialmedia_textimage_classification_auxlosses_tpu"

# NVIDIA H100 SXM data sheet (dense): bytes/s of HBM3, operations/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

BATCH = 16
N_REQUESTS = 48
N_CLIENTS = 16
PROB_TOL = 2e-2


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def device_ms(torch, fn, iters=30, warmup=3):
    """Device milliseconds per call of ``fn``. A long sleep kernel is queued
    first so the host enqueues every call before the card reaches the start
    event: the events then time the device, not the host's launch loop."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_bound = start.query()  # the card got past the sleep before the host was done
    torch.cuda.synchronize()
    if host_bound:
        raise RuntimeError("timing loop was host-bound; lengthen the sleep")
    return start.elapsed_time(end) / iters


def bound(nbytes: int, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def check_kernels(torch):
    """Each kernel against its plain version at the serving shapes."""
    import torch.nn.functional as F

    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attention as A
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attn_block as AB

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    def lengths_mask(b, length):
        lens = torch.randint(2, length + 1, (b,), generator=g, device="cuda")
        mask = (torch.arange(length, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
        mask[0] = 0  # a fully masked row: uniform weights, not NaN
        return mask

    def record(name, kernel, key, out, ref, run, plain, library, nb, ops, dtype):
        out, ref = out.float(), ref.float()
        if not torch.isfinite(out).all():
            raise AssertionError(f"{name}: kernel output is not finite")
        err = (out - ref).abs().max().item()
        scale = max(1.0, ref.abs().max().item())
        tol = (2e-2 if dtype == "bfloat16" else 1e-4) * scale
        log(f"check {name}: max_abs_err {err:.3e} rel {err / scale:.3e} "
            f"tol {tol:.1e} ({dtype})")
        if not err <= tol:
            raise AssertionError(f"{name}: kernel disagrees with its plain version "
                                 f"({err} > {tol})")
        bound_ms, bound_by = bound(nb, ops, dtype)
        with torch.no_grad():
            row = dict(name=name, kernel=kernel, key=key, max_abs_err=err,
                       ms=device_ms(torch, run), plain_ms=device_ms(torch, plain),
                       bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=device_ms(torch, library))
        log(f"time {name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"library {row['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        rows.append(row)

    # kernel 1: every SDPA of the serving path
    for tag, (b, h, lq, lk, d, dtype, masked) in {
            "text": (BATCH, 12, 128, 128, 64, "bfloat16", True),
            "image": (BATCH, 12, 197, 197, 64, "bfloat16", False),
            "fusion": (BATCH, 1, 1, 197, 768, "float32", False)}.items():
        dt = getattr(torch, dtype)
        q, k, v = randn(b, h, lq, d, dtype=dt), randn(b, h, lk, d, dtype=dt), randn(b, h, lk, d, dtype=dt)
        mask = lengths_mask(b, lk) if masked else None
        scale = d ** -0.5
        attn_mask = None if mask is None else (mask > 0)[:, None, None, :]
        out = A.sdpa(q, k, v, mask, scale)
        ref = A.sdpa_reference(q, k, v, mask, scale)
        record(f"sdpa_fwd/{tag}", "sdpa_fwd", (dtype, b, h, lq, lk, d, masked), out, ref,
               lambda: A.sdpa(q, k, v, mask, scale),
               lambda: A.sdpa_reference(q, k, v, mask, scale),
               lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, scale=scale),
               nbytes(q, k, v, mask, out), 4.0 * b * h * lq * lk * d, dtype)

    # kernel 2: every self-attention block with --attn_impl fused
    hid, heads = 768, 12
    for tag, (b, l, masked) in {"text": (BATCH, 128, True),
                                "image": (BATCH, 197, False)}.items():
        dt = torch.bfloat16
        x = randn(b, l, hid, dtype=dt)
        w = [(randn(hid, hid, dtype=torch.float32) * hid ** -0.5).to(dt) for _ in range(4)]
        bias = [randn(hid, dtype=torch.float32).mul(0.1).to(dt) for _ in range(4)]
        mask = lengths_mask(b, l) if masked else None
        args = [x, mask, w[0], bias[0], w[1], bias[1], w[2], bias[2], w[3], bias[3]]
        mha = torch.nn.MultiheadAttention(hid, heads, batch_first=True, device="cuda", dtype=dt)
        with torch.no_grad():
            mha.in_proj_weight.copy_(torch.cat([wi.t() for wi in w[:3]]))
            mha.in_proj_bias.copy_(torch.cat(bias[:3]))
            mha.out_proj.weight.copy_(w[3].t())
            mha.out_proj.bias.copy_(bias[3])
        pad = None if mask is None else mask == 0
        out = AB.attn_block(*args, heads=heads)
        ref = AB.attn_block(*args, heads=heads, impl="jnp")
        ops = 2.0 * b * l * hid * hid * 4 + 4.0 * b * l * l * hid
        record(f"attn_block_fwd/{tag}", "attn_block_fwd", ("bfloat16", b, l, hid, heads, masked),
               out, ref, lambda: AB.attn_block(*args, heads=heads),
               lambda: AB.attn_block(*args, heads=heads, impl="jnp"),
               lambda: mha(x, x, x, key_padding_mask=pad, need_weights=False),
               nbytes(x, mask, *w, *bias, out), ops, "bfloat16")
    return rows


def make_requests():
    import numpy as np

    rng = np.random.RandomState(30)
    words = ("rain sun happy sad team win lose #news @user https://t.co/x "
             "love hate coffee city \U0001F60D \U0001F389 tonight again never "
             "best worst").split()
    reqs = []
    for i in range(N_REQUESTS):
        text = " ".join(rng.choice(words, size=rng.randint(1, 40)))
        image = rng.randint(0, 256, (224, 224, 3), np.uint8) if i % 2 else None
        reqs.append((text, image))
    return reqs


def service_args(serve, model_path, attn_impl):
    return serve.parse_args([
        "--task", "3", "--txt_model_name", "bernice", "--img_model_name", "vit",
        "--fusion_name", "attention", "--arch", "base", "--dtype", "bfloat16",
        "--max_batch", str(BATCH), "--batch_window_ms", "20", "--seed", "30",
        "--attn_impl", attn_impl, "--model_path", model_path, "--port", "0"])


def profile_window(torch, predict, window, tag):
    """Where one full window's time goes: wall clock, the host ranges of
    ``predict_batch`` (serve.make_batch / serve.forward / serve.answer) and
    the device time by kernel, from torch.profiler. Informational: it checks
    nothing, and says so when the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    predict(window)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predict(window)
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # a named range also shows on the device as its span: keep it apart
    spans = {e.key: e.self_device_time_total / 1e3 for e in events
             if e.device_type == DeviceType.CUDA and e.key.startswith("serve.")}
    device = [e for e in events
              if e.device_type == DeviceType.CUDA and not e.key.startswith("serve.")]
    busy = sum(e.self_device_time_total for e in device) / 1e3
    ranges = {e.key: e.cpu_time_total / 1e3 for e in events
              if e.device_type == DeviceType.CPU and e.key.startswith("serve.")}
    log(f"profile[{tag}]: window wall {wall:.2f} ms; host ranges "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(ranges.items()))
        + "; device spans " + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(spans.items()))
        + (f"; kernels busy {busy:.2f} ms ({100 * (1 - busy / wall):.0f}% of the "
           "window idle)" if busy
           else "; device time not measured (the profiler saw no device events)"))
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        log(f"profile[{tag}]:   {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} "
            f"{e.key[:90]}")


def run_service(torch, serve, A, AB, args, reqs, http_text):
    """Serve ``reqs`` from several client threads plus one HTTP request;
    returns (answers, batcher stats, launch counts, seconds)."""
    predict, meta = serve.build_service(args)
    serve.warm_service(args, predict)
    torch.cuda.synchronize()
    A.launches.reset()
    AB.launches.reset()
    batcher = serve.MicroBatcher(predict, args.max_batch, args.batch_window_ms)
    server = serve.make_server(args, batcher, meta)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    answers = [None] * len(reqs)
    try:
        def client(c):
            for i in range(c, len(reqs), N_CLIENTS):
                answers[i] = batcher.submit(*reqs[i])

        t0 = time.monotonic()
        clients = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
            if c.is_alive():
                raise AssertionError("a client thread did not finish")
        seconds = time.monotonic() - t0
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/classify",
            data=json.dumps({"text": http_text}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            http_answer = json.loads(r.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        batcher.close()
        server.server_close()
        thread.join(timeout=30)
    counts = {"sdpa_fwd": dict(A.launches.by_key), "attn_block_fwd": dict(AB.launches.by_key)}
    profile_window(torch, predict, reqs[:BATCH], args.attn_impl)
    del predict
    torch.cuda.empty_cache()
    return answers + [http_answer], health, counts, seconds


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import numpy as np

    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import serve
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._build import (
        build_mm_late_setup)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._common import (
        seed_everything)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as C
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import _cuda
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attention as A
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attn_block as AB
    from socialmedia_textimage_classification_auxlosses_tpu_torch.train.checkpoint import (
        save_params)

    if any(m == JAX_PKG or m.startswith(JAX_PKG + ".") or m.split(".")[0] in ("jax", "flax")
           for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.monotonic()
    secs = _cuda.build()
    log(f"build: {time.monotonic() - t0:.1f} s wall; per source {secs}")
    for name in _cuda.SOURCES:
        regs = [ln.strip() for ln in _cuda.build_log(name).splitlines() if "Used" in ln]
        log(f"ptxas {name}: {regs}")

    rows = check_kernels(torch)

    reqs = make_requests()
    http_text = "an http request about the #weather @user"
    with tempfile.TemporaryDirectory() as tmp:
        model_path = os.path.join(tmp, "random_weights.pth")
        args = service_args(serve, model_path, "auto")
        t0 = time.monotonic()
        setup = build_mm_late_setup(args, C.serving_config(args),
                                    generator=seed_everything(args.seed))
        save_params(model_path, setup.model)
        n_params = sum(p.numel() for p in setup.model.parameters())
        del setup
        log(f"weights: {n_params} random parameters (seed {args.seed}) in "
            f"{time.monotonic() - t0:.1f} s")

        # the plain path: every attention through the plain PyTorch version
        plain_args = service_args(serve, model_path, "jnp")
        plain_predict, _ = serve.build_service(plain_args)
        A.launches.reset()
        AB.launches.reset()
        every = reqs + [(http_text, None)]
        plain = []
        for i in range(0, len(every), BATCH):
            plain += plain_predict(every[i:i + BATCH])
        if A.launches.count or AB.launches.count:
            raise AssertionError("the plain path launched a kernel")
        del plain_predict
        torch.cuda.empty_cache()
        plain_probs = np.array([p["probs"] for p in plain])

        per_window = {"auto": {"sdpa_fwd": 25, "attn_block_fwd": 0},
                      "fused": {"sdpa_fwd": 1, "attn_block_fwd": 24}}
        launches = {}
        for impl, expect in per_window.items():
            answers, health, counts, seconds = run_service(
                torch, serve, A, AB, service_args(serve, model_path, impl), reqs, http_text)
            windows = health["windows"]
            log(f"serve[{impl}]: {health['requests']} requests in {windows} windows, "
                f"{len(reqs) / seconds:.1f} requests/s from {N_CLIENTS} clients, "
                f"mean window {health['mean_dispatch_ms']} ms, errors {health['errors']}")
            if health["errors"] or health["requests"] != len(reqs) + 1:
                raise AssertionError(f"serve[{impl}]: {health}")
            probs = np.array([a["probs"] for a in answers])
            if probs.shape != plain_probs.shape or not np.isfinite(probs).all():
                raise AssertionError(f"serve[{impl}]: bad probabilities {probs.shape}")
            if np.abs(probs.sum(-1) - 1).max() > 1e-4:
                raise AssertionError(f"serve[{impl}]: probabilities do not sum to 1")
            err = np.abs(probs - plain_probs).max()
            log(f"serve[{impl}]: max |p - p_plain| {err:.3e} (tol {PROB_TOL})")
            if not err <= PROB_TOL:
                raise AssertionError(f"serve[{impl}]: disagrees with the plain path")
            for kernel, n in expect.items():
                total = sum(counts[kernel].values())
                log(f"serve[{impl}]: {kernel} launches {total} = {windows} windows x "
                    f"{total / windows:g} {counts[kernel]}")
                if total != n * windows:
                    raise AssertionError(f"serve[{impl}]: {kernel} launched {total} "
                                         f"times, expected {n} x {windows}")
            for kernel, by_key in counts.items():
                for key, n in by_key.items():
                    launches[(kernel, key)] = launches.get((kernel, key), 0) + n

    sources = {"sdpa_fwd": (f"{PKG}/csrc/sdpa_fwd.cu", f"{JAX_PKG}/ops/attention.py:81"),
               "attn_block_fwd": (f"{PKG}/csrc/attn_block_fwd.cu",
                                  f"{JAX_PKG}/ops/attn_block.py:143")}
    kernels = []
    for row in rows:
        n = launches.get((row["kernel"], row["key"]), 0)
        if n == 0:
            raise AssertionError(f"{row['name']} was never launched on the serving path")
        source, replaces = sources[row["kernel"]]
        kernels.append(dict(name=row["name"], route="cuda", source=source,
                            replaces=replaces, launches=n,
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)

"""HTTP serving endpoint for the late-fusion model, ViLT, MMBT and LXMERT, on
CUDA.

Counterpart of the JAX package's ``cli/serve.py`` for ``--model mm_late``,
``vilt``, ``mmbt`` and ``lxmert``, with the same flags plus ``--device``:

    python -m socialmedia_textimage_classification_auxlosses_tpu_torch.cli.serve \\
        --task 3 --txt_model_name bernice --img_model_name vit \\
        --fusion_name attention --port 8473 [--random_init]

    POST /classify   {"text": "...", "image_b64": "<base64 bytes>" |
                      "image_path": "p.jpg"}   ->
                     {"prediction": k, "class": "...", "probs": [...],
                      "timing_ms": {"queue": ..., "dispatch": ...}}
    GET  /healthz    liveness + model identity + traffic counters

Requests are micro-batched: the dispatcher collects up to ``--max_batch``
requests inside a ``--batch_window_ms`` window and answers them with one
forward at the fixed ``max_batch`` shape (padding rows are placeholders,
dropped before answering). Requests without an image run the empty-image
flow (a zero canvas). Every attention of that forward launches the port's
hand-written kernels (``ops/``) on a CUDA device.

The artifact (under the trainers' name contract, or ``--model_path``) is the
port's own ``torch.save`` state dict or a JAX-trained one, the flax msgpack
the JAX package writes (``train/checkpoint.py::load_params`` tells them apart
by their first bytes, and the layer layout, unrolled or scanned, from the
tree); ``--scan_layers`` is accepted as the JAX CLI takes it and decides
nothing here. ``--random_init`` serves random weights made from
``--seed``. Every image tower of the late-fusion model is served: ViT,
DeiT, BEiT, and ResNet-50/152 with ``--fusion_name concat_cnn|xatt`` (their
request images resized to 256 on the shorter side and centre-cropped, the
training recipe). ``--model vilt`` and ``--model mmbt`` serve the early
models of ``cli/_build_early.py`` (ViLT's fixed square, 384 px at base, a
joint sequence of 40 + 1 + 144; MMBT's ResNet-152 at 224 px or
``--image_size``, 132 tokens), each request image resized to the square,
their artifacts under the trainers' names in ``results_dir_mm_early`` and
``results_dir_mmbt``. ``--model lxmert`` runs the Faster R-CNN
(``models/frcnn.py``, fused path) on the images of every window: each image
becomes 36 regions of 2,048 features and their boxes, a request without an
image zeros; ``--frcnn_arch``, ``--frcnn_ckpt``, ``--frcnn_ingest``,
``--rpn_pre_topk`` and ``--rpn_post_topk`` set it up, and its missing
weights raise ``SystemExit`` unless ``--random_init`` (which makes the
detector random too). What the port lacks so far raises ``SystemExit``:
``--quantize``, ``--extra_model``, ``--workers`` > 1 and ``--img_decoder
native``; ``GET /metrics`` answers 501.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import pickle
import queue
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..core import config as C
from ..ops.attention import IMPLS as SDPA_IMPLS
from ..utils.logging import get_logger
from ._common import artifact_stem, resolve_device, results_dir_for, seed_everything

logger = get_logger(__name__)


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def build_parser():
    parser = argparse.ArgumentParser(description="serve a trained model")
    parser.add_argument("--model", type=str, default="mm_late",
                        choices=["mm_late", "vilt", "lxmert", "mmbt"],
                        help="model family; lxmert runs the FRCNN detector per window "
                             "(raw image -> ROI features -> classify)")
    parser.add_argument("--frcnn_arch", type=str, default="full",
                        choices=["full", "tiny"], help="(--model lxmert) detector geometry")
    parser.add_argument("--frcnn_ckpt", type=str, default=None,
                        help="(--model lxmert) detector checkpoint (default "
                             "MODEL_DIR_DICT['frcnn'])")
    parser.add_argument("--frcnn_ingest", type=str, default="pil",
                        choices=["pil", "device"],
                        help="(--model lxmert) device = ship the ORIGINAL uint8 request "
                             "pixels and resize on the device (torch bilinear); pil = the "
                             "reference's uint8/PIL resize (parity default)")
    parser.add_argument("--rpn_pre_topk", type=int, default=None,
                        help="(--model lxmert) RPN pre-NMS proposal count (default 6000); "
                             "a recall trade")
    parser.add_argument("--rpn_post_topk", type=int, default=None,
                        help="(--model lxmert) RPN post-NMS ROI count fed to res5 (default "
                             "1000): the per-window device-time lever, a recall trade")
    parser.add_argument("--image_size", type=int, default=None,
                        help="(CNN towers) input image size")
    parser.add_argument("--img_decoder", type=str, default="pil",
                        choices=["pil", "native"],
                        help="request image decoder (only pil is ported)")
    parser.add_argument("--txt_model_name", type=str, default="bernice",
                        choices=["bert", "bernice", "bertweet", "roberta"])
    parser.add_argument("--img_model_name", type=str, default="vit",
                        choices=["vit", "beit", "deit", "resnet50",
                                 "resnet152"])
    parser.add_argument("--fusion_name", type=str, default="attention",
                        choices=["xatt", "concat", "attention", "concat_cnn",
                                 "aspect-att", "gmu"])
    parser.add_argument("--task", type=int, required=True,
                        choices=[0, 1, 2, 3, 4, 5, 6])
    parser.add_argument("--seed", type=int, default=30,
                        help="seed of the trained artifact (name contract) "
                             "and of --random_init")
    parser.add_argument("--model_path", type=str, default=None,
                        help="explicit artifact path; default derives the "
                             "run_mm_late naming contract under the results "
                             "dir")
    parser.add_argument("--use_clip_loss", action="store_true",
                        help="artifact was trained with ITC (name contract)")
    parser.add_argument("--use_tim_loss", action="store_true",
                        help="artifact was trained with TIM (name contract)")
    parser.add_argument("--beta_itc", type=float, default=0.1)
    parser.add_argument("--beta_itm", type=float, default=0.1)
    parser.add_argument("--nsamples", type=int, default=-1)
    parser.add_argument("--testing", action="store_true")
    parser.add_argument("--dropout", type=float, default=0.05)
    parser.add_argument("--weight_decay", type=float, default=0.00025)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--attn_impl", type=str, default="auto",
                        help="auto/pallas: the SDPA kernel; fused: the "
                             "whole-block kernel for self-attention; jnp: "
                             "the plain PyTorch version")
    parser.add_argument("--arch", type=str, default="base",
                        choices=["base", "small", "tiny"])
    parser.add_argument("--scan_layers", action="store_true",
                        help="the JAX CLI's flag for a scanned-layer artifact; "
                             "the port reads the layout from the file")
    parser.add_argument("--quantize", type=str, default=None, choices=["w8"])
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8473)
    parser.add_argument("--workers", type=int, default=1,
                        help="SO_REUSEPORT multi-process serving (not ported)")
    parser.add_argument("--image_root", type=str, default=None,
                        help="directory that request image_path values are "
                             "confined to; image_path requests are REFUSED "
                             "unless this is set (image_b64 always works)")
    parser.add_argument("--fast_start", action="store_true",
                        help="(--model lxmert) warm only the first window shape (a "
                             "landscape image), not a portrait one too")
    parser.add_argument("--max_batch", type=int, default=16,
                        help="serving batch (one fixed shape)")
    parser.add_argument("--batch_window_ms", type=float, default=5.0,
                        help="micro-batching window: first request opens the "
                             "window, the dispatch ships when it closes or "
                             "the batch fills")
    parser.add_argument("--random_init", action="store_true",
                        help="serve random-init weights (smoke tests only)")
    parser.add_argument("--drain_timeout", type=float, default=10.0,
                        help="seconds SIGTERM waits for in-flight requests "
                             "to finish before the process exits")
    parser.add_argument("--extra_model", action="append", default=[],
                        metavar="NAME:KEY=VALUE[,KEY=VALUE...]",
                        help="serve an additional model (not ported)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where the model runs; cuda unless cpu is asked "
                             "for (no quiet fallback)")
    return parser


def check_supported(args) -> None:
    """Raise ``SystemExit`` for every flag value that selects something the
    port does not have yet, rather than ignoring it."""
    from ._build import check_mm_late_supported

    if args.quantize:
        raise SystemExit("--quantize w8 is not ported to PyTorch yet")
    if args.extra_model:
        raise SystemExit("--extra_model is not ported to PyTorch yet")
    if args.workers != 1:
        raise SystemExit("--workers is not ported to PyTorch yet")
    if args.img_decoder != "pil":
        raise SystemExit("--img_decoder native is not ported to PyTorch yet")
    if args.attn_impl not in SDPA_IMPLS:
        raise SystemExit(f"--attn_impl {args.attn_impl}: expected one of "
                         f"{SDPA_IMPLS}")
    if args.model == "mm_late":
        check_mm_late_supported(args)


def _make_detector(args, device, cache: dict = None):
    """The FRCNN detector of ``--model lxmert`` on ``device``. ``cache``
    shares one detector between services of the same (arch, ckpt,
    random_init, pre, post). ``--random_init`` makes it random; otherwise
    weights that do not load raise ``SystemExit``: a service must not
    answer from noise ROI features."""
    from ..models import frcnn as FR
    from .obj_features import frcnn_config

    pre, post = args.rpn_pre_topk, args.rpn_post_topk
    key = (args.frcnn_arch, args.frcnn_ckpt, args.random_init, pre, post)
    if cache is not None and key in cache:
        logger.info("sharing the %s FRCNN detector across models", args.frcnn_arch)
        return cache[key]
    cfg = frcnn_config(args.frcnn_arch == "tiny", rpn_pre_topk=pre, rpn_post_topk=post)
    weight_path = args.frcnn_ckpt or C.MODEL_DIR_DICT.get("frcnn", "")
    if args.random_init:
        det = FR.FrcnnDetector(cfg, device=device)
    else:
        try:
            det = FR.load_frcnn(weight_path, cfg, device=device)
        except (OSError, RuntimeError, pickle.UnpicklingError) as e:
            raise SystemExit(
                f"serve: cannot load FRCNN detector weights from {weight_path!r}"
                f" ({e!r}); pass --frcnn_ckpt (unc-nlp/frcnn-vg-finetuned "
                "pytorch_model.bin) or --random_init for smoke runs") from e
    if cache is not None:
        cache[key] = det
    return det


def _serving_roi_cache(detector):
    """What the LXMERT build reads of a ROI cache: the detector's region
    count and feature width, which size the visual projection (requests
    carry live detector features; no rows are stored)."""
    return SimpleNamespace(num_boxes=detector.cfg.max_detections,
                           feat_dim=detector.cfg.feat_dim)


def build_service(args, detector_cache: dict = None):
    """Model + fixed-shape predict + request preprocessing.

    Returns ``(predict_batch, meta)`` where ``predict_batch(requests) ->
    list of response dicts`` runs one forward for up to ``max_batch``
    requests of ``(text, image-or-None)``; an image is a PIL image or an
    already resized (S, S, 3) uint8 array (for ``--model lxmert`` the raw
    RGB array, which the detector resizes). ``detector_cache`` shares
    detectors between services (``_make_detector``)."""
    from ..data.images import resize_to_u8
    from ..train.checkpoint import load_params
    from ..utils.cast import cast_params_for_eval
    from ._build import build_mm_late_setup
    from ._build_early import build_mm_early_setup

    check_supported(args)
    device = resolve_device(args.device)
    family = args.model
    cfg = C.serving_config(args, model_name=family)
    generator = seed_everything(args.seed)
    detector = None
    if family == "mm_late":
        setup = build_mm_late_setup(args, cfg, generator=generator if args.random_init else None)
    else:
        roi_cache = None
        if family == "lxmert":
            detector = _make_detector(args, device, detector_cache)
            roi_cache = _serving_roi_cache(detector)
        setup = build_mm_early_setup(args, cfg, generator=generator if args.random_init else None,
                                     roi_cache=roi_cache)
    model_path = None
    if args.random_init:
        logger.warning("serving RANDOM-INIT weights (--random_init)")
    else:
        # the trainers' artifact names (MMBT's in the reference's results_dir_mmbt)
        base = {"mm_late": C.results_dir_mm_late,
                "mmbt": C.results_dir_mmbt}.get(family, C.results_dir_mm_early)
        model_path = args.model_path or (
            results_dir_for(base, args.testing) + artifact_stem(args, cfg, family) + "net.pth")
        load_params(model_path, setup.model)
        logger.info("loaded %s", model_path)
    # the serving pre-cast (utils/cast.py), on the host before the copy
    cast_params_for_eval(setup.model, args.dtype)
    setup.model.to(device)
    tokenizer, image_size, forward = setup.tokenizer, setup.image_size, setup.forward_fn
    crop = setup.center_crop_from
    b = args.max_batch

    def make_batch(requests):
        """requests -> the fixed-shape host batch (rows past len(requests)
        are placeholder texts with the empty image)."""
        n = len(requests)
        if not 0 < n <= b:
            raise ValueError(f"a window holds 1..{b} requests, got {n}")
        enc = tokenizer([r[0] for r in requests] + ["placeholder"] * (b - n))
        batch = {"ids": enc["ids"], "mask": enc["mask"]}
        if "token_type_ids" in enc:
            batch["token_type_ids"] = enc["token_type_ids"]
        if detector is not None:
            dc = detector.cfg
            feats = np.zeros((b, dc.max_detections, dc.feat_dim), np.float32)
            boxes = np.zeros((b, dc.max_detections, 4), np.float32)
            with_img = [(i, img) for i, (_, img) in enumerate(requests) if img is not None]
            if with_img:
                # unpadded: the JAX service pads to a power of two for its
                # compiled shapes, and a padded row changes no result
                outs = detector.detect_batch([im for _, im in with_img],
                                             ingest=args.frcnn_ingest)
                for (i, _), out in zip(with_img, outs):
                    feats[i] = out["roi_features"]
                    boxes[i] = out["normalized_boxes"]
            batch["roi_features"] = feats
            batch["roi_boxes"] = boxes
            return batch
        pixels = np.zeros((b, image_size, image_size, 3), np.uint8)
        for i, (_, img) in enumerate(requests):
            if img is None:
                continue  # empty-image flow
            pixels[i] = (img if isinstance(img, np.ndarray)
                         else resize_to_u8(img, image_size, center_crop_from=crop))
        batch["pixel_values"] = pixels
        return batch

    def predict_batch(requests):
        n = len(requests)
        # named ranges for torch.profiler traces (no cost when it is off)
        with torch.profiler.record_function("serve.make_batch"):
            host = make_batch(requests)
        with torch.inference_mode():
            batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
            with torch.profiler.record_function("serve.forward"):
                logits = forward(batch)["out_cls"].float()
            with torch.profiler.record_function("serve.answer"):
                probs = torch.softmax(logits, dim=-1)[:n].cpu().numpy()
        out = []
        for row in probs:
            pred = int(np.argmax(row))
            out.append({
                "prediction": pred,
                "class": cfg.classes[pred] if cfg.classes else None,
                "probs": [float(v) for v in row],
            })
        return out

    meta = {
        "model": (f"{args.txt_model_name}-{args.img_model_name}-{args.fusion_name}"
                  if family == "mm_late" else family),
        "task": args.task,
        "task_name": cfg.task_name,
        "num_labels": cfg.num_labels,
        "max_batch": b,
        "model_path": model_path,
        "device": str(device),
        "attn_impl": args.attn_impl,
        # the HTTP handler resizes images to this size (the CNN recipe from
        # center_crop_from) in its own thread; the detector resizes its own
        "resize_size": image_size,
        "center_crop_from": crop,
    }
    return predict_batch, meta


class MicroBatcher:
    """Collects concurrent requests into one forward.

    The first queued request opens a window; the dispatcher ships when the
    window closes or ``max_batch`` requests are pending. Callers block on a
    per-request event and get their row of the batched result."""

    def __init__(self, predict_batch, max_batch: int, window_ms: float):
        self._predict = predict_batch
        self._max = max_batch
        self._window = window_ms / 1000.0
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._stop = False
        # served-traffic counters, written by the dispatcher thread under
        # _stats_lock so a reader sees one consistent window
        self.requests = 0
        self.windows = 0
        self.errors = 0
        self.dispatch_seconds = 0.0
        self._stats_lock = threading.Lock()
        # in-flight accounting for drain(): submit() spans and whole HTTP
        # handlers, so a drain cannot cut off a response
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._thread.start()

    def stats(self) -> dict:
        with self._stats_lock:
            req, w, err = self.requests, self.windows, self.errors
            disp = self.dispatch_seconds
        d = max(w, 1)
        return {"requests": req, "windows": w, "errors": err,
                "mean_batch": round(req / d, 2),
                "mean_dispatch_ms": round(disp / d * 1e3, 2)}

    def handler_started(self):
        with self._inflight_lock:
            self._inflight += 1

    def handler_finished(self):
        with self._inflight_lock:
            self._inflight -= 1

    def submit(self, text, image, timeout: float = 600.0):
        if self._stop or not self._thread.is_alive():
            raise RuntimeError("serving dispatcher is not running")
        done = threading.Event()
        slot = {"done": done, "t_submit": time.monotonic()}
        with self._inflight_lock:
            self._inflight += 1
        try:
            self._q.put((text, image, slot))
            if not done.wait(timeout):
                raise RuntimeError("serving dispatch timed out")
            if "error" in slot:
                raise RuntimeError(slot["error"])
            return slot["result"]
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def drain(self, timeout: float = 10.0) -> bool:
        """Block until every ``submit`` in flight has returned. Returns False
        if requests were still pending at the deadline."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._inflight_lock:
                if self._inflight == 0:
                    return True
            time.sleep(0.01)
        with self._inflight_lock:
            return self._inflight == 0

    def close(self):
        self._stop = True
        self._q.put(None)
        self._thread.join(timeout=5)

    def _run(self):
        while not self._stop:
            first = self._q.get()
            if first is None:
                continue
            pending = [first]
            deadline = time.monotonic() + self._window
            while len(pending) < self._max:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    item = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if item is None:
                    break
                pending.append(item)
            t0 = time.monotonic()
            try:
                results = self._predict([(t, im) for t, im, _ in pending])
                dt = time.monotonic() - t0
                with self._stats_lock:
                    self.windows += 1
                    self.requests += len(pending)
                    self.dispatch_seconds += dt
                for (_, _, slot), res in zip(pending, results):
                    res["timing_ms"] = {
                        "queue": round((t0 - slot["t_submit"]) * 1e3, 2),
                        "dispatch": round(dt * 1e3, 2),
                    }
                    slot["result"] = res
                    slot["done"].set()
            except BaseException as e:  # answer every waiting caller: a dead
                # dispatcher would hang all later submits
                logger.exception("serving dispatch failed for a window of "
                                 "%d requests", len(pending))
                with self._stats_lock:
                    self.errors += len(pending)
                for _, _, slot in pending:
                    slot["error"] = "internal prediction failure"
                    slot["done"].set()
                if not isinstance(e, Exception):
                    raise


def _decode_image(payload, image_root=None):
    """-> PIL Image or None."""
    from PIL import Image

    if payload.get("image_b64"):
        raw = base64.b64decode(payload["image_b64"])
        return Image.open(io.BytesIO(raw)).convert("RGB")
    if payload.get("image_path"):
        # image_path names a server-side file: confine it to the operator's
        # directory (regular files only) and refuse it without --image_root
        if not image_root:
            raise ValueError(
                "image_path requests are disabled (start the server with "
                "--image_root to allow them); send image_b64 instead")
        root = os.path.realpath(image_root)
        path = os.path.realpath(os.path.join(root, payload["image_path"]))
        if os.path.commonpath([root, path]) != root:
            raise ValueError("image_path escapes --image_root")
        if not os.path.isfile(path):
            raise ValueError("image_path is not a regular file")
        return Image.open(path).convert("RGB")
    return None


def warm_service(args, predict_batch):
    """Run one window before accepting traffic: builds the kernels and
    brings the weights' first use out of a live request. ``--model lxmert``
    also runs the detector: one window of a landscape image and one of a
    portrait image (the two canvases), or only the first with
    ``--fast_start``. The JAX service warms every pad size of each
    orientation because XLA compiles one program per shape; torch compiles
    nothing, so one window per orientation is enough."""
    t0 = time.time()
    if args.model != "lxmert":
        predict_batch([("warmup", None)])
        logger.info("warmed serving shape (batch %d) in %.1fs", args.max_batch,
                    time.time() - t0)
        return
    shapes = [("landscape", (240, 320)), ("portrait", (320, 240))]
    if args.fast_start:
        shapes = shapes[:1]
    for orient, hw in shapes:
        ts = time.time()
        predict_batch([("warmup", np.zeros(hw + (3,), np.uint8))])
        logger.info("warm: detector %s in %.1fs", orient, time.time() - ts)
    logger.info("warmed serving + detector (batch %d) in %.1fs", args.max_batch,
                time.time() - t0)


def make_server(args, batcher: MicroBatcher, meta):
    """HTTP server: ``POST /classify`` and ``GET /healthz``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "pid": os.getpid(), **meta,
                                 **batcher.stats()})
            elif self.path == "/metrics":
                self._send(501, {"error": "/metrics is not ported to PyTorch yet"})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/classify":
                self._send(404, {"error": "unknown path"})
                return
            batcher.handler_started()
            try:
                self._do_post()
            finally:
                batcher.handler_finished()

        def _do_post(self):
            try:  # malformed request (bad JSON / image bytes) -> 400
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
                text = payload.get("text", "")
                image = _decode_image(payload, args.image_root)
                if image is not None and meta["resize_size"]:
                    # resize here, in the handler thread (PIL releases the
                    # GIL), not in the one dispatcher thread
                    from ..data.images import resize_to_u8

                    image = resize_to_u8(image, meta["resize_size"],
                                         center_crop_from=meta["center_crop_from"])
            except Exception as e:
                self._send(400, {"error": repr(e)})
                return
            try:  # server-side prediction failure -> 500, details in logs
                self._send(200, batcher.submit(text, image))
            except Exception:
                self._send(500, {"error": "internal prediction failure"})

        def log_message(self, fmt, *a):
            logger.info("http: " + fmt, *a)

    class Server(ThreadingHTTPServer):
        # the stdlib accept backlog (5) drops bursty connects
        request_queue_size = 128

    return Server((args.host, args.port), Handler)


def main(argv=None):
    import signal

    args = parse_args(argv)
    check_supported(args)
    state = {"server": None, "stopping": False}

    def _graceful(signum, frame):
        # serving: stop the accept loop (off its own thread) and drain;
        # build/warm-up: nothing is in flight, exit now
        state["stopping"] = True
        srv = state["server"]
        if srv is not None:
            logger.info("signal %d: stopping accept loop and draining", signum)
            threading.Thread(target=srv.shutdown, daemon=True).start()
        else:
            logger.info("signal %d during build/warm-up: exiting", signum)
            raise SystemExit(128 + signum)

    try:
        signal.signal(signal.SIGTERM, _graceful)
    except ValueError:  # signal only works on the main thread
        logger.warning("not on the main thread: SIGTERM drain disabled")

    predict_batch, meta = build_service(args)
    warm_service(args, predict_batch)
    batcher = MicroBatcher(predict_batch, args.max_batch, args.batch_window_ms)
    server = make_server(args, batcher, meta)
    state["server"] = server
    logger.info("serving %s on %s:%d (device %s, max_batch=%d, window=%.1fms)",
                meta["model"], args.host, server.server_address[1],
                meta["device"], args.max_batch, args.batch_window_ms)
    try:
        if not state["stopping"]:
            server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if not batcher.drain(timeout=args.drain_timeout):
            logger.warning("drain timeout (%.1fs): exiting with requests "
                           "still in flight", args.drain_timeout)
        batcher.close()
        server.server_close()


if __name__ == "__main__":
    raise SystemExit(main())

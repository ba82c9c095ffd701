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
    POST /classify/NAME   the same, for the model ``--extra_model NAME:...``
    GET  /healthz    liveness + model identity + traffic counters (per model)
    GET  /metrics    Prometheus text exposition (0.0.4): requests, errors and
                     windows counters and the per-window dispatch latency
                     histogram, the JAX package's series byte for byte

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
tree); ``--scan_layers`` is accepted as the JAX CLI takes it and, as there,
keeps the stacked layer kernels out of ``--quantize w8``. ``--random_init``
serves random weights made from ``--seed``. Every image tower of the
late-fusion model is served: ViT, DeiT, BEiT, and ResNet-50/152 with
``--fusion_name concat_cnn|xatt`` (their request images resized to 256 on
the shorter side and centre-cropped, the training recipe). ``--model vilt``
and ``--model mmbt`` serve the early models of ``cli/_build_early.py``
(ViLT's fixed square, 384 px at base, a joint sequence of 40 + 1 + 144;
MMBT's ResNet-152 at 224 px or ``--image_size``, 132 tokens), each request
image resized to the square, their artifacts under the trainers' names in
``results_dir_mm_early`` and ``results_dir_mmbt``. ``--model lxmert`` runs
the Faster R-CNN (``models/frcnn.py``, fused path) on the images of every
window: each image becomes 36 regions of 2,048 features and their boxes, a
request without an image zeros; ``--frcnn_arch``, ``--frcnn_ckpt``,
``--frcnn_ingest``, ``--rpn_pre_topk`` and ``--rpn_post_topk`` set it up,
and its missing weights raise ``SystemExit`` unless ``--random_init``
(which makes the detector random too).

The serving extras, as in the JAX package:

* ``--quantize w8``: the weight-only int8 weights of ``ops/quant.py``,
  dequantized to bfloat16 inside each window's forward (the other weights
  are not pre-cast); every family but the detector's weights.
* ``--extra_model NAME:KEY=VALUE,...`` (repeatable): another model in the
  same process at ``POST /classify/NAME``, its flags those of the primary
  with the pairs' overrides (``parse_model_spec``); each model has its own
  micro-batcher, LXMERT models with the same detector flags share one
  detector, and ``/healthz`` and ``/metrics`` report per model.
* ``--workers N``: this process becomes a supervisor of N serving processes
  that bind one explicit ``--port`` with ``SO_REUSEPORT`` (the kernel
  spreads connections); it forwards SIGTERM and SIGINT, reaps them and
  exits with the worst worker's code. Each worker holds its own model on
  the card.
* ``--img_decoder native``: request images of the square-resize families
  decode and resize in C++ (``data/native.py``); the CNN recipe and the
  detector's canvas stay PIL, and a failed build or decode falls back to
  PIL with the JAX package's warning.

``build_service(..., export_info=)`` hands ``cli/export.py`` the fixed-shape
predict it exports with ``torch.export``.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import pickle
import queue
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..core import config as C
from ..ops.attention import IMPLS as SDPA_IMPLS
from ..utils.logging import get_logger
from ._common import (artifact_stem, publish_img_decoder, resolve_device, results_dir_for,
                      seed_everything)

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
                        help="native = C++ in-memory JPEG/PNG decode + resize of request "
                             "images (csrc/imgdec.cpp; DCT-scaled JPEG decode, so large "
                             "photos never decode at full size). Applies to the "
                             "square-resize families; the CNN centre-crop recipe and the "
                             "lxmert detector canvas stay PIL. Falls back to PIL per image "
                             "on any decode failure")
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
                             "the port reads the layout from the file, and under "
                             "--quantize w8 keeps the stacked layer kernels "
                             "unquantized, as the JAX service does")
    parser.add_argument("--quantize", type=str, default=None, choices=["w8"],
                        help="w8: weight-only int8 Dense kernels (ops/quant.py), "
                             "dequantized to bfloat16 in each window's forward")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8473)
    parser.add_argument("--workers", type=int, default=1,
                        help="SO_REUSEPORT multi-process serving: N full service "
                             "processes bind the same port and the kernel spreads "
                             "connections across them. Each worker builds its own "
                             "model on the device. Requires an explicit --port")
    parser.add_argument("--_reuse_port", action="store_true", help=argparse.SUPPRESS)
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
                        help="serve an ADDITIONAL model from this process at POST "
                             "/classify/NAME, e.g. --extra_model early:model=vilt,arch=base. "
                             "KEY=VALUE pairs override the primary flags for that model. "
                             "Repeatable. lxmert entries share one FRCNN detector per "
                             "(arch, ckpt); each model gets its own micro-batcher, and "
                             "/healthz + /metrics report per-model")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where the model runs; cuda unless cpu is asked "
                             "for (no quiet fallback)")
    return parser


# --extra_model keys a spec may override: what shapes the model, its artifact
# lookup or its batching, not the shared server plumbing (host, port,
# image_root, drain_timeout, device); the JAX package's set
_SPEC_KEYS = frozenset({
    "model", "task", "txt_model_name", "img_model_name", "fusion_name",
    "arch", "seed", "model_path", "use_clip_loss", "use_tim_loss",
    "beta_itc", "beta_itm", "dropout", "dtype", "attn_impl", "scan_layers",
    "quantize", "max_batch", "batch_window_ms", "random_init", "testing",
    "image_size", "frcnn_arch", "frcnn_ckpt", "frcnn_ingest", "fast_start",
    "nsamples", "rpn_pre_topk", "rpn_post_topk",
})


def parse_model_spec(base_args, spec: str):
    """``NAME:KEY=VALUE,...`` -> (name, the flags of that model): a copy of
    ``base_args`` with the pairs set. Values are coerced from the declared
    flag types (booleans take 1/true/yes), declared choices are enforced, and
    a bad name, an unknown key or a bad value raise ``SystemExit`` with the
    JAX package's words."""
    import copy

    name, _, body = spec.partition(":")
    name = name.strip()
    if not name or "/" in name:
        raise SystemExit(f"--extra_model {spec!r}: NAME missing or invalid "
                         "(route segment, no '/')")
    if name == "default":
        # the primary owns the "default" label of a multi-model /metrics
        raise SystemExit(f"--extra_model {spec!r}: the name 'default' is "
                         "reserved for the primary /classify model")
    args = copy.deepcopy(base_args)
    args.extra_model = []
    actions = build_parser()._option_string_actions
    for pair in filter(None, (p.strip() for p in body.split(","))):
        key, eq, raw = pair.partition("=")
        if not eq or key not in _SPEC_KEYS:
            raise SystemExit(
                f"--extra_model {spec!r}: bad override {pair!r} "
                f"(allowed keys: {', '.join(sorted(_SPEC_KEYS))})")
        action = actions["--" + key]
        try:
            if isinstance(getattr(args, key), bool) or (
                    action.const is True and action.nargs == 0):
                val = raw.lower() in ("1", "true", "yes")
            elif action.type is not None:
                val = action.type(raw)
            else:
                val = raw
            if action.choices and val not in action.choices:
                raise ValueError(f"choose from {sorted(action.choices)}")
        except ValueError as e:
            raise SystemExit(f"--extra_model {spec!r}: bad value for {key}: {e}")
        setattr(args, key, val)
    return name, args


def check_supported(args) -> None:
    """Raise ``SystemExit`` for a flag value the service cannot take, rather
    than ignoring it."""
    from ._build import check_mm_late_supported

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


def build_service(args, detector_cache: dict = None, export_info: dict = None):
    """Model + fixed-shape predict + request preprocessing.

    Returns ``(predict_batch, meta)`` where ``predict_batch(requests) ->
    list of response dicts`` runs one forward for up to ``max_batch``
    requests of ``(text, image-or-None)``; an image is a PIL image or an
    already resized (S, S, 3) uint8 array (for ``--model lxmert`` the raw
    RGB array, which the detector resizes). ``detector_cache`` shares
    detectors between services (``_make_detector``). ``export_info`` (a
    dict, filled in place) receives what ``cli/export.py`` exports: the
    model, ``predict(batch of device tensors) -> probabilities``, the host
    batch builder, the device, the detector and the classes."""
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
    w8 = None
    if args.quantize == "w8":
        # int8 weights dequantized in each forward; the other weights are
        # not pre-cast, as in the JAX service
        from ..ops.quant import quantize_w8

        w8 = quantize_w8(setup.model, scan_layers=args.scan_layers, compute_dtype=args.dtype)
        logger.info("w8 serving quantization enabled (%d weights)", len(w8.names))
    else:
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

    def predict(batch):
        """The device batch -> (max_batch, num_labels) float32 probabilities
        (softmax; serving is never multilabel)."""
        return torch.softmax(forward(batch)["out_cls"].float(), dim=-1)

    def predict_batch(requests):
        n = len(requests)
        # named ranges for torch.profiler traces (no cost when it is off)
        with torch.profiler.record_function("serve.make_batch"):
            host = make_batch(requests)
        with torch.inference_mode():
            batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
            with torch.profiler.record_function("serve.forward"):
                probs = predict(batch)
            with torch.profiler.record_function("serve.answer"):
                probs = probs[:n].cpu().numpy()
        out = []
        for row in probs:
            pred = int(np.argmax(row))
            out.append({
                "prediction": pred,
                "class": cfg.classes[pred] if cfg.classes else None,
                "probs": [float(v) for v in row],
            })
        return out

    if export_info is not None:
        export_info.update(model=setup.model, predict=predict, make_batch=make_batch,
                           device=device, detector=detector, w8=w8,
                           num_labels=cfg.num_labels, classes=cfg.classes)

    native_size = None
    if args.img_decoder == "native" and detector is None and crop is None:
        from ..data.native import imgdec_available

        if imgdec_available():
            native_size = image_size
        else:
            logger.warning("--img_decoder native: imgdec build unavailable; "
                           "serving with PIL decode")
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
        "quantize": args.quantize,
        # the request decoder's square (None: PIL decodes)
        "native_size": native_size,
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

    # per-window dispatch latency histogram bounds (seconds) for /metrics
    LATENCY_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)

    def __init__(self, predict_batch, max_batch: int, window_ms: float):
        self._predict = predict_batch
        self._max = max_batch
        self._window = window_ms / 1000.0
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._stop = False
        # served-traffic counters (/healthz, /metrics), written by the one
        # dispatcher thread under _stats_lock, held for the counter bump only
        # and never during the forward, so a scrape sees one consistent
        # window (sum, count and windows agree)
        self.requests = 0
        self.windows = 0
        self.errors = 0
        self.dispatch_seconds = 0.0
        self.latency_counts = [0] * (len(self.LATENCY_BUCKETS) + 1)  # the last: +Inf
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

    def snapshot(self) -> dict:
        """One lock-consistent copy of every counter."""
        with self._stats_lock:
            return {"requests": self.requests, "errors": self.errors,
                    "windows": self.windows,
                    "dispatch_seconds": self.dispatch_seconds,
                    "latency_counts": list(self.latency_counts)}

    def prometheus_text(self, meta: dict) -> str:
        """Prometheus text exposition (0.0.4) of this batcher's counters."""
        return prometheus_text([(None, self, meta)])

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
                i = 0
                while i < len(self.LATENCY_BUCKETS) and dt > self.LATENCY_BUCKETS[i]:
                    i += 1
                with self._stats_lock:
                    self.windows += 1
                    self.requests += len(pending)
                    self.dispatch_seconds += dt
                    self.latency_counts[i] += 1
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


def _escape_label(value) -> str:
    """Text-exposition label escaping: backslash, double quote and newline."""
    return (str(value).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def prometheus_text(services) -> str:
    """Prometheus text exposition (0.0.4) over one or more services, the
    JAX package's series, labels and order. ``services``: a list of
    ``(name, batcher, meta)``; one model passes ``name=None`` and its series
    are unlabelled, several label every series ``model="name"``."""

    def lbl(name, extra=""):
        parts = [f'model="{_escape_label(name)}"'] if name is not None else []
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    snaps = [(name, b.snapshot(), meta) for name, b, meta in services]
    lines = ["# HELP smtc_serving_requests_total classify requests served",
             "# TYPE smtc_serving_requests_total counter"]
    lines += [f"smtc_serving_requests_total{lbl(n)} {s['requests']}" for n, s, _ in snaps]
    lines += ["# HELP smtc_serving_errors_total requests failed in dispatch",
              "# TYPE smtc_serving_errors_total counter"]
    lines += [f"smtc_serving_errors_total{lbl(n)} {s['errors']}" for n, s, _ in snaps]
    lines += ["# HELP smtc_serving_windows_total device dispatch windows",
              "# TYPE smtc_serving_windows_total counter"]
    lines += [f"smtc_serving_windows_total{lbl(n)} {s['windows']}" for n, s, _ in snaps]
    lines += ["# HELP smtc_serving_dispatch_seconds per-window device dispatch latency",
              "# TYPE smtc_serving_dispatch_seconds histogram"]
    for n, s, _ in snaps:
        cum = 0
        for le, cnt in zip(MicroBatcher.LATENCY_BUCKETS, s["latency_counts"]):
            cum += cnt
            le_label = lbl(n, 'le="%s"' % le)
            lines.append(f"smtc_serving_dispatch_seconds_bucket{le_label} {cum}")
        cum += s["latency_counts"][-1]
        inf_label = lbl(n, 'le="+Inf"')
        lines.append(f"smtc_serving_dispatch_seconds_bucket{inf_label} {cum}")
        lines.append(f"smtc_serving_dispatch_seconds_sum{lbl(n)} {s['dispatch_seconds']:.6f}")
        lines.append(f"smtc_serving_dispatch_seconds_count{lbl(n)} {cum}")
    lines += ["# HELP smtc_serving_info model identity (value is always 1)",
              "# TYPE smtc_serving_info gauge"]
    for n, _, meta in snaps:
        if n is not None:  # the route's name and the artifact it serves
            labels = [f'model="{_escape_label(n)}"',
                      f'artifact="{_escape_label(meta.get("model", ""))}"']
        else:
            labels = [f'model="{_escape_label(meta.get("model", ""))}"']
        labels.append(f'task="{_escape_label(meta.get("task", ""))}"')
        lines.append(f'smtc_serving_info{{{",".join(labels)}}} 1')
    return "\n".join(lines) + "\n"


def _decode_image(payload, image_root=None, native_size=None):
    """-> PIL Image, None, or with ``native_size`` (``--img_decoder native``)
    the request image decoded and resized by the C++ decoder to a
    (native_size, native_size, 3) uint8 array; a decode it cannot do falls
    back to PIL."""
    from PIL import Image

    if payload.get("image_b64"):
        raw = base64.b64decode(payload["image_b64"])
        if native_size:
            from ..data.native import native_decode_resize_mem

            px = native_decode_resize_mem(raw, native_size)
            if px is not None:
                return px
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
        if native_size:
            from ..data.native import native_decode_resize

            px = native_decode_resize(path, native_size)
            if px is not None:
                return px
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


def make_server(args, batcher: MicroBatcher, meta, extra_services=None):
    """HTTP server over the primary service and the named extras
    (``extra_services``: name -> (batcher, meta), from ``--extra_model``).
    The primary answers ``POST /classify`` and is ``default`` in a
    multi-model ``/metrics``; an extra answers ``POST /classify/<name>``.
    Without extras ``/healthz`` and ``/metrics`` are those of one model."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    extra_services = extra_services or {}

    def scrape_entries():
        if not extra_services:
            return [(None, batcher, meta)]
        return [("default", batcher, meta)] + [(n, b, m) for n, (b, m) in extra_services.items()]

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
                # pid tells the workers of --workers apart
                health = {"status": "ok", "pid": os.getpid(), **meta, **batcher.stats()}
                if extra_services:
                    health["models"] = {n: {**m, **b.stats()}
                                        for n, (b, m) in extra_services.items()}
                self._send(200, health)
            elif self.path == "/metrics":
                body = prometheus_text(scrape_entries()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": "unknown path"})

        def _route(self):
            if self.path == "/classify":
                return batcher, meta
            name = self.path.removeprefix("/classify/")
            if name != self.path and name in extra_services:
                return extra_services[name]
            return None, None

        def do_POST(self):
            b, m = self._route()
            if b is None:
                self._send(404, {"error": "unknown path"})
                return
            b.handler_started()
            try:
                self._do_post(b, m)
            finally:
                b.handler_finished()

        def _do_post(self, b, m):
            try:  # malformed request (bad JSON / image bytes) -> 400
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
                text = payload.get("text", "")
                image = _decode_image(payload, args.image_root, m.get("native_size"))
                if m["resize_size"] and image is not None and not isinstance(image, np.ndarray):
                    # resize here, in the handler thread (PIL releases the
                    # GIL), not in the one dispatcher thread
                    from ..data.images import resize_to_u8

                    image = resize_to_u8(image, m["resize_size"],
                                         center_crop_from=m["center_crop_from"])
            except Exception as e:
                self._send(400, {"error": repr(e)})
                return
            try:  # server-side prediction failure -> 500, details in logs
                self._send(200, b.submit(text, image))
            except Exception:
                self._send(500, {"error": "internal prediction failure"})

        def log_message(self, fmt, *a):
            logger.info("http: " + fmt, *a)

    class Server(ThreadingHTTPServer):
        # the stdlib accept backlog (5) drops bursty connects
        request_queue_size = 128
        # --workers: every worker binds the same port with SO_REUSEPORT
        allow_reuse_port = bool(getattr(args, "_reuse_port", False))

    return Server((args.host, args.port), Handler)


def _strip_workers_flag(argv):
    out, skip = [], False
    for tok in argv:
        if skip:
            skip = False
            continue
        if tok == "--workers":
            skip = True
            continue
        if tok.startswith("--workers="):
            continue
        out.append(tok)
    return out


def _supervise_workers(args, argv):
    """``--workers N``: start N serving processes that share the port through
    SO_REUSEPORT; this process only supervises (forwards SIGTERM and SIGINT,
    reaps the workers) and returns the worst worker's exit code."""
    import signal
    import subprocess

    if args.port == 0:
        raise SystemExit("--workers>1 requires an explicit --port "
                         "(SO_REUSEPORT workers must share one port)")
    base = list(argv) if argv is not None else sys.argv[1:]
    child_argv = _strip_workers_flag(base) + ["--workers", "1", "--_reuse_port"]
    module = __package__ + ".serve"
    procs = []
    for i in range(args.workers):
        p = subprocess.Popen([sys.executable, "-m", module] + child_argv)
        logger.info("worker %d/%d pid=%d", i + 1, args.workers, p.pid)
        procs.append(p)

    def _forward(signum, frame):
        logger.info("supervisor: forwarding signal %d to %d workers", signum, len(procs))
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    for s in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(s, _forward)
        except ValueError:
            logger.warning("not on the main thread: supervisor signal forwarding disabled")
            break
    rc = 0
    for p in procs:
        try:
            rc = max(rc, abs(p.wait()))
        except KeyboardInterrupt:
            _forward(signal.SIGINT, None)
            rc = max(rc, abs(p.wait()))
    return rc


def main(argv=None):
    import signal

    args = parse_args(argv)
    if args.workers > 1:
        return _supervise_workers(args, argv)
    check_supported(args)
    publish_img_decoder(args)
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

    detector_cache = {}
    predict_batch, meta = build_service(args, detector_cache)
    warm_service(args, predict_batch)
    batcher = MicroBatcher(predict_batch, args.max_batch, args.batch_window_ms)
    extra_services = {}
    for spec in args.extra_model:
        name, margs = parse_model_spec(args, spec)
        if name in extra_services:
            raise SystemExit(f"--extra_model: duplicate name {name!r}")
        logger.info("building extra model %r (%s)", name, spec)
        predict_m, meta_m = build_service(margs, detector_cache)
        warm_service(margs, predict_m)
        extra_services[name] = (MicroBatcher(predict_m, margs.max_batch,
                                             margs.batch_window_ms), meta_m)
    server = make_server(args, batcher, meta, extra_services)
    state["server"] = server
    logger.info("serving %s%s on %s:%d (pid %d, device %s, max_batch=%d, window=%.1fms)",
                meta["model"],
                (" + " + ", ".join(f"/classify/{n}" for n in extra_services)
                 if extra_services else ""),
                args.host, server.server_address[1], os.getpid(), meta["device"],
                args.max_batch, args.batch_window_ms)
    all_batchers = [batcher] + [b for b, _ in extra_services.values()]
    try:
        if not state["stopping"]:
            server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # drain covers whole handlers, so every accepted request is answered
        deadline = time.monotonic() + args.drain_timeout
        for b in all_batchers:
            if not b.drain(timeout=max(0.0, deadline - time.monotonic())):
                logger.warning("drain timeout (%.1fs): exiting with requests "
                               "still in flight", args.drain_timeout)
                break
        for b in all_batchers:
            b.close()
        server.server_close()


if __name__ == "__main__":
    raise SystemExit(main())

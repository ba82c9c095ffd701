"""Export a trained model's serving graph with ``torch.export``.

Counterpart of the JAX package's ``cli/export.py``, which writes a StableHLO
artifact: this writes the ``torch.export`` program of the same fixed-shape
predict that ``cli/serve.py`` runs (weights resolved and held in the
program, the eval cast or the ``--quantize w8`` dequantization applied, the
softmax included), saved with ``torch.export.save``:

    python -m socialmedia_textimage_classification_auxlosses_tpu_torch.cli.export \\
        --task 3 --txt_model_name bernice --img_model_name vit \\
        --fusion_name attention --platforms cuda --check

    # consume it
    import torch
    import socialmedia_textimage_classification_auxlosses_tpu_torch.ops.attention
    import socialmedia_textimage_classification_auxlosses_tpu_torch.ops.attn_block
    program = torch.export.load("...serving.pt2").module()
    probs = program(*tensors)   # in the order and shapes of the .json sidecar

The flags are ``cli.serve``'s (the same artifact name contract); ``--out``
defaults to ``<stem>serving.pt2`` beside the model artifact. ``--platforms``
takes ``cpu`` and ``cuda`` (default: serve's ``--device``), one program
each; with more than one, each file name carries its platform
(``...serving.cuda.pt2``). A ``.json`` sidecar beside each program holds the
JAX package's keys: the input contract (names, shapes, dtypes, the
tokenizer and image preprocessing), the output, the classes.

The inputs are token ids and mask (and token types where the tower has
them) and uint8 pixels (LXMERT: the detector's ROI features and boxes), the
output is the (max_batch, num_labels) probabilities. A ``cuda`` program runs
the hand-written kernels: under ``torch.export`` the attention wrappers
record them as the ``torch.library`` ops ``smtc::sdpa_fwd`` and
``smtc::attn_block_fwd`` (``ops/attention.py``, ``ops/attn_block.py``),
whose CUDA implementations launch the kernels, so the port's ``ops``
modules must be imported before such a program is loaded (the sidecar's
``format`` says so). A ``cpu`` program holds the plain forward and loads
with torch alone.

``--check`` loads the written program and holds it against the live predict
at the JAX package's tolerance (rtol 1e-5, atol 1e-7).

``--export_detector`` (``--model lxmert``) also writes the fused Faster R-CNN
(``models/frcnn.py::FusedDetectProgram``) as one program per canvas
orientation at ``--detector_batch``, as the JAX package does: landscape
``rup(min_size) x rup(max_size)`` and portrait the other way round, rounded
up to the stride divisor, in ``<program>.detector.{landscape,portrait}.pt2``
with a ``.json`` sidecar of the JAX keys (``canvas``, ``inputs``,
``outputs``, ``platforms``). A program takes (batch, Hp, Wp, 3) uint8 RAW RGB
canvases (``preprocess_image``) and (batch, 2) float32 valid sizes and
gives the fused detector's 36-region tensors. Its greedy NMS is the op node
``smtc::nms_keep`` (registered by ``models/frcnn.py``, which is imported
before such a program is loaded, on either platform). As in the JAX package,
``--check`` holds the serving program only; ``tests/test_torch_export.py``
and ``chip_smoke.py`` hold the detector programs against the live detector.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..utils.logging import get_logger
from . import serve as _serve

logger = get_logger(__name__)

PLATFORMS = ("cpu", "cuda")


def parse_args(argv=None):
    """(export flags, serve flags): the export-only flags here, everything
    else is ``cli.serve``'s flag surface."""
    ap = argparse.ArgumentParser(description="export the serving graph with torch.export")
    ap.add_argument("--out", type=str, default=None,
                    help="output path (default: <artifact stem>serving.pt2 in the "
                         "results dir)")
    ap.add_argument("--platforms", type=str, default=None,
                    help="comma-separated devices to export for: cpu, cuda "
                         "(default: serve's --device)")
    ap.add_argument("--check", action="store_true",
                    help="load the written program and hold it against the live "
                         "predict (rtol 1e-5, atol 1e-7)")
    ap.add_argument("--export_detector", action="store_true",
                    help="(--model lxmert) also export the fused FRCNN "
                         "detector program per canvas orientation at "
                         "--detector_batch: raw padded uint8 canvases + "
                         "per-image valid sizes in, 36-region tensors out "
                         "(<out>.detector.{landscape,portrait}.pt2)")
    ap.add_argument("--detector_batch", type=int, default=16,
                    help="fixed batch of the exported detector programs "
                         "(the cacher's dispatch group size)")
    export_args, serve_argv = ap.parse_known_args(argv)
    return export_args, _serve.parse_args(serve_argv)


class ServingProgram(torch.nn.Module):
    """The serving predict as a module: ``forward(*tensors)`` with the batch
    tensors in ``names`` order -> probabilities. The model is a submodule,
    so its parameters and buffers (the int8 weights under w8) are the
    program's state."""

    def __init__(self, model: torch.nn.Module, predict, names):
        super().__init__()
        self.model = model
        self._predict = predict
        self.names = tuple(names)

    def forward(self, *tensors):
        return self._predict(dict(zip(self.names, tensors)))


def _sidecar(args, info, sample, platform):
    lxmert = info.get("detector") is not None
    if platform == "cuda":
        fmt = ("torch.export (.pt2); holds the custom ops smtc::sdpa_fwd and "
               "smtc::attn_block_fwd: import socialmedia_textimage_classification_"
               "auxlosses_tpu_torch.ops.attention and .ops.attn_block before "
               "torch.export.load")
    else:
        fmt = "torch.export (.pt2); loads with torch alone"
    return {
        "format": fmt,
        "platforms": [platform],
        "calling_convention_version": f"torch {torch.__version__}",
        "inputs": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in sample.items()},
        "output": "probabilities (max_batch, num_labels) float32 "
                  "(softmax; sigmoid when multilabel)",
        "num_labels": info["num_labels"],
        "classes": info["classes"],
        "max_batch": args.max_batch,
        "model": args.model,
        "task": args.task,
        "quantize": args.quantize,
        "preprocessing": {
            "text": "framework tokenizer for the configured tower "
                    "(data/tokenizers.py), padded to the shape above",
            "image": ("FRCNN 36-ROI features (models/frcnn.py)" if lxmert else
                      "uint8 RGB square resize to the pixel_values shape "
                      "(data/images.py resize_to_u8); zeros = no image"),
        },
    }


def export_one(args, platform: str):
    """The service of ``args`` built on ``platform`` and exported ->
    (ExportedProgram, sidecar dict, check_fn, info, sample tensors).
    ``check_fn(path)`` loads a saved program and holds it against the live
    predict on the sample batch."""
    import copy

    if platform not in PLATFORMS:
        raise SystemExit(f"--platforms {platform!r}: one of {PLATFORMS}")
    args = copy.copy(args)
    args.device = platform
    info = {}
    _serve.build_service(args, export_info=info)
    host = info["make_batch"]([("torch.export sample", None)])
    sample = {k: torch.from_numpy(np.ascontiguousarray(v)).to(info["device"])
              for k, v in host.items()}
    program = ServingProgram(info["model"], info["predict"], list(sample))
    with torch.no_grad():
        exported = torch.export.export(program, tuple(sample.values()), strict=False)
    sidecar = _sidecar(args, info, {k: v for k, v in host.items()}, platform)

    def check(path):
        loaded = torch.export.load(path).module()
        with torch.no_grad():
            live = program(*sample.values()).float().cpu().numpy()
            back = loaded(*sample.values()).float().cpu().numpy()
        np.testing.assert_allclose(live, back, rtol=1e-5, atol=1e-7)
        return live

    return exported, sidecar, check, info, sample


def export_detector(detector, batch: int, platform: str):
    """The fused detector (``models/frcnn.py::FusedDetectProgram``) exported
    once per canvas orientation, as the JAX package's ``export_detector``:
    landscape ``rup(min_size) x rup(max_size)`` and portrait the other way
    round, rounded up to the stride divisor -> {orientation:
    (ExportedProgram, sidecar)}."""
    from ..models.frcnn import FusedDetectProgram

    cfg = detector.cfg
    short, long = (-(-v // cfg.size_divisibility) * cfg.size_divisibility
                   for v in (cfg.min_size, cfg.max_size))
    program = FusedDetectProgram(detector)
    out = {}
    for orient, (ph, pw) in (("landscape", (short, long)), ("portrait", (long, short))):
        spec = (torch.zeros((batch, ph, pw, 3), dtype=torch.uint8, device=detector.device),
                torch.ones((batch, 2), dtype=torch.float32, device=detector.device))
        with torch.no_grad():
            exported = torch.export.export(program, spec, strict=False)
        out[orient] = (exported, {
            "canvas": [batch, ph, pw, 3],
            "inputs": "canvases uint8 RAW RGB (preprocess_image), "
                      "size_hw float32 (batch, 2) valid resized dims",
            "outputs": "roi_features (batch, 36, feat), normalized_boxes, "
                       "scores, classes, valid counts",
            "platforms": [platform],
        })
    return out


def export_service(args, platforms=None):
    """One export per platform (default: ``args.device``) ->
    {platform: (ExportedProgram, sidecar, check_fn, info, sample)}."""
    return {p: export_one(args, p) for p in (platforms or [args.device])}


def default_out(args) -> str:
    from ..core import config as C
    from ._common import artifact_stem, results_dir_for

    cfg = C.serving_config(args, model_name=args.model)
    base = {"mm_late": C.results_dir_mm_late,
            "mmbt": C.results_dir_mmbt}.get(args.model, C.results_dir_mm_early)
    return (results_dir_for(base, args.testing) + artifact_stem(args, cfg, args.model)
            + "serving.pt2")


def main(argv=None):
    export_args, args = parse_args(argv)
    if export_args.export_detector and args.model != "lxmert":
        raise SystemExit("--export_detector needs --model lxmert")
    platforms = export_args.platforms.split(",") if export_args.platforms else [args.device]
    out = export_args.out or default_out(args)
    stem, ext = os.path.splitext(out)
    for platform, (exported, sidecar, check, info, _) in export_service(args, platforms).items():
        path = out if len(platforms) == 1 else f"{stem}.{platform}{ext or '.pt2'}"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.export.save(exported, path)
        with open(path + ".json", "w") as f:
            json.dump(sidecar, f, indent=1)
        size = os.path.getsize(path)
        logger.info("wrote %s (%.1f MB) + sidecar", path, size / 2 ** 20)
        if export_args.check:
            check(path)
            logger.info("round-trip check passed: the loaded program matches the live "
                        "predict")
        detector_files = []
        if export_args.export_detector:
            dets = export_detector(info["detector"], export_args.detector_batch, platform)
            for orient, (dexported, dmeta) in dets.items():
                dpath = f"{path}.detector.{orient}.pt2"
                torch.export.save(dexported, dpath)
                with open(dpath + ".json", "w") as f:
                    json.dump(dmeta, f, indent=1)
                detector_files.append(dpath)
                logger.info("wrote %s (%.1f MB)", dpath, os.path.getsize(dpath) / 2 ** 20)
        print(json.dumps({"out": path, "bytes": size, "platforms": sidecar["platforms"],
                          "detectors": detector_files, "checked": bool(export_args.check)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

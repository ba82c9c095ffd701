"""Offline feature cacher: ROI features for LXMERT, and the uint8 image
caches.

Counterpart of the JAX package's ``cli/obj_features.py`` (reference
``models/obj_features.py``), its command line and its three modes:

* ``--mode mm``   -> the uint8 image cache for the dual encoders
                     (``<data>/cache/{task}_u8_{size}``, 224 px);
* ``--mode vilt`` -> the uint8 image cache at ViLT's square
                     (``{task}_vilt_u8_{size}``, 384 px);
* ``--mode obj``  -> LXMERT's object features (``{task}_roi``), from
  ``--obj_source``: ``frcnn``, the port's Faster R-CNN
  (``models/frcnn.py``; raw images -> 36 regions of 2,048 features and
  their normalised boxes, weights from ``--frcnn_ckpt`` or
  ``MODEL_DIR_DICT["frcnn"]``, a random detector with a loud warning when
  no file is there); ``dumps``, the reference's per-sample dumps imported
  (``RoiFeatureCache.import_reference_dumps``); ``grid``, a ResNet-50
  trunk's 7 x 7 map as 49 pseudo-regions (``extract_grid_features``: the
  trunk from the torchvision ResNet-50 in ``MODEL_DIR_DICT["resnet50"]``,
  else random with a loud warning; ``tiny`` runs stages (1, 1, 1, 1) at
  64 px, always random; its pixels from a uint8 pixel source when the
  caller gives one, else each image decoded with PIL: an image that does
  not open is zeros, but a missing PIL raises). ``auto`` (default) takes
  the dumps, else the detector.

    python -m socialmedia_textimage_classification_auxlosses_tpu_torch.cli.obj_features \\
        --task 3 --mode obj [--obj_source frcnn] [--frcnn_dtype bfloat16]

The detector runs ``FRCNN_BATCH`` (16) images a round trip; a thread
decodes and resizes the next chunk (``FrcnnDetector.prepare_batch``) while
the card works on the current one. The data key is read with ``csv``
(the id column ``tweet_id``, ``id`` for task 5); ``--testing`` takes its
first 10 ids, ``--shard I:N`` every N-th from the I-th (its own ROI cache
``{task}_roi_shard{I}``; the image caches decode their slice now and the
rest at first use, as in the JAX package). Features go into the cache in
float16. The runs are on the card unless ``--device cpu``.
``--img_decoder native`` decodes the mm/vilt cache builds' square resizes
with the C++ decoder of ``data/native.py`` (PIL where it is unavailable).
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core import config as C
from ..data.cache import ImageCache, RoiFeatureCache
from ..data.images import load_pixels_u8, normalize_on_device, open_image
from ..models import hf_import as H
from ..models.encoder import init_weights
from ..models.resnet import STAGE_SIZES, ResNet
from ..models.vision import IMAGE_NORM
from ..utils.logging import get_logger

logger = get_logger(__name__)


def grid_image_size(tiny: bool, image_size: int = 224) -> int:
    """The extractor's input size: 64 px for ``tiny``."""
    return 64 if tiny else image_size


def extract_grid_features(ids, img_fmt, cache: RoiFeatureCache, tiny: bool = False,
                          batch_size: int = 16, image_size: int = 224,
                          weight_path: str = None, device="cuda", pixel_source=None):
    """ResNet trunk -> (N, grid², 2048) pseudo-ROI features and the grid's
    boxes, written into ``cache``; returns it. ``pixel_source`` (anything
    with ``gather(ids)`` -> (n, S, S, 3) uint8 at ``grid_image_size``)
    replaces decoding ``img_fmt`` (an image that does not open is zeros)."""
    image_size = grid_image_size(tiny, image_size)
    model = ResNet((1, 1, 1, 1) if tiny else STAGE_SIZES["resnet50"], 2)
    init_weights(model, torch.Generator().manual_seed(0))
    if not tiny:  # the tiny stages cannot hold ResNet-50 weights
        if weight_path is None:
            weight_path = C.MODEL_DIR_DICT.get("resnet50", "")
        if H.maybe_import_resnet(model, weight_path, "resnet50"):
            logger.info("grid-feature trunk: imported weights from %s", weight_path)
        else:
            logger.warning(
                "extract_grid_features: no pretrained trunk weights at %r; grid "
                "features will come from a RANDOM-INIT ResNet and are effectively "
                "noise. Provide MODEL_DIR_DICT['resnet50'] (a torchvision resnet50 "
                "state dict) or reference FRCNN dumps for real LXMERT runs.", weight_path)
    model = model.to(device).eval()
    mean, std = IMAGE_NORM["imagenet"]

    ids = [str(i) for i in ids]
    feats_all = []
    with torch.inference_mode():
        for start in range(0, len(ids), batch_size):
            chunk = ids[start:start + batch_size]
            pixels = (pixel_source.gather(chunk) if pixel_source is not None
                      else np.stack([_safe_pixels(img_fmt, i, image_size) for i in chunk]))
            x = normalize_on_device(torch.from_numpy(np.ascontiguousarray(pixels)).to(device),
                                    mean, std, torch.float32)
            _, fmap = model(x, False, return_features=True)
            feats_all.append(fmap.flatten(2).transpose(1, 2).float().cpu().numpy())
            if start % (batch_size * 20) == 0:
                logger.info("grid features %d/%d", start, len(ids))
    feats = np.concatenate(feats_all)
    grid = int(round(feats.shape[1] ** 0.5))
    boxes = np.tile(_grid_boxes(grid)[None], (len(ids), 1, 1))
    cache.num_boxes = grid * grid
    cache.feat_dim = feats.shape[-1]
    cache.write(ids, feats, boxes)
    logger.info("wrote %d grid-feature rows to %s", len(ids), cache.cache_dir)
    return cache


def _safe_pixels(img_fmt, data_id, size):
    try:
        return load_pixels_u8(img_fmt, data_id, size=size)
    except OSError:  # missing or unreadable, as the pixel cache's zero rows
        logger.info("failed id %s", data_id)
        return np.zeros((size, size, 3), np.uint8)


def _grid_boxes(grid: int) -> np.ndarray:
    """The (grid², 4) normalised (x0, y0, x1, y1) boxes of a grid x grid
    split, row-major."""
    xs = np.linspace(0, 1, grid + 1)
    return np.asarray([[xs[c], xs[r], xs[c + 1], xs[r + 1]]
                       for r in range(grid) for c in range(grid)], np.float32)


FRCNN_BATCH = 16  # images a detector round trip


def frcnn_config(tiny: bool = False, dtype: str = "float32", rpn_pre_topk=None,
                 rpn_post_topk=None):
    """The detector's configuration: ``TINY`` or the published one, in
    ``dtype``, with the RPN budgets of ``apply_topk_overrides``."""
    from ..models import frcnn as FR

    cfg = FR.TINY if tiny else FR.FrcnnConfig()
    if dtype != cfg.dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return FR.apply_topk_overrides(cfg, rpn_pre_topk, rpn_post_topk)


def _open_or_zeros(img_fmt, data_id):
    """The image as an RGB array; a missing or unreadable one is the JAX
    package's black 224 x 224 image."""
    try:
        return np.asarray(open_image(img_fmt, data_id))
    except OSError:
        logger.info("missing image for id %s: a black image", data_id)
        return np.zeros((224, 224, 3), np.uint8)


def extract_frcnn_features(ids, img_fmt, cache: RoiFeatureCache, weight_path: str = None,
                           tiny: bool = False, dtype: str = "float32", ingest: str = "pil",
                           rpn_pre_topk: int = None, rpn_post_topk: int = None,
                           device="cuda"):
    """The detector's (N, 36, 2048) ROI features and (N, 36, 4) normalised
    boxes of ``ids`` (reference preprocess_obj, obj_features.py:142-173),
    written into ``cache``; returns it.

    ``dtype="bfloat16"`` runs the trunk and res5 in bfloat16 (the
    throughput option); the RPN's outputs, the box decode, the NMS and the
    pooled features stay float32. Without a checkpoint file at
    ``weight_path`` (default ``MODEL_DIR_DICT["frcnn"]``) the detector is
    random, with a loud warning; a file that is there must load. A batch
    whose detection fails is logged and its rows stay zeros, as in the JAX
    package.

    One thread decodes and resizes the next chunk (``prepare_batch``)
    while the main thread drives the card through this one. The last info
    line gives the detector's set-up, the first batch and the rate of the
    batches after it, and carries them as ``record.frcnn_timing``."""
    from ..models import frcnn as FR

    t_start = time.perf_counter()
    cfg = frcnn_config(tiny, dtype, rpn_pre_topk, rpn_post_topk)
    if weight_path is None:
        weight_path = C.MODEL_DIR_DICT.get("frcnn", "")
    if os.path.isfile(FR.frcnn_checkpoint_file(weight_path)):
        det = FR.load_frcnn(weight_path, cfg, device=device)
    else:
        det = FR.FrcnnDetector(cfg, device=device)
        logger.warning(
            "extract_frcnn_features: no detector weights at %r — ROI "
            "features come from a RANDOM-INIT detector and are effectively "
            "noise. Provide MODEL_DIR_DICT['frcnn'] "
            "(unc-nlp/frcnn-vg-finetuned pytorch_model.bin) for real LXMERT "
            "runs.", weight_path)
    ids = [str(i) for i in ids]
    feats = np.zeros((len(ids), cfg.max_detections, cfg.feat_dim), np.float32)
    boxes = np.zeros((len(ids), cfg.max_detections, 4), np.float32)
    starts = list(range(0, len(ids), FRCNN_BATCH))
    timing = dict(setup_s=time.perf_counter() - t_start, batch_s=[], host_s=[], wait_s=[])

    def prepare(start):
        t = time.perf_counter()
        imgs = [_open_or_zeros(img_fmt, i) for i in ids[start:start + FRCNN_BATCH]]
        return det.prepare_batch(imgs, ingest), time.perf_counter() - t

    with ThreadPoolExecutor(max_workers=1) as pool:
        nxt = pool.submit(prepare, starts[0]) if starts else None
        for k, start in enumerate(starts):
            t0 = time.perf_counter()
            prepared, host_s = nxt.result()
            timing["wait_s"].append(time.perf_counter() - t0)
            timing["host_s"].append(host_s)
            if k + 1 < len(starts):
                nxt = pool.submit(prepare, starts[k + 1])
            try:
                outs = det.detect_prepared_async(prepared)()
            except RuntimeError:  # a failed batch: its rows stay zeros
                logger.exception("failed batch at %d", start)
            else:
                for j, out in enumerate(outs):
                    feats[start + j] = out["roi_features"]
                    boxes[start + j] = out["normalized_boxes"]
            timing["batch_s"].append(time.perf_counter() - t0)
            if k % 16 == 0:
                logger.info("frcnn features %d/%d", start, len(ids))
    cache.num_boxes = cfg.max_detections
    cache.feat_dim = cfg.feat_dim
    cache.write(ids, feats, boxes)
    after = len(ids) - min(len(ids), FRCNN_BATCH)
    rest = sum(timing["batch_s"][1:])
    timing.update(images=len(ids), images_after_first=after,
                  images_per_s_after_first=after / rest if rest else None)
    logger.info("wrote %d detector ROI rows to %s: set-up %.2f s, the first batch %.2f s, "
                "%d images in %.2f s after it (%s images/s); decode and resize %.2f s a "
                "batch in the thread, the card waited %.2f s for it in all",
                len(ids), cache.cache_dir, timing["setup_s"], sum(timing["batch_s"][:1]), after,
                rest, "%.2f" % (after / rest) if rest else "n/a",
                sum(timing["host_s"]) / max(len(starts), 1), sum(timing["wait_s"]),
                extra={"frcnn_timing": timing})
    return cache


def read_ids(task: int) -> list:
    """The ids of the task's data key, in file order (``id`` for task 5,
    else ``tweet_id``), read with ``csv``."""
    column = "id" if task == 5 else "tweet_id"
    with open(C.PATH[task], newline="", encoding="utf-8") as f:
        return [row[column] for row in csv.DictReader(f)]


def build_parser():
    parser = argparse.ArgumentParser(description="offline feature caching")
    parser.add_argument("--task", type=int, choices=[0, 1, 2, 3, 4, 5, 6], required=True)
    parser.add_argument("--mode", type=str, choices=["mm", "vilt", "obj"], default="mm")
    parser.add_argument("--image_size", type=int, default=None)
    parser.add_argument("--obj_source", type=str, default="auto",
                        choices=["auto", "frcnn", "dumps", "grid"],
                        help="object-feature source for --mode obj: the detector (raw "
                             "images), imported reference dumps, or grid pseudo-regions")
    parser.add_argument("--frcnn_ckpt", type=str, default=None,
                        help="unc-nlp/frcnn-vg-finetuned checkpoint (file or dir; default "
                             "MODEL_DIR_DICT['frcnn'])")
    parser.add_argument("--frcnn_arch", type=str, default="full", choices=["full", "tiny"],
                        help="tiny = smoke-test detector geometry")
    parser.add_argument("--frcnn_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="bfloat16 = bf16 trunk and res5 (throughput option; float32 "
                             "is the parity default)")
    parser.add_argument("--rpn_pre_topk", type=int, default=None,
                        help="RPN pre-NMS proposal count (default 6000); lower = less "
                             "sort/NMS work, a recall trade")
    parser.add_argument("--rpn_post_topk", type=int, default=None,
                        help="RPN post-NMS ROI count fed to res5 (default 1000): the "
                             "device-time lever, a recall trade like --rpn_pre_topk")
    parser.add_argument("--frcnn_ingest", type=str, default="pil", choices=["pil", "device"],
                        help="device = ship the ORIGINAL uint8 pixels and resize on the "
                             "device (torch bilinear); pil = the reference's uint8/PIL "
                             "resize (parity default)")
    parser.add_argument("--img_decoder", type=str, default="pil", choices=["pil", "native"],
                        help="image decoder of the mm/vilt cache builds (pil = parity "
                             "default; native = C++ libjpeg/libpng, data/native.py)")
    parser.add_argument("--testing", action="store_true")
    parser.add_argument("--shard", type=str, default=None, metavar="I:N",
                        help="process this 1/N round-robin slice of the ids (one shard per "
                             "host; the ROI cache of a shard is its own)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="where the extractors run; cuda unless cpu is asked for")
    return parser


def main(argv=None):
    from ._common import publish_img_decoder, resolve_device

    parser = build_parser()
    args = parser.parse_args(argv)
    publish_img_decoder(args)
    shard = None
    if args.shard:
        i, n = (int(x) for x in args.shard.split(":"))
        if not 0 <= i < n:
            parser.error(f"--shard {args.shard}: need 0 <= I < N")
        shard = (i, n)
    task_name = C.TASKS[args.task]
    ids = read_ids(args.task)
    if args.testing:
        ids = ids[:10]
    img_fmt = C.IMG_FMT[args.task]

    if args.mode == "obj":
        if shard is not None:
            ids = ids[shard[0]::shard[1]]
            cache_dir = f"{C.DATA_PATH}cache/{task_name}_roi_shard{shard[0]}"
        else:
            cache_dir = f"{C.DATA_PATH}cache/{task_name}_roi"
        cache = RoiFeatureCache(cache_dir)
        src = args.obj_source
        if src in ("auto", "dumps") and cache.import_reference_dumps(C.DATA_PATH, task_name,
                                                                     ids):
            logger.info("imported reference FRCNN dumps")
        elif src == "dumps":
            parser.error("--obj_source dumps: no reference dumps found under "
                         f"{C.DATA_PATH}{task_name}_img_feats/")
        elif src == "grid":
            extract_grid_features(ids, img_fmt, cache, device=resolve_device(args.device))
        else:  # auto (no dumps) or frcnn: the detector
            extract_frcnn_features(ids, img_fmt, cache, weight_path=args.frcnn_ckpt,
                                   tiny=args.frcnn_arch == "tiny", dtype=args.frcnn_dtype,
                                   ingest=args.frcnn_ingest, rpn_pre_topk=args.rpn_pre_topk,
                                   rpn_post_topk=args.rpn_post_topk,
                                   device=resolve_device(args.device))
    else:
        size = args.image_size or (384 if args.mode == "vilt" else 224)
        tag = f"{task_name}_vilt_u8_{size}" if args.mode == "vilt" else f"{task_name}_u8_{size}"
        ImageCache(f"{C.DATA_PATH}cache/{tag}", size=size).build(
            ids, img_fmt, on_missing="zeros", process_shard=shard)
    logger.info("done")


if __name__ == "__main__":
    main()

"""The uint8 pixel cache read under ``--use_saved_features``, and LXMERT's
ROI-feature cache.

Counterparts of ``ImageCache`` and ``RoiFeatureCache`` in the JAX package's
``data/cache.py``, in the same on-disk formats, so either package reads a
cache the other wrote. ``ImageCache``: one ``pixels.npy`` of shape
(N, S, S, 3) uint8 and a ``meta.json`` holding the id -> row index, the size
and a row-validity list. ``RoiFeatureCache``: ``features.npy`` (N, boxes,
feat_dim), ``boxes.npy`` (N, boxes, 4) float32 and a ``meta.json`` holding
``index``, ``num_boxes`` and ``feat_dim``. Reading needs numpy alone;
building an image cache decodes with PIL, imported only then. The JAX
cache's multi-host shards (``build(process_shard=(i, n))``: each host decodes
its round-robin slice, the rest at first ``gather``) are carried.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from ..utils.logging import get_logger
from .images import load_pixels_u8

logger = get_logger(__name__)


class ImageCache:
    """uint8 pixel cache for one (task, image-size) combination."""

    def __init__(self, cache_dir: str, size: int = 224):
        self.cache_dir = cache_dir
        self.size = size
        self.meta_path = os.path.join(cache_dir, "meta.json")
        self.pixels_path = os.path.join(cache_dir, "pixels.npy")
        self.index = {}
        self.valid = None
        self._pixels = None
        self._decode_opts = None  # set by build(): how a row missing at gather is decoded
        if os.path.isfile(self.meta_path):
            with open(self.meta_path) as f:
                meta = json.load(f)
            self.index = {str(k): v for k, v in meta["index"].items()}
            self.size = meta["size"]
            self.valid = np.asarray(meta["valid"], bool)
            self._decode_opts = meta.get("decode_opts")

    def build(self, ids: Sequence, img_fmt: str, center_crop_from: Optional[int] = None,
              on_missing: str = "zeros", process_shard: Optional[tuple] = None):
        """Add the ids not cached yet (decoded with PIL, resized or, with
        ``center_crop_from``, resized and centre-cropped); a cache that holds
        every id is used as it is, whatever recipe built it, as in the JAX
        package (whose cache directory names only the task and the size).
        Splits share one cache directory. An image that does not open stays
        a zero row, or raises with ``on_missing="error"``.

        ``process_shard=(index, count)``: decode only every count-th new id
        (round-robin by position), as one host of a multi-host job; the
        other rows stay invalid and are decoded when ``gather`` first asks
        for them. A sharded build needs a directory of its own: one that
        another shard built is refused (its rows could be zeros on disk
        that this process believes decoded)."""
        os.makedirs(self.cache_dir, exist_ok=True)
        shard_idx, shard_cnt = process_shard if process_shard else (0, 1)
        if shard_cnt > 1:
            self._claim_shard_dir(shard_idx)
        ids = [str(x) for x in ids]
        self._decode_opts = {"img_fmt": img_fmt, "empty_image": None,
                             "center_crop_from": center_crop_from, "on_missing": on_missing}
        if self.index and all(i in self.index for i in ids):
            return self
        old_index = dict(self.index)
        old_pixels = np.array(self.pixels) if old_index else None
        old_valid = self.valid if self.valid is not None else np.zeros(0, bool)
        self._pixels = None
        new_ids = [i for i in ids if i not in old_index]
        all_ids = list(old_index) + new_ids
        pixels = np.lib.format.open_memmap(
            self.pixels_path, mode="w+", dtype=np.uint8,
            shape=(len(all_ids), self.size, self.size, 3))
        valid = np.zeros(len(all_ids), bool)
        if old_pixels is not None:
            pixels[: len(old_index)] = old_pixels
            valid[: len(old_index)] = old_valid[: len(old_index)]
        for k, data_id in enumerate(new_ids):
            if k % shard_cnt != shard_idx:
                continue  # another shard's row, decoded at its first gather here
            row = len(old_index) + k
            valid[row] = self._decode_into(pixels, row, data_id)
        pixels.flush()
        self.index = {data_id: row for row, data_id in enumerate(all_ids)}
        self.valid = valid
        self._write_meta()
        if shard_cnt > 1:  # a builder that appeared meanwhile may have overwritten ours
            self._claim_shard_dir(shard_idx)
        return self

    def _decode_into(self, pixels, row: int, data_id: str) -> bool:
        """Decode one image into ``pixels[row]``; whether it opened. A
        failure raises under ``on_missing="error"``, else leaves the row
        as it is (zeros)."""
        opts = self._decode_opts
        try:
            pixels[row] = load_pixels_u8(opts["img_fmt"], data_id, size=self.size,
                                         center_crop_from=opts.get("center_crop_from"))
            return True
        except OSError:  # missing or unreadable
            if opts.get("on_missing") == "error":
                raise
            logger.info("failed id %s", data_id)
            return False

    def _claim_shard_dir(self, shard_idx: int) -> None:
        """Mark the directory as built by process shard ``shard_idx``;
        refuse one that another shard has built."""
        mine = f".builder_shard{shard_idx}"
        others = sorted(f for f in os.listdir(self.cache_dir)
                        if f.startswith(".builder_shard") and f != mine)
        if others:
            raise RuntimeError(
                f"cache dir {self.cache_dir} was built by process shard(s) {others}; "
                "sharded cache builds require a distinct per-host cache directory (a "
                "shared dir races last-writer-wins on the pixel memmap and can serve "
                "blank images)")
        with open(os.path.join(self.cache_dir, mine), "w") as f:
            f.write(str(os.getpid()))

    def _write_meta(self) -> None:
        with open(self.meta_path, "w") as f:
            json.dump({"index": self.index, "size": self.size, "valid": self.valid.tolist(),
                       "decode_opts": self._decode_opts}, f)

    @property
    def pixels(self):
        if self._pixels is None:
            self._pixels = np.load(self.pixels_path, mmap_mode="r")
        return self._pixels

    def rows(self, ids) -> np.ndarray:
        return np.asarray([self.index[str(i)] for i in ids], np.int64)

    def _fill_missing(self, ids, rows) -> None:
        """Decode the rows another process shard owned, once each, into the
        file (a row whose image does not open becomes a valid zero row)."""
        missing = [(str(i), int(r)) for i, r in zip(ids, rows) if not self.valid[r]]
        if not missing or self._decode_opts is None:
            return
        self._pixels = None
        pixels = np.load(self.pixels_path, mmap_mode="r+")
        for data_id, row in missing:
            self._decode_into(pixels, row, data_id)
            self.valid[row] = True
        pixels.flush()
        self._write_meta()

    def gather(self, ids) -> np.ndarray:
        """(len(ids), S, S, 3) uint8; an id the cache lacks raises KeyError.
        Rows whose decode failed at build time are zeros, as in the JAX
        cache; a row another shard owned is decoded now."""
        rows = self.rows(ids)
        if self.valid is not None and not self.valid[rows].all():
            self._fill_missing(ids, rows)
        return np.asarray(self.pixels[rows])


class RoiFeatureCache:
    """Precomputed object features for LXMERT: per id, ``num_boxes`` region
    features of ``feat_dim`` and their normalised boxes (x0, y0, x1, y1).

    Our own extractors write the features in float16 (half the disk);
    ``import_reference_dumps`` keeps the float32 bits of the reference's
    per-sample dumps. ``gather`` hands back float32 either way."""

    def __init__(self, cache_dir: str, num_boxes: int = 36, feat_dim: int = 2048,
                 feat_dtype=np.float16):
        self.cache_dir = cache_dir
        self.num_boxes = num_boxes
        self.feat_dim = feat_dim
        self.feat_dtype = np.dtype(feat_dtype)
        self.meta_path = os.path.join(cache_dir, "meta.json")
        self.feat_path = os.path.join(cache_dir, "features.npy")
        self.box_path = os.path.join(cache_dir, "boxes.npy")
        self.index = {}
        if os.path.isfile(self.meta_path):
            with open(self.meta_path) as f:
                meta = json.load(f)
            self.index = {str(k): v for k, v in meta["index"].items()}
            self.num_boxes = meta["num_boxes"]
            self.feat_dim = meta["feat_dim"]
        self._feats = None
        self._boxes = None

    def write(self, ids, features: np.ndarray, boxes: np.ndarray) -> None:
        """Replace the cache with ``features`` / ``boxes`` (row i for
        ``ids[i]``)."""
        os.makedirs(self.cache_dir, exist_ok=True)
        np.save(self.feat_path, np.asarray(features).astype(self.feat_dtype))
        np.save(self.box_path, np.asarray(boxes).astype(np.float32))
        self.index = {str(i): row for row, i in enumerate(ids)}
        self._feats = self._boxes = None
        with open(self.meta_path, "w") as f:
            json.dump({"index": self.index, "num_boxes": self.num_boxes,
                       "feat_dim": self.feat_dim}, f)

    @property
    def features(self):
        if self._feats is None:
            self._feats = np.load(self.feat_path, mmap_mode="r")
        return self._feats

    @property
    def boxes(self):
        if self._boxes is None:
            self._boxes = np.load(self.box_path, mmap_mode="r")
        return self._boxes

    def holds(self, ids) -> bool:
        """Whether every id has a row."""
        return bool(self.index) and all(str(i) in self.index for i in ids)

    def gather(self, ids):
        """(features, boxes) of ``ids``, both float32; an id the cache lacks
        raises KeyError."""
        rows = np.asarray([self.index[str(i)] for i in ids], np.int64)
        return (np.asarray(self.features[rows], np.float32),
                np.asarray(self.boxes[rows], np.float32))

    def import_reference_dumps(self, data_path: str, task_name: str, ids) -> bool:
        """Ingest the reference's per-sample torch dumps
        (``{data_path}{task}_img_feats/features/feat_{id}`` and
        ``.../boxes/nbox_{id}``, each a (1, boxes, ...) tensor) when they
        are there, read with ``torch.load(..., weights_only=True)`` and kept
        in their own dtype; ids without both files are left out. Returns
        whether any was found."""
        box_dir = os.path.join(data_path, f"{task_name}_img_feats", "boxes")
        feat_dir = os.path.join(data_path, f"{task_name}_img_feats", "features")
        if not (os.path.isdir(box_dir) and os.path.isdir(feat_dir)):
            return False
        import torch

        feats, boxes, kept = [], [], []
        for data_id in ids:
            fp = os.path.join(feat_dir, f"feat_{data_id}")
            bp = os.path.join(box_dir, f"nbox_{data_id}")
            if not (os.path.isfile(fp) and os.path.isfile(bp)):
                continue
            feats.append(torch.load(fp, map_location="cpu", weights_only=True).squeeze(0).numpy())
            boxes.append(torch.load(bp, map_location="cpu", weights_only=True).squeeze(0).numpy())
            kept.append(data_id)
        if not kept:
            return False
        self.num_boxes, self.feat_dim = feats[0].shape
        self.feat_dtype = np.dtype(feats[0].dtype)
        self.write(kept, np.stack(feats), np.stack(boxes))
        return True

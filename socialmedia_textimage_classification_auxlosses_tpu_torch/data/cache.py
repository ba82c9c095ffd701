"""The uint8 pixel cache read under ``--use_saved_features``.

Counterpart of ``ImageCache`` in the JAX package's ``data/cache.py``, in the
same on-disk format, so either package reads a cache the other built: one
``pixels.npy`` of shape (N, S, S, 3) uint8 and a ``meta.json`` holding the
id -> row index, the size and a row-validity list. Reading needs numpy
alone; building decodes with PIL, imported only then. The multi-host shard
options of the JAX cache are not ported.
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
        if os.path.isfile(self.meta_path):
            with open(self.meta_path) as f:
                meta = json.load(f)
            self.index = {str(k): v for k, v in meta["index"].items()}
            self.size = meta["size"]
            self.valid = np.asarray(meta["valid"], bool)

    def build(self, ids: Sequence, img_fmt: str, center_crop_from: Optional[int] = None):
        """Add the ids not cached yet (decoded with PIL, resized or, with
        ``center_crop_from``, resized and centre-cropped; an image that does
        not open stays a zero row, as in the JAX cache); a cache that holds
        every id is used as it is, whatever recipe built it, as in the JAX
        package (whose cache directory names only the task and the size).
        Splits share one cache directory."""
        ids = [str(x) for x in ids]
        if self.index and all(i in self.index for i in ids):
            return self
        os.makedirs(self.cache_dir, exist_ok=True)
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
            row = len(old_index) + k
            try:
                pixels[row] = load_pixels_u8(img_fmt, data_id, size=self.size,
                                             center_crop_from=center_crop_from)
                valid[row] = True
            except OSError:  # an image that does not open stays a zero row
                logger.info("failed id %s", data_id)
        pixels.flush()
        self.index = {data_id: row for row, data_id in enumerate(all_ids)}
        self.valid = valid
        with open(self.meta_path, "w") as f:
            json.dump({"index": self.index, "size": self.size,
                       "valid": valid.tolist(),
                       "decode_opts": {"img_fmt": img_fmt, "empty_image": None,
                                       "center_crop_from": center_crop_from,
                                       "on_missing": "zeros"}}, f)
        return self

    @property
    def pixels(self):
        if self._pixels is None:
            self._pixels = np.load(self.pixels_path, mmap_mode="r")
        return self._pixels

    def gather(self, ids) -> np.ndarray:
        """(len(ids), S, S, 3) uint8; an id the cache lacks raises KeyError.
        Rows whose decode failed at build time are zeros, as in the JAX
        cache."""
        rows = np.asarray([self.index[str(i)] for i in ids], np.int64)
        return np.asarray(self.pixels[rows])

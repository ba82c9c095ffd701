"""Batch pipeline: fixed-shape batches with a ``valid`` row mask.

Counterpart of the JAX package's ``data/pipeline.py`` (``PipelineConfig``,
``SplitPipeline.batches``, the image sources): text is normalized and
tokenized once per split into padded int32 arrays; images come from the
uint8 cache (``--use_saved_features``) or a memoised lazy decoder, or, for
ViLT under ``--vilt_exact_resize``, from ``ExactViltImageSource``, whose
batches also carry each image's true extent as ``grid_hw``; every batch has
the same shape, the last one padded by repeating its last row and marked in
``valid``. Visit order under ``shuffle`` is
``rng.shuffle(arange(n))`` with the trainer's ``np.random.RandomState``, as
in the JAX package, so both see the same batches in the same order.

``to_device`` is the adapter to torch: every array but the host-side
``data_id`` becomes a tensor on the device (``pin_memory`` +
``non_blocking`` on CUDA). ``stage_chunks`` (``--steps_per_dispatch``: the
pipeline's ``device_iter_chunks`` and the seed sweep's stacked batches)
stacks K batches and stages them on the device in one copy per array.
``EmptyImageSource`` gives every id the one empty image (the MIC text-only
eval, ``--eval_txt_test``). LXMERT's batches carry no pixels
(``PipelineConfig(with_images=False)``) but each id's ROI features and boxes
from a ``RoiFeatureCache`` (``roi_features``, ``roi_boxes``, float32).
Sequence bucketing (``--bucket_seq``) and the
multi-host row slicing are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .cache import ImageCache, RoiFeatureCache
from .images import load_pixels_u8, vilt_canvas
from .prep import SplitArrays


class LazyImageSource:
    """Decode + resize on first touch (PIL), memoised in RAM as uint8."""

    def __init__(self, img_fmt: str, size: int = 224, center_crop_from: Optional[int] = None):
        self.img_fmt = img_fmt
        self.size = size
        self.center_crop_from = center_crop_from
        self._memo: Dict[str, np.ndarray] = {}

    def gather(self, ids) -> np.ndarray:
        out = np.empty((len(ids), self.size, self.size, 3), np.uint8)
        for i, data_id in enumerate(ids):
            key = str(data_id)
            px = self._memo.get(key)
            if px is None:
                try:
                    px = load_pixels_u8(self.img_fmt, data_id, size=self.size,
                                        center_crop_from=self.center_crop_from)
                except OSError:  # an image that does not open is zeros
                    px = np.zeros((self.size, self.size, 3), np.uint8)
                self._memo[key] = px
            out[i] = px
        return out


class ExactViltImageSource:
    """``--vilt_exact_resize``: each image resized as ``ViltImageProcessor``
    does (``images.vilt_exact_resize_u8``) onto the fixed canvas, instead of
    the default square resize. ``gather`` returns ``(frames, grid_hw)``;
    ``returns_grid`` tells the pipeline to put the extents in the batch as
    ``grid_hw``. Each id is decoded once and memoised; an image that does not
    open is a zero frame of extent ``shortest`` x ``shortest``, as in the JAX
    package. A caller may fill ``memo`` itself (id string -> (frame,
    (h, w))), as on a host without PIL."""

    returns_grid = True

    def __init__(self, img_fmt: str, shortest: int = 384):
        self.img_fmt = img_fmt
        self.shortest = shortest
        self.canvas = vilt_canvas(shortest)
        self.memo: Dict[str, tuple] = {}

    def gather(self, ids):
        from .images import open_image, vilt_exact_resize_u8

        frames = np.empty((len(ids), self.canvas, self.canvas, 3), np.uint8)
        grids = np.empty((len(ids), 2), np.int32)
        for i, data_id in enumerate(ids):
            key = str(data_id)
            hit = self.memo.get(key)
            if hit is None:
                try:
                    frame, hw = vilt_exact_resize_u8(open_image(self.img_fmt, data_id),
                                                     self.shortest)
                except OSError:  # an image that does not open
                    frame = np.zeros((self.canvas, self.canvas, 3), np.uint8)
                    hw = (self.shortest, self.shortest)
                hit = (frame, hw)
                self.memo[key] = hit
            frames[i], grids[i] = hit
        return frames, grids


class EmptyImageSource:
    """Every id gets the same image: ``path`` decoded and resized once, or a
    zero frame when it does not open (as the JAX package's lazy source gives
    an image that fails to load)."""

    def __init__(self, path: str, size: int = 224):
        self.path = path
        self.size = size
        self._px: Optional[np.ndarray] = None

    def gather(self, ids) -> np.ndarray:
        if self._px is None:
            from .images import resize_to_u8

            try:
                from PIL import Image

                self._px = resize_to_u8(Image.open(self.path).convert("RGB"), self.size)
            except OSError:
                self._px = np.zeros((self.size, self.size, 3), np.uint8)
        return np.broadcast_to(self._px, (len(ids),) + self._px.shape).copy()


@dataclasses.dataclass
class PipelineConfig:
    batch_size: int
    max_length: int = 128
    image_size: int = 224
    with_images: bool = True


class SplitPipeline:
    """One split's tokenised arrays + image source -> padded batches."""

    def __init__(self, split: SplitArrays, cfg: PipelineConfig, tokenizer=None,
                 image_source=None, roi_cache: Optional[RoiFeatureCache] = None):
        self.cfg = cfg
        self.roi_cache = roi_cache
        self.n = len(split)
        self.labels = np.asarray(split.labels, np.float32)
        self.data_ids = split.ids
        self.ids_num = split.ids_num
        self.image_adds = split.image_adds
        self.image_source = image_source
        if tokenizer is not None:
            enc = tokenizer(list(split.text))
            self.ids, self.mask = enc["ids"], enc["mask"]
            self.token_type_ids = enc.get("token_type_ids")
        else:
            self.ids = self.mask = self.token_type_ids = None

    def __len__(self):
        return self.n

    @property
    def num_batches(self):
        return -(-self.n // self.cfg.batch_size) if self.n else 0

    def batches(self, shuffle=False, rng: Optional[np.random.RandomState] = None,
                skip: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """The padded batches in visit order; ``skip`` leaves out the first
        ``skip`` batches of that order (a run resumed inside an epoch)."""
        if self.n == 0:
            return
        order = np.arange(self.n)
        if shuffle:
            (rng or np.random.RandomState(0)).shuffle(order)
        bs = self.cfg.batch_size
        for start in range(skip * bs, self.n, bs):
            idx = order[start:start + bs]
            pad = bs - len(idx)
            valid = np.ones(bs, np.float32)
            if pad:
                idx = np.concatenate([idx, np.repeat(idx[-1:], pad)])
                valid[bs - pad:] = 0.0
            batch: Dict[str, np.ndarray] = {
                "labels": self.labels[idx],
                "valid": valid,
                "data_id": self.ids_num[idx],
            }
            if self.ids is not None:
                batch["ids"] = self.ids[idx]
                batch["mask"] = self.mask[idx]
                if self.token_type_ids is not None:
                    batch["token_type_ids"] = self.token_type_ids[idx]
            if self.image_source is not None and self.cfg.with_images:
                images = self.image_source.gather([self.data_ids[i] for i in idx])
                if getattr(self.image_source, "returns_grid", False):
                    batch["pixel_values"], batch["grid_hw"] = images
                else:
                    batch["pixel_values"] = images
            if self.roi_cache is not None:
                batch["roi_features"], batch["roi_boxes"] = self.roi_cache.gather(
                    [self.data_ids[i] for i in idx])
            if self.image_adds is not None:
                batch["image_adds"] = np.asarray(self.image_adds, np.int32)[idx]
            yield batch

    def device_iter(self, device, shuffle=False, rng=None, skip: int = 0):
        """``batches`` through ``to_device``."""
        for batch in self.batches(shuffle=shuffle, rng=rng, skip=skip):
            yield to_device(batch, device)

    def device_iter_chunks(self, device, k: int, shuffle=False, rng=None, skip: int = 0):
        """``stage_chunks`` over ``batches``."""
        return stage_chunks(self.batches(shuffle=shuffle, rng=rng, skip=skip), device, k)


def stage_chunks(batches, device, k: int):
    """``(batches, k_real)``: host ``batches`` in chunks of ``k``, each array
    stacked on a new leading axis and staged on the device in one copy
    (``data_id`` stays on the host). The last chunk of an epoch holds only
    its ``k_real < k`` batches: it is not padded (the JAX package pads it and
    skips the padded steps; here the caller runs ``k_real`` steps)."""
    chunk = []
    for batch in batches:
        chunk.append(batch)
        if len(chunk) == k:
            yield _stack_to_device(chunk, device), k
            chunk = []
    if chunk:
        yield _stack_to_device(chunk, device), len(chunk)


def _stack_to_device(chunk, device) -> Dict:
    return to_device({key: np.stack([b[key] for b in chunk]) for key in chunk[0]}, device)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict:
    """Numpy batch -> tensors on ``device``; ``data_id`` stays a host int64
    array (the step never reads it; prediction CSVs need every digit)."""
    device = torch.device(device)
    out = {}
    for key, value in batch.items():
        if key == "data_id":
            out[key] = value
            continue
        t = torch.from_numpy(np.ascontiguousarray(value))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out


def make_image_source(img_fmt: str, ids=None, size: int = 224,
                      center_crop_from: Optional[int] = None,
                      cache_dir: Optional[str] = None, use_cache: bool = False):
    """The uint8 cache under ``cache_dir`` when asked (``--use_saved_features``;
    missing ids are decoded into it), else memoised lazy decoding; either
    with the CNN recipe when ``center_crop_from`` is given."""
    if use_cache and cache_dir and ids is not None:
        return ImageCache(cache_dir, size=size).build(ids, img_fmt, center_crop_from)
    return LazyImageSource(img_fmt, size=size, center_crop_from=center_crop_from)

"""Grid ROI features for LXMERT when no detector features exist.

Counterpart of the grid source of the JAX package's ``cli/obj_features.py``
(``extract_grid_features``, ``_grid_boxes``, ``_safe_pixels``): a ResNet-50
trunk's final feature map as pseudo-regions, 7 x 7 = 49 of 2,048 features at
224 px, each with its grid cell as a normalised box, written into a
``RoiFeatureCache`` (features in float16). The trunk starts from the
torchvision ResNet-50 in ``MODEL_DIR_DICT["resnet50"]`` when that holds one;
without it the features come from a random trunk and a loud warning says so.
``tiny`` runs stages (1, 1, 1, 1) at 64 px (2 x 2 regions) for quick runs,
always random. The trunk runs in float32 on the caller's device. The pixels
come from a uint8 pixel source when the caller gives one (the LXMERT
builder's under ``--use_saved_features``), else each image is decoded with
PIL: an image that is missing or does not open is zeros, as in the JAX
package, but a missing PIL raises.

The detector source (``frcnn``) and the command line with its cache modes
are not ported (``ROADMAP.md`` Queue 1 item 7); the reference's dumps are
read by ``RoiFeatureCache.import_reference_dumps``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config as C
from ..data.cache import RoiFeatureCache
from ..data.images import load_pixels_u8, normalize_on_device
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

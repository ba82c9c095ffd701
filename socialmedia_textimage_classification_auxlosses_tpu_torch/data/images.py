"""Image ingest: decode + resize on the host to uint8, normalize on the device.

Counterpart of the JAX package's ``data/images.py`` (serving part). PIL is
imported only where an image is resized, so the module imports without it.
"""

from __future__ import annotations

import numpy as np
import torch


def resize_to_u8(img, size: int = 224) -> np.ndarray:
    """Bilinear resize of a PIL image to (size, size, 3) uint8, as the JAX
    package does for the square-resize (ViT-family) towers."""
    from PIL import Image

    return np.asarray(img.resize((size, size), Image.BILINEAR), dtype=np.uint8)


def normalize_on_device(pixels_u8: torch.Tensor, mean, std, dtype) -> torch.Tensor:
    """uint8 NHWC -> (x / 255 - mean) / std in ``dtype``, on the device of
    ``pixels_u8``; the arithmetic is float32, as in the JAX package."""
    dev = pixels_u8.device
    mean = torch.tensor(mean, dtype=torch.float32, device=dev).reshape(1, 1, 1, 3)
    std = torch.tensor(std, dtype=torch.float32, device=dev).reshape(1, 1, 1, 3)
    x = pixels_u8.to(torch.float32) / 255.0
    return ((x - mean) / std).to(dtype)

"""Image ingest: decode + resize on the host to uint8, normalize on the device.

Counterpart of the JAX package's ``data/images.py``. PIL is imported only
where an image is decoded or resized, so the module imports without it (the
card's machine has no PIL: training there reads the uint8 pixel cache of
``data/cache.py``). The native C++ decoder (``--img_decoder native``), the
empty-image flow of the text-only MIC eval and the CNN center crop are not
ported.
"""

from __future__ import annotations

import numpy as np
import torch


def open_image(path_fmt: str, data_id):
    """PIL open with the jpg -> png fallback of the JAX package; raises when
    neither file opens."""
    from PIL import Image

    try:
        return Image.open(path_fmt.format(data_id)).convert("RGB")
    except OSError:  # missing or unreadable (PIL's UnidentifiedImageError)
        return Image.open(path_fmt.replace("jpg", "png").format(data_id)).convert("RGB")


def resize_to_u8(img, size: int = 224) -> np.ndarray:
    """Bilinear resize of a PIL image to (size, size, 3) uint8, as the JAX
    package does for the square-resize (ViT-family) towers."""
    from PIL import Image

    return np.asarray(img.resize((size, size), Image.BILINEAR), dtype=np.uint8)


def load_pixels_u8(path_fmt: str, data_id, size: int = 224) -> np.ndarray:
    """Decode and resize one image to (size, size, 3) uint8."""
    return resize_to_u8(open_image(path_fmt, data_id), size=size)


def normalize_on_device(pixels_u8: torch.Tensor, mean, std, dtype) -> torch.Tensor:
    """uint8 NHWC -> (x / 255 - mean) / std in ``dtype``, on the device of
    ``pixels_u8``; the arithmetic is float32, as in the JAX package."""
    dev = pixels_u8.device
    mean = torch.tensor(mean, dtype=torch.float32, device=dev).reshape(1, 1, 1, 3)
    std = torch.tensor(std, dtype=torch.float32, device=dev).reshape(1, 1, 1, 3)
    x = pixels_u8.to(torch.float32) / 255.0
    return ((x - mean) / std).to(dtype)

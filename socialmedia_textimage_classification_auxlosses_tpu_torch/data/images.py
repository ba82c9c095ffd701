"""Image ingest: decode + resize on the host to uint8, normalize on the device.

Counterpart of the JAX package's ``data/images.py``. PIL is imported only
where an image is decoded or resized, so the module imports without it
(training on the card reads the uint8 pixel cache of ``data/cache.py`` and
needs no PIL). The native C++ decoder (``--img_decoder native``), the
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


def vilt_exact_geometry(height: int, width: int, shortest: int = 384,
                        size_divisor: int = 32):
    """The (height, width) ``ViltImageProcessor`` resizes a photo to: the
    shortest edge to ``shortest`` keeping the aspect, the longer edge capped
    at ``int(1333 / 800 * shortest)`` (639), both floored to a multiple of
    ``size_divisor``; so no side exceeds ``vilt_canvas`` (608). An aspect
    ratio that would floor a side to 0 keeps one divisor, as in the JAX
    package."""
    longer = int(1333 / 800 * shortest)
    scale = shortest / min(height, width)
    if height < width:
        nh, nw = float(shortest), scale * width
    else:
        nh, nw = scale * height, float(shortest)
    if max(nh, nw) > longer:
        s2 = longer / max(nh, nw)
        nh, nw = nh * s2, nw * s2
    nh, nw = int(nh + 0.5), int(nw + 0.5)
    nh = max(nh // size_divisor * size_divisor, size_divisor)
    nw = max(nw // size_divisor * size_divisor, size_divisor)
    return nh, nw


def vilt_canvas(shortest: int = 384, size_divisor: int = 32) -> int:
    """The side of the fixed square canvas that holds every
    ``vilt_exact_geometry`` output (608 at 384); the area past an image's
    extent is masked out of attention."""
    longer = int(1333 / 800 * shortest)
    return max(longer // size_divisor * size_divisor, shortest)


def vilt_exact_resize_u8(img, shortest: int = 384, size_divisor: int = 32):
    """Aspect-preserving BICUBIC resize of a PIL image to its
    ``vilt_exact_geometry``, pasted top-left into a zero uint8 canvas.
    Returns ``(frame, (h, w))``: the true extent drives the patch mask and the
    position-grid interpolation of ``models/vilt.py``."""
    from PIL import Image

    w, h = img.size
    nh, nw = vilt_exact_geometry(h, w, shortest, size_divisor)
    canvas = vilt_canvas(shortest, size_divisor)
    frame = np.zeros((canvas, canvas, 3), np.uint8)
    frame[:nh, :nw] = np.asarray(img.resize((nw, nh), Image.BICUBIC), np.uint8)
    return frame, (nh, nw)


def normalize_on_device(pixels_u8: torch.Tensor, mean, std, dtype) -> torch.Tensor:
    """uint8 NHWC -> (x / 255 - mean) / std in ``dtype``, on the device of
    ``pixels_u8``; the arithmetic is float32, as in the JAX package."""
    dev = pixels_u8.device
    mean = torch.tensor(mean, dtype=torch.float32, device=dev).reshape(1, 1, 1, 3)
    std = torch.tensor(std, dtype=torch.float32, device=dev).reshape(1, 1, 1, 3)
    x = pixels_u8.to(torch.float32) / 255.0
    return ((x - mean) / std).to(dtype)

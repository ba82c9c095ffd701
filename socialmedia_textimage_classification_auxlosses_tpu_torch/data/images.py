"""Image ingest: decode + resize on the host to uint8, normalize on the device.

Counterpart of the JAX package's ``data/images.py``. PIL is imported only
where an image is decoded or resized, so the module imports without it
(training on the card reads the uint8 pixel cache of ``data/cache.py`` and
needs no PIL). The CNN paths' recipe (``center_crop_from``: the shorter
side resized to 256, then a centre crop) is carried. ``--img_decoder native``
(published by the entry points as ``SMTC_IMG_DECODER``, as in the JAX
package) sends ``load_pixels_u8``'s square resizes through the C++ decoder of
``data/native.py``; the CNN recipe stays PIL, and a file the decoder cannot
read falls back to PIL.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def native_enabled() -> bool:
    """Whether ``--img_decoder native`` was published (``SMTC_IMG_DECODER``):
    the decoder is opt-in because its DCT-scaled JPEG decode is not
    bit-identical to PIL's full decode and resize."""
    return os.environ.get("SMTC_IMG_DECODER", "pil") == "native"


def open_image(path_fmt: str, data_id):
    """PIL open with the jpg -> png fallback of the JAX package; raises when
    neither file opens."""
    from PIL import Image

    try:
        return Image.open(path_fmt.format(data_id)).convert("RGB")
    except OSError:  # missing or unreadable (PIL's UnidentifiedImageError)
        return Image.open(path_fmt.replace("jpg", "png").format(data_id)).convert("RGB")


def resize_to_u8(img, size: int = 224, center_crop_from: Optional[int] = None) -> np.ndarray:
    """A PIL image as (size, size, 3) uint8: a bilinear resize to the square
    (the ViT-family towers), or with ``center_crop_from`` the torchvision CNN
    recipe of the JAX package, the shorter side resized (bilinear) to
    ``center_crop_from`` keeping the aspect, then the centre
    ``size`` x ``size`` crop."""
    from PIL import Image

    if center_crop_from:
        w, h = img.size
        short = min(w, h)
        nw = int(round(w * center_crop_from / short))
        nh = int(round(h * center_crop_from / short))
        img = img.resize((nw, nh), Image.BILINEAR)
        left, top = (nw - size) // 2, (nh - size) // 2
        img = img.crop((left, top, left + size, top + size))
    else:
        img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def load_pixels_u8(path_fmt: str, data_id, size: int = 224,
                   center_crop_from: Optional[int] = None) -> np.ndarray:
    """Decode and resize (or resize and centre-crop) one image to
    (size, size, 3) uint8. Under ``--img_decoder native`` a square resize
    goes through the C++ decoder, trying the jpg path then the png one, as
    ``open_image`` does; the first file that exists decides, and a decode
    failure there falls back to PIL."""
    if native_enabled() and center_crop_from is None:
        from .native import native_decode_resize

        for path in (path_fmt.format(data_id), path_fmt.replace("jpg", "png").format(data_id)):
            if os.path.isfile(path):
                px = native_decode_resize(path, size)
                if px is not None:
                    return px
                break
    return resize_to_u8(open_image(path_fmt, data_id), size=size,
                        center_crop_from=center_crop_from)


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

    def channels(values):  # made on the device: no host copy for a CUDA graph to refuse
        return torch.stack([torch.full((), float(v), dtype=torch.float32, device=dev)
                            for v in values]).reshape(1, 1, 1, 3)

    mean, std = channels(mean), channels(std)
    x = pixels_u8.to(torch.float32) / 255.0
    return ((x - mean) / std).to(dtype)

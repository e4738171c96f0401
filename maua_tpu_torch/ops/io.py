"""Host-side image IO: PIL <-> NHWC float arrays.

Port of `maua_tpu/ops/io.py` (img2tensor, tensor2img, tensor2imgs,
tensor2bytes, save_image, load_image, load_images, content_hash). Arrays are numpy NHWC float32; `save_image` takes [-1, 1]
and also accepts a torch tensor on any device. PIL is imported inside
the functions that read or write a file.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np


def _pil():
    from PIL import Image

    return Image


def _numpy(tensor) -> np.ndarray:
    if hasattr(tensor, "detach"):
        return tensor.detach().float().cpu().numpy()
    return np.asarray(tensor)


def img2tensor(pil_image, format: str = "RGB") -> np.ndarray:
    """PIL image -> (1, H, W, C) float32 in [0, 1]."""
    arr = np.asarray(pil_image.convert(format), dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr[None]


def tensor2img(tensor, format: str = "RGB"):
    """(1, H, W, C) or (H, W, C) in [0, 1] -> PIL image."""
    arr = _numpy(tensor)
    if arr.ndim == 4:
        arr = arr[0]
    arr = np.round(np.clip(arr, 0, 1) * 255).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    return _pil().fromarray(arr, format if arr.ndim == 3 else "L").convert(format)


def tensor2imgs(tensor, format: str = "RGB") -> List:
    """(B, H, W, C) in [0, 1] -> a PIL image each."""
    return [tensor2img(img, format) for img in _numpy(tensor)]


def tensor2bytes(tensor, value_range: Tuple[float, float] = (0, 1)) -> bytes:
    """(1, H, W, C) or (H, W, C) in value_range -> raw uint8 RGB bytes (a video pipe's frame)."""
    mn, mx = value_range
    arr = _numpy(tensor)
    if arr.ndim == 4:
        arr = arr[0]
    arr = (np.clip(arr, mn, mx) - mn) / (mx - mn)
    return np.round(arr * 255).astype(np.uint8).tobytes()


def save_image(tensor, filename: str):
    """Save a [-1, 1] NHWC image as a file."""
    tensor2img((_numpy(tensor) + 1.0) / 2.0).save(filename)


def load_image(im) -> np.ndarray:
    """Path, PIL image or array -> (1, H, W, C) float32 in [0, 1]."""
    if isinstance(im, (str, Path)):
        return img2tensor(_pil().open(im))
    if hasattr(im, "convert"):  # PIL image
        return img2tensor(im)
    arr = np.asarray(_numpy(im), dtype=np.float32)
    return arr if arr.ndim == 4 else arr[None]


def load_images(*inputs):
    """Each input loaded by `load_image`, None kept, lists and tuples loaded recursively into lists."""
    results = []
    for item in inputs:
        if item is None:
            results.append(None)
        elif isinstance(item, (list, tuple)):
            results.append(load_images(*item))
        else:
            results.append(load_image(item))
    return results


def content_hash(obj) -> str:
    """A cheap rolling hash of an array's contents (its first 1024 bytes, every fourth, of the min-max
    scaled uint8 values) for cache keys; scalars and strings as their text."""
    if isinstance(obj, (float, int, str, bool)):
        return str(obj)
    arr = _numpy(obj)
    arr = arr - arr.min()
    mx = arr.max()
    if mx > 0:
        arr = arr / mx
    byte = (arr * 255).ravel().astype(np.uint8)
    h = 0
    for ch in byte[:1024:4]:
        h = (h * 281 ^ int(ch) * 997) & 0xFFFFFFFF
    return str(hex(h)[2:].upper().zfill(8))

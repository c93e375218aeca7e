"""Training targets (counterpart of ``load_image`` and ``flat_color_target``
in ``sph_nca_tpu/utils/image.py``). PIL is imported only to read an image
file; a ``.npy`` target needs no PIL (the card's machine has none)."""

from __future__ import annotations

import numpy as np


def load_image(path: str, max_size: int = 64,
               alpha_premultiply: bool = True) -> np.ndarray:
    """Load + thumbnail + premultiply -> [H, W, 4] float32 in [0, 1];
    RGB-only inputs get alpha = 1.

    A ``.npy`` file holds the image itself, [H, W, 3 | 4] float32 in
    [0, 1] (straight alpha, as a PNG's): it is padded and premultiplied as
    a PNG is, but never resized; one larger than ``max_size`` is refused.
    """
    if path.endswith(".npy"):
        return _load_npy(path, max_size, alpha_premultiply)
    from PIL import Image

    img = Image.open(path)
    if img.mode == "L":
        img = img.convert("RGB")
    img.thumbnail((max_size, max_size), Image.LANCZOS)
    arr = np.float32(img) / 255.0
    if arr.shape[-1] == 4:
        if alpha_premultiply:
            arr[..., :3] *= arr[..., 3:]
    elif arr.shape[-1] == 3:
        arr = np.pad(
            arr, [(0, 0)] * (arr.ndim - 1) + [(0, 1)], constant_values=1.0
        )
    return arr


def _load_npy(path: str, max_size: int,
              alpha_premultiply: bool) -> np.ndarray:
    arr = np.load(path)
    if arr.ndim != 3 or arr.shape[-1] not in (3, 4):
        raise ValueError(f"{path}: expected [H, W, 3|4], got {arr.shape}")
    if arr.dtype != np.float32:
        raise ValueError(f"{path}: expected float32, got {arr.dtype}")
    if max(arr.shape[:2]) > max_size:
        raise ValueError(f"{path}: {arr.shape[0]}x{arr.shape[1]} is larger "
                         f"than max_size {max_size}; a .npy target is not "
                         "resized")
    if not (np.all(arr >= 0.0) and np.all(arr <= 1.0)):
        raise ValueError(f"{path}: values outside [0, 1]")
    arr = arr.copy()
    if arr.shape[-1] == 4:
        if alpha_premultiply:
            arr[..., :3] *= arr[..., 3:]
    else:
        arr = np.pad(arr, [(0, 0), (0, 0), (0, 1)], constant_values=1.0)
    return arr


def flat_color_target(size: int, rgb=(1.0, 0.5, 0.0)) -> np.ndarray:
    """The no-target fallback of the train CLI: one flat color, alpha 1."""
    img = np.zeros((size, size, 4), np.float32)
    img[..., 0], img[..., 1], img[..., 2] = rgb
    img[..., 3] = 1.0
    return img

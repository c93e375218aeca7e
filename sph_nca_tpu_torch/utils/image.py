"""Training targets (counterpart of ``load_image`` and ``flat_color_target``
in ``sph_nca_tpu/utils/image.py``). PIL is imported only to read a file."""

from __future__ import annotations

import numpy as np


def load_image(path: str, max_size: int = 64,
               alpha_premultiply: bool = True) -> np.ndarray:
    """Load + thumbnail + premultiply -> [H, W, 4] float32 in [0, 1];
    RGB-only inputs get alpha = 1."""
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


def flat_color_target(size: int, rgb=(1.0, 0.5, 0.0)) -> np.ndarray:
    """The no-target fallback of the train CLI: one flat color, alpha 1."""
    img = np.zeros((size, size, 4), np.float32)
    img[..., 0], img[..., 1], img[..., 2] = rgb
    img[..., 3] = 1.0
    return img

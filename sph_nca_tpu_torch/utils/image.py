"""Training targets and frame export (counterpart of
``sph_nca_tpu/utils/image.py``). PIL is imported only to read an image file
(a PNG target, an emoji); a ``.npy`` target needs no PIL, and
``save_frame_png`` writes its PNGs with the standard library (``zlib``,
``struct``), since the card's machine has no PIL.

Emoji targets resolve through a local cache of Noto PNGs,
``$SPH_NCA_EMOJI_CACHE/emoji_u<code points>.png`` (default ``data/emoji``):
nothing is downloaded, and a PNG that is not cached raises.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np

EMOJI_CACHE_ENV = "SPH_NCA_EMOJI_CACHE"
EMOJI_CACHE_DEFAULT = os.path.join("data", "emoji")


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


def emoji_path(emoji: str) -> str:
    """The cached Noto PNG of ``emoji``: emoji_u<code points, 4+ hex digits,
    joined by _>.png under $SPH_NCA_EMOJI_CACHE (read at each call)."""
    code = "_".join(f"{ord(c):04x}" for c in emoji)
    return os.path.join(os.environ.get(EMOJI_CACHE_ENV, EMOJI_CACHE_DEFAULT),
                        f"emoji_u{code}.png")


def load_emoji(emoji: str, max_size: int = 64,
               alpha_premultiply: bool = True) -> np.ndarray:
    """An emoji target from the local cache, loaded as ``load_image`` loads
    a PNG. Raises FileNotFoundError when it is not cached."""
    path = emoji_path(emoji)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"emoji PNG not cached at {path}; nothing is downloaded: place "
            f"Noto PNGs under ${EMOJI_CACHE_ENV} or use --img <file>")
    return load_image(path, max_size, alpha_premultiply)


# PNG color types by channel count: gray, gray + alpha, RGB, RGBA
_PNG_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """An 8-bit image [H, W] or [H, W, C] (C in 1-4) as PNG bytes: one IDAT,
    filter 0 on every row, no interlace."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"expected uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _PNG_COLOR_TYPE:
        raise ValueError(f"expected 1-4 channels, got {c}")
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[c], 0, 0, 0)
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], axis=1)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _png_chunk(b"IEND", b""))


def save_frame_png(path: str, rgba, side: Optional[int] = None) -> None:
    """Save one rollout state as a PNG: rgba [N, C] grid-ordered particles
    (a side x side grid, side = round(sqrt(N)) when not given) or an image
    [H, W, C], values in [0, 1] (clipped, scaled by 255 and truncated to
    8 bits, as the JAX package's)."""
    arr = np.asarray(rgba)
    if arr.ndim == 2:
        if side is None:
            side = int(round(np.sqrt(arr.shape[0])))
        arr = arr.reshape(side, side, arr.shape[-1])
    arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(arr))

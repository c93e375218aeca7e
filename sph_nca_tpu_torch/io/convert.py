"""Carry update-MLP weights from the JAX package across to the port.

The JAX ``MLPParams`` and the port's share one layout ([in, out] weights), so
the four arrays (as numpy, e.g. ``np.asarray(jax_params.w1)``) move over as
they are. Tests use this to feed both packages the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..models.nca import MLPParams


def params_from_jax_numpy(w1, b1, w2, b2, device="cuda") -> MLPParams:
    """numpy w1 [3C, H], b1 [H], w2 [H, out], b2 [out] -> float32
    MLPParams on ``device``."""
    dev = resolve_device(device)
    w1, b1, w2, b2 = (np.asarray(a, np.float32) for a in (w1, b1, w2, b2))
    if (w1.ndim != 2 or w2.ndim != 2 or b1.shape != (w1.shape[1],)
            or w2.shape[0] != w1.shape[1] or b2.shape != (w2.shape[1],)):
        raise ValueError(
            f"inconsistent MLP shapes: w1 {w1.shape}, b1 {b1.shape}, "
            f"w2 {w2.shape}, b2 {b2.shape}"
        )
    return MLPParams(*(torch.tensor(a, device=dev) for a in (w1, b1, w2, b2)))

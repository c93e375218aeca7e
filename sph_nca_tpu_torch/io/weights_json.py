"""Read and write the web-demo JSON weight format.

Counterpart of ``load_weights_json`` and ``save_weights_json`` in
``sph_nca_tpu/io/weights_json.py``.

Format:
  {"layers": [{"index": 0, "weight": [[out x in]], "bias": [out]},
              {"index": 2, ...}],
   "config": {"input_features", "hidden_features", "output_features",
              "fire_rate", "update_rule", "h", "mode"}}

Torch Linear stores weight as [out, in]; MLPParams store [in, out].
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np

from .. import resolve_device
from ..models.nca import MLPParams, SPHNCAConfig
from .convert import params_from_jax_numpy


class ImportedModel(NamedTuple):
    params: MLPParams
    cfg: SPHNCAConfig
    h: float
    mode: str  # 'image' (mse-trained) or 'texture'


def load_weights_json(path: str, device="cuda") -> ImportedModel:
    dev = resolve_device(device)
    with open(path) as f:
        data = json.load(f)

    layers = sorted(data["layers"], key=lambda l: l["index"])
    if len(layers) != 2:
        raise ValueError(f"expected 2 linear layers, got {len(layers)}")
    w1 = np.asarray(layers[0]["weight"], np.float32).T  # [in, hidden]
    b1 = np.asarray(layers[0]["bias"], np.float32)
    w2 = np.asarray(layers[1]["weight"], np.float32).T  # [hidden, out]
    b2 = np.asarray(layers[1]["bias"], np.float32)

    cfg_json = data.get("config", {})
    in_features = int(cfg_json.get("input_features", w1.shape[0]))
    hidden = int(cfg_json.get("hidden_features", w1.shape[1]))
    out_features = int(cfg_json.get("output_features", w2.shape[1]))
    update_rule = cfg_json.get("update_rule", "gated")
    h = float(cfg_json.get("h", 0.08))

    cfg = SPHNCAConfig(
        channels=in_features // 3,
        hidden=hidden,
        fire_rate=float(cfg_json.get("fire_rate", 0.5)),
        update_rule=update_rule,
        smoothing=cfg_json.get("smoothing", "poly6"),
        # the web demo bakes gA * h/h0 into its input prep; shipped weights
        # are h0-normalized
        normalize_perception=1.0 / h,
    )
    if cfg.in_features != in_features or cfg.out_features != out_features:
        raise ValueError(
            f"inconsistent layer shapes for {update_rule}: "
            f"in={in_features}, out={out_features}, channels={cfg.channels}"
        )
    params = params_from_jax_numpy(w1, b1, w2, b2, device=dev)
    return ImportedModel(params=params, cfg=cfg, h=h,
                         mode=cfg_json.get("mode", "image"))


def save_weights_json(path: str, params: MLPParams, cfg: SPHNCAConfig,
                      h: float, mode: str = "image") -> None:
    """Write trained weights in the format ``load_weights_json`` reads."""

    def host(t):
        return t.detach().cpu().numpy()

    data = {
        "layers": [
            {"index": 0, "weight": host(params.w1).T.tolist(),
             "bias": host(params.b1).tolist()},
            {"index": 2,  # torch Sequential index (Linear, ReLU, Linear)
             "weight": host(params.w2).T.tolist(),
             "bias": host(params.b2).tolist()},
        ],
        "config": {
            "input_features": cfg.in_features,
            "hidden_features": cfg.hidden,
            "output_features": cfg.out_features,
            "fire_rate": cfg.fire_rate,
            "update_rule": cfg.update_rule,
            "smoothing": cfg.smoothing,
            "h": h,
            "mode": mode,
        },
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=2)

"""Inference CLI of the port: image-mode rollout on the cell engine.

Counterpart of ``sph_nca_tpu/cli/test.py`` for ``--engine cells`` in image
mode:

    python -m sph_nca_tpu_torch.cli.test \
        --weights_json sph_nca_tpu/demo/web/weights/gecko.json \
        --image_size 128 --steps 128 --output_dir /tmp/sphnca

writes ``<output_dir>/sphnca-test-<time>/states.npz`` (grid positions ``x``
[N, 2] and the trajectory ``states`` [steps+1, N, F] in particle order). Give
an output directory outside the source tree: the trajectory of a 128x128,
128-step run is ~135 MB.

Runs poly6 models only: the cell engine's pair kernels hard-wire the poly6 /
spiky pair math, and the Wendland models of the JAX package run on its band
engine, which is not ported yet.

Not ported yet: the band and graph engines, the 3D surface mode (the JAX CLI
runs it on the band engine; the library entry point
``sph_nca_tpu_torch.models.surface.rollout_mesh_cells`` runs a surface rollout
on the cell engine), the random initial feature, JAX checkpoints, PNG export.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--weights_json", type=str, required=True,
                   help="web-demo JSON weights")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--initial_feature", choices=["radial", "random"],
                   default=None)
    p.add_argument("--initial_feature_radius", type=float, default=-1)
    p.add_argument("--use_alpha", type=str2bool, default=None)
    p.add_argument("--wrap", type=str2bool, default=None)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--surface", type=str, default="")
    p.add_argument("--steps", type=int, default=128)
    p.add_argument("--nca_normalize_perception", type=float, default=-1)
    p.add_argument("--h", type=float, default=0.08)
    p.add_argument("--firerate", type=float, default=0.5)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--use_3d", type=str2bool, default=True)
    p.add_argument("--engine", choices=["band", "cells", "graph"],
                   default="cells")
    p.add_argument("--device", type=str, default="cuda")
    return p


def load_model(args, device):
    from ..io.weights_json import load_weights_json

    m = load_weights_json(args.weights_json, device=device)
    cfg, h = m.cfg, m.h
    # mode-dependent defaults, as the JAX CLI derives them
    if args.use_alpha is None:
        args.use_alpha = m.mode == "image"
    if args.wrap is None:
        args.wrap = m.mode != "image"
    if args.initial_feature is None:
        args.initial_feature = "radial" if m.mode == "image" else "random"
    overrides = {"fire_rate": args.firerate, "use_alpha": args.use_alpha}
    if args.nca_normalize_perception > 0:
        overrides["normalize_perception"] = args.nca_normalize_perception
    cfg = dataclasses.replace(cfg, **overrides)
    if args.h != build_parser().get_default("h"):
        h = args.h  # explicit override for cross-discretization rollouts
    return cfg, m.params, h


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.surface:
        raise SystemExit(
            "the 3D surface mode is not ported yet: the JAX CLI runs it on "
            "the band engine (--engine band), which comes with the band "
            "engine's port; models.surface.rollout_mesh_cells runs a surface "
            "rollout on a cell engine built with pair tables")
    if args.engine != "cells":
        raise SystemExit(f"--engine {args.engine} is not ported yet; "
                         "use --engine cells")
    if args.image_size <= 0:
        raise SystemExit("need --image_size")

    from .. import resolve_device
    from ..models.cell_step import rollout_states_cells
    from ..ops.cells import build_cell_engine
    from ..utils.geometry import grange
    from ..utils.seeds import plane_seed

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params, h = load_model(args, device)
    if args.initial_feature != "radial":
        raise SystemExit("--initial_feature random is not ported yet")
    print(f"model: {cfg}, h={h}", flush=True)

    seed_radius = (
        args.initial_feature_radius if args.initial_feature_radius > 0 else h
    )
    m = args.image_size
    gmin, gsize = (-1.0, -1.0), (2.0, 2.0)
    x2 = grange((m, m), gmin, gsize).reshape(-1, 2)
    x = torch.nn.functional.pad(x2, (0, 1)) if args.use_3d else x2
    period = None
    if args.wrap:
        period = [2.0] * x.shape[1]
    A0 = plane_seed(x2, cfg.channels, gmin=gmin, gsize=gsize,
                    radius=seed_radius).to(device)

    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    t0 = time.time()
    try:
        eng = build_cell_engine(x, h, period=period, smoothing=cfg.smoothing,
                                device=device)
    except NotImplementedError as err:
        raise SystemExit(f"--engine cells: {err}") from err
    print(f"image rollout: n={x.shape[0]}, {args.steps} steps, "
          f"engine C={eng.num_cells} built in {time.time() - t0:.2f}s",
          flush=True)
    t0 = time.time()
    states = rollout_states_cells(params, cfg, eng, A0, gen, args.steps, h,
                                  fire_rate=args.firerate)
    states = states.cpu().numpy()
    print(f"rollout {time.time() - t0:.2f}s", flush=True)

    out_dir = os.path.join(args.output_dir,
                           f"sphnca-test-{time.strftime('%m%d%H%M')}")
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "states.npz"), x=x2.numpy(), states=states)
    print(f"exported {out_dir}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

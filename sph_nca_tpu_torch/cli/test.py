"""Inference CLI of the port: image-mode and 3D-surface rollouts on the band,
cell or graph engine.

Counterpart of ``sph_nca_tpu/cli/test.py`` for ``--engine band`` (the
default), ``--engine cells`` and ``--engine graph``. Image mode:

    python -m sph_nca_tpu_torch.cli.test \
        --weights_json sph_nca_tpu/demo/web/weights/gecko.json \
        --image_size 128 --steps 128 --output_dir /tmp/sphnca

writes ``<output_dir>/sphnca-test-<time>/states.npz`` (grid positions ``x``
[N, 2] and the trajectory ``states`` [steps+1, N, F] in particle order) and
a PNG frame of every ``--export_every``-th state, ``{i:04d}.png`` (RGBA, or
RGB without alpha; written with the standard library: the card's machine
has no PIL). On
the band engine it builds bfloat16 tables and runs the batched rollout
(``models.cell_step.rollout_cells_batched``) at B = 1 with every state kept,
as the JAX CLI does; on the cell engine the recompute kernels
(``rollout_states_cells``); on the graph engine (``ops/hashgrid.py``: fixed-K
neighbour lists built on the device, capacities from the native grid
analyzer) ``models.rollout.rollout_states``, plain PyTorch. 3D surface mode:

    python -m sph_nca_tpu_torch.cli.test \
        --weights_json sph_nca_tpu/demo/web/weights/stripes.json \
        --surface mesh.obj --surface_numpoints 25600 --steps 128 \
        --output_dir /tmp/sphnca

samples the mesh (normalized, 8x oversampled, farthest-point sampled on the
device), seeds it (``--initial_feature radial``: ``--surface_numseed`` radial
seeds; ``random``: a pre-diffused tangent field at radius 0.2 and uniform
features), runs ``models.surface.rollout_mesh_batched_dual`` at B = 1 on an
engine with bfloat16 tables at the model's h (the diffusion on a second
engine at ``DIFFUSE_H`` = 0.1 when h differs; with ``--engine graph``,
``models.surface.rollout_mesh`` on a model graph and a diffusion graph at
``DIFFUSE_H`` / ``DIFFUSE_DIMS``), and writes
``states.npz`` (``x`` [N, 3], ``states``) and one binary PLY point cloud per
``--export_every``-th step. Give an output directory outside the source tree:
a 128x128, 128-step trajectory is ~135 MB.

The model comes from ``--weights_json`` or ``--checkpoint`` (a checkpoint
directory of either package: ``io/checkpoint.py``). Texture-mode models
(``mode: texture`` in the JSON, ``meta.extra.mode`` in a checkpoint) derive ``--wrap`` (a periodic plane
in image mode), no alpha and ``--initial_feature random`` (uniform features
drawn from a ``torch.Generator``: the JAX CLI's law, another stream); image
models derive the opposite. ``--h`` overrides the model's h whenever it is
given (the JAX CLI ignores an explicit ``--h 0.08``, its parser default).

The band and graph engines run every smoothing kernel (the graphs are built
with the model's, where the JAX CLI builds its graphs with poly6, the
kernel of both shipped models); the random seed pre-diffuses its tangents on
a float32 band engine at radius 0.2, as the JAX CLI does, also with
``--engine graph``. ``--engine cells`` runs poly6 models only (the cell
engine's pair kernels hard-wire the poly6 / spiky pair math), with cell
engines in the surface mode too, where the JAX CLI maps both engine names to
band engines. ``--nca_update`` is parsed and ignored, as the JAX CLI does
(the model's update rule comes with its weights).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

# the random surface seed's radial seeds and pre-diffusion radius
# (sph_nca_tpu/cli/test.py:181-203)
SEED_RADIUS_RANDOM = 0.2
PREDIFFUSE_PASSES = 50


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
    p.add_argument("--checkpoint", type=str, default="",
                   help="checkpoint directory (either package's)")
    p.add_argument("--weights_json", type=str, default="",
                   help="web-demo JSON weights")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--initial_feature", choices=["radial", "random"],
                   default=None)
    p.add_argument("--initial_feature_radius", type=float, default=-1)
    p.add_argument("--use_alpha", type=str2bool, default=None)
    p.add_argument("--wrap", type=str2bool, default=None)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--surface", type=str, default="",
                   help="OBJ mesh: run the 3D surface mode")
    p.add_argument("--surface_scale", type=float, default=1.0)
    p.add_argument("--surface_numpoints", type=int, default=25600)
    p.add_argument("--surface_numseed", type=int, default=10)
    p.add_argument("--export_every", type=int, default=1,
                   help="export every n-th step (PNG frames in image mode, "
                        "PLYs in surface mode)")
    p.add_argument("--steps", type=int, default=128)
    p.add_argument("--nca_update", choices=["orig", "gated"],
                   default="gated",
                   help="ignored, as by the JAX CLI: the model's rule is "
                        "its weights'")
    p.add_argument("--nca_normalize_perception", type=float, default=-1)
    p.add_argument("--h", type=float, default=None,
                   help="override the model's h")
    p.add_argument("--firerate", type=float, default=0.5)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--use_3d", type=str2bool, default=True)
    p.add_argument("--engine", choices=["band", "cells", "graph"],
                   default="band")
    p.add_argument("--device", type=str, default="cuda")
    return p


def load_model(args, device):
    """(cfg, params, h) of ``--weights_json`` or ``--checkpoint``; the
    model's mode (the JSON's ``mode``, a checkpoint's ``meta.extra.mode``)
    sets the defaults of --use_alpha, --wrap and --initial_feature."""
    from ..io.checkpoint import load_checkpoint
    from ..io.weights_json import load_weights_json

    if args.weights_json:
        m = load_weights_json(args.weights_json, device=device)
        cfg, params, h, mode = m.cfg, m.params, m.h, m.mode
    elif args.checkpoint:
        ck = load_checkpoint(args.checkpoint, device=device)
        cfg, params, h = ck["model_cfg"], ck["params"], ck["h"]
        mode = ck["meta"].get("extra", {}).get("mode", "image")
    else:
        raise SystemExit("need --checkpoint or --weights_json")
    # mode-dependent defaults, as the JAX CLI derives them
    if args.use_alpha is None:
        args.use_alpha = mode == "image"
    if args.wrap is None:
        args.wrap = mode != "image"
    if args.initial_feature is None:
        args.initial_feature = "radial" if mode == "image" else "random"
    overrides = {"fire_rate": args.firerate, "use_alpha": args.use_alpha}
    if args.nca_normalize_perception > 0:
        overrides["normalize_perception"] = args.nca_normalize_perception
    cfg = dataclasses.replace(cfg, **overrides)
    if args.h is not None:
        h = args.h  # explicit override for cross-discretization rollouts
    return cfg, params, h


def surface_points(path: str, scale: float, numpoints: int,
                   rng: np.random.Generator, device):
    """The surface mode's points and normals (``sph_nca_tpu/cli/test.py:
    154-166``): load and normalize the mesh, area-weighted vertex normals,
    ``numpoints * 8`` area-uniform samples (numpy draws from ``rng``) with
    normals interpolated barycentrically, then ``numpoints`` of them by
    farthest-point sampling on ``device``. Returns (x, normals) [N, 3]
    float32 numpy arrays and the sampling's seconds."""
    from ..utils.meshes import (
        farthest_point_sampling,
        load_obj,
        normalize_mesh,
        sample_surface,
        vertex_normals,
    )

    v, f = load_obj(path)
    v = normalize_mesh(v, scale)
    vn = vertex_normals(v, f)
    pts, fi, w = sample_surface(v, f, numpoints * 8, rng)
    nrm = np.einsum("nc,ncd->nd", w, vn[f[fi]])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    t0 = time.time()
    sel = farthest_point_sampling(torch.from_numpy(pts).to(device),
                                  numpoints).cpu().numpy()
    return pts[sel], nrm[sel], time.time() - t0


def graph_engine(x: torch.Tensor, h: float, dims, period, smoothing):
    """The graph engine of ``--engine graph`` on x's device: capacities from
    the native grid analyzer, then ``build_graph`` (exact lists)."""
    from ..ops.hashgrid import build_graph, suggest_capacity

    mpc, k = suggest_capacity(x, h, dims, period=period)
    return build_graph(x, h, dims, max_per_cell=mpc, k=k, period=period,
                       smoothing=smoothing)


def _describe(eng) -> str:
    """One line of an engine's shape and table bytes."""
    from ..ops.bands import BandEngine
    from ..ops.hashgrid import SPHGraph

    if isinstance(eng, SPHGraph):
        return (f"graph N={eng.n} K={eng.k}, "
                f"{int(eng.valid.sum()) / eng.n:.1f} neighbours a particle, "
                f"{eng.nbytes() / 1e6:.1f} MB")
    if isinstance(eng, BandEngine):
        band_b, far_b = eng.table_bytes()
        widths = ", ".join(str(g.shape[1]) for g in eng.far_groups)
        far = (f"{len(eng.far_tabs)} far buckets of {widths} groups"
               if widths else "no far buckets")
        return (f"blocks={eng.num_cells} P={eng.slots_per_cell}, {far}, "
                f"{str(eng.Tband.dtype).split('.')[-1]} band + far tables "
                f"{band_b / 1e6:.1f} + {far_b / 1e6:.1f} MB")
    nbytes = sum(t.numel() * t.element_size() for t in
                 (eng.blk_md, eng.blk_w6, eng.blk2_md, eng.blk2_w6)
                 if t is not None)
    return (f"C={eng.num_cells}, blocks x W {eng.blk_xs.shape[0]} x "
            f"{eng.blk_xw.shape[2]} + {eng.blk2_xs.shape[0]} x "
            f"{eng.blk2_xw.shape[2]}, {str(eng.blk_w6.dtype).split('.')[-1]} "
            f"{'w6 table' if eng.blk_md is None else 'tables'} "
            f"{nbytes / 1e6:.1f} MB")


def run_surface(args, cfg, params, h, device, gen) -> str:
    """The 3D surface mode; returns the run's output directory."""
    from ..models.nca import to_rgba
    from ..models.surface import (
        DIFFUSE_DIMS,
        DIFFUSE_H,
        rollout_mesh,
        rollout_mesh_batched_dual,
    )
    from ..ops.bands import build_band_engine
    from ..ops.cells import build_cell_engine
    from ..ops.hashgrid import default_dims
    from ..utils.meshes import save_ply
    from ..utils.seeds import surface_radial_seed, surface_random_seed

    seed_radius = (
        args.initial_feature_radius if args.initial_feature_radius > 0 else h
    )
    rng = np.random.default_rng(args.seed)
    x_np, n_np, fps_s = surface_points(args.surface, args.surface_scale,
                                       args.surface_numpoints, rng, device)
    x = torch.from_numpy(x_np).to(device)
    nrm = torch.from_numpy(n_np).to(device)
    print(f"surface: {x.shape[0]} points by farthest-point sampling in "
          f"{fps_s:.2f}s", flush=True)

    def engine(radius, tables, w6_only, smoothing=cfg.smoothing, dims=None):
        """A graph (``dims`` cells per axis) with --engine graph, else a band
        or cell engine with ``tables``."""
        t1 = time.time()
        if dims is not None:
            eng = graph_engine(x, radius, dims, None, smoothing)
        elif args.engine == "cells":
            eng = build_cell_engine(x_np, radius, pair_tables=tables,
                                    w6_only=w6_only, device=device)
        else:
            eng = build_band_engine(x_np, radius, table_dtype=tables,
                                    smoothing=smoothing, device=device)
        print(f"  engine h={radius}: {_describe(eng)}, built in "
              f"{time.time() - t1:.2f}s", flush=True)
        return eng

    # the JAX CLI's engines: bfloat16 tables at the model's h and at
    # DIFFUSE_H (graphs with --engine graph, the diffusion graph on
    # DIFFUSE_DIMS cells), float32 at the seeding radius (a poly6 band
    # engine, as the JAX CLI's, also for --engine graph; cell engines there
    # read only w6)
    graph = args.engine == "graph"
    eng = engine(h, "bfloat16", False,
                 dims=default_dims(h) if graph else None)
    if args.initial_feature == "random":
        A0, t0 = surface_random_seed(
            x, nrm, cfg.channels, rng, gen,
            engine(SEED_RADIUS_RANDOM, "float32", True, "poly6"),
            PREDIFFUSE_PASSES)
    else:
        A0, t0 = surface_radial_seed(x, nrm, cfg.channels,
                                     args.surface_numseed, seed_radius, gen)
    eng_d = (eng if abs(h - DIFFUSE_H) < 1e-9
             else engine(DIFFUSE_H, "bfloat16", True,
                         dims=DIFFUSE_DIMS if graph else None))
    print(f"surface rollout: n={x.shape[0]}, {args.steps} steps"
          + ("" if eng_d is eng else f", diffusion at h={DIFFUSE_H}"),
          flush=True)
    t1 = time.time()
    with torch.no_grad():
        if graph:
            _, _, states = rollout_mesh(
                params, cfg, eng, eng_d, A0, nrm, t0, gen, args.steps, h,
                fire_rate=args.firerate, collect_all=True)
        else:
            _, _, states = rollout_mesh_batched_dual(
                params, cfg, eng, eng_d, A0[None], nrm, t0[None], gen,
                args.steps, h, fire_rate=args.firerate, collect_all=True)
            states = states[:, 0]
        rgba = to_rgba(states[::args.export_every], cfg.use_alpha)
    states = states.cpu().numpy()
    rgba = rgba.cpu().numpy()
    print(f"rollout {time.time() - t1:.2f}s", flush=True)

    out_dir = _out_dir(args)
    np.savez(os.path.join(out_dir, "states.npz"), x=x_np, states=states)
    for k, i in enumerate(range(0, states.shape[0], args.export_every)):
        save_ply(os.path.join(out_dir, f"{i:04d}.ply"), x_np, rgba[k])
    return out_dir


def _out_dir(args) -> str:
    out_dir = os.path.join(args.output_dir,
                           f"sphnca-test-{time.strftime('%m%d%H%M')}")
    os.makedirs(out_dir, exist_ok=True)
    return out_dir


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.export_every <= 0:
        raise SystemExit("--export_every must be positive")
    if not args.surface and args.image_size <= 0:
        raise SystemExit("need --image_size or --surface")

    from .. import resolve_device
    from ..models.cell_step import rollout_cells_batched, rollout_states_cells
    from ..models.nca import to_rgba
    from ..models.rollout import rollout_states
    from ..ops.bands import build_band_engine
    from ..ops.batched import batched_scatter
    from ..ops.cells import build_cell_engine
    from ..ops.hashgrid import default_dims
    from ..utils.geometry import grange
    from ..utils.image import save_frame_png
    from ..utils.seeds import plane_seed

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params, h = load_model(args, device)
    if args.engine == "cells" and cfg.smoothing != "poly6":
        raise SystemExit(f"--engine cells: the cell engine runs poly6 "
                         f"models only, not {cfg.smoothing!r}; use --engine "
                         "band")
    print(f"model: {cfg}, h={h}", flush=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)

    if args.surface:
        out_dir = run_surface(args, cfg, params, h, device, gen)
        print(f"exported {out_dir}", flush=True)
        return 0

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
                    radius=seed_radius,
                    randomized=args.initial_feature == "random",
                    generator=gen).to(device)

    t0 = time.time()
    if args.engine == "band":
        eng = build_band_engine(x, h, period=period, table_dtype="bfloat16",
                                smoothing=cfg.smoothing, device=device)
    elif args.engine == "graph":
        eng = graph_engine(x.to(device), h, default_dims(h), period,
                           cfg.smoothing)
    else:
        eng = build_cell_engine(x, h, period=period, device=device)
    desc = (f"C={eng.num_cells}" if args.engine == "cells"
            else _describe(eng))
    print(f"image rollout: n={x.shape[0]}, {args.steps} steps, "
          f"{args.engine} engine {desc} built in {time.time() - t0:.2f}s",
          flush=True)
    t0 = time.time()
    if args.engine == "band":
        # the JAX CLI's band path: the batched rollout at B = 1, every state
        # kept
        with torch.no_grad():
            _, coll = rollout_cells_batched(
                params, cfg, eng, batched_scatter(eng, A0[None]), 1, gen,
                args.steps, h, fire_rate=args.firerate,
                collect_steps=range(args.steps + 1))
            states = eng.gather_back(coll)
    elif args.engine == "graph":
        with torch.no_grad():
            states = rollout_states(params, cfg, eng, A0, gen, args.steps, h,
                                    fire_rate=args.firerate)
    else:
        states = rollout_states_cells(params, cfg, eng, A0, gen, args.steps,
                                      h, fire_rate=args.firerate)
    with torch.no_grad():
        rgba = to_rgba(states[::args.export_every], cfg.use_alpha)
    if not cfg.use_alpha:
        rgba = rgba[..., :3]
    states = states.cpu().numpy()
    rgba = rgba.cpu().numpy()
    print(f"rollout {time.time() - t0:.2f}s", flush=True)

    out_dir = _out_dir(args)
    np.savez(os.path.join(out_dir, "states.npz"), x=x2.numpy(), states=states)
    for k, i in enumerate(range(0, states.shape[0], args.export_every)):
        save_frame_png(os.path.join(out_dir, f"{i:04d}.png"), rgba[k],
                       side=m)
    print(f"exported {out_dir}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

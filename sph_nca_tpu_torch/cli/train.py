"""Training CLI of the port: plane-mode MSE training on the band or cell
engine.

Counterpart of ``sph_nca_tpu/cli/train.py`` for ``--loss mse_simple`` in
plane mode, with the same flags and defaults:

    python -m sph_nca_tpu_torch.cli.train --training_iter 2000 \
        --output_dir /tmp/sphnca-train

trains on a 128x128 grid padded to 3D (h = 0.08, 16 channels, 256 hidden
units, gated rule, batch 8 from a pool of 1024, rollouts of 32-48 steps after
the progressive warm-up) against ``--img`` or, without one, a flat color. It
logs the loss every ``--log_every`` iterations and writes to ``--output_dir``:

  metrics-<time>.jsonl      one line per iteration: iter, loss, steps (the
                            rollout length) and seconds (its wall time)
  sphnca-<time>-<iters>.json  the trained weights, for ``cli.test``

It runs ``--training_iter`` iterations (the JAX CLI runs one more, to
checkpoint at the last). As the JAX CLI, it builds the band engine with
float32 tables by default (``--engine band``: curve-banded pair tables on the
host, ``ops/bands.py``, any ``--smoothing_kernel``), or with ``--engine
cells`` the cell engine with float32 pair tables (poly6 only); either way the
trainer takes the batched-lane rollout (the band products or the table
kernels, and the fused update-MLP kernel), and keeps the pool on the device
(``DevicePool``) when it is under 4 GB (``--device_pool auto``; 1.07 GB at
the defaults). Not ported yet: the OT and CLIP losses, the graph engine,
surface mode, emoji targets, the random initial feature, checkpoints and
resume.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .test import str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--target", type=str, default="", help="emoji target")
    p.add_argument("--img", type=str, default="", help="image file target")
    p.add_argument("--initial_feature", choices=["radial", "random"],
                   default="radial")
    p.add_argument("--initial_feature_radius", type=float, default=-1)
    p.add_argument("--loss", choices=["mse_simple", "ot", "clip_multiscale"],
                   default="mse_simple")
    p.add_argument("--use_alpha", type=str2bool, default=True)
    p.add_argument("--wrap", type=str2bool, default=False)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--target_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--training_iter", type=int, default=8000)
    p.add_argument("--steps_range", type=str, default="32,48")
    p.add_argument("--steps_increment", type=int, default=5)
    p.add_argument("--loss_weight_overflow", type=float, default=0.05)
    p.add_argument("--nca_update", choices=["orig", "gated"],
                   default="gated")
    p.add_argument("--nca_normalize_grad", type=str2bool, default=True)
    p.add_argument("--nca_normalize_perception", type=float, default=-1)
    p.add_argument("--alpha_premultiply", type=str2bool, default=True)
    p.add_argument("--degrade_prob", type=float, default=0.0)
    p.add_argument("--erase_radius", type=float, default=0.0)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--pool_size", type=int, default=1024)
    p.add_argument("--h", type=float, default=0.08)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--use_3d", type=str2bool, default=True)
    p.add_argument("--channels", type=int, default=16)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--engine", choices=["band", "cells", "graph"],
                   default="band",
                   help="band (curve-banded pair tables) or cells "
                        "(cell-dense, pair-table kernels)")
    p.add_argument("--smoothing_kernel",
                   choices=["poly6", "wendlandC2", "wendlandC4"],
                   default="poly6",
                   help="SPH smoothing kernel; the band engine takes all "
                        "three, cells poly6 only")
    p.add_argument("--device_pool", choices=["auto", "on", "off"],
                   default="auto",
                   help="keep the pool on the device (auto: when under 4 GB)")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.loss != "mse_simple":
        raise SystemExit(f"--loss {args.loss} is not ported yet; use "
                         "--loss mse_simple")
    if args.engine == "graph":
        raise SystemExit("--engine graph is not ported yet; use --engine "
                         "band or cells")
    if args.engine == "cells" and args.smoothing_kernel != "poly6":
        raise SystemExit(
            "--engine cells is poly6-only (the pair kernels hard-wire the "
            f"core); use --engine band for {args.smoothing_kernel}")
    if args.target:
        raise SystemExit("emoji targets (--target) are not ported yet; use "
                         "--img <file>")
    if args.initial_feature != "radial":
        raise SystemExit("--initial_feature random is not ported yet")

    from .. import resolve_device
    from ..io.weights_json import save_weights_json
    from ..models.nca import SPHNCAConfig, num_params
    from ..ops.bands import build_band_engine
    from ..ops.cells import build_cell_engine
    from ..training.losses import MSELossConfig
    from ..training.pool import DevicePool, Pool
    from ..training.trainer import TrainConfig, Trainer, make_mse_bundle
    from ..utils.geometry import grange
    from ..utils.image import flat_color_target, load_image
    from ..utils.seeds import plane_seed

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(args, flush=True)

    h = args.h
    m = args.image_size
    seed_radius = (
        args.initial_feature_radius if args.initial_feature_radius > 0 else h
    )
    norm_perception = (
        args.nca_normalize_perception
        if args.nca_normalize_perception > 0 else 1.0 / h
    )
    steps_range = tuple(int(s) for s in args.steps_range.split(","))

    if args.img:
        img_np = load_image(args.img, args.target_size,
                            args.alpha_premultiply)
    else:
        img_np = flat_color_target(args.target_size)
    img = torch.from_numpy(img_np).to(device)
    print(f"target image: {tuple(img.shape)}", flush=True)

    gmin, gsize = (-1.0, -1.0), (2.0, 2.0)
    x2 = grange((m, m), gmin, gsize).reshape(-1, 2)
    if args.use_3d:
        x = torch.nn.functional.pad(x2, (0, 1))  # z = 0
        period = [gsize[0], gsize[1], 2.0] if args.wrap else None
    else:
        x = x2
        period = list(gsize) if args.wrap else None
    t0 = time.time()
    # float32 tables send the trainer to the batched-lane rollout, as the
    # JAX CLI does on either engine
    if args.engine == "band":
        eng = build_band_engine(x, h, period=period,
                                smoothing=args.smoothing_kernel,
                                table_dtype="float32", device=device)
        band_b, far_b = eng.table_bytes()
        print(f"band engine: n={x.shape[0]} blocks={eng.num_cells} "
              f"P={eng.slots_per_cell} far buckets {len(eng.far_tabs)}, "
              f"float32 tables {band_b / 1e6:.1f} + {far_b / 1e6:.1f} MB "
              f"({time.time() - t0:.2f}s"
              f"{', periodic' if args.wrap else ''})", flush=True)
    else:
        eng = build_cell_engine(x, h, period=period, pair_tables="float32",
                                device=device)
        table_mb = sum(t.numel() * t.element_size() for t in (
            eng.blk_md, eng.blk_w6, eng.blk2_md, eng.blk2_w6)) / 1e6
        print(f"cell engine: n={x.shape[0]} C={eng.num_cells} "
              f"M={eng.slots_per_cell} buckets {eng.blk_xs.shape[0]} + "
              f"{eng.blk2_xs.shape[0]} blocks, float32 pair tables "
              f"{table_mb:.1f} MB ({time.time() - t0:.2f}s"
              f"{', periodic' if args.wrap else ''})", flush=True)

    model_cfg = SPHNCAConfig(
        channels=args.channels,
        hidden=args.hidden,
        fire_rate=0.5,
        update_rule=args.nca_update,
        use_alpha=args.use_alpha,
        normalize_perception=norm_perception,
        smoothing=args.smoothing_kernel,
    )
    loss_cfg = MSELossConfig(
        gmin=gmin, gsize=gsize, image_scale=args.target_size / m,
        overflow_weight=args.loss_weight_overflow, use_alpha=args.use_alpha,
    )
    train_cfg = TrainConfig(
        batch_size=args.batch_size,
        pool_size=args.pool_size,
        training_iter=args.training_iter,
        steps_range=steps_range,
        steps_increment=args.steps_increment,
        lr=args.lr,
        normalize_grads=args.nca_normalize_grad,
        degrade_prob=args.degrade_prob,
        erase_radius=args.erase_radius,
        seed=args.seed,
    )
    trainer = Trainer(model_cfg, train_cfg, eng, x2,
                      make_mse_bundle(img, loss_cfg), h)
    print(f"model params: {num_params(trainer.params)}", flush=True)

    A_seed = plane_seed(x2, args.channels, gmin=gmin, gsize=gsize,
                        radius=seed_radius)
    pool_bytes = args.pool_size * x2.shape[0] * args.channels * 4
    rng = np.random.default_rng(args.seed)
    if args.device_pool == "on" or (args.device_pool == "auto"
                                    and pool_bytes < 4e9):
        pool = DevicePool(x2.numpy(), A_seed.numpy(), args.pool_size,
                          rng=rng, device=device)
    else:
        pool = Pool(x2.numpy(), A_seed.numpy(), args.pool_size, rng=rng)
    print(f"pool: {type(pool).__name__}, {pool_bytes / 1e9:.2f} GB",
          flush=True)

    os.makedirs(args.output_dir, exist_ok=True)
    run_id = time.strftime("%m%d%H%M")
    metrics_path = os.path.join(args.output_dir, f"metrics-{run_id}.jsonl")
    t_start = time.time()
    with open(metrics_path, "w") as metrics:
        for i in range(args.training_iter):
            t1 = time.time()
            loss = trainer.run_iteration(i, pool)
            seconds = time.time() - t1
            metrics.write(json.dumps({"iter": i, "loss": loss,
                                      "steps": trainer.last_steps,
                                      "seconds": seconds}) + "\n")
            if i % args.log_every == 0:
                rate = (i + 1) / (time.time() - t_start)
                print(f"iter {i:6d}  loss {loss:.6f}  steps "
                      f"{trainer.last_steps:3d}  ({rate:.2f} it/s)",
                      flush=True)

    out = os.path.join(args.output_dir,
                       f"sphnca-{run_id}-{args.training_iter:04d}.json")
    save_weights_json(out, trainer.params, model_cfg, h, mode="image")
    print(f"saved weights {out}; done in {time.time() - t_start:.1f}s",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

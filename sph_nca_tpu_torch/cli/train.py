"""Training CLI of the port: plane-mode MSE, exemplar (OT) and text-guided
(CLIP) training on the band, cell or graph engine, with checkpoints and
resume.

Counterpart of ``sph_nca_tpu/cli/train.py``, with the same flags and
defaults (``--device`` in place of ``--platform``):

    python -m sph_nca_tpu_torch.cli.train --training_iter 2000 \
        --output_dir /tmp/sphnca-train

trains on a 128x128 grid padded to 3D (h = 0.08, 16 channels, 256 hidden
units, gated rule, batch 8 from a pool of 1024, rollouts of 32-48 steps after
the progressive warm-up) against ``--img`` (a PNG, or a ``.npy`` image),
``--target`` (an emoji, from the local cache of Noto PNGs under
``$SPH_NCA_EMOJI_CACHE``: ``utils/image.load_emoji``; it needs PIL) or,
without either, a flat color. A texture:

    python -m sph_nca_tpu_torch.cli.train --loss ot --wrap true \
        --use_alpha false --initial_feature random \
        --img sph_nca_tpu_torch/assets/dotted_synth_64.npy --image_size 64 \
        --batch_size 4 --pool_size 128 --steps_range 24,36 \
        --output_dir /tmp/sphnca-texture

takes the OT style loss over ``--texture_features`` (gabor, the default;
vgg with ``--vgg_weights``; vgg_random) against the exemplar resized to the
particle grid. A text prompt:

    python -m sph_nca_tpu_torch.cli.train --loss clip_multiscale \
        --clip_guide "a red and yellow spiral" --image_size 48 \
        --batch_size 4 --pool_size 64 --steps_range 8,12 \
        --output_dir /tmp/sphnca-clip

takes the CLIP loss: the spherical distance between the ViT-B/32 image
tower's features of each sample's views (``--clip_multiscale_scales``: a
downsized copy for a scale above 1, a random crop below it) and the prompt's
text features (``--clip_text_embed``: a ``.npy`` of them; else the text
tower on ``--clip_guide``, tokenized with the BPE merges of ``--clip_bpe``).
``--clip_weights`` is an ``.npz`` of the towers (``convert_open_clip`` /
``convert_open_clip_text``); without it both towers are the JAX package's
fixed-seed random ones, which run the pipeline but are not semantically
CLIP (a warning says so). ``--optimizer`` takes every optimizer of the JAX
trainer, as optax defines it (adam, adamw, sgd, rmsprop, adagrad, lion,
lamb, any case; an unknown name gives Adam: ``training/optim.py``). It logs
the loss every ``--log_every`` iterations and writes to ``--output_dir``:

  metrics-<time>.jsonl        one line per iteration: the JAX CLI's keys
                              (step, t, loss, it_per_sec, rss_gb) and iter,
                              steps (the rollout length) and seconds (its
                              wall time); appended to, so a resumed run
                              continues it
  sphnca-<time>-<step>/       a checkpoint every ``--checkpoint_every``
                              iterations (``io/checkpoint.py``: the JAX
                              package's layout, the optimizer's state as
                              optax's), with the resume sidecar unless
                              ``--save_resume false`` (the previous
                              checkpoint's sidecar is pruned)
  sphnca-<time>-<step>.json   the weights beside each checkpoint, and at the
                              end, for ``cli.test``

``--resume <dir>|auto`` continues from a checkpoint (auto: the latest one in
``--output_dir`` with a sidecar): params, the optimizer's state and
schedule, step, pool and every random stream, so the run goes on exactly as
if it had not stopped. A checkpoint without a sidecar, or with the JAX
package's (a JAX key, which the port cannot continue), resumes softly:
params, optimizer state and step, with a fresh pool and streams.
``--max_rss_gb`` checkpoints and exits with code 42 when the host's
resident memory passes it.

It runs ``--training_iter`` iterations (the JAX CLI runs one more); the
checkpoints fall where the JAX CLI's do. As the JAX CLI, it builds the band
engine with float32 tables by default (``--engine band``: curve-banded pair
tables on the host, ``ops/bands.py``, any ``--smoothing_kernel``), or with
``--engine cells`` the cell engine with float32 pair tables (poly6 only);
either way the trainer takes the batched-lane rollout (the band products or
the table kernels, and the fused update-MLP kernel). ``--engine graph``
builds the fixed-K graph engine on the device (``ops/hashgrid.py``: capacities
from the native grid analyzer, then ``build_graph`` with the smoothing
kernel), which the trainer rolls out in plain PyTorch
(``models.rollout.rollout_batch``). The trainer keeps the pool on
the device (``DevicePool``) when it is under 4 GB (``--device_pool auto``;
1.07 GB at the defaults).
"""

from __future__ import annotations

import argparse
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
    p.add_argument("--img", type=str, default="",
                   help="target image file (.png, or .npy [H, W, 3|4] "
                        "float32 in [0, 1])")
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
    p.add_argument("--loss_weight_color", type=float, default=0.05)
    p.add_argument("--loss_weight_clip", type=float, default=1)
    p.add_argument("--loss_weight_overflow", type=float, default=0.05)
    p.add_argument("--loss_weight_style", type=float, default=1)
    p.add_argument("--clip_guide", type=str, default="",
                   help="the text prompt of --loss clip_multiscale")
    p.add_argument("--clip_multiscale_scales", type=str, default="1",
                   help="comma-separated view scales: > 1 downsizes, < 1 "
                        "crops at random")
    p.add_argument("--nca_update", choices=["orig", "gated"],
                   default="gated")
    p.add_argument("--nca_normalize_grad", type=str2bool, default=True)
    p.add_argument("--nca_normalize_perception", type=float, default=-1)
    p.add_argument("--alpha_premultiply", type=str2bool, default=True)
    p.add_argument("--pretrained_checkpoint", type=str, default="",
                   help="start from this checkpoint's params (step 0)")
    p.add_argument("--optimizer", type=str, default="Adam",
                   help="adam, adamw, sgd, rmsprop, adagrad, lion or lamb "
                        "(any case), as optax defines them; an unknown name "
                        "gives Adam")
    p.add_argument("--degrade_prob", type=float, default=0.0)
    p.add_argument("--erase_radius", type=float, default=0.0)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--pool_size", type=int, default=1024)
    p.add_argument("--h", type=float, default=0.08)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--use_3d", type=str2bool, default=True)
    p.add_argument("--channels", type=int, default=16)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--checkpoint_every", type=int, default=1000)
    p.add_argument("--vgg_weights", type=str, default="",
                   help=".npz of VGG19 conv weights for the OT loss "
                        "(implies --texture_features vgg)")
    p.add_argument("--texture_features",
                   choices=["gabor", "vgg", "vgg_random"], default="gabor",
                   help="OT-loss features: gabor (a fixed multi-scale "
                        "oriented bank), vgg (needs --vgg_weights), "
                        "vgg_random (seeded random filters)")
    p.add_argument("--clip_weights", type=str, default="",
                   help=".npz of the CLIP ViT-B/32 towers (convert_open_clip"
                        " / convert_open_clip_text; one combined file may "
                        "hold both); without it, fixed-seed random towers "
                        "(not semantically CLIP)")
    p.add_argument("--clip_bpe", type=str, default="",
                   help="CLIP's bpe_simple_vocab_16e6.txt.gz, to tokenize "
                        "--clip_guide (without it: a byte hash)")
    p.add_argument("--clip_text_embed", type=str, default="",
                   help=".npy of precomputed unit text features [512] "
                        "(in place of encoding --clip_guide)")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--engine", choices=["band", "cells", "graph"],
                   default="band",
                   help="band (curve-banded pair tables), cells "
                        "(cell-dense, pair-table kernels) or graph (fixed-K "
                        "neighbour lists)")
    p.add_argument("--smoothing_kernel",
                   choices=["poly6", "wendlandC2", "wendlandC4"],
                   default="poly6",
                   help="SPH smoothing kernel; the band and graph "
                        "engines take all three, cells poly6 only")
    p.add_argument("--resume", type=str, default="",
                   help="checkpoint directory to resume from, or 'auto': "
                        "the latest resumable one in --output_dir")
    p.add_argument("--save_resume", type=str2bool, default=True,
                   help="write the resume sidecar (pool and random streams) "
                        "with each checkpoint")
    p.add_argument("--max_rss_gb", type=float, default=0.0,
                   help="if > 0, checkpoint and exit with code 42 when the "
                        "host's resident memory passes this many GB")
    p.add_argument("--device_pool", choices=["auto", "on", "off"],
                   default="auto",
                   help="keep the pool on the device (auto: when under 4 GB)")
    p.add_argument("--device", type=str, default="cuda")
    return p


def _rss_gb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1e6  # kB -> GB
    except OSError:
        pass
    return 0.0


def _build_engine(args, x, h, period, device):
    """The engine as the JAX CLI builds it: on the band and cell engines the
    float32 tables that send the trainer to the batched-lane rollout, or the
    graph engine."""
    from ..ops.bands import build_band_engine
    from ..ops.cells import build_cell_engine
    from ..ops.hashgrid import build_graph, default_dims, suggest_capacity

    t0 = time.time()
    if args.engine == "graph":
        dims = default_dims(h)
        mpc, k = suggest_capacity(x, h, dims, period=period)
        graph = build_graph(x.to(device), h, dims, max_per_cell=mpc, k=k,
                            period=period, smoothing=args.smoothing_kernel)
        nd = int(graph.valid.sum())
        print(f"graph: n={x.shape[0]} k={graph.k} max_per_cell={mpc} "
              f"({time.time() - t0:.1f}s, avg {nd / x.shape[0]:.1f} nbrs"
              f"{', periodic' if args.wrap else ''})", flush=True)
        return graph
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
        return eng
    eng = build_cell_engine(x, h, period=period, pair_tables="float32",
                            device=device)
    table_mb = sum(t.numel() * t.element_size() for t in (
        eng.blk_md, eng.blk_w6, eng.blk2_md, eng.blk2_w6)) / 1e6
    print(f"cell engine: n={x.shape[0]} C={eng.num_cells} "
          f"M={eng.slots_per_cell} buckets {eng.blk_xs.shape[0]} + "
          f"{eng.blk2_xs.shape[0]} blocks, float32 pair tables "
          f"{table_mb:.1f} MB ({time.time() - t0:.2f}s"
          f"{', periodic' if args.wrap else ''})", flush=True)
    return eng


def _clip_bundle(args, m, device):
    """The CLIP loss bundle: the text features of ``--clip_text_embed`` or
    of ``--clip_guide`` (computed once, without a gradient) and the image
    tower."""
    from ..training.clip_encoder import get_clip_encoder
    from ..training.clip_text import get_text_features
    from ..training.losses import CLIPLossConfig
    from ..training.trainer import make_clip_bundle

    if args.clip_text_embed:
        text_features = torch.from_numpy(
            np.load(args.clip_text_embed).astype(np.float32)).to(device)
    else:
        text_features = get_text_features(
            args.clip_guide, weights_path=args.clip_weights or None,
            bpe_path=args.clip_bpe or None, device=device)
        if not (args.clip_weights and args.clip_bpe):
            print(
                "WARNING: encoding --clip_guide with "
                f"{'random weights' if not args.clip_weights else ''}"
                f"{' and ' if not (args.clip_weights or args.clip_bpe) else ''}"
                f"{'fallback tokenizer' if not args.clip_bpe else ''}"
                " — pipeline-correct but not semantically CLIP", flush=True)
    encoder = get_clip_encoder(args.clip_weights or None, device=device)
    clip_cfg = CLIPLossConfig(
        image_size=m,
        scales=tuple(float(s) for s in
                     args.clip_multiscale_scales.split(",")),
        clip_weight=args.loss_weight_clip,
        overflow_weight=args.loss_weight_overflow,
        use_alpha=args.use_alpha)
    return make_clip_bundle(text_features, encoder, clip_cfg)


def _make_loss(args, img, m, gmin, gsize, device):
    """The loss bundle of ``--loss``: the MSE against the target sampled at
    the particles, the OT loss against the exemplar resized to the particle
    grid (bilinear, antialiased when it shrinks, as the JAX CLI's
    ``jax.image.resize``), or the CLIP loss."""
    from ..training.features import get_texture_features, resize_image
    from ..training.losses import MSELossConfig, OTLossConfig
    from ..training.trainer import make_mse_bundle, make_ot_bundle

    if args.loss == "clip_multiscale":
        return _clip_bundle(args, m, device)
    if args.loss == "mse_simple":
        return make_mse_bundle(img, MSELossConfig(
            gmin=gmin, gsize=gsize, image_scale=args.target_size / m,
            overflow_weight=args.loss_weight_overflow,
            use_alpha=args.use_alpha))
    kind = "vgg" if args.vgg_weights else args.texture_features
    feature_fn = get_texture_features(kind, args.vgg_weights or None,
                                      device=device)
    ot_cfg = OTLossConfig(image_size=m, style_weight=args.loss_weight_style,
                          color_weight=args.loss_weight_color,
                          overflow_weight=args.loss_weight_overflow,
                          use_alpha=args.use_alpha)
    return make_ot_bundle(resize_image(img, (m, m)), feature_fn, ot_cfg)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if (args.loss == "clip_multiscale" and not args.clip_text_embed
            and not args.clip_guide):
        raise SystemExit("--loss clip_multiscale needs --clip_guide (a text "
                         "prompt) or --clip_text_embed")
    if args.engine == "cells" and args.smoothing_kernel != "poly6":
        raise SystemExit(
            "--engine cells is poly6-only (the pair kernels hard-wire the "
            f"core); use --engine band for {args.smoothing_kernel}")

    from .. import resolve_device
    from ..io.checkpoint import (
        find_latest_resumable,
        has_resume_state,
        load_checkpoint,
        load_resume_state,
        save_checkpoint,
        save_resume_state,
    )
    from ..io.weights_json import save_weights_json
    from ..models.nca import SPHNCAConfig, num_params
    from ..training.pool import DevicePool, Pool
    from ..training.trainer import TrainConfig, Trainer
    from ..utils.geometry import grange
    from ..utils.image import flat_color_target, load_emoji, load_image
    from ..utils.profiling import MetricsLogger
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
    randomized = args.initial_feature == "random"
    mode = "image" if args.loss == "mse_simple" else "texture"

    if args.target:
        img_np = load_emoji(args.target, args.target_size,
                            args.alpha_premultiply)
    elif args.img:
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
    eng = _build_engine(args, x, h, period, device)

    model_cfg = SPHNCAConfig(
        channels=args.channels,
        hidden=args.hidden,
        fire_rate=0.5,
        update_rule=args.nca_update,
        use_alpha=args.use_alpha,
        normalize_perception=norm_perception,
        smoothing=args.smoothing_kernel,
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
        optimizer=args.optimizer,
        seed=args.seed,
    )
    bundle = _make_loss(args, img, m, gmin, gsize, device)

    resume_path = args.resume
    if resume_path == "auto":
        resume_path = find_latest_resumable(args.output_dir) or ""
        print(f"resume auto -> {resume_path}" if resume_path else
              "resume auto: no resumable checkpoint found, fresh start",
              flush=True)
    params, resume_ck = None, None
    if resume_path:
        resume_ck = load_checkpoint(resume_path, device=device)
        params = resume_ck["params"]
        print(f"resuming from {resume_path} (step {resume_ck['step']})",
              flush=True)
    elif args.pretrained_checkpoint:
        ck = load_checkpoint(args.pretrained_checkpoint, device=device)
        params = ck["params"]
        print(f"loaded pretrained checkpoint (step {ck['step']})",
              flush=True)
    trainer = Trainer(model_cfg, train_cfg, eng, x2, bundle, h,
                      params=params)
    print(f"model params: {num_params(trainer.params)}", flush=True)

    A_seed = plane_seed(x2, args.channels, gmin=gmin, gsize=gsize,
                        radius=seed_radius, randomized=randomized,
                        generator=torch.Generator().manual_seed(args.seed))
    pool_bytes = args.pool_size * x2.shape[0] * args.channels * 4
    rng = np.random.default_rng(args.seed)
    if args.device_pool == "on" or (args.device_pool == "auto"
                                    and pool_bytes < 4e9):
        pool = DevicePool(x2.numpy(), A_seed.numpy(), args.pool_size,
                          randomized_feat=randomized, rng=rng, device=device)
    else:
        pool = Pool(x2.numpy(), A_seed.numpy(), args.pool_size,
                    randomized_feat=randomized, rng=rng)
    print(f"pool: {type(pool).__name__}, {pool_bytes / 1e9:.2f} GB",
          flush=True)

    start_iter = 0
    if resume_ck is not None:
        if "opt_state" in resume_ck:
            trainer.load_opt_state(resume_ck["opt_state"])
        start_iter = int(resume_ck["step"])
        rs = load_resume_state(resume_path) if has_resume_state(
            resume_path) else None
        if rs is None or not rs["port"]:
            why = ("no pool/RNG sidecar (saved with --save_resume false)"
                   if rs is None else "the sidecar is the JAX package's (a "
                   "JAX key, which the port cannot continue)")
            print(f"resume: {why}: soft resume: params, optimizer state and "
                  f"step {start_iter} restored, a fresh pool and random "
                  "streams", flush=True)
            resume_path = ""
        else:
            shape = (args.pool_size, x2.shape[0], args.channels)
            if tuple(rs["pool_A"].shape) != shape:
                raise SystemExit(
                    f"--resume pool shape {rs['pool_A'].shape} does not "
                    f"match the current config {shape}; rerun with the "
                    "original flags")
            if isinstance(pool, DevicePool):
                pool.load_state(rs["pool_A"])
            else:
                pool.A[:] = rs["pool_A"]
            pool.rng.bit_generator.state = rs["pool_rng"]
            trainer.set_rng_state(rs["np_rng"], rs["torch_rng"])

    os.makedirs(args.output_dir, exist_ok=True)
    run_id = time.strftime("%m%d%H%M")
    metrics_path = os.path.join(args.output_dir, f"metrics-{run_id}.jsonl")
    prev_sidecar = [resume_path]

    def save_all(step: int, loss: float) -> str:
        ck_path = os.path.join(args.output_dir,
                               f"sphnca-{run_id}-{step:04d}")
        save_checkpoint(ck_path, params=trainer.params, model_cfg=model_cfg,
                        h=h, step=step, loss=loss,
                        opt_state=trainer.opt_state_tree(),
                        train_cfg=train_cfg, seed_x=x2, seed_A=A_seed,
                        extra_meta={"args": vars(args), "mode": mode})
        save_weights_json(ck_path + ".json", trainer.params, model_cfg, h,
                          mode=mode)
        if args.save_resume:
            rng_state = trainer.rng_state()
            pool_A = (pool.state_np() if isinstance(pool, DevicePool)
                      else pool.A)
            save_resume_state(ck_path, pool_A=pool_A,
                              np_rng_state=rng_state["np_rng"],
                              pool_rng_state=pool.rng.bit_generator.state,
                              torch_rng=rng_state["torch"])
            # the pool is large: keep one sidecar
            prev = prev_sidecar[0]
            if prev and os.path.abspath(prev) != os.path.abspath(ck_path):
                for side in ("resume.npz", "resume_rng.json"):
                    try:
                        os.remove(os.path.join(prev, side))
                    except OSError:
                        pass
            prev_sidecar[0] = ck_path
        print(f"saved checkpoint {ck_path}", flush=True)
        return ck_path

    t_start = time.time()
    last_saved = start_iter if resume_ck is not None else -1
    metrics = MetricsLogger(metrics_path)
    try:
        for i in range(start_iter, args.training_iter):
            t1 = time.time()
            loss = trainer.run_iteration(i, pool)
            seconds = time.time() - t1
            rate = (i + 1 - start_iter) / (time.time() - t_start)
            rss = _rss_gb()
            metrics.log(i, loss=loss, it_per_sec=rate, rss_gb=rss, iter=i,
                        steps=trainer.last_steps, seconds=seconds)
            if i % args.log_every == 0:
                print(f"iter {i:6d}  loss {loss:.6f}  steps "
                      f"{trainer.last_steps:3d}  ({rate:.2f} it/s, rss "
                      f"{rss:.2f} GB)", flush=True)
                if args.max_rss_gb > 0 and rss > args.max_rss_gb:
                    save_all(i + 1, loss)
                    print(f"RSS {rss:.2f} GB > --max_rss_gb "
                          f"{args.max_rss_gb}; checkpointed for --resume "
                          "auto, exiting 42", flush=True)
                    return 42
            if (i + 1) % args.checkpoint_every == 0:
                save_all(i + 1, loss)
                last_saved = i + 1
    finally:
        metrics.close()

    if last_saved != args.training_iter:
        out = os.path.join(args.output_dir,
                           f"sphnca-{run_id}-{args.training_iter:04d}.json")
        save_weights_json(out, trainer.params, model_cfg, h, mode=mode)
        print(f"saved weights {out}", flush=True)
    print(f"done in {time.time() - t_start:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Evaluation CLI of the port: the PSNR / SSIM density study and the texture
statistics (counterpart of ``sph_nca_tpu/cli/eval.py``).

    python -m sph_nca_tpu_torch.cli.eval \
        --checkpoint sph_nca_tpu_torch/assets/gecko_full_8000 \
        --img sph_nca_tpu_torch/assets/face_target_64.npy --steps 160

rolls one model out at 0.5x..4x particle densities (regular grids, or
jittered with ``--jitter``) and prints PSNR / SSIM against the target;
``--texture true`` rolls out wrapped random states at densities >= 1, with
and without jitter, and prints spectrum / colour L1 against the exemplar
beside the calibration baselines. ``--out`` writes the results as JSON.

The training geometry comes from the checkpoint's ``meta.extra.args`` (1x
density = the trained image_size, the trained target_size and seed radius,
use_3d); ``--img`` overrides the recorded target path (the recorded paths
point into directories a checkout may lack). A weights JSON carries no
geometry: give ``--img``, ``--base_size`` and ``--target_size``.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from .test import str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--checkpoint", type=str, default="")
    p.add_argument("--weights_json", type=str, default="")
    p.add_argument("--img", type=str, default="",
                   help="target image (.png or .npy); defaults to the one "
                        "recorded in the checkpoint")
    p.add_argument("--base_size", type=int, default=0,
                   help="particle grid side at 1x density; 0 = the "
                        "training image_size")
    p.add_argument("--target_size", type=int, default=0,
                   help="target resolution; 0 = the training target_size")
    p.add_argument("--seed_radius", type=float, default=0.0,
                   help="radial seed radius; 0 = the training value")
    p.add_argument("--densities", type=str, default="0.5,1,2,4")
    p.add_argument("--steps", type=int, default=96)
    p.add_argument("--jitter", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--texture", type=str2bool, default=False,
                   help="score stationary statistics of wrapped random-state "
                        "rollouts against the exemplar (OT-trained models)")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .. import resolve_device
    from ..eval import density_sweep, texture_eval
    from ..io.checkpoint import load_checkpoint
    from ..io.weights_json import load_weights_json
    from ..utils.image import load_image

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train_args = {}
    if args.weights_json:
        m = load_weights_json(args.weights_json, device=device)
        params, cfg, h = m.params, m.cfg, m.h
    elif args.checkpoint:
        ck = load_checkpoint(args.checkpoint, device=device)
        params, cfg, h = ck["params"], ck["model_cfg"], ck["h"]
        train_args = ck["meta"].get("extra", {}).get("args", {})
    else:
        raise SystemExit("need --checkpoint or --weights_json")

    # the training geometry by default: 1x density = the trained particle
    # spacing, the target in the domain's centre, the trained seed radius
    base_size = args.base_size or int(train_args.get("image_size", 64))
    target_size = args.target_size or int(train_args.get("target_size", 64))
    seed_radius = args.seed_radius or float(
        train_args.get("initial_feature_radius", 0.0)) or None
    image_scale = target_size / base_size
    img_path = args.img or train_args.get("img", "")
    if not img_path:
        raise SystemExit("need --img (the checkpoint records no target)")
    premultiply = bool(train_args.get("alpha_premultiply", True))
    target = load_image(img_path, max_size=target_size,
                        alpha_premultiply=premultiply)
    densities = tuple(float(s) for s in args.densities.split(","))

    if args.texture:
        res = texture_eval(
            params, cfg, h, target[..., :3], base_size=base_size,
            steps=args.steps,
            densities=tuple(d for d in densities if d >= 1.0) or (1.0,),
            jitters=(0.0, args.jitter) if args.jitter else (0.0, 0.5),
            seed=args.seed, use_3d=bool(train_args.get("use_3d", True)),
            device=device)
        print(f"baselines: self spectrum_l1="
              f"{res['baseline_self']['spectrum_l1']:.4f} color_l1="
              f"{res['baseline_self']['color_l1']:.4f} | blur4x "
              f"spectrum_l1={res['baseline_blur4x']['spectrum_l1']:.4f} "
              f"color_l1={res['baseline_blur4x']['color_l1']:.4f} | gray "
              f"spectrum_l1={res['baseline_gray']['spectrum_l1']:.4f} "
              f"color_l1={res['baseline_gray']['color_l1']:.4f}",
              flush=True)
        print(f"{'density':>8} {'jitter':>7} {'spec_l1':>9} {'color_l1':>9}")
        for r in res["sweep"]:
            print(f"{r['density']:8.2f} {r['jitter']:7.2f} "
                  f"{r['spectrum_l1']:9.4f} {r['color_l1']:9.4f}")
        _write(args.out, res)
        return 0

    print(f"protocol: base_size={base_size} target_size={target_size} "
          f"image_scale={image_scale:.3f} seed_radius={seed_radius} "
          f"steps={args.steps} img={img_path}", flush=True)
    results = density_sweep(
        params, cfg, h, target, base_size=base_size, densities=densities,
        steps=args.steps, jitter=args.jitter, seed=args.seed,
        image_scale=image_scale, seed_radius=seed_radius, device=device)
    print(f"{'density':>8} {'particles':>10} {'PSNR dB':>9} {'SSIM':>7}")
    for r in results:
        print(f"{r['density']:8.2f} {r['n_particles']:10d} "
              f"{r['psnr']:9.2f} {r['ssim']:7.3f}")
    _write(args.out, results)
    return 0


def _write(path: str, res) -> None:
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(res, f, indent=2)
        print(f"wrote {path}")


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit. The main path is the cell-engine gecko rollout (16 channels, 256
hidden units, h = 0.1) on a 128x128 grid for 128 steps, as
``python -m sph_nca_tpu_torch.cli.test`` runs it. Phases, each printing one
line with its wall time:

  1 device   the card's name and power limit; TF32 off
  2 build    the nvcc build of sph_nca_tpu_torch/csrc/*.cu for sm_90a
  3 kernels  each CUDA kernel against its plain PyTorch version on the card,
             at the gecko 128x128 bucket shapes, both buckets, use_alpha on
             and off
  4 rollout  the CLI's 128-step rollout through the kernels, with every
             launch counter read around it; then 16 steps at fire_rate 1.0
             with the kernels and with the plain versions
  5 times    each kernel with CUDA events beside its plain version and its
             bound; ms per rollout step
Then one JSON line describing the kernels, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that
line. Without a card it exits non-zero and prints no result.

``python3 chip_smoke.py --profile`` adds one phase before those lines: a
torch.profiler trace of 16 rollout steps, with device time by kernel.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from sph_nca_tpu_torch.cli import test as cli_test
from sph_nca_tpu_torch.io.weights_json import load_weights_json
from sph_nca_tpu_torch.models.cell_step import rollout_cells
from sph_nca_tpu_torch.ops import _build
from sph_nca_tpu_torch.ops import pair_kernel as PK
from sph_nca_tpu_torch.ops.cells import build_cell_engine
from sph_nca_tpu_torch.utils.geometry import grange
from sph_nca_tpu_torch.utils.seeds import plane_seed

ROOT = os.path.dirname(os.path.abspath(__file__))
GECKO = os.path.join(ROOT, "sph_nca_tpu", "demo", "web", "weights",
                     "gecko.json")
IMAGE, STEPS = 128, 128
CHECK_STEPS = 16
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth. Both assume the full 700 W power limit.
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# Kernel vs plain tolerance: both are float32, summing the window in other
# orders (the kernel in 4 interleaved partial sums, the plain version in
# matmul order), and rsqrtf may differ from torch.rsqrt by an ulp or two.
# gA is a difference of two sums of size |A| sum|Tg r|, so its error is held
# relative to the largest |gA|; the blurs sum positive terms.
GA_RTOL = 1e-5  # of max |gA|
SM_RTOL = 1e-5  # of max |sm|
# 16 steps at fire_rate 1.0 through kernels vs plain versions: the states
# (|A| <~ 1) may drift apart by the per-step rounding differences above.
ROLLOUT_ATOL = 1e-4

# operations per pair (D = 3, F = 16): every pair needs its d2 (3 sub, 3 mul,
# 2 add) and the support test; a pair inside the support also needs the
# spiky magnitude (rsqrt + 4), Tg (2), Tw (5), the mask sum (2) and the
# D * (2 + 2F) gradient products; the mask pass needs Tw (5) and its sum (2).
OPS_EVERY_PAIR = 9
OPS_FWD_IN_SUPPORT = 5 + 2 + 5 + 2 + 3 * (2 + 2 * 16)
OPS_MASK_IN_SUPPORT = 5 + 2


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase(name: str, t0: float, text: str) -> None:
    print(f"[{name}] {time.time() - t0:.2f}s {text}", flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of fn() over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bucket_args(eng, S, bucket):
    nb1 = eng.blk_xs.shape[0]
    p, f = eng.blk_xs.shape[2], S.shape[-1]
    rows = S.reshape(-1, p, f)
    if bucket == 1:
        return (eng.blk_xs, rows[:nb1], eng.blk_xw, eng.blk_vw,
                eng.blk_win_cells)
    return (eng.blk2_xs, rows[nb1:], eng.blk2_xw, eng.blk2_vw,
            eng.blk2_win_cells)


def real_rows(eng, bucket):
    nb1 = eng.blk_xs.shape[0]
    real = (eng.vs > 0).reshape(-1, eng.blk_xs.shape[2])
    return real[:nb1] if bucket == 1 else real[nb1:]


def rel_err(got, want, real):
    """(max abs error, max abs error / max |want|) over real rows."""
    err = float((got - want).abs()[real].max())
    scale = float(want.abs()[real].max())
    return err, err / max(scale, 1e-30)


def work(eng, S):
    """Bytes and operations one step's launches of each kernel need (both
    buckets), counted from this run's engine: each input read once, each
    output written once, operations per pair as above."""
    c, m, f = S.shape
    n_all = n_in = 0
    geo = 0
    for xs_b, xw_b, vw_b, wc in ((eng.blk_xs, eng.blk_xw, eng.blk_vw,
                                  eng.blk_win_cells),
                                 (eng.blk2_xs, eng.blk2_xw, eng.blk2_vw,
                                  eng.blk2_win_cells)):
        _, d2 = PK._pair_d2(xs_b, xw_b)
        n_all += d2.numel()
        n_in += int(((d2 < eng.h * eng.h) & (vw_b[:, None, :] > 0)).sum())
        geo += 4 * (xs_b.numel() + xw_b.numel() + vw_b.numel() + wc.numel())
    n_rows = c * m
    d = eng.xs.shape[-1]
    fwd_bytes = geo + 4 * (S.numel() + n_rows * d * f + n_rows)
    mask_bytes = geo + 4 * (n_rows + n_rows)  # alpha channel in, sm out
    fwd_ops = n_all * OPS_EVERY_PAIR + n_in * OPS_FWD_IN_SUPPORT
    mask_ops = n_all * OPS_EVERY_PAIR + n_in * OPS_MASK_IN_SUPPORT
    return {"pairs": n_all, "pairs_in_support": n_in,
            "sph_fwd_kernel": (fwd_bytes, fwd_ops),
            "sph_mask_kernel": (mask_bytes, mask_ops)}


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_steps(model, eng, S0, h, steps: int = 16) -> None:
    """Device time per rollout step by kernel name, and the device's busy
    share of the traced wall time (the profiler's own overhead included)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=eng.device).manual_seed(SEED)
    rollout_cells(model.params, model.cfg, eng, S0, gen, 4, h)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.time()
        rollout_cells(model.params, model.cfg, eng, S0, gen, steps, h)
        torch.cuda.synchronize()
        wall_us = (time.time() - t1) * 1e6
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and ev.device_type != torch.autograd.DeviceType.CPU:
            rows.append((dev_us, ev.count, ev.key))
    total = sum(r[0] for r in rows)
    if not rows:
        print("  profile: no device time recorded", flush=True)
        return
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {dev_us / steps:9.2f} us/step {100 * dev_us / total:5.1f}% "
              f"{count / steps:5.1f} launches/step  {key[:70]}", flush=True)
    print(f"  device busy {total / steps:.2f} us/step of {wall_us / steps:.2f}"
          f" us/step traced wall ({100 * total / wall_us:.1f}% busy), "
          f"{sum(r[1] for r in rows) / steps:.1f} kernels/step", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    # ---- 1 device -------------------------------------------------------
    t0 = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    phase("device", t0, f"{kind} | nvidia-smi: {smi} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda} | TF32 off")

    # ---- 2 build --------------------------------------------------------
    t0 = time.time()
    lib_path = _build.build(verbose=True)
    _build.load_library()
    phase("build", t0, f"nvcc {' '.join(_build.NVCC_FLAGS)} -> "
          f"{os.path.relpath(lib_path, ROOT)}")

    # ---- 3 kernels vs plain at the main path's shapes ------------------
    t0 = time.time()
    model = load_weights_json(GECKO, device=dev)
    h = model.h
    gmin, gsize = (-1.0, -1.0), (2.0, 2.0)
    x2 = grange((IMAGE, IMAGE), gmin, gsize).reshape(-1, 2)
    x = torch.nn.functional.pad(x2, (0, 1))  # 3D, as the CLI runs it
    eng = build_cell_engine(x, h, device=dev)
    nb1, w1 = eng.blk_xs.shape[0], eng.blk_xw.shape[2]
    nb2, w2 = eng.blk2_xs.shape[0], eng.blk2_xw.shape[2]
    if nb1 == 0 or nb2 == 0:
        fail(f"expected two non-empty buckets, got nb1={nb1} nb2={nb2}")
    shapes = (f"C={eng.num_cells} M={eng.slots_per_cell} "
              f"bucket1 nb={nb1} W={w1}, bucket2 nb={nb2} W={w2}")
    scal = PK.scal_vec(eng)
    rng = np.random.default_rng(SEED)
    S = torch.from_numpy(rng.normal(
        size=(eng.num_cells, eng.slots_per_cell, model.cfg.channels)
    ).astype(np.float32)).to(dev)
    errs = {"sph_fwd_kernel": 0.0, "sph_mask_kernel": 0.0}
    for bucket in (1, 2):
        xs_b, ab, xw_b, vw_b, wc = bucket_args(eng, S, bucket)
        real = real_rows(eng, bucket)
        for use_alpha in (True, False):
            ga_k, sm_k = PK.fwd_bucket(scal, xs_b, ab, xw_b, vw_b, S, wc,
                                       use_alpha=use_alpha)
            ga_p, sm_p = PK.fwd_bucket_plain(scal, xs_b, ab, xw_b, vw_b, S,
                                             wc, use_alpha=use_alpha)
            mk = PK.mask_bucket(scal, xs_b, xw_b, vw_b, S, wc,
                                use_alpha=use_alpha)
            mp = PK.mask_bucket_plain(scal, xs_b, xw_b, vw_b, S, wc,
                                      use_alpha=use_alpha)
            torch.cuda.synchronize()
            ga_abs, ga_rel = rel_err(ga_k, ga_p, real)
            sm_abs, sm_rel = rel_err(sm_k, sm_p, real)
            mk_abs, mk_rel = rel_err(mk, mp, real)
            print(f"  bucket {bucket} use_alpha={use_alpha}: fwd gA max abs "
                  f"{ga_abs:.3e} (rel to max {ga_rel:.3e}), fwd sm max abs "
                  f"{sm_abs:.3e} (rel {sm_rel:.3e}); mask sm max abs "
                  f"{mk_abs:.3e} (rel {mk_rel:.3e})", flush=True)
            errs["sph_fwd_kernel"] = max(errs["sph_fwd_kernel"], ga_abs,
                                         sm_abs)
            errs["sph_mask_kernel"] = max(errs["sph_mask_kernel"], mk_abs)
            if not (ga_rel <= GA_RTOL and sm_rel <= SM_RTOL
                    and mk_rel <= SM_RTOL):
                fail(f"kernel vs plain out of tolerance (bucket {bucket}, "
                     f"use_alpha={use_alpha}): gA {ga_rel:.3e} > {GA_RTOL} "
                     f"or sm {sm_rel:.3e} / {mk_rel:.3e} > {SM_RTOL}")
    phase("kernels", t0, f"kernel == plain within gA {GA_RTOL} and sm "
          f"{SM_RTOL} of max, at {shapes}")

    # ---- 4 rollout through the CLI --------------------------------------
    t0 = time.time()
    with tempfile.TemporaryDirectory() as out_dir:
        PK.fwd_bucket.launches = 0
        PK.mask_bucket.launches = 0
        rc = cli_test.main([
            "--weights_json", GECKO, "--image_size", str(IMAGE),
            "--steps", str(STEPS), "--firerate", "0.5", "--seed", str(SEED),
            "--output_dir", out_dir, "--device", "cuda",
        ])
        torch.cuda.synchronize()
        launches = {"sph_fwd_kernel": PK.fwd_bucket.launches,
                    "sph_mask_kernel": PK.mask_bucket.launches}
        if rc != 0:
            fail(f"CLI returned {rc}")
        (run,) = os.listdir(out_dir)
        with np.load(os.path.join(out_dir, run, "states.npz")) as z:
            states = z["states"]
    want = 2 * STEPS  # two buckets a step
    if launches != {"sph_fwd_kernel": want, "sph_mask_kernel": want}:
        fail(f"launch counts {launches}, expected {want} each "
             "(2 buckets x 128 steps)")
    if states.shape != (STEPS + 1, IMAGE * IMAGE, model.cfg.channels):
        fail(f"trajectory shape {states.shape}")
    finite = bool(np.isfinite(states).all())
    alive0 = float((states[0][:, 3] > 0.1).mean())
    alive = float((states[-1][:, 3] > 0.1).mean())
    if not finite:
        fail("non-finite states in the rollout")
    if not alive0 < alive < 0.5:
        fail(f"the gecko did not grow: alive fraction {alive0} -> {alive}")
    phase("rollout", t0, f"CLI {STEPS} steps at fire_rate 0.5, "
          f"{IMAGE * IMAGE} particles: launches {launches}, finite={finite}, "
          f"alive fraction {alive0:.4f} -> {alive:.4f}")

    t0 = time.time()
    cfg1 = dataclasses.replace(model.cfg, fire_rate=1.0)
    A0 = plane_seed(x2, model.cfg.channels, gmin=gmin, gsize=gsize,
                    radius=h).to(dev)
    S0 = eng.scatter(A0)
    finals = {}
    for use_kernels in (True, False):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        finals[use_kernels] = eng.gather_back(rollout_cells(
            model.params, cfg1, eng, S0, gen, CHECK_STEPS, h, fire_rate=1.0,
            use_kernels=use_kernels))
    diff = float((finals[True] - finals[False]).abs().max())
    phase("rollout-check", t0, f"{CHECK_STEPS} steps at fire_rate 1.0, "
          f"kernels vs plain versions: max state difference {diff:.3e} "
          f"(limit {ROLLOUT_ATOL})")
    if not diff <= ROLLOUT_ATOL:
        fail(f"kernel rollout departs from the plain rollout by {diff}")

    # ---- 5 times --------------------------------------------------------
    t0 = time.time()
    need = work(eng, S)
    args = [bucket_args(eng, S, b) for b in (1, 2)]

    def fwd(fn):
        for xs_b, ab, xw_b, vw_b, wc in args:
            fn(scal, xs_b, ab, xw_b, vw_b, S, wc, use_alpha=True)

    def mask(fn):
        for xs_b, _, xw_b, vw_b, wc in args:
            fn(scal, xs_b, xw_b, vw_b, S, wc, use_alpha=True)

    times = {
        "sph_fwd_kernel": (cuda_ms(lambda: fwd(PK.fwd_bucket)),
                           cuda_ms(lambda: fwd(PK.fwd_bucket_plain))),
        "sph_mask_kernel": (cuda_ms(lambda: mask(PK.mask_bucket)),
                            cuda_ms(lambda: mask(PK.mask_bucket_plain))),
    }
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step_ms = {}
    for use_kernels in (True, False):
        rollout_cells(model.params, model.cfg, eng, S0, gen, 4, h,
                      use_kernels=use_kernels)  # warm-up
        torch.cuda.synchronize()
        t1 = time.time()
        rollout_cells(model.params, model.cfg, eng, S0, gen, STEPS, h,
                      use_kernels=use_kernels)
        torch.cuda.synchronize()
        step_ms[use_kernels] = (time.time() - t1) * 1e3 / STEPS
    rows = []
    for name, replaces in (
        ("sph_fwd_kernel", "sph_nca_tpu/ops/pallas/pair_kernel.py:79"),
        ("sph_mask_kernel", "sph_nca_tpu/ops/pallas/pair_kernel.py:625"),
    ):
        ms, plain_ms = times[name]
        nbytes, ops = need[name]
        bound_ms, bound_by = bound(nbytes, ops)
        print(f"  {name}: {ms:.4f} ms a step (both buckets), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
              f"({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G operations; "
              f"{need['pairs']} pairs, {need['pairs_in_support']} within h)",
              flush=True)
        rows.append({
            "name": name, "route": "cuda",
            "source": "sph_nca_tpu_torch/csrc/pair_kernels.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "max_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
        })
    phase("times", t0, f"rollout step {step_ms[True]:.4f} ms with the "
          f"kernels, {step_ms[False]:.4f} ms with the plain versions "
          f"({STEPS} steps, fire_rate 0.5, host clock around synchronize); "
          f"kernel times by CUDA events over 50 calls, L2-warm")

    if "--profile" in sys.argv[1:]:
        t0 = time.time()
        profile_steps(model, eng, S0, h)
        phase("profile", t0, "torch.profiler, 16 steps at fire_rate 0.5")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

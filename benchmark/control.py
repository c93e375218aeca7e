"""Readings for the limits of ``correct``: the program's numbers, the
control's and the faults', at a cell's own size, on several seeds in one
process.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --side program,control,fault:half_batch

``program`` is the cell's run as the benchmark makes it (a short window of
two units). ``control`` puts the plain reference in the program's place,
computed in the nearest precision below the configuration's (fp8 for
bfloat16, TF32 for float32 with TF32 off), and judges it by the same
comparison. ``fault:<name>`` breaks the program's timed path underneath
(``FAULTS``). Each reading is one JSON line on standard output. The
benchmark's own runs run none of this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
LOWER = {"bfloat16": "fp8", "float32": "tf32"}


def _reference_rollout(driver, precision: str):
    """The reference's batched rollout at ``precision`` with the program's
    entry's signature, drawing its fire masks from the generator it is
    given, in the program's row order."""
    from benchmark.reference import geometry as GEO
    from benchmark.reference import nca as REF
    from benchmark.reference.sph import Operators

    ops = Operators(torch.from_numpy(driver.x).to(driver.device), driver.h,
                    precision)
    rank, shape = GEO.band_ranks(driver.x, driver.h)

    def rollout(params, cfg, eng, A0, n, T0, gen, steps, h, **_):
        draws = REF.FireDraws(gen, rank, shape, A0.shape[0], A0.device)
        return REF.surface_rollout(ops, REF.Weights(*params), A0, T0, n,
                                   draws, steps, driver.rule)
    return rollout


class _ReferenceTrainer:
    """The reference's trainer at a lower precision, shaped as the
    program's ``Trainer`` where the driver reads it: it draws from and
    writes back to the program's pool, as the program's trainer would."""

    def __init__(self, driver, precision: str):
        from benchmark.reference.sph import Operators

        ops = Operators(torch.from_numpy(driver.x).to(driver.device),
                        driver.h, precision)
        self.ref = driver._reference(ops, driver.weights, driver.pool.A)
        self.b = driver.b
        self.params = self.ref.params
        self.np_rng = self.ref.np_rng
        self.generator = self.ref.draws.gen
        self.last_steps = 0

    @property
    def optimizer(self):
        adam = self.ref.adam
        step = torch.tensor(float(adam.count))

        class _State:  # Adam's state, as torch.optim keeps it
            state = {} if not adam.count else {
                p: {"exp_avg": m, "exp_avg_sq": v, "step": step}
                for p, m, v in zip(adam.params, adam.m, adam.v)}
        return _State

    def run_iteration(self, i, pool):
        idx, A0 = pool.sample(self.b)
        loss, final, order = self.ref.iterate(A0)
        pool.update(torch.as_tensor(idx, device=final.device)[order], final)
        self.last_steps = self.ref.last_steps
        return loss


def control(driver) -> None:
    """Put the reference at the precision below the configuration's in the
    program's place."""
    low = LOWER[driver.spec["precision"]]
    if driver.spec["kind"] == "rollout":
        driver.rollout_fn = _reference_rollout(driver, low)
    else:
        driver.trainer = _ReferenceTrainer(driver, low)


# ---- faults of the timed path ----------------------------------------------


def _unchanged(driver) -> None:
    """A step that returns its state unchanged."""
    if driver.spec["kind"] == "rollout":
        driver.rollout_fn = lambda params, cfg, eng, A0, n, T0, *a, **k: (
            A0.clone(), T0.clone())
        return
    tr = driver.trainer
    tr.optimizer.step = lambda *a, **k: None


def _half_batch(driver) -> None:
    """Half of the batch left out, the mean taken over the rest."""
    if driver.spec["kind"] == "rollout":
        inner = driver.rollout_fn

        def rollout(params, cfg, eng, A0, n, T0, *a, **k):
            half = A0.shape[0] // 2
            A, T = inner(params, cfg, eng, A0[:half], n, T0[:half], *a, **k)
            return torch.cat([A, A0[half:]]), torch.cat([T, T0[half:]])
        driver.rollout_fn = rollout
        return
    loss = driver.trainer.loss
    half = driver.b // 2
    driver.trainer.loss = type(loss)(
        per_sample=loss.per_sample,
        batch_total=lambda x, A, g=None: loss.batch_total(x, A[:half], g))


def _altered(driver) -> None:
    """An answer altered where it is produced: one rollout's first sample
    comes back with its channels in reverse order."""
    inner = driver.rollout_fn

    def rollout(*a, **k):
        A, T = inner(*a, **k)
        A = A.clone()
        A[0] = A[0].flip(-1)
        return A, T
    driver.rollout_fn = rollout


# the program's modules that test life against their own copy of the
# threshold
THRESHOLD_HOLDERS = ("sph_nca_tpu_torch.models.nca",
                     "sph_nca_tpu_torch.models.cell_step",
                     "sph_nca_tpu_torch.ops.bands")
SHIFTED_THRESHOLD = 0.2


def _mask(driver) -> None:
    """The life masks tested against a shifted threshold (0.2 for the
    configuration's 0.1) while the program runs."""
    import importlib

    mods = [importlib.import_module(m) for m in THRESHOLD_HOLDERS]

    def shifted(fn):
        def run(*a, **k):
            kept = [m.ALIVE_THRESHOLD for m in mods]
            for m in mods:
                m.ALIVE_THRESHOLD = SHIFTED_THRESHOLD
            try:
                return fn(*a, **k)
            finally:
                for m, t in zip(mods, kept):
                    m.ALIVE_THRESHOLD = t
        return run
    if driver.spec["kind"] == "rollout":
        driver.rollout_fn = shifted(driver.rollout_fn)
    else:
        tr = driver.trainer
        tr.run_iteration = shifted(tr.run_iteration)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "altered": _altered, "mask": _mask}
# the faults a cell of each kind can have
KIND_FAULTS = {"rollout": ("unchanged", "half_batch", "altered", "mask"),
               "train": ("unchanged", "half_batch", "mask")}


def side_hook(side: str):
    if side == "program":
        return None
    if side == "control":
        return control
    return FAULTS[side.split(":", 1)[1]]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--side", default="program,control")
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness as H

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for side in args.side.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            out = H.run_cell(args.workload, seed, args.seconds, False,
                             substitute=side_hook(side), min_units=2)
            print(json.dumps({"side": side, "seed": seed,
                              "correct": out["correct"],
                              "checks": {k: c["value"] for k, c in
                                         out["checks"].items()},
                              "rate": [m["value"] for n, m in
                                       out["metrics"].items()
                                       if n != "setup_s"][0]}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    np.seterr(all="ignore")
    sys.exit(main())

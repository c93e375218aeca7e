"""The benchmark of sph_nca_tpu_torch on one NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell (``benchmark/workloads/<cell>.json``) in this process: set-up,
a window of ``--seconds`` of back-to-back work, with ``--trace 1`` a traced
window after it, then the comparison with the plain reference that decides
``correct``. It prints each compared number beside its limit as the last
lines of standard error, and one JSON object as the last line of standard
output. Without a CUDA device, or with fewer than the cell's chips, it
exits with code 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# imported by whole top-level name; the port's own name begins with the JAX
# package's, so a prefix would match it
FORBIDDEN = ("jax", "jaxlib", "flax", "sph_nca_tpu")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    chips = harness.load_json("workloads", args.workload)["chips"]
    harness.log(f"imports {time.perf_counter() - T_START:.3f} s")
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); {found} "
              "found", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda", t_start=T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: the run loaded {loaded}", file=sys.stderr)
        return 3
    checks = out.pop("checks")
    peak = out["device"].pop("peak")
    overhead = out.pop("tracing_overhead", None)
    if overhead is not None:
        print(f"tracing overhead: the traced rate is {overhead:.6f} below "
              "the untraced window's", file=sys.stderr)
    result = {
        "correct": out["correct"], "attempted": out["attempted"],
        "failed": out["failed"], "metrics": out["metrics"],
        "device": {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(0), "count": chips,
                   "memory_peak_bytes": peak, **out["device"]},
    }
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

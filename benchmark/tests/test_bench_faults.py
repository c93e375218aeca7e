"""The comparison that decides ``correct`` comes out false for the control
(the reference one precision below the configuration's, in the program's
place) and for each fault the cell can have, with the timed path broken
underneath; the rest of a run is driven as the benchmark drives it, on the
CPU at a tiny size."""

import pytest

from benchmark import control as C
from benchmark import harness as H

from test_bench_reference import RUNS

CASES = [(cell, size, seed, side) for cell, size, seed in RUNS
         for side in ["control"] + [
             f"fault:{f}" for f in C.KIND_FAULTS[H.cell_spec(cell)["kind"]]]]


@pytest.mark.parametrize("cell,size,seed,side", CASES)
def test_broken_runs_are_not_correct(cell, size, seed, side):
    out = H.run_cell(cell, seed, 0.0, False, device="cpu", overrides=size,
                     substitute=C.side_hook(side), min_units=2)
    assert not out["correct"], out["checks"]

"""End to end on the card: each cell by the benchmark's own command, a
short window. Marked ``cuda``; skips without a card. Without one the
command exits with code 2 and prints no result."""

import json
import subprocess
import sys

import pytest

from benchmark import harness as H

RUN = str(H.HERE / "run.py")


def _run(cell: str, trace: int):
    return subprocess.run(
        [sys.executable, RUN, "--workload", cell, "--seed", str(2 ** 32 + 3),
         "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, cwd=H.HERE.parent, timeout=600)


def test_without_a_card_the_command_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run("surface-band-b8", 0)
    assert out.returncode == 2 and not out.stdout.strip()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["surface-band-b8", "plane-train-b8"])
def test_a_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = _run(cell, 1)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0


@pytest.mark.cuda
def test_the_surface_cell_reports_the_device_time_a_step():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = _run("surface-band-b8", 0)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"]
    assert set(line["metrics"]) == {"device_ms_per_step", "setup_s"}
    assert line["metrics"]["device_ms_per_step"]["value"] > 0

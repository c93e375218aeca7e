"""The yardstick's arithmetic: published peaks, and the operations and bytes
that a step's work needs, counted from the inputs' shapes and their pairs
within h (never from the program's padded tables).

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense, at its 700 W limit.
A roofline share is the least time the work could take (the larger of its
bytes over the HBM bandwidth and its operations over the peak of its
precision) over the device time it took.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 495e12}
# float32 products may run on the tensor cores as 3xTF32 or on the CUDA
# cores (67e12); the TF32 rate is the fastest route, so it bounds both
BYTES = {"bfloat16": 2, "float32": 4}

DIM = 3  # the space the points live in (the plane's carry z = 0)
# the model's widths, as a configuration file names them
WIDTHS = ("channels", "hidden", "mlp_inputs", "mlp_outputs")


def widths(spec: dict) -> dict:
    """The configuration's widths (``WIDTHS``) from its file."""
    return {k: int(spec[k]) for k in WIDTHS}


def least_s(nbytes: float, ops: float, precision: str) -> float:
    """The least seconds of work moving ``nbytes`` and doing ``ops``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[precision])


def mlp_launch(items: int, precision: str, w: dict):
    """(bytes, operations) of one update-MLP launch over ``items`` rows of
    the widths ``w``: the inputs (state and perception) read once, the
    weights once (biases in float32), the float32 outputs written once; a
    multiply-add is two operations."""
    es = BYTES[precision]
    fin, hid, out = w["mlp_inputs"], w["hidden"], w["mlp_outputs"]
    nbytes = (items * fin * es + (fin * hid + hid * out) * es
              + 4 * (hid + out) + 4 * items * out)
    return nbytes, 2 * items * (fin * hid + hid * out)


def pair_pass(pairs: int, rows: int, width: int, weights_per_pair: int,
              precision: str):
    """(bytes, operations) of one pass of pair sums: each pair's
    ``weights_per_pair`` weights read once in the table precision, the
    right-hand side [rows, width] once in it, the float32 output [rows,
    width * weights_per_pair] written once; a multiply-add for every pair,
    weight and column."""
    es = BYTES[precision]
    nbytes = (pairs * weights_per_pair * es + rows * width * es
              + 4 * rows * width * weights_per_pair)
    return nbytes, 2 * pairs * width * weights_per_pair


def step_passes(batch: int, surface: bool, channels: int):
    """The pair passes of one step as (width, weights a pair): the
    gradient's D moments of the channels, the two life-mask blurs of one
    column a sample, and on a surface the tangent diffusion's blur of 4."""
    passes = [(channels * batch, DIM), (batch, 1), (batch, 1)]
    if surface:
        passes.append((4 * batch, 1))
    return passes


def model_flops_per_particle_step(pairs_per_particle: float,
                                  surface: bool, w: dict) -> float:
    """The model's operations a particle and step: the MLP's
    2 (inputs x hidden + hidden x outputs), and the SPH sums over its pairs
    within h (the gradient of the channels on 3 axes, the two mask blurs,
    on a surface the diffusion's 4 columns), two operations a
    multiply-add."""
    sph = w["channels"] * DIM + 1 + 1 + (4 if surface else 0)
    return (2 * (w["mlp_inputs"] * w["hidden"]
                 + w["hidden"] * w["mlp_outputs"])
            + 2 * pairs_per_particle * sph)

"""The whole step's share of the card's dense peak in the configuration's
precision: the model's operations a particle-step (arithmetic.py; a
training step counts three forwards, its recompute none) times the
particle-steps per second of the run's measured window (the traced
window's rate reads the profiler's overhead), over the peak."""

from benchmark import arithmetic as AR

UNIT = "%"
PASSES = 3


def read(rec):
    if not rec["kernels"] or rec["kind"] != "train" or not rec["points"]:
        return None
    flops = AR.model_flops_per_particle_step(rec["pairs"] / rec["points"],
                                             rec["surface"], rec["widths"])
    return (100.0 * PASSES * flops * rec["untraced_rate"]
            / AR.PEAK_FLOPS[rec["precision"]])

"""The band engine's pair products against their roofline: the least time
of every pair pass in the traced window (arithmetic.pair_pass: each pair's
weights read once, the right-hand side once, the output written once;
operations at the precision's peak) over the device time of the kernels
that aten::bmm launched. A cell engine launches no bmm: nothing to read."""

from benchmark import arithmetic as AR

UNIT = "%"


def read(rec):
    if rec["kind"] != "rollout" or rec["bmm_s"] <= 0:
        return None
    passes = AR.step_passes(rec["batch"], rec["surface"],
                            rec["widths"]["channels"])
    least = sum(AR.least_s(*AR.pair_pass(rec["pairs"], rec["points"], width,
                                         weights, rec["precision"]),
                           rec["precision"])
                for width, weights in passes)
    return 100.0 * least * rec["steps"] / rec["bmm_s"]

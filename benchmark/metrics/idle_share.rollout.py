"""Share of the run's own untraced time in which no operation ran on the
device: 100 (1 - busy / untraced seconds), the busy seconds the union of
the device's intervals over the traced units, the untraced seconds what the
same work took at the measured window's rate (tracing slows the host, not
the device: the traced window's own length reads the profiler's
overhead)."""

UNIT = "%"


def read(rec):
    if not rec["kernels"] or rec["kind"] != "rollout" or rec["busy_s"] <= 0:
        return None
    untraced_s = rec["particle_steps"] / rec["untraced_rate"]
    return 100.0 * (1.0 - rec["busy_s"] / untraced_s)

"""Particle-steps a second by the host's clock over the traced run's
untraced window: B x N x steps of every rollout in it over its seconds,
the rate a user of a host-paced rollout waits for. The cell's end-to-end
metric is the device's time a step, since the host's pace spreads too
widely between runs to hold a bound (PERF.md section 2)."""

UNIT = "particle-steps/s"


def read(rec):
    if rec["kind"] != "rollout" or not rec["untraced_rate"]:
        return None
    return rec["untraced_rate"]

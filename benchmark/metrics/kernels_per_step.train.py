"""Device kernels a step in the traced window (copies and fills left out):
the launches the host makes per BPTT step, an iteration's pool draw, loss,
backward and update included."""

UNIT = "kernels/step"


def read(rec):
    if not rec["kernels"] or rec["kind"] != "train" or not rec["steps"]:
        return None
    return rec["kernels"] / rec["steps"]

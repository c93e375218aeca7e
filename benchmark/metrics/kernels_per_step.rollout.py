"""Device kernels a step in the traced window (copies and fills left out):
the launches the host makes per rollout step."""

UNIT = "kernels/step"


def read(rec):
    if not rec["kernels"] or rec["kind"] != "rollout" or not rec["steps"]:
        return None
    return rec["kernels"] / rec["steps"]

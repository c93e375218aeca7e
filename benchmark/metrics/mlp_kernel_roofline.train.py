"""Kernel 2.8 (sph_mlp_kernel) against its roofline: the least time of one
launch over B x N rows (its inputs read once, its outputs written once, its
operations at the peak of the configuration's precision) over the mean
device time of its launches in the traced window."""

from benchmark import arithmetic as AR

UNIT = "%"


def read(rec):
    runs = [k for name, k in rec["per_kernel"].items()
            if "sph_mlp_kernel" in name]
    count = sum(k["count"] for k in runs)
    seconds = sum(k["seconds"] for k in runs)
    if rec["kind"] != "train" or not count or seconds <= 0:
        return None
    least = AR.least_s(*AR.mlp_launch(rec["batch"] * rec["points"],
                                      rec["precision"], rec["widths"]),
                       rec["precision"])
    return 100.0 * least / (seconds / count)

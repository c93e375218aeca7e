"""The traced window: a few units of work under ``torch.profiler`` (CPU and
CUDA activity), reduced to the record that the per-layer readers in
``metrics/`` read, and to the breakdown of the contract's last line.

The record holds counts and sums, never the events themselves: the device
time and launches of each kernel name, the device time of the kernels that
``aten::bmm`` launched, the union of the device's busy intervals, the
traced window's length and its particle-steps.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

TOP = 10  # entries of each breakdown list
NAME = 120  # characters of a kernel's name kept in the breakdown
COPIES = ("Memcpy", "Memset")


def _union(intervals):
    """Merged [start, end] intervals of ``intervals`` (microseconds)."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_seconds(starts, ends) -> float:
    """Seconds covered by the union of the intervals [starts, ends)
    (nanoseconds; numpy, for the million intervals of a whole window)."""
    if not len(starts):
        return 0.0
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    # a merged interval opens where a start lies past every earlier end,
    # and runs to the reach just before the next opening
    opens = np.flatnonzero(np.r_[True, s[1:] > reach[:-1]])
    last = reach[np.r_[opens[1:] - 1, len(s) - 1]]
    return float((last - s[opens]).sum()) * 1e-9


def device_busy_s(prof) -> float:
    """Seconds in which an operation ran on the device, from a profile of
    the device's activity."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = np.array([(ev.start_ns(), ev.duration_ns())
                      for ev in prof.profiler.kineto_results.events()
                      if ev.device_type() == cuda],
                     dtype=np.int64).reshape(-1, 2)
    return busy_seconds(spans[:, 0], spans[:, 0] + spans[:, 1])


def short(name: str) -> str:
    """A kernel's name without its namespaces and argument list, cut to
    ``NAME`` characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "c10::", "std::"):
        name = name.replace(noise, "")
    depth = 0
    for i, ch in enumerate(name):  # the first "(" outside template brackets
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name[:NAME]


def _events(prof):
    """(name, on the device, start us, end us, id, linked id) of every
    event the profiler kept, read from its raw results (building its
    function events takes tens of seconds at these sizes)."""
    cuda = torch.autograd.DeviceType.CUDA
    raw = getattr(prof.profiler, "kineto_results", None)
    if raw is None:
        return [(ev.name, ev.device_type == cuda, ev.time_range.start,
                 ev.time_range.end, ev.id, 0) for ev in prof.events()]
    return [(ev.name(), ev.device_type() == cuda, ev.start_ns() * 1e-3,
             (ev.start_ns() + ev.duration_ns()) * 1e-3, ev.correlation_id(),
             ev.linked_correlation_id()) for ev in raw.events()]


def reduce_events(events, wall_s: float) -> dict:
    """The record's device part from ``_events``' tuples."""
    per_name = defaultdict(lambda: [0, 0.0])
    spans, host = [], []
    bmm_ops = set()
    for name, on_device, s, e, ident, linked in events:
        if on_device:
            spans.append((s, e))
            per_name[name][0] += 1
            per_name[name][1] += (e - s) * 1e-6
        else:
            host.append((s, e, name))
            if name == "aten::bmm":
                bmm_ops.add(ident)
    # a kernel's linked id is the id of the operator that launched it
    bmm_s = sum(e - s for name, on_device, s, e, _, linked in events
                if on_device and linked in bmm_ops) * 1e-6
    merged = _union(spans)
    busy_s = sum(e - s for s, e in merged) * 1e-6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:TOP]
    # each gap is named by the innermost host event running at its middle
    hs = np.array([h[0] for h in host])
    he = np.array([h[1] for h in host])
    idle = []
    for length, s, e in gaps:
        mid = 0.5 * (s + e)
        around = np.flatnonzero((hs <= mid) & (mid <= he))
        name = (host[around[np.argmin(he[around] - hs[around])]][2]
                if around.size else "host (no op)")
        idle.append([name, length * 1e-6])
    ops = sorted(((t, name) for name, (_, t) in per_name.items()),
                 reverse=True)[:TOP]
    return {
        "window_s": wall_s,
        "busy_s": busy_s,
        "kernels": sum(c for name, (c, _) in per_name.items()
                       if not name.startswith(COPIES)),
        "per_kernel": {name: {"count": c, "seconds": t}
                       for name, (c, t) in per_name.items()},
        "bmm_s": bmm_s,
        "breakdown": {"device_ops": [[short(name), t] for t, name in ops],
                      "idle_gaps": idle},
    }


def traced_window(driver) -> dict:
    """``driver.traced_units()`` units under the profiler, after the
    measured window's units."""
    from torch.profiler import ProfilerActivity, profile

    dev = driver.device
    start = getattr(driver, "next_unit", 10 ** 6)
    acts = [ProfilerActivity.CPU]
    if torch.device(dev).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        work = sum(driver.unit(start + k)
                   for k in range(driver.traced_units()))
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rec = reduce_events(_events(prof), wall)
    rec["particle_steps"] = work
    rec["steps"] = work / (driver.b * driver.x.shape[0])
    rec["traced_rate"] = work / wall
    return rec

"""The program's spans joined with the device trace: which layer of the
program launched each kernel, and what the device did while the host was in
each layer.

The program records spans and counters (``sph_nca_tpu_torch.utils.
profiling``: ``recording()``, ``span``, ``count``) on the profiler's clock,
Unix-epoch nanoseconds. ``attribute`` joins them with a profile's raw
events: each device operation is joined to its host launch (the CUDA
runtime or driver call with the same correlation id, which also covers the
kernels launched through ctypes, outside any ``aten::`` operator), and
counts toward every span open on the launching thread at the launch, and,
when that thread is not the main one (the autograd engine's, which runs
the CUDA backward), toward the spans open on the main thread at that time
too. Per span name it gives ``count``, ``host_s`` (inclusive),
``device_s`` (the device time of the operations attributed to it) and
``idle_s`` (the part of the device's idle gaps that overlaps the name's
spans on the main thread).

``READERS`` are the per-layer metrics these totals give, each a function of
a record that holds, besides the traced window's record of
``benchmark/trace.py``, ``spans`` (``attribute``'s totals), ``counters``,
``setup_spans`` and ``setup_counters`` (the set-up's); a record without
them, as from a program that records nothing, reads ``None``. ``run.py``
does not read them; this module's command measures them in one cell:

    python3 benchmark/spans.py --workload <cell> --seed <n> \
        --seconds <s> --repeats <r>

set-up under ``recording()``, then ``r`` measured windows of ``s`` seconds
with recording off and on in turns (the rates), then ``r`` traced windows
(``trace.py``'s units under ``torch.profiler``) off and on in turns: the
harness's record of each, and of each recorded one the span totals, the
metrics, the share of the device's busy time attributed to some span and,
in a rollout, where the update kernel's launches fall against the
``step.update`` spans. It prints one JSON object as its last line. Without
a CUDA device it exits with code 2.
"""

from __future__ import annotations

import bisect
import contextlib
import gc
import json
import sys
import threading
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import arithmetic as AR  # noqa: E402
from benchmark import harness as H  # noqa: E402
from benchmark import trace as TR  # noqa: E402

# host events that launch device work: CUDA runtime and driver calls
LAUNCH_PREFIX = "cu"
UPDATE_KERNEL = "sph_mlp_kernel"


def raw_events(prof) -> list:
    """(name, on the device, start ns, end ns, correlation id, thread) of
    every event of a profile, from its raw results; a host event's thread
    is its OS thread id (``threading.get_native_id``'s)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(ev.name(), ev.device_type() == cuda, ev.start_ns(),
             ev.start_ns() + ev.duration_ns(), ev.correlation_id(),
             ev.device_resource_id())
            for ev in prof.profiler.kineto_results.events()]


class OpenSpans:
    """The spans open on a thread at a time. A thread's spans nest, so the
    innermost open one is the last to start before the time, or the first
    of its ancestors still open then."""

    def __init__(self, spans):
        self.spans = list(spans)
        by_thread = defaultdict(list)
        for i, s in enumerate(self.spans):
            by_thread[s.thread].append((s.start_ns, i))
        self.starts, self.index = {}, {}
        for thread, rows in by_thread.items():
            rows.sort()
            self.starts[thread] = [r[0] for r in rows]
            self.index[thread] = [r[1] for r in rows]

    def innermost(self, thread, t: int) -> int:
        """Index of the innermost span open on ``thread`` at ``t``, -1 for
        none."""
        starts = self.starts.get(thread)
        if not starts:
            return -1
        k = bisect.bisect_right(starts, t) - 1
        i = self.index[thread][k] if k >= 0 else -1
        while i >= 0 and self.spans[i].end_ns < t:
            i = self.spans[i].parent
        return i

    def names(self, thread, t: int) -> set:
        """Names of every span open on ``thread`` at ``t``."""
        out = set()
        i = self.innermost(thread, t)
        while i >= 0:
            out.add(self.spans[i].name)
            i = self.spans[i].parent
        return out


def launches(events) -> dict:
    """Correlation id -> (start ns, thread) of the first host launch event
    of that id."""
    out = {}
    for name, on_device, s, _, corr, thread in events:
        if not on_device and name.startswith(LAUNCH_PREFIX):
            if corr not in out or s < out[corr][0]:
                out[corr] = (s, thread)
    return out


def _merged(intervals) -> list:
    """[start, end] intervals merged where they overlap or touch."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap_ns(a, b) -> int:
    """Length of the intersection of two lists of disjoint sorted
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def attribute(events, spans, main_thread) -> dict:
    """Per span name: ``count``, ``host_s``, ``device_s`` and ``idle_s``
    (the module docstring); and the device's busy seconds and the part of
    them in operations attributed to some span (``busy_s``,
    ``attributed_s``)."""
    spans = list(spans)
    open_at = OpenSpans(spans)
    launch = launches(events)
    device_ns = defaultdict(int)
    busy, attributed = [], []
    for name, on_device, s, e, corr, _ in events:
        if not on_device:
            continue
        busy.append((s, e))
        if corr not in launch:
            continue
        t, thread = launch[corr]
        names = open_at.names(thread, t)
        if thread != main_thread:
            names |= open_at.names(main_thread, t)
        if names:
            attributed.append((s, e))
        for n in names:
            device_ns[n] += e - s
    merged = _merged(busy)
    gaps = [[a[1], b[0]] for a, b in zip(merged, merged[1:])]
    totals = defaultdict(lambda: {"count": 0, "host_s": 0.0,
                                  "device_s": 0.0, "idle_s": 0.0})
    main = defaultdict(list)
    for s in spans:
        row = totals[s.name]
        row["count"] += 1
        row["host_s"] += (s.end_ns - s.start_ns) * 1e-9
        if s.thread == main_thread:
            main[s.name].append((s.start_ns, s.end_ns))
    for n, ns in device_ns.items():
        totals[n]["device_s"] = ns * 1e-9
    for n, intervals in main.items():
        totals[n]["idle_s"] = _overlap_ns(gaps, _merged(intervals)) * 1e-9
    return {"names": dict(totals),
            "busy_s": sum(e - s for s, e in merged) * 1e-9,
            "attributed_s": sum(e - s for s, e in _merged(attributed)) * 1e-9}


def launch_offsets(events, spans, kernel: str, span_name: str) -> list:
    """For each device operation whose name holds ``kernel``: (whether its
    launch falls inside a ``span_name`` span on the launching thread, the
    launch's nanoseconds after that span's start or None)."""
    open_at = OpenSpans(spans)
    launch = launches(events)
    out = []
    for name, on_device, _, _, corr, _ in events:
        if not on_device or kernel not in name:
            continue
        if corr not in launch:
            out.append((False, None))
            continue
        t, thread = launch[corr]
        i = open_at.innermost(thread, t)
        while i >= 0 and open_at.spans[i].name != span_name:
            i = open_at.spans[i].parent
        out.append((i >= 0, t - open_at.spans[i].start_ns if i >= 0
                    else None))
    return out


# ---- the metrics -----------------------------------------------------------


def _per_step_ms(kind: str, name: str, field: str):
    """Milliseconds a step of span ``name``'s ``field`` in a ``kind``
    cell's traced window (a device reading needs device events)."""

    def read(rec):
        spans = rec.get("spans")
        if (rec["kind"] != kind or spans is None or not rec["steps"]
                or name not in spans
                or (field != "host_s" and rec["busy_s"] <= 0)):
            return None
        return 1e3 * spans[name][field] / rec["steps"]
    return read


def _table_mb(rec):
    """Megabytes (1e6 bytes) of table columns the band passes read a step:
    the counter ``band.table_bytes`` over the traced window's steps."""
    counters = rec.get("counters")
    if (rec["kind"] != "rollout" or counters is None or not rec["steps"]
            or "band.table_bytes" not in counters):
        return None
    return counters["band.table_bytes"] * 1e-6 / rec["steps"]


def _engine_scan_s(rec):
    """Seconds of the set-up's ``engine.scan`` spans (the native pair
    scan)."""
    spans = rec.get("setup_spans")
    if spans is None or "engine.scan" not in spans:
        return None
    return spans["engine.scan"]["host_s"]


def _kernel_builds(rec):
    """The set-up's counter ``kernels.compiled``: builds of the CUDA
    library that ran nvcc (0 where the library was found)."""
    counters = rec.get("setup_counters")
    if counters is None:
        return None
    return counters.get("kernels.compiled", 0)


# name -> (unit, reader, what it reads)
READERS = {
    "band_pass_device_ms.rollout": (
        "ms/step", _per_step_ms("rollout", "band.pass", "device_s"),
        "device_s of the band.pass spans"),
    "band_table_mb.rollout": (
        "MB/step", _table_mb, "the counter band.table_bytes"),
    "update_device_ms.rollout": (
        "ms/step", _per_step_ms("rollout", "step.update", "device_s"),
        "device_s of the step.update spans"),
    "diffuse_device_ms.rollout": (
        "ms/step", _per_step_ms("rollout", "rollout.diffuse", "device_s"),
        "device_s of the rollout.diffuse spans"),
    "step_idle_ms.rollout": (
        "ms/step", _per_step_ms("rollout", "rollout.step", "idle_s"),
        "idle_s of the rollout.step spans"),
    "step_idle_ms.train": (
        "ms/step", _per_step_ms("train", "rollout.step", "idle_s"),
        "idle_s of the forward's rollout.step spans"),
    "backward_device_ms.train": (
        "ms/step", _per_step_ms("train", "train.backward", "device_s"),
        "device_s of the train.backward spans"),
    "sync_wait_ms.train": (
        "ms/step", _per_step_ms("train", "train.sync", "host_s"),
        "host_s of the train.sync spans: the wait for the card"),
    "engine_scan_s": ("s", _engine_scan_s, "host_s of engine.scan"),
    "kernel_builds": ("count", _kernel_builds,
                      "the counter kernels.compiled in set-up"),
}


def read_all(rec) -> dict:
    """Every ``READERS`` metric that the record gives a value."""
    out = {}
    for name, (_, read, _) in READERS.items():
        value = read(rec)
        if value is not None:
            out[name] = value
    return out


# ---- the measurement --------------------------------------------------------


def _recorder():
    """The program's ``recording`` context, or None for a program that has
    none."""
    from sph_nca_tpu_torch.utils import profiling

    return getattr(profiling, "recording", None)


def _maybe(recorder, on: bool):
    return recorder() if recorder is not None and on \
        else contextlib.nullcontext(None)


def _totals(spans) -> dict:
    """Per name: count and inclusive host seconds (the set-up's spans)."""
    out = defaultdict(lambda: {"count": 0, "host_s": 0.0})
    for s in spans:
        out[s.name]["count"] += 1
        out[s.name]["host_s"] += (s.end_ns - s.start_ns) * 1e-9
    return dict(out)


def traced(driver, recorder, on: bool, main_thread) -> dict:
    """``trace.py``'s traced window (its units, its record) with recording
    ``on`` or off; a recorded one adds the span totals and counters."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(driver.device)
    start = getattr(driver, "next_unit", 10 ** 6)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    H.sync(dev)
    with _maybe(recorder, on) as rec, profile(activities=acts) as prof:
        t0 = time.perf_counter()
        work = sum(driver.unit(start + k)
                   for k in range(driver.traced_units()))
        H.sync(dev)
        wall = time.perf_counter() - t0
    out = TR.reduce_events(TR._events(prof), wall)
    out.update(particle_steps=work,
               steps=work / (driver.b * driver.x.shape[0]),
               traced_rate=work / wall, spans=None, counters=None)
    if rec is not None:
        events = raw_events(prof)
        joined = attribute(events, rec.spans, main_thread)
        out.update(spans=joined["names"], counters=dict(rec.counters),
                   attributed_s=joined["attributed_s"],
                   span_busy_s=joined["busy_s"])
        if driver.spec["kind"] == "rollout":
            out["update_launches"] = launch_offsets(
                events, rec.spans, UPDATE_KERNEL, "step.update")
    return out


def measure(cell: str, seed: int, seconds: float, repeats: int, *,
            device="cuda", overrides=None, min_units: int = 1) -> dict:
    """The command's measurement of one cell (the module docstring)."""
    spec = H.cell_spec(cell, overrides)
    torch.backends.cuda.matmul.allow_tf32 = spec["tf32"]
    torch.backends.cudnn.allow_tf32 = spec["tf32"]
    recorder = _recorder()
    main_thread = threading.get_native_id()
    driver = H.DRIVERS[spec["kind"]](spec, seed, device)
    t0 = time.perf_counter()
    with _maybe(recorder, True) as setup:
        driver.setup()
        H.sync(device)
    setup_s = time.perf_counter() - t0
    gc.collect()  # as the harness's windows: the set-up's objects frozen
    gc.freeze()
    rates = {"off": [], "on": []}
    records = {"off": [], "on": []}
    for r in range(repeats):
        for side in ("off", "on") if r % 2 == 0 else ("on", "off"):
            with _maybe(recorder, side == "on"):
                _, work, secs = H.window(driver, seconds, min_units)
            rates[side].append(work / secs)
    for r in range(repeats):
        for side in ("off", "on") if r % 2 == 0 else ("on", "off"):
            records[side].append(traced(driver, recorder, side == "on",
                                        main_thread))
    base = dict(untraced_rate=float(np.median(rates["off"])),
                engine_build_s=driver.build_s, precision=spec["precision"],
                batch=driver.b, points=driver.x.shape[0], kind=spec["kind"],
                widths=AR.widths(spec), surface=spec["kind"] == "rollout",
                pairs=int(driver.eng.nbr_count.sum()),
                setup_spans=None if setup is None else _totals(setup.spans),
                setup_counters=None if setup is None
                else dict(setup.counters))
    old = H.load_readers()
    out = {"cell": cell, "seed": seed, "setup_s": setup_s,
           "setup_spans": base["setup_spans"],
           "setup_counters": base["setup_counters"],
           "untraced_rate": rates, "traced": {}}
    for side, recs in records.items():
        rows = []
        for rec in recs:
            rec.update(base)
            row = {"traced_rate": rec["traced_rate"],
                   "kernels_per_step": rec["kernels"] / rec["steps"],
                   "busy_s": rec["busy_s"], "steps": rec["steps"],
                   "old": {n: m.read(rec) for n, m in old.items()},
                   "metrics": read_all(rec)}
            if rec["spans"] is not None:
                row.update(spans=rec["spans"], counters=rec["counters"],
                           coverage=rec["attributed_s"]
                           / max(rec["span_busy_s"], 1e-30),
                           per_kernel_s={
                               n: k["seconds"]
                               for n, k in rec["per_kernel"].items()
                               if UPDATE_KERNEL in n},
                           bmm_s=rec["bmm_s"])
                if "update_launches" in rec:
                    inside = [o for ok, o in rec["update_launches"] if ok]
                    row["update_launches"] = {
                        "count": len(rec["update_launches"]),
                        "inside": len(inside),
                        "median_offset_us": float(np.median(inside)) * 1e-3
                        if inside else None}
            rows.append(row)
        out["traced"][side] = rows
    gc.unfreeze()
    return out


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--repeats", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("spans: needs a CUDA device", file=sys.stderr)
        return 2
    out = measure(args.workload, args.seed, args.seconds, args.repeats)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

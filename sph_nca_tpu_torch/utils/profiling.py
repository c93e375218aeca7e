"""Step timing, device synchronization, profiler traces and the training
metrics stream (counterpart of ``sph_nca_tpu/utils/profiling.py``).

  * ``StepTimer``      — step timing with warmup skip; reports
                         particle-steps/s, the framework's north-star metric
  * ``device_sync``    — wait for the work queued on a tensor's card
  * ``trace(logdir)``  — a ``torch.profiler`` context (CPU and CUDA
                         activity) that writes a Chrome trace into ``logdir``
  * ``MetricsLogger``  — the append-only JSONL metrics stream

The JAX module's ``select_platform`` (pins JAX's platform before its first
computation) and ``enable_compilation_cache`` (XLA's on-disk compile cache)
set XLA's runtime state and have no counterpart here: the port picks its
device per call (``device=``) and compiles its kernels once per source hash
(``ops/_build.py``).

``MetricsLogger`` appends one JSON object a line: ``step``, ``t`` (seconds
since the logger opened, to the millisecond) and the metrics given. Python
ints stay ints (the port's rows carry ``iter`` and ``steps``); every other
value becomes a float where it can, as in the JAX package, so a reader of
the JAX CLI's stream reads the port's.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def _tensors(x):
    """The tensors in a nested structure of lists, tuples (named tuples
    too) and dicts, in order."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def device_sync(x) -> None:
    """Wait until the work queued on the current CUDA stream of each card
    that holds a tensor of ``x`` (a tensor or a nested structure of them)
    has finished. Tensors on the CPU need no wait: for them this does
    nothing."""
    seen = set()
    for t in _tensors(x):
        if t.device.type == "cuda" and t.device not in seen:
            seen.add(t.device)
            torch.cuda.current_stream(t.device).synchronize()


class StepTimer:
    """Step timing with warmup skip.

    timer = StepTimer(num_particles=n, warmup=2)
    for ...: with timer: run_one_step()
    timer.summary() -> {steps, mean_ms, particle_steps_per_sec}

    A CUDA step returns to the host once its kernels are queued, long before
    the card has run them. So each interval is wall-clock time closed by a
    synchronization of the card (``torch.cuda.synchronize``) on entry and
    on exit: entry drains the work queued before the step, exit waits for
    the step's own. A synchronization was chosen over a pair of CUDA events
    because the interval should hold what the step costs its caller, host
    work and launch gaps included, and because a step may queue work on
    several streams (the sharded paths' staging copies), which events on
    one stream would not see. The card waited for is the current one; when
    CUDA was never initialized in this process no card has work queued and
    nothing is waited for.
    """

    def __init__(self, num_particles: int = 0, warmup: int = 2):
        self.num_particles = num_particles
        self.warmup = warmup
        self.times: list = []
        self._t0 = 0.0

    @staticmethod
    def _sync() -> None:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.times.append(time.perf_counter() - self._t0)
        return False

    def summary(self) -> Dict[str, float]:
        ts = self.times[self.warmup:] or self.times
        mean = float(np.mean(ts)) if ts else float("nan")
        out = {"steps": len(self.times), "mean_ms": mean * 1e3}
        if self.num_particles and mean > 0:
            out["particle_steps_per_sec"] = self.num_particles / mean
        return out


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """``with trace(dir): run_steps()``: a ``torch.profiler`` profile of the
    block's CPU activity, and its CUDA activity where CUDA is present,
    written on exit as a Chrome trace ``trace-<pid>-<ns>.json`` into
    ``logdir`` (default ``$TMPDIR/sph_nca_trace``; open it in Perfetto or
    chrome://tracing). Yields ``logdir``, as the JAX package's does."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "sph_nca_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield logdir
    finally:
        StepTimer._sync()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class MetricsLogger:
    """Append-only JSONL metrics stream (no file: every call is a no-op)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self._t0 = time.time()

    def log(self, step: int, **metrics: Any) -> None:
        if self._fh is None:
            return
        rec = {"step": step, "t": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            if isinstance(v, int) and not isinstance(v, bool):
                rec[k] = v
                continue
            try:
                rec[k] = float(v)  # python, numpy and 0-d torch scalars
            except (TypeError, ValueError):
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

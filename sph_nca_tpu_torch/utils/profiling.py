"""Step timing, device synchronization, profiler traces and the training
metrics stream (counterpart of ``sph_nca_tpu/utils/profiling.py``).

  * ``StepTimer``      — step timing with warmup skip; reports
                         particle-steps/s, the framework's north-star metric
  * ``device_sync``    — wait for the work queued on a tensor's card
  * ``trace(logdir)``  — a ``torch.profiler`` context (CPU and CUDA
                         activity) that writes a Chrome trace into ``logdir``
  * ``MetricsLogger``  — the append-only JSONL metrics stream
  * ``span(name)``, ``count(name, n)``, ``recording()`` — spans and counters
                         at the program's layer boundaries, kept in memory
                         while a ``recording()`` block is open (below)

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

Spans and counters. ``with span("band.pass"):`` marks a layer's work and
``count("band.table_bytes", n)`` adds to a counter. Both do nothing until a
``recording()`` block turns them on for the whole process; that block
yields the ``Record`` of every span and counter until it closes. Off, which
is the default, ``span`` returns one shared no-op object after one test of
the module's open record and ``count`` returns at once: nothing is
allocated, no tensor is touched, the card is never waited for. A call site
that computes a counter's value guards the computation with
``is_recording()``. A span keeps its name, its start and end in Unix-epoch
nanoseconds (``time.time_ns``, the clock of ``torch.profiler``'s events, so
a span can be set against the kernels launched inside it), its thread's OS
id and its parent: the index of the innermost span open on the same thread
when it opened, -1 for none. The autograd engine runs a CUDA backward on a
thread of its own, so the spans of a step recomputed there carry that
thread's id and no parent. Spans do not enter
``torch.profiler.record_function`` and add no event to a profile. Names in
use:

  * ``rollout``, ``rollout.step`` (each step: fire draw, step, diffusion),
    ``rollout.diffuse`` (the surface rollouts' tangent diffusion);
  * ``step.perceive``, ``step.update``, ``step.mask`` (the batched step's
    perception, update MLP and rule, post-update life mask);
  * ``band.pass`` (one pair pass of the band engine) and the counter
    ``band.table_bytes`` (the table columns it reads);
  * ``train.iteration`` with ``train.sample``, ``train.rank``,
    ``train.rollout``, ``train.loss``, ``train.backward``,
    ``train.optimizer``, ``train.pool_update``, ``train.sync``;
  * ``engine.build`` with ``engine.scan``, ``engine.tables``,
    ``engine.transfer`` (the band engine's build);
  * the counter ``kernels.compiled`` (builds of the CUDA library).

``trace(logdir)`` records spans for its block and writes each into the
Chrome trace beside the profiler's events, as a complete event on the
thread that opened it.
"""

from __future__ import annotations

import array
import contextlib
import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

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


# ---- spans and counters ---------------------------------------------------

_record: Optional["Record"] = None  # the open record; None: off
_lock = threading.Lock()  # guards the record's columns and counters
# each thread's (stack of open spans, OS thread id), made on its first span:
# the id is a system call, which costs microseconds under some container
# runtimes
_local = threading.local()


class Span(NamedTuple):
    """One recorded span (see the module docstring); ``end_ns`` is 0 while
    it is open."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: int


class Record:
    """What a ``recording()`` block saw: its spans in the order they opened
    (a span's ``parent`` indexes them) and its counters by name. The spans
    are kept in columns (no object a span, so the collector sees none) and
    ``spans`` builds them anew on each read."""

    def __init__(self):
        self.names: List[str] = []
        self.starts = array.array("q")
        self.ends = array.array("q")
        self.threads = array.array("q")
        self.parents = array.array("q")
        self.counters: Dict[str, int] = {}

    @property
    def spans(self) -> List[Span]:
        return [Span(*row) for row in zip(self.names, self.starts,
                                          self.ends, self.threads,
                                          self.parents)]


class _Close:
    """What ``span`` hands out while recording: its exit closes the
    innermost span open on the calling thread."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        state = getattr(_local, "state", None)
        if state and state[0]:
            record, index = state[0].pop()
            record.ends[index] = time.time_ns()
        return False


_CLOSE = _Close()


def _open(name: str, record: "Record") -> None:
    """Record the start of span ``name`` on the calling thread."""
    start = time.time_ns()
    try:
        stack, thread = _local.state
    except AttributeError:
        stack, thread = _local.state = [], threading.get_native_id()
    parent = stack[-1][1] if stack and stack[-1][0] is record else -1
    with _lock:
        index = len(record.names)
        record.names.append(name)
        record.starts.append(start)
        record.ends.append(0)
        record.threads.append(thread)
        record.parents.append(parent)
    stack.append((record, index))


def span(name: str):
    """``with span(name):`` records the block as a span while a
    ``recording()`` block is open; off, it returns one shared object that
    does nothing."""
    record = _record
    if record is None:
        return _OFF
    _open(name, record)
    return _CLOSE


class _Off:
    """The span handed out while nothing records: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording; else nothing."""
    record = _record
    if record is not None:
        with _lock:
            record.counters[name] = record.counters.get(name, 0) + n


def is_recording() -> bool:
    """Whether spans and counters are on (a call site that computes a
    counter's value asks first)."""
    return _record is not None


@contextlib.contextmanager
def recording():
    """``with recording() as rec:`` turns spans and counters on for every
    thread of the process until the block closes, and yields their
    ``Record``. A block opened inside another shares the outer record and
    leaves recording on when it closes."""
    global _record
    if _record is not None:
        yield _record
        return
    _record = Record()
    try:
        yield _record
    finally:
        _record = None


def _chrome_events(spans, base_ns: int) -> list:
    """Complete events (``"ph": "X"``) of closed spans on a Chrome trace's
    time base: microseconds after ``base_ns``."""
    pid = os.getpid()
    return [{"ph": "X", "cat": "span", "name": s.name, "pid": pid,
             "tid": s.thread, "ts": (s.start_ns - base_ns) * 1e-3,
             "dur": (s.end_ns - s.start_ns) * 1e-3}
            for s in spans if s.end_ns]


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """``with trace(dir): run_steps()``: a ``torch.profiler`` profile of the
    block's CPU activity, and its CUDA activity where CUDA is present,
    written on exit as a Chrome trace ``trace-<pid>-<ns>.json`` into
    ``logdir`` (default ``$TMPDIR/sph_nca_trace``; open it in Perfetto or
    chrome://tracing), with the program's spans recorded in the block
    beside the profiler's events (on the file's time base, its
    ``baseTimeNanoseconds``). Yields ``logdir``, as the JAX package's
    does."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "sph_nca_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    with recording() as rec:
        first = len(rec.names)
        prof.start()
        try:
            yield logdir
        finally:
            StepTimer._sync()
            prof.stop()
            path = os.path.join(
                logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
            doc["traceEvents"].extend(_chrome_events(
                rec.spans[first:], int(doc.get("baseTimeNanoseconds", 0))))
            with open(path, "w") as f:
                json.dump(doc, f)


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

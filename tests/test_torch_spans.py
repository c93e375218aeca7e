"""The port's spans and counters (``utils/profiling.py``): the recorder off
and on, its clock against ``torch.profiler``'s, and the spans of the
instrumented paths on the CPU at small sizes: the batched surface rollout,
the band passes and their table bytes, one trainer iteration, the band
engine's build, the kernel build's counter and ``trace()``'s export. No
span changes a number: the outputs with recording on and off are equal bit
for bit."""

import glob
import itertools
import json
import os
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from sph_nca_tpu_torch.models import surface as TS
from sph_nca_tpu_torch.models.nca import SPHNCAConfig, init_params
from sph_nca_tpu_torch.ops import _build
from sph_nca_tpu_torch.ops.bands import build_band_engine, pass_table_bytes
from sph_nca_tpu_torch.training.losses import MSELossConfig
from sph_nca_tpu_torch.training.pool import Pool
from sph_nca_tpu_torch.training.trainer import (
    TrainConfig,
    Trainer,
    make_mse_bundle,
)
from sph_nca_tpu_torch.utils import profiling as P
from sph_nca_tpu_torch.utils.meshes import fibonacci_sphere, sphere_normals

F = 16
STEP_SPANS = ("rollout.step", "step.perceive", "step.update", "step.mask",
              "rollout.diffuse")
TRAIN_SPANS = ("train.sample", "train.rank", "train.rollout", "train.loss",
               "train.backward", "train.optimizer", "train.pool_update",
               "train.sync")


def _names(rec):
    return [s.name for s in rec.spans]


# ---- the recorder -----------------------------------------------------------


def test_off_spans_are_one_shared_object_and_record_nothing():
    assert not P.is_recording()
    assert P.span("a") is P.span("b")
    with P.span("a"):
        P.count("c", 3)
    with P.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}
    assert not P.is_recording()
    # a record that outlives its block records nothing more
    with P.span("after"):
        P.count("after")
    assert rec.spans == [] and rec.counters == {}


def _peak_growth(body) -> int:
    """The traced memory's peak over 2000 calls of ``body`` above where it
    stood (an object freed at once raises the peak too), the least of five
    tries: another thread of the process may allocate meanwhile."""
    grown = []
    tracemalloc.start()
    try:
        for _ in range(5):
            calls = itertools.repeat(None, 2000)
            before = tracemalloc.get_traced_memory()[0]
            tracemalloc.reset_peak()
            for _ in calls:
                body()
            grown.append(tracemalloc.get_traced_memory()[1] - before)
    finally:
        tracemalloc.stop()
    return min(grown)


def test_off_spans_and_counts_allocate_nothing():
    """An off span and count cost no more memory than a ``with`` block on
    one shared object (the interpreter's own bound ``__exit__``); a span
    that made an object a call would."""
    span, count = P.span, P.count

    class Noop:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    shared = Noop()

    def off():
        with span("band.pass"):
            count("band.table_bytes", 4096)

    def with_shared():
        with shared:
            pass

    def with_fresh():
        with Noop():
            pass

    floor = _peak_growth(with_shared)
    assert _peak_growth(with_fresh) > floor  # the measure sees one object
    assert _peak_growth(off) <= floor


def test_spans_nest_with_parents_and_counters_add():
    with P.recording() as rec:
        assert P.is_recording()
        with P.span("a"):
            with P.span("b"):
                P.count("k")
            with P.span("c"):
                P.count("k", 4)
                with P.recording() as inner:  # shares the open record
                    with P.span("d"):
                        pass
                assert inner is rec and P.is_recording()
        with P.span("e"):
            pass
    assert not P.is_recording()
    assert _names(rec) == ["a", "b", "c", "d", "e"]
    assert [s.parent for s in rec.spans] == [-1, 0, 0, 2, -1]
    assert rec.counters == {"k": 5}
    a, b, c, d, e = rec.spans
    assert a.start_ns <= b.start_ns <= b.end_ns <= c.start_ns
    assert c.start_ns <= d.start_ns <= d.end_ns <= c.end_ns <= a.end_ns
    assert a.end_ns <= e.start_ns
    assert {s.thread for s in rec.spans} == {threading.get_native_id()}


def test_a_second_thread_keeps_its_own_id_and_parent_chain():
    seen = {}

    def work():
        seen["id"] = threading.get_native_id()
        with P.span("t.outer"):
            with P.span("t.inner"):
                P.count("t")

    with P.recording() as rec:
        with P.span("main"):
            th = threading.Thread(target=work)
            th.start()
            th.join(timeout=30)
            assert not th.is_alive()
            with P.span("main.child"):
                pass
    by = {s.name: (i, s) for i, s in enumerate(rec.spans)}
    main_id = threading.get_native_id()
    assert seen["id"] != main_id
    assert by["t.outer"][1].thread == by["t.inner"][1].thread == seen["id"]
    assert by["t.outer"][1].parent == -1
    assert by["t.inner"][1].parent == by["t.outer"][0]
    assert by["main.child"][1].parent == by["main"][0]
    assert by["main"][1].thread == main_id
    assert rec.counters == {"t": 1}


def test_spans_share_the_profilers_clock():
    """A span around a ``torch.mm`` brackets the profiler's ``aten::mm``
    event, both ends within 1 ms (the median of five)."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(64, 64)
    torch.mm(a, a)
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            P.recording() as rec:
        for _ in range(5):
            with P.span("mm"):
                torch.mm(a, a)
    events = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name() == "aten::mm")
    assert len(events) == 5 and len(rec.spans) == 5
    lead, lag = [], []
    for s, (start, end) in zip(rec.spans, events):
        assert s.start_ns <= start and end <= s.end_ns
        lead.append(start - s.start_ns)
        lag.append(s.end_ns - end)
    assert np.median(lead) < 1e6 and np.median(lag) < 1e6, (lead, lag)


# ---- the instrumented paths -------------------------------------------------


def _surface_scene():
    """A small sphere on a band engine with far tables, a random model and
    B = 2 initial states and tangents."""
    x = fibonacci_sphere(400, 0.8)
    nrm = sphere_normals(x)
    eng = build_band_engine(x, 0.25, block_rows=16, far_group=8,
                            device="cpu")
    assert len(eng.far_tabs) > 0
    cfg = SPHNCAConfig(channels=F, hidden=32, fire_rate=0.5,
                       normalize_perception=4.0)
    params = init_params(cfg, torch.Generator().manual_seed(3),
                         device="cpu")
    rng = np.random.default_rng(4)
    A0 = torch.from_numpy(rng.uniform(0, 1, (2, 400, F)).astype(np.float32))
    t = rng.normal(size=(2, 400, 3)).astype(np.float32)
    t -= nrm * np.sum(nrm * t, -1, keepdims=True)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    return (params, cfg, eng, A0, torch.from_numpy(nrm),
            torch.from_numpy(t))


def _surface_rollout(scene, steps=2):
    params, cfg, eng, A0, n, t = scene
    return TS.rollout_mesh_batched(params, cfg, eng, A0, n, t,
                                   torch.Generator().manual_seed(9), steps,
                                   0.25)


def test_surface_rollout_spans_and_table_bytes():
    scene = _surface_scene()
    eng = scene[2]
    off = _surface_rollout(scene)
    with P.recording() as rec:
        on = _surface_rollout(scene)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    names = _names(rec)
    assert names.count("rollout") == 1
    for name in STEP_SPANS:
        assert names.count(name) == 2, (name, names)
    # per step: two perception passes, the life mask's and the diffusion's
    assert names.count("band.pass") == 8
    parents = {names[s.parent] for s in rec.spans if s.name == "band.pass"}
    assert parents == {"step.perceive", "step.mask", "rollout.diffuse"}
    for s in rec.spans:
        if s.name in STEP_SPANS[1:]:
            assert names[s.parent] == "rollout.step"
    # the table columns each step reads: D + 3 column blocks of P (the
    # moments, the perception's life blur, the mask's, the diffusion's) of
    # every table row, band and far
    rows = sum(t.shape[0] * t.shape[1] for t in (eng.Tband, *eng.far_tabs))
    p, d = eng.slots_per_cell, eng.dim
    per_step = rows * (d + 3) * p * eng.Tband.element_size()
    assert rec.counters == {"band.table_bytes": 2 * per_step}
    assert pass_table_bytes(eng, slice(0, None)) == \
        rows * (d + 1) * p * eng.Tband.element_size()


def _trainer_run(i):
    m, h = 10, 0.3
    x2 = torch.stack(torch.meshgrid(torch.linspace(-0.9, 0.9, m),
                                    torch.linspace(-0.9, 0.9, m),
                                    indexing="ij"), -1).reshape(-1, 2)
    x = torch.nn.functional.pad(x2, (0, 1))
    cfg = SPHNCAConfig(channels=F, hidden=16, fire_rate=0.5,
                       normalize_perception=1.0 / h)
    img = np.random.default_rng(4).uniform(0, 1, (8, 8, 4)).astype(
        np.float32)
    loss = make_mse_bundle(torch.from_numpy(img), MSELossConfig(
        gmin=(-1, -1), gsize=(2, 2), image_scale=8 / m))
    tc = TrainConfig(batch_size=2, pool_size=4, steps_range=(2, 4),
                     steps_increment=0, aux_states=1, lr_decay_steps=10)
    seed_A = np.zeros((m * m, F), np.float32)
    seed_A[m * m // 2 + m // 2, 3:] = 1.0
    tr = Trainer(cfg, tc, build_band_engine(x, h, device="cpu"), x2, loss,
                 h)
    pool = Pool(x2.numpy(), seed_A, 4, rng=np.random.default_rng(0))
    return tr.run_iteration(i, pool), tr


def test_trainer_iteration_spans():
    loss_off, tr_off = _trainer_run(5)
    with P.recording() as rec:
        loss_on, tr_on = _trainer_run(5)
    assert loss_on == loss_off
    for a, b in zip(tr_off.params, tr_on.params):
        assert torch.equal(a, b)
    names = _names(rec)
    top = names.index("train.iteration")
    assert names.count("train.iteration") == 1
    children = [s.name for s in rec.spans if s.parent == top]
    assert children == list(TRAIN_SPANS)
    steps = tr_on.last_steps
    assert names.count("rollout.step") == steps
    # the backward recomputes each step under train.backward
    back = names.index("train.backward")
    redone = [s for s in rec.spans if s.name == "step.update"
              and names[s.parent] == "train.backward"]
    assert len(redone) == steps and names.count("step.update") == 2 * steps
    assert all(rec.spans[back].start_ns <= s.start_ns for s in redone)


def test_band_engine_build_spans():
    x = fibonacci_sphere(300, 0.8)
    with P.recording() as rec:
        eng = build_band_engine(x, 0.25, block_rows=16, far_group=8,
                                device="cpu")
    off = build_band_engine(x, 0.25, block_rows=16, far_group=8,
                            device="cpu")
    assert torch.equal(eng.Tband, off.Tband)
    assert all(torch.equal(a, b) for a, b in zip(eng.far_tabs, off.far_tabs))
    assert torch.equal(eng.gsum, off.gsum)
    assert _names(rec) == ["engine.build", "engine.scan", "engine.tables",
                           "engine.transfer"]
    assert [s.parent for s in rec.spans] == [-1, 0, 0, 0]


def test_kernel_builds_are_counted(tmp_path, monkeypatch):
    """``kernels.compiled`` counts the builds that run nvcc, not the ones
    that find the library."""
    lib = tmp_path / "libsph_nca_kernels_test.so"
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "library_path", lambda: lib)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    with P.recording() as rec:
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build()
        lib.write_bytes(b"")
        assert _build.build() == lib
    assert rec.counters == {"kernels.compiled": 1}


def test_trace_exports_the_spans(tmp_path):
    """``trace()``'s Chrome trace holds each step's ``rollout.step`` span
    on the file's time base: inside the rollout's ``aten::`` events, each
    with ``aten::`` events of its own thread inside it."""
    scene = _surface_scene()
    _surface_rollout(scene, 1)
    with P.trace(str(tmp_path)) as d:
        _surface_rollout(scene)
    (path,) = glob.glob(os.path.join(d, "trace-*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    aten = [e for e in events if e.get("name", "").startswith("aten::")
            and e.get("ph") == "X"]
    steps = [e for e in events if e.get("cat") == "span"
             and e["name"] == "rollout.step"]
    assert len(steps) == 2 and aten
    first = min(e["ts"] for e in aten)
    last = max(e["ts"] + e["dur"] for e in aten)
    for s in steps:
        assert s["ph"] == "X" and s["pid"] == os.getpid()
        assert first <= s["ts"] and s["ts"] + s["dur"] <= last
        inside = [e for e in aten if e["tid"] == s["tid"]
                  and s["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= s["ts"] + s["dur"]]
        assert inside
    assert {e["name"] for e in events if e.get("cat") == "span"} >= \
        set(STEP_SPANS) | {"rollout", "band.pass"}
    assert not P.is_recording()

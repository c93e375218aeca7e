"""The join of the program's spans with the device trace
(``benchmark/spans.py``) on hand-made events, its readers on a hand-made
record, and its measurement driven as on the card, on the CPU at a tiny
size, with the program's recorder and without it."""

from collections import namedtuple

import pytest

from benchmark import spans as SP

from test_bench_reference import RUNS

Span = namedtuple("Span", "name start_ns end_ns thread parent")
MAIN, WORKER = 100, 200


def _kernel(corr, start, end, name="k"):
    return (name, True, start, end, corr, 7)


def _launch(corr, t, thread=MAIN):
    return ("cudaLaunchKernel", False, t, t + 1, corr, thread)


def test_a_kernel_counts_in_every_span_open_at_its_launch():
    spans = [Span("outer", 0, 1000, MAIN, -1),
             Span("inner", 100, 400, MAIN, 0),
             Span("later", 500, 900, MAIN, 0)]
    events = [_launch(1, 200), _kernel(1, 300, 350),
              _launch(2, 450), _kernel(2, 460, 480),
              _launch(3, 2000), _kernel(3, 2100, 2200),
              # a host operator whose id equals a kernel's is no launch
              ("aten::mm", False, 600, 700, 4, MAIN), _kernel(4, 700, 710)]
    out = SP.attribute(events, spans, MAIN)
    names = out["names"]
    assert names["outer"]["device_s"] == pytest.approx(70e-9)
    assert names["inner"]["device_s"] == pytest.approx(50e-9)
    assert names["later"]["device_s"] == 0.0
    assert names["outer"]["count"] == 1
    assert names["inner"]["host_s"] == pytest.approx(300e-9)
    assert out["busy_s"] == pytest.approx(180e-9)
    assert out["attributed_s"] == pytest.approx(70e-9)


def test_a_launch_from_another_thread_counts_there_and_on_the_main():
    spans = [Span("train.backward", 0, 1000, MAIN, -1),
             Span("step.update", 200, 300, WORKER, -1),
             Span("elsewhere", 0, 1000, 300, -1)]
    events = [_launch(1, 250, WORKER), _kernel(1, 260, 290),
              _launch(2, 500, WORKER), _kernel(2, 510, 530)]
    names = SP.attribute(events, spans, MAIN)["names"]
    assert names["step.update"]["device_s"] == pytest.approx(30e-9)
    assert names["train.backward"]["device_s"] == pytest.approx(50e-9)
    assert names["elsewhere"]["device_s"] == 0.0


def test_an_idle_gap_over_half_a_span_counts_half():
    spans = [Span("rollout.step", 100, 300, MAIN, -1),
             Span("worker", 100, 300, WORKER, -1)]
    # busy [0, 200] and [400, 500]: the gap [200, 400] covers the span's
    # second half
    events = [_launch(1, 0), _kernel(1, 0, 150), _kernel(2, 120, 200),
              _kernel(3, 400, 500)]
    names = SP.attribute(events, spans, MAIN)["names"]
    assert names["rollout.step"]["idle_s"] == pytest.approx(100e-9)
    assert names["worker"]["idle_s"] == 0.0  # main-thread spans only


def test_the_innermost_open_span_skips_closed_siblings():
    spans = [Span("a", 0, 100, MAIN, -1), Span("b", 10, 20, MAIN, 0),
             Span("c", 30, 40, MAIN, 0), Span("d", 200, 300, MAIN, -1)]
    at = SP.OpenSpans(spans)
    assert at.names(MAIN, 50) == {"a"}
    assert at.names(MAIN, 35) == {"a", "c"}
    assert at.names(MAIN, 150) == set()
    assert at.names(WORKER, 35) == set()
    events = [_launch(1, 35), _kernel(1, 40, 50, "sph_mlp_kernel<float>"),
              _launch(2, 50), _kernel(2, 60, 70, "sph_mlp_kernel<float>"),
              _kernel(3, 80, 90, "sph_mlp_kernel<float>")]
    assert SP.launch_offsets(events, spans, "sph_mlp_kernel", "c") == [
        (True, 5), (False, None), (False, None)]


def _record(kind, **extra):
    rec = {"kind": kind, "steps": 4, "busy_s": 1.0,
           "spans": {n: {"count": 4, "host_s": 0.2, "device_s": 0.04,
                         "idle_s": 0.008}
                     for n in ("band.pass", "step.update",
                               "rollout.diffuse", "rollout.step",
                               "train.backward", "train.sync")},
           "counters": {"band.table_bytes": 8_000_000},
           "setup_spans": {"engine.scan": {"count": 1, "host_s": 0.5}},
           "setup_counters": {"kernels.compiled": 1}}
    rec.update(extra)
    return rec


def test_readers_on_a_hand_made_record():
    got = SP.read_all(_record("rollout"))
    assert got == pytest.approx({
        "band_pass_device_ms.rollout": 10.0, "band_table_mb.rollout": 2.0,
        "update_device_ms.rollout": 10.0, "diffuse_device_ms.rollout": 10.0,
        "step_idle_ms.rollout": 2.0, "engine_scan_s": 0.5,
        "kernel_builds": 1})
    got = SP.read_all(_record("train", setup_counters={}))
    assert got == pytest.approx({
        "step_idle_ms.train": 2.0, "backward_device_ms.train": 10.0,
        "sync_wait_ms.train": 50.0, "engine_scan_s": 0.5,
        "kernel_builds": 0})
    # no device events: the host's reading alone
    got = SP.read_all(_record("train", busy_s=0.0))
    assert set(got) == {"sync_wait_ms.train", "engine_scan_s",
                        "kernel_builds"}
    nothing = _record("rollout", spans=None, counters=None,
                      setup_spans=None, setup_counters=None)
    assert SP.read_all(nothing) == {}
    assert set(SP.READERS) == {
        "band_pass_device_ms.rollout", "band_table_mb.rollout",
        "update_device_ms.rollout", "diffuse_device_ms.rollout",
        "step_idle_ms.rollout", "step_idle_ms.train",
        "backward_device_ms.train", "sync_wait_ms.train", "engine_scan_s",
        "kernel_builds"}


@pytest.mark.parametrize("cell,size,seed", RUNS)
def test_the_measurement_with_and_without_the_recorder(cell, size, seed,
                                                       monkeypatch):
    """On the CPU (no device events): with the recorder the set-up's spans
    and every recorded window's spans; without it (a program that has no
    ``recording``) no span and no new reading, and the harness's readers
    give the same metrics."""
    from sph_nca_tpu_torch.utils import profiling

    run = dict(seconds=0.0, repeats=1, device="cpu", overrides=size)
    got = SP.measure(cell, seed, **run)
    # nothing builds CUDA kernels on the CPU; the warm-up runs band passes
    assert "kernels.compiled" not in got["setup_counters"]
    assert got["setup_counters"]["band.table_bytes"] > 0
    assert got["setup_spans"]["engine.build"]["count"] == 1
    on, off = got["traced"]["on"][0], got["traced"]["off"][0]
    step = "train.iteration" if "train" in cell else "rollout.step"
    assert on["spans"][step]["count"] >= 1 and "spans" not in off
    assert set(on["metrics"]) >= {"engine_scan_s", "kernel_builds"}
    assert on["kernels_per_step"] == off["kernels_per_step"]
    monkeypatch.delattr(profiling, "recording")
    bare = SP.measure(cell, seed, **run)
    assert bare["setup_spans"] is None and bare["setup_counters"] is None
    for side in ("on", "off"):
        row = bare["traced"][side][0]
        assert row["metrics"] == {} and "spans" not in row
        assert {n for n, v in row["old"].items() if v is not None} == \
            {n for n, v in on["old"].items() if v is not None}

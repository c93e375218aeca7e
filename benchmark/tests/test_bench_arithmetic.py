"""The yardstick's operation and byte counts on small hand-counted shapes,
and the readers on a hand-made record."""

import pytest

from benchmark import arithmetic as AR
from benchmark import harness as H

W = {"channels": 16, "hidden": 256, "mlp_inputs": 48, "mlp_outputs": 33}

def test_mlp_launch_counts_by_hand():
    # 10 rows, bfloat16: 10 x 48 inputs, 48 x 256 + 256 x 33 weights at 2
    # bytes, 289 float32 biases, 10 x 33 float32 outputs
    nbytes, ops = AR.mlp_launch(10, "bfloat16", W)
    assert nbytes == 10 * 48 * 2 + (12288 + 8448) * 2 + 4 * 289 + 4 * 330
    assert ops == 2 * 10 * (12288 + 8448)
    # 8 channels, 64 hidden, float32: 3 rows of 24, 24 x 64 + 64 x 17
    # weights, 81 biases, 3 x 17 outputs
    small = {"channels": 8, "hidden": 64, "mlp_inputs": 24,
             "mlp_outputs": 17}
    nbytes, ops = AR.mlp_launch(3, "float32", small)
    assert nbytes == 4 * (3 * 24 + 1536 + 1088 + 81 + 3 * 17)
    assert ops == 2 * 3 * (1536 + 1088)


def test_pair_pass_counts_by_hand():
    # 7 pairs, 5 rows, 2 columns, 3 weights a pair, float32
    nbytes, ops = AR.pair_pass(7, 5, 2, 3, "float32")
    assert nbytes == 7 * 3 * 4 + 5 * 2 * 4 + 4 * 5 * 2 * 3
    assert ops == 2 * 7 * 2 * 3


def test_least_time_takes_the_larger_bound():
    assert AR.least_s(3.35e12, 0, "float32") == pytest.approx(1.0)
    assert AR.least_s(0, 989e12, "bfloat16") == pytest.approx(1.0)
    assert AR.least_s(3.35e12, 2 * 495e12, "float32") == pytest.approx(2.0)


def test_step_flops_by_hand():
    # 10 pairs a particle on a surface: the MLP's 2 x 20736 and
    # 2 x 10 x (48 + 1 + 1 + 4)
    assert AR.model_flops_per_particle_step(10, True, W) == 41472 + 1080
    assert AR.model_flops_per_particle_step(10, False, W) == 41472 + 1000
    assert AR.step_passes(2, True, 16) == [(32, 3), (2, 1), (2, 1), (8, 1)]
    assert AR.step_passes(2, False, 8) == [(16, 3), (2, 1), (2, 1)]


def _record(kind):
    return {"kind": kind, "steps": 4, "kernels": 1000, "window_s": 2.0,
            "busy_s": 1.5, "bmm_s": 0.5, "pairs": 300, "points": 10,
            "batch": 2, "precision": "bfloat16", "surface": kind == "rollout",
            "traced_rate": 1e6, "untraced_rate": 2e6, "particle_steps": 4e6,
            "engine_build_s": 1.25, "widths": W,
            "per_kernel": {"void sph_mlp_kernel<float, 33>(float)": {
                "count": 4, "seconds": 4e-3}}}


def test_readers_on_a_hand_made_record():
    r = H.load_readers()
    rec = _record("rollout")
    assert r["kernels_per_step.rollout"].read(rec) == 250
    assert r["kernels_per_step.train"].read(rec) is None
    # the untraced window does the traced 4e6 particle-steps in 2 s
    assert r["idle_share.rollout"].read(rec) == pytest.approx(25.0)
    assert r["engine_build_s"].read(rec) == 1.25
    mlp = AR.least_s(*AR.mlp_launch(20, "bfloat16", W), "bfloat16")
    assert r["mlp_kernel_roofline.rollout"].read(rec) == pytest.approx(
        100 * mlp / 1e-3)
    least = sum(AR.least_s(*AR.pair_pass(300, 10, w, k, "bfloat16"),
                           "bfloat16")
                for w, k in AR.step_passes(2, True, 16))
    assert r["band_products_roofline.rollout"].read(rec) == pytest.approx(
        100 * least * 4 / 0.5)
    flops = AR.model_flops_per_particle_step(30, True, W)
    assert r["step_mfu.rollout"].read(rec) == pytest.approx(
        100 * flops * 2e6 / 989e12)
    assert r["wall_pps.rollout"].read(rec) == 2e6
    assert r["wall_pps.rollout"].read(_record("train")) is None
    train = _record("train")
    assert r["step_mfu.train"].read(train) == pytest.approx(
        3 * 100 * AR.model_flops_per_particle_step(30, False, W) * 2e6
        / 989e12)
    assert r["band_products_roofline.rollout"].read(train) is None


def test_readers_find_nothing_without_device_events():
    rec = {**_record("rollout"), "kernels": 0, "busy_s": 0.0, "bmm_s": 0.0,
           "per_kernel": {}}
    found = {n: m.read(rec) for n, m in H.load_readers().items()}
    # the host's clock reads these two without any device event
    assert {n for n, v in found.items() if v is not None} == \
        {"engine_build_s", "wall_pps.rollout"}


def test_the_trace_reduction_on_hand_made_events():
    from benchmark import trace as TR

    # (name, on the device, start us, end us, id, linked id)
    events = [("aten::bmm", False, 0.0, 10.0, 7, 0),
              ("aten::mul", False, 10.0, 40.0, 8, 0),
              ("aten::view", False, 20.0, 25.0, 9, 0),
              ("nvjet_gemm", True, 5.0, 15.0, 100, 7),
              ("void at::native::mul_kernel<float>(float*)", True, 15.0,
               20.0, 101, 8),
              ("Memcpy DtoD", True, 30.0, 32.0, 102, 8)]
    rec = TR.reduce_events(events, 1e-3)
    assert rec["kernels"] == 2 and rec["bmm_s"] == pytest.approx(10e-6)
    assert rec["busy_s"] == pytest.approx(17e-6)
    # the one gap, 20-30 us, is named by the innermost host event at 25 us
    assert rec["breakdown"]["idle_gaps"] == [["aten::view",
                                              pytest.approx(10e-6)]]
    assert rec["breakdown"]["device_ops"][0] == ["nvjet_gemm",
                                                 pytest.approx(10e-6)]
    assert TR.short("void at::native::mul_kernel<float>(float*)") == \
        "mul_kernel<float>"


def test_busy_seconds_by_hand():
    import numpy as np

    from benchmark import trace as TR

    # [0, 5) and [3, 8) overlap, [8, 9) touches, [10, 12) stands apart,
    # [4, 6) lies inside: busy 9 + 2 ns
    starts = np.array([10, 3, 0, 8, 4])
    ends = np.array([12, 8, 5, 9, 6])
    assert TR.busy_seconds(starts, ends) == pytest.approx(11e-9)
    assert TR.busy_seconds(starts[:0], ends[:0]) == 0.0

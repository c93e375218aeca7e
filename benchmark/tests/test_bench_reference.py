"""The plain reference against the port on the CPU at a tiny size: each
operator, one step, and whole cells run through the harness."""

import numpy as np
import pytest
import torch

from benchmark import harness as H
from benchmark.reference import geometry as GEO
from benchmark.reference import nca as REF
from benchmark.reference.sph import Operators, quantize

N, NEIGHBOURS = 2000, 30
SURFACE = dict(points=1500, batch=3, steps=12)
PLANE = dict(side=32, h=0.16, batch=4, pool_size=16)
# (cell, size, seed) of the CPU runs; at the plane's small size some seeds'
# random weights kill every particle within the first rollout, which leaves
# nothing to compare, so its seed is one whose states stay alive
RUNS = [("surface-band-b8", SURFACE, 2 ** 33 + 7),
        ("plane-train-b8", PLANE, 1)]
# a configuration of other widths than the flagship's
OTHER_WIDTHS = dict(channels=8, hidden=64, mlp_inputs=24, mlp_outputs=17)


@pytest.fixture(scope="module")
def cloud():
    x = GEO.fibonacci_sphere(N, 0.8)
    return x, GEO.h_for_neighbours(N, 0.8, NEIGHBOURS)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_operators_match_the_band_engine(cloud, precision):
    from sph_nca_tpu_torch.ops import bands as BD

    x, h = cloud
    eng = BD.build_band_engine(x, h, table_dtype=precision, device="cpu")
    ops = Operators(torch.from_numpy(x), h, precision)
    assert ops.pairs == int(eng.nbr_count.sum())
    A = torch.rand(2, N, 16, generator=torch.Generator().manual_seed(1))
    ga, sm = BD.perceive_band_samples(eng, eng.scatter(A), True, None)
    want = ops.gradient(A).permute(0, 1, 3, 2).reshape(2, N, 48)
    tol = {"float32": 1e-6, "bfloat16": 2e-3}[precision]
    assert H.rel_gap(eng.gather_back(ga), want) < tol
    sm_ref = ops.blur(REF.alive(A, precision, 0.1))
    assert H.rel_gap(eng.gather_back(sm[..., None]), sm_ref) < 10 * tol
    X = torch.rand(2, N, 4, generator=torch.Generator().manual_seed(2))
    blur = eng.gather_back(BD.blur_band_samples(eng, eng.scatter(X)))
    assert H.rel_gap(blur, ops.blur(X)) < tol


def test_band_ranks_are_the_engines_rows(cloud):
    from sph_nca_tpu_torch.ops import bands as BD

    x, h = cloud
    eng = BD.build_band_engine(x, h, device="cpu")
    rank, shape = GEO.band_ranks(x, h)
    assert np.array_equal(rank, eng.slot_of_particle.numpy())
    assert shape == tuple(eng.xs.shape[:2])


def test_quantize():
    t = torch.tensor([1.0 + 2 ** -12, 3.0, -0.1])
    assert torch.equal(quantize(t, "float32"), t)
    assert quantize(t, "bfloat16")[0] == 1.0
    assert quantize(t, "tf32")[0] == 1.0
    assert quantize(t, "tf32")[1] == 3.0
    q = quantize(t, "fp8")
    assert q[1] == 3.0 and abs(float(q[2]) + 0.1) < 0.01
    g = torch.ones(3, requires_grad=True)
    quantize(g * 2, "tf32").sum().backward()
    assert torch.equal(g.grad, torch.full((3,), 2.0))


@pytest.mark.parametrize("key,value", [
    ("update_rule", "orig"), ("smoothing", "wendlandC2"),
    ("gradient_kernel", "poly6"), ("optimizer", "sgd"), ("mlp_outputs", 16)])
def test_the_reference_refuses_a_rule_it_does_not_implement(key, value):
    spec = {**H.cell_spec("plane-train-b8"), key: value}
    with pytest.raises(ValueError):
        REF.rule_of(spec, 1.0)


@pytest.mark.parametrize("cell,size,seed", [
    (cell, {**size, **OTHER_WIDTHS}, seed) for cell, size, seed in RUNS])
def test_a_run_takes_its_widths_from_the_configuration(cell, size, seed):
    out = H.run_cell(cell, seed, 0.0, False, device="cpu", overrides=size,
                     min_units=2)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell,size,seed", RUNS)
def test_a_sound_run_is_correct(cell, size, seed):
    out = H.run_cell(cell, seed, 0.0, False, device="cpu", overrides=size,
                     min_units=2)
    assert out["correct"], out["checks"]
    assert out["metrics"]["setup_s"]["value"] > 0

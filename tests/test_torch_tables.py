"""Port parity: the pair-table engine and the table passes (forward, adjoint,
life-mask blur, SPH blur, one full step) against the JAX package, whose Pallas
table kernels run in interpret mode on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernels are held against those on the card by tests/test_torch_cuda.py and
chip_smoke.py.

Tolerances. Tables: both packages evaluate the same f32 formula, XLA with some
products contracted into FMAs, so f32 tables agree to a few ulp of the
largest entry (1e-6 of it; measured ~2e-7; small entries near the support's
edge, where h - d cancels, differ by more of their own ulps). A bf16 entry
rounds the same way unless its f32 value lies that close to a rounding
midpoint: such entries (measured 0-4 of 1,500-6,700 nonzero entries a
bucket) differ by one bf16 ulp of themselves, and every bf16 table holds to
1e-5 of its largest entry (measured ~2e-8). gsum comes from the tables by a
window sum: 1e-6 of max |gsum|. The passes are sums over the same tables in
another order: 1e-5 of the largest output. A constant field cancels in the
forward to f32 rounding: |gA| < 1e-4 (O(0.05) without the quantized gsum).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sph_nca_tpu.models import SPHNCAConfig as JaxConfig
from sph_nca_tpu.models import init_params as jax_init_params
from sph_nca_tpu.models.cell_step import nca_step_cells as jax_step
from sph_nca_tpu.ops import batched as JB
from sph_nca_tpu.ops.cells import build_cell_engine as jax_build
from sph_nca_tpu.ops.pallas import pair_kernel as JP
from sph_nca_tpu_torch.io.convert import params_from_jax_numpy
from sph_nca_tpu_torch.models.cell_step import nca_step_cells
from sph_nca_tpu_torch.models.nca import SPHNCAConfig
from sph_nca_tpu_torch.ops import batched as TB
from sph_nca_tpu_torch.ops import pair_kernel as TP
from sph_nca_tpu_torch.ops.cells import build_cell_engine

TAB_RTOL = 1e-6  # f32 tables and gsum, of the largest entry
RTOL = 1e-5  # the passes, of the largest output

SCENES = {  # (points, dim, h, periodic)
    "3d": (250, 3, 0.3, False),
    "2d-periodic": (300, 2, 0.25, True),
}


@functools.cache
def _engines(scene, dtype):
    n, dim, h, periodic = SCENES[scene]
    x = np.random.default_rng(0).uniform(-1, 1, (n, dim)).astype(np.float32)
    period = [2.0] * dim if periodic else None
    je = jax_build(jnp.asarray(x), h, xla_tables=False, pair_tables=dtype,
                   period=None if period is None else jnp.asarray(period))
    te = build_cell_engine(x, h, period=period, pair_tables=dtype,
                           device="cpu")
    assert te.blk_xs.shape[0] > 0 and te.blk2_xs.shape[0] > 0
    return je, te


@pytest.fixture(scope="module",
                params=[(s, d) for s in SCENES for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def engines(request):
    return _engines(*request.param)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def engines3d(request):
    return _engines("3d", request.param)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, rtol, mask=None):
    got, want = np.asarray(got), np.asarray(want)
    if mask is not None:
        got, want = got[mask], want[mask]
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * scale, (err, scale)


def _real(te):
    return te.vs.numpy() > 0


def test_tables_match_jax(engines):
    """The tables on real rows; pad rows are zero in the port (the JAX build
    keeps phantom pairs there between a pad slot and the union window's
    unused entries, which read cell 0's volumes at PAD_POS)."""
    je, te = engines
    d = te.xs.shape[-1]
    real = _real(te).reshape(-1, 64)
    nb1 = te.blk_xs.shape[0]
    for jt, tt, rows in ((je.blk_md, te.blk_md, np.tile(real[:nb1], (1, d))),
                         (je.blk_w6, te.blk_w6, real[:nb1]),
                         (je.blk2_md, te.blk2_md, np.tile(real[nb1:], (1, d))),
                         (je.blk2_w6, te.blk2_w6, real[nb1:])):
        assert tt.dtype == getattr(torch, str(jt.dtype))
        assert tuple(tt.shape) == tuple(jt.shape)
        assert torch.all(tt[torch.from_numpy(~rows)] == 0)
        want = np.asarray(jt.astype(jnp.float32))[rows]
        got = tt.float().numpy()[rows]
        if tt.dtype == torch.float32:
            _close(got, want, TAB_RTOL)
        else:
            _close(got, want, RTOL)
            diff = got != want
            ulp = np.abs(want[diff]) * 2.0 ** -7  # one bf16 ulp, or less
            assert np.all(np.abs(got[diff] - want[diff]) <= ulp)
    # gsum re-derived from the quantized table; nothing on pad slots
    _close(te.gsum.numpy(), je.gsum, TAB_RTOL, _real(te))
    assert torch.all(te.gsum[te.vs == 0] == 0)


def test_no_tables_keeps_the_engine():
    """pair_tables=None builds the recompute engine exactly as before."""
    x = np.random.default_rng(0).uniform(-1, 1, (250, 3)).astype(np.float32)
    base = build_cell_engine(x, 0.3, device="cpu")
    tab = build_cell_engine(x, 0.3, pair_tables="bfloat16", device="cpu")
    assert base.blk_md is None and base.blk2_w6 is None
    for name in ("slot_of_particle", "xs", "vs", "blk_xs", "blk_xw",
                 "blk2_vw", "blk_win_cells"):
        assert torch.equal(getattr(base, name), getattr(tab, name))


def test_forward_matches_pallas(engines):
    je, te = engines
    c, m, _ = te.xs.shape
    S = _normal((c, m, 16), 1)
    ga_j, sm_j = JP.fused_perception_pallas(je, jnp.asarray(S),
                                            use_alpha=True, d_major=True)
    ga_t, sm_t = TP.fused_perception(te, torch.from_numpy(S), d_major=True)
    real = _real(te)
    _close(ga_t.numpy(), ga_j, RTOL, real)
    _close(sm_t.numpy(), sm_j, RTOL, real)
    # pad rows come out as exact zeros
    assert torch.all(ga_t[te.vs == 0] == 0) and torch.all(sm_t[te.vs == 0] == 0)


def test_constant_field_cancels(engines3d):
    _, te = engines3d
    S = te.scatter(torch.full((te.num_particles, 16), 1.7))
    ga, _ = TP.fused_perception(te, S, d_major=True)
    assert float(te.gather_back(ga).abs().max()) < 1e-4


def test_adjoint_matches_pallas(engines):
    je, te = engines
    c, m, d = te.xs.shape
    G = _normal((c, m, d * 16), 2)
    want = JP.gradient_adjoint_dmajor_pallas(je, je.gsum, jnp.asarray(G))
    got = TP.gradient_adjoint_dmajor(te, torch.from_numpy(G))
    _close(got.numpy(), want, RTOL, _real(te))
    assert torch.all(got[te.vs == 0] == 0)


@pytest.mark.parametrize("use_alpha", [True, False])
def test_function_grad_matches_jax(engines3d, use_alpha):
    """The gradient through perceive_cells ([C, M, F, D] layout) and its
    custom backward (the table adjoint) against jax.grad through the JAX
    package's perceive_cells."""
    je, te = engines3d
    c, m, d = te.xs.shape
    S = _normal((c, m, 16), 3)
    R = _normal((c, m, 16, d), 4)
    R[~_real(te)] = 0.0  # no cotangent on pad rows, as a loss gives

    def jloss(s):
        ga, sm = JP.perceive_cells(je, s, use_alpha)
        return jnp.sum(ga * R) + jnp.sum(sm)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(S)))
    St = torch.from_numpy(S).requires_grad_(True)
    ga, sm = TP.perceive_cells(te, St, use_alpha)
    assert ga.shape == (c, m, 16, d) and not sm.requires_grad
    (torch.sum(ga * torch.from_numpy(R)) + sm.sum()).backward()
    _close(St.grad.numpy(), want, RTOL)


@pytest.mark.parametrize("use_alpha", [True, False])
def test_mask_blur_matches_pallas(engines3d, use_alpha):
    je, te = engines3d
    c, m, _ = te.xs.shape
    S = _normal((c, m, 16), 5)
    want = JP.mask_blur_pallas(je, jnp.asarray(S), use_alpha=use_alpha)
    got = TP.mask_blur(te, torch.from_numpy(S), use_alpha=use_alpha)
    _close(got.numpy(), want, RTOL, _real(te))
    assert torch.all(got[te.vs == 0] == 0)


def test_blur_matches_pallas(engines):
    je, te = engines
    c, m, _ = te.xs.shape
    X = _normal((c, m, 4), 6)
    want = JP.blur_cells_pallas(je, jnp.asarray(X))
    got = TP.blur_cells(te, torch.from_numpy(X))
    _close(got.numpy(), want, RTOL, _real(te))
    assert torch.all(got[te.vs == 0] == 0)


def test_blur_batched_matches_jax(engines):
    """The batched blur (B = 3 samples of K = 4 lanes, the tangent
    diffusion's, in the lane layout [C, M, B*K]) against the JAX package's
    blur_batched: f32 tables within 1e-5 of max; bf16 tables within 1e-2 of
    max, since JAX rounds v X to bf16 before its product where the port keeps
    it f32 (the bf16 level of tests/test_torch_batched.py). Pad rows 0."""
    je, te = engines
    c, m, _ = te.xs.shape
    XB = _normal((c, m, 3 * 4), 10)
    want = JB.blur_batched(je, jnp.asarray(XB), 3)
    got = TB.blur_batched(te, torch.from_numpy(XB), 3)
    rtol = RTOL if te.blk_w6.dtype == torch.float32 else 1e-2
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.numpy(), want, rtol, _real(te))
    assert torch.all(got[te.vs == 0] == 0)


def test_blur_needs_tables():
    x = np.random.default_rng(0).uniform(-1, 1, (100, 3)).astype(np.float32)
    eng = build_cell_engine(x, 0.3, device="cpu")
    with pytest.raises(ValueError, match="pair tables"):
        TP.blur_cells(eng, torch.zeros(*eng.xs.shape[:2], 4))


def test_batch_axis_equals_per_sample(engines3d):
    _, te = engines3d
    c, m, _ = te.xs.shape
    S = torch.from_numpy(_normal((3, c, m, 16), 7))
    G = torch.from_numpy(_normal((3, c, m, 48), 8))
    X = torch.from_numpy(_normal((3, c, m, 4), 9))
    ga, sm = TP.fused_perception(te, S, d_major=True)
    mk = TP.mask_blur(te, S)
    da = TP.gradient_adjoint_dmajor(te, G)
    bl = TP.blur_cells(te, X)
    for b in range(3):
        ga1, sm1 = TP.fused_perception(te, S[b], d_major=True)
        torch.testing.assert_close(ga[b], ga1, rtol=0, atol=1e-6)
        torch.testing.assert_close(sm[b], sm1, rtol=0, atol=1e-6)
        torch.testing.assert_close(mk[b], TP.mask_blur(te, S[b]), rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(
            da[b], TP.gradient_adjoint_dmajor(te, G[b]), rtol=0, atol=1e-6)
        torch.testing.assert_close(bl[b], TP.blur_cells(te, X[b]), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_step_matches_jax(dtype):
    """One NCA step on a table engine (fire_rate 1) against the JAX step."""
    je, te = _engines("2d-periodic", dtype)
    h = SCENES["2d-periodic"][2]
    jcfg = JaxConfig(channels=8, hidden=32, normalize_perception=1.0 / h)
    jp = jax_init_params(jax.random.key(0), jcfg)
    tp = params_from_jax_numpy(*(np.asarray(a) for a in jp), device="cpu")
    cfg = SPHNCAConfig(channels=8, hidden=32, normalize_perception=1.0 / h)
    A = (np.random.default_rng(10).random((te.num_particles, 8)) * 0.5
         ).astype(np.float32)
    want = je.gather_back(jax_step(jp, jcfg, je, je.scatter(jnp.asarray(A)),
                                   jax.random.key(1), h, fire_rate=1.0))
    gen = torch.Generator().manual_seed(0)
    got = te.gather_back(nca_step_cells(tp, cfg, te,
                                        te.scatter(torch.from_numpy(A)), gen,
                                        h, fire_rate=1.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)

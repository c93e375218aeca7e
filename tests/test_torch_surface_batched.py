"""Port parity: the batched surface rollouts on the cell engine
(``rollout_mesh_batched``, ``rollout_mesh_batched_dual`` and their pieces in
``models/surface.py``), the w6-only engine and the tangent pre-diffusion of the
random surface seed, against the JAX package.

The JAX side runs on cell engines with float32 (or bfloat16) pair tables, its
update MLP through its Pallas kernel in interpret mode (its module default is
set to ``"pallas"``, the implementation the port carries, for each test); the
port's wrappers run their plain PyTorch versions. Fire masks come from
different RNG streams in the two packages, so rollouts run at fire_rate 1.0.

Tolerances. The diffusion is a blur over the same float32 table in another
order, then a normalization: 1e-5 absolute on unit tangents. A 3-step batched
rollout holds the final states and tangents to 1e-4 absolute (|A| <~ 1, unit
tangents), against the JAX package and against B runs of the port's
unbatched ``rollout_mesh_cells``. With bfloat16 tables and MLP the JAX
package rounds the perception, the table products' right-hand sides and the
normals to bfloat16 where the port keeps float32 (a documented deviation):
one step is held to 1e-2 of the largest state, the bfloat16 level of the
batched-lane tests, and its unit tangents to 1e-2 absolute; with alpha on
and random tangents, by share rules past those limits. The
pre-diffusion on a cell engine against the JAX package's on a band engine:
1e-4 absolute after 3 passes (the same blur over tables of another layout,
renormalized each pass). The states' alpha lane is kept 0.005 away from the
alive threshold 0.1.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import sph_nca_tpu.models.cell_step as JCS
from sph_nca_tpu.models import SPHNCAConfig as JaxConfig
from sph_nca_tpu.models import init_params as jax_init_params
from sph_nca_tpu.models import surface as JS
from sph_nca_tpu.ops.bands import build_band_engine as jax_build_band
from sph_nca_tpu.ops.cells import build_cell_engine as jax_build
from sph_nca_tpu.utils import meshes as JM
from sph_nca_tpu_torch.io.convert import params_from_jax_numpy
from sph_nca_tpu_torch.models import cell_step as TCS
from sph_nca_tpu_torch.models import surface as TS
from sph_nca_tpu_torch.models.nca import SPHNCAConfig
from sph_nca_tpu_torch.ops import batched as TB
from sph_nca_tpu_torch.ops.cells import build_cell_engine
from sph_nca_tpu_torch.ops.mlp_kernel import project_td
from sph_nca_tpu_torch.utils.seeds import prediffuse_tangents

# tests/test_torch_surface.py's scene: a sphere of 1200 points, h = 0.22
N, H, F, B, STEPS = 1200, 0.22, 16, 2, 3
H_DIFFUSE = 0.3
ATOL = 1e-4
DIFFUSE_ATOL = 1e-5
BF16_RTOL = 1e-2
# bfloat16 share rules (test_bf16_step_share_alpha_random_tangents): the
# share of state values, and of tangent rows, past BF16_RTOL
BF16_STEP_SHARE = 0.005
TANGENT_SHARE = 0.05


@functools.cache
def _sphere(dtype="float32"):
    x = JM.fibonacci_sphere(N, 0.8)
    nrm = JM.sphere_normals(x)
    je = jax_build(jnp.asarray(x), H, xla_tables=False, pair_tables=dtype)
    te = build_cell_engine(x, H, pair_tables=dtype, device="cpu")
    return x, nrm, je, te


@pytest.fixture
def pallas_mlp(monkeypatch):
    monkeypatch.setattr(JCS, "_MLP_IMPL_DEFAULT", "pallas")


def _inputs(seed, b=B):
    """States [b, N, F] (alpha kept 0.005 away from 0.1) and unit tangents
    [b, N, 3] orthogonal to the sphere's normals."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-0.5, 1.0, (b, N, F)).astype(np.float32)
    a = A[..., 3]
    near = np.abs(a - 0.1) < 0.005
    A[..., 3] = np.where(near, np.where(a < 0.1, 0.09, 0.11), a)
    nrm = JM.sphere_normals(JM.fibonacci_sphere(N, 0.8))
    t = rng.normal(size=(b, N, 3)).astype(np.float32)
    t = np.stack([np.asarray(JS.orthogonalize(jnp.asarray(nrm),
                                              jnp.asarray(ti))) for ti in t])
    return A, t


def _model(hidden=32, use_alpha=True):
    kw = dict(channels=F, hidden=hidden, fire_rate=1.0, use_alpha=use_alpha,
              normalize_perception=1.0 / H)
    jcfg, cfg = JaxConfig(**kw), SPHNCAConfig(**kw)
    jp = jax_init_params(jax.random.key(0), jcfg)
    tp = params_from_jax_numpy(*(np.asarray(a) for a in jp), device="cpu")
    return jcfg, jp, cfg, tp


def _close(got, want, atol):
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert err <= atol, err


def test_diffuse_batched_matches_jax():
    """The sample-layout diffusion ``_diffuse_td`` against the JAX package's
    ``diffuse_batched``, the layouts converted here."""
    x, nrm, je, te = _sphere()
    A, t = _inputs(1)
    SB = TB.batched_scatter(te, torch.from_numpy(A))
    nc = te.scatter(torch.from_numpy(nrm))
    tB = torch.cat([TB.batched_scatter(te, torch.from_numpy(t[..., i:i + 1]))
                    for i in range(3)], dim=-1)  # [C, M, 3B] d-major blocks
    td = tuple(tB[..., i * B:(i + 1) * B].permute(2, 0, 1) for i in range(3))
    for lerp, wm in ((1.0, 1.0), (0.0, 0.5)):
        want = JS.diffuse_batched(je, jnp.asarray(nc.numpy()),
                                  jnp.asarray(tB.numpy()),
                                  jnp.asarray(SB.numpy()), B,
                                  lerp_multiplier=lerp, w_multiplier=wm)
        out = TS._diffuse_td(te, TS.normal_components(nc), td,
                             TB.to_samples(SB, B), lerp_multiplier=lerp,
                             w_multiplier=wm)
        got = torch.cat([ti.permute(1, 2, 0) for ti in out], dim=-1)
        assert got.shape == tB.shape
        _close(got.numpy(), want, DIFFUSE_ATOL)


def test_project_tangent_space_lanes_matches_jax():
    """The sample-layout projection ``project_td`` against the JAX
    package's ``project_tangent_space_lanes``, the layouts converted here;
    without the normal block it gives the first two blocks."""
    x, nrm, je, te = _sphere()
    rng = np.random.default_rng(2)
    c, m = te.xs.shape[:2]
    gaB = rng.normal(size=(c, m, 3 * B * F)).astype(np.float32)
    nc = te.scatter(torch.from_numpy(nrm))
    tc = te.scatter(torch.from_numpy(_inputs(3, 1)[1][0]))
    want = JS.project_tangent_space_lanes(
        jnp.asarray(gaB), jnp.asarray(nc.numpy()), jnp.asarray(tc.numpy()), B)
    want = TB.lanes_to_dmajor(torch.from_numpy(np.asarray(want)), B, 3)
    ga = TB.lanes_to_dmajor(torch.from_numpy(gaB), B, 3)
    nd = TS.normal_components(nc)
    td = TS.normal_components(tc.expand(B, -1, -1, -1))
    got = project_td(ga, nd, td)
    assert got.shape == ga.shape
    _close(got.numpy(), want.numpy(), 1e-5)
    two = project_td(ga, nd, td, include_normal=False)
    _close(two.numpy(), want[..., :2 * F].numpy(), 1e-5)


def test_rollout_mesh_batched_matches_jax(pallas_mlp):
    x, nrm, je, te = _sphere()
    jcfg, jp, cfg, tp = _model()
    A, t = _inputs(4)
    want_A, want_T = JS.rollout_mesh_batched(
        jp, jcfg, je, jnp.asarray(A), jnp.asarray(nrm), jnp.asarray(t),
        jax.random.key(1), STEPS, H, fire_rate=1.0)
    got_A, got_T, states = TS.rollout_mesh_batched(
        tp, cfg, te, torch.from_numpy(A), torch.from_numpy(nrm),
        torch.from_numpy(t), torch.Generator(), STEPS, H, fire_rate=1.0,
        collect_all=True)
    assert got_A.shape == (B, N, F) and got_T.shape == (B, N, 3)
    assert states.shape == (STEPS + 1, B, N, F)
    assert torch.equal(states[0], torch.from_numpy(A))
    assert torch.equal(states[-1], got_A)
    _close(got_A.numpy(), want_A, ATOL)
    _close(got_T.numpy(), want_T, ATOL)
    assert float(got_T.norm(dim=-1).max()) <= 1.0 + 1e-5


def test_rollout_mesh_batched_equals_per_sample():
    """B batched rollouts against B runs of the unbatched rollout_mesh_cells
    (tests/test_batched.py's check of the JAX package)."""
    x, nrm, je, te = _sphere()
    _, _, cfg, tp = _model()
    A, t = _inputs(5)
    got_A, got_T = TS.rollout_mesh_batched(
        tp, cfg, te, torch.from_numpy(A), torch.from_numpy(nrm),
        torch.from_numpy(t), torch.Generator(), STEPS, H, fire_rate=1.0)
    for b in range(B):
        ra, rt, _ = TS.rollout_mesh_cells(
            tp, cfg, te, torch.from_numpy(A[b]), torch.from_numpy(nrm),
            torch.from_numpy(t[b]), torch.Generator(), STEPS, H,
            fire_rate=1.0)
        _close(got_A[b].numpy(), ra.numpy(), ATOL)
        _close(got_T[b].numpy(), rt.numpy(), ATOL)


def test_rollout_mesh_batched_dual_matches_jax(pallas_mlp):
    """Perception at h = 0.22, the diffusion on a second engine at 0.3 (the
    port's a w6-only engine), against the JAX package's dual rollout on two
    cell engines; eng_d is eng runs the one-engine rollout."""
    x, nrm, je, te = _sphere()
    jcfg, jp, cfg, tp = _model()
    A, t = _inputs(6)
    je_d = jax_build(jnp.asarray(x), H_DIFFUSE, xla_tables=False,
                     pair_tables="float32")
    te_d = build_cell_engine(x, H_DIFFUSE, pair_tables="float32",
                             w6_only=True, device="cpu")
    assert te_d.blk_md is None and te_d.blk2_md is None
    assert te_d.blk_w6.shape == te_d.blk_vw.shape[:1] + (64,) + \
        te_d.blk_vw.shape[1:]
    want_A, want_T, want_states = JS.rollout_mesh_batched_dual(
        jp, jcfg, je, je_d, jnp.asarray(A), jnp.asarray(nrm), jnp.asarray(t),
        jax.random.key(1), STEPS, H, fire_rate=1.0, collect_all=True)
    got_A, got_T, states = TS.rollout_mesh_batched_dual(
        tp, cfg, te, te_d, torch.from_numpy(A), torch.from_numpy(nrm),
        torch.from_numpy(t), torch.Generator(), STEPS, H, fire_rate=1.0,
        collect_all=True)
    _close(got_A.numpy(), want_A, ATOL)
    _close(got_T.numpy(), want_T, ATOL)
    _close(states.numpy(), want_states, ATOL)
    same = TS.rollout_mesh_batched_dual(
        tp, cfg, te, te, torch.from_numpy(A), torch.from_numpy(nrm),
        torch.from_numpy(t), torch.Generator(), STEPS, H, fire_rate=1.0)
    one = TS.rollout_mesh_batched(
        tp, cfg, te, torch.from_numpy(A), torch.from_numpy(nrm),
        torch.from_numpy(t), torch.Generator(), STEPS, H, fire_rate=1.0)
    assert all(torch.equal(a, b) for a, b in zip(same, one))
    assert not torch.equal(same[1], got_T)  # the radius matters


def test_slot_maps_keep_pads_zero():
    x, nrm, je, te = _sphere()
    te_d = build_cell_engine(x, H_DIFFUSE, pair_tables="float32",
                             w6_only=True, device="cpu")
    to_d, from_d = TS._slot_maps(te, te_d)
    X = torch.randn(B, te.num_cells, te.slots_per_cell, 4)
    Xd = TS._permute(X, to_d, te_d)
    real_d = (te_d.vs > 0)
    assert bool((Xd[:, ~real_d] == 0).all())
    assert torch.equal(te_d.gather_back(Xd), te.gather_back(X))
    back = TS._permute(Xd, from_d, te)
    assert torch.equal(te.gather_back(back), te.gather_back(X))
    assert bool((back[:, ~(te.vs > 0)] == 0).all())
    small = build_cell_engine(x[:600], H_DIFFUSE, pair_tables="float32",
                              w6_only=True, device="cpu")
    with pytest.raises(ValueError, match="particles"):
        TS._slot_maps(te, small)


def test_bf16_step_matches_jax(pallas_mlp):
    """One step with bfloat16 tables and a bfloat16 MLP (the bench
    configuration's numerics) against the JAX package at bfloat16 level.
    The model runs without alpha, as the stripes texture model does: with
    bfloat16 tables the JAX package tests alive in bfloat16 where the port
    tests it in float32 (a documented deviation), so a slot whose blurred
    alive share lies within that rounding of 0.1 lives in one package and
    dies in the other (8 of the 2400 rows of this scene with alpha on).
    The tangent fields are smooth, as the CLI's seeds are: the JAX package
    rounds m t to bfloat16 before the diffusion blur, and where random
    per-slot tangents cancel in the blurred sum the normalization amplifies
    that rounding (0.27 at one slot of this scene)."""
    x, nrm, je, te = _sphere("bfloat16")
    jcfg, jp, cfg, tp = _model(use_alpha=False)
    A, _ = _inputs(7)
    t = np.stack([np.asarray(JS.orthogonalize(
        jnp.asarray(nrm), jnp.broadcast_to(jnp.asarray(v, jnp.float32),
                                           (N, 3))))
        for v in ([1, 1, 1], [1, -1, 0.5])])
    want_A, want_T = JS.rollout_mesh_batched(
        jp, jcfg, je, jnp.asarray(A), jnp.asarray(nrm), jnp.asarray(t),
        jax.random.key(1), 1, H, fire_rate=1.0, mlp_dtype="bfloat16")
    got_A, got_T = TS.rollout_mesh_batched(
        tp, cfg, te, torch.from_numpy(A), torch.from_numpy(nrm),
        torch.from_numpy(t), torch.Generator(), 1, H, fire_rate=1.0,
        mlp_dtype="bfloat16")
    want_A = np.asarray(want_A, np.float32)
    _close(got_A.numpy(), want_A, BF16_RTOL * float(np.abs(want_A).max()))
    _close(got_T.numpy(), np.asarray(want_T, np.float32), BF16_RTOL)


def test_bf16_step_share_alpha_random_tangents(pallas_mlp):
    """The inputs the smooth-field case above avoids: alpha on and random
    per-slot tangents, one bfloat16 step against the JAX package, held by
    share rules. States: at most BF16_STEP_SHARE of the values past 1e-2 of
    the largest (the rows whose life mask flips, 8 of 2400 here: 0.33% of
    the values measured). Tangents: at most TANGENT_SHARE of the (point,
    sample) rows with a component past 1e-2 (94 of 2400 measured, 3.9%):
    where the blurred m t and the lerp toward the old tangent nearly cancel,
    the renormalization amplifies bfloat16-level differences of the states
    and the blur's inputs. The other rows hold to 1e-2, as above."""
    x, nrm, je, te = _sphere("bfloat16")
    jcfg, jp, cfg, tp = _model(use_alpha=True)
    A, t = _inputs(7)
    want_A, want_T = JS.rollout_mesh_batched(
        jp, jcfg, je, jnp.asarray(A), jnp.asarray(nrm), jnp.asarray(t),
        jax.random.key(1), 1, H, fire_rate=1.0, mlp_dtype="bfloat16")
    got_A, got_T = TS.rollout_mesh_batched(
        tp, cfg, te, torch.from_numpy(A), torch.from_numpy(nrm),
        torch.from_numpy(t), torch.Generator(), 1, H, fire_rate=1.0,
        mlp_dtype="bfloat16")
    want_A = np.asarray(want_A, np.float32)
    dA = np.abs(got_A.numpy() - want_A)
    share_A = float(np.mean(dA > BF16_RTOL * float(np.abs(want_A).max())))
    assert share_A <= BF16_STEP_SHARE, share_A
    dT = np.abs(got_T.numpy() - np.asarray(want_T, np.float32))
    share_T = float(np.mean((dT > BF16_RTOL).any(-1)))
    assert share_T <= TANGENT_SHARE, share_T
    assert float(got_T.norm(dim=-1).max()) <= 1.0 + 1e-5


@pytest.mark.parametrize("dual", [False, True])
def test_batched_rollout_grads_remat(dual):
    """The rollout is differentiable in A0 and the parameters, the tangents
    detached; remat recomputes each step in the backward and gives the same
    gradients."""
    x, nrm, je, te = _sphere()
    _, _, cfg, tp = _model()
    A, t = _inputs(8)
    eng_d = (build_cell_engine(x, H_DIFFUSE, pair_tables="float32",
                               w6_only=True, device="cpu") if dual else te)
    R = torch.from_numpy(np.random.default_rng(9).normal(
        size=(B, N, F)).astype(np.float32))
    grads = {}
    for remat in (False, True):
        params = type(tp)(*(q.detach().clone().requires_grad_(True)
                            for q in tp))
        A0 = torch.from_numpy(A).requires_grad_(True)
        fA, fT = TS.rollout_mesh_batched_dual(
            params, cfg, te, eng_d, A0, torch.from_numpy(nrm),
            torch.from_numpy(t), torch.Generator(), STEPS, H, fire_rate=1.0,
            remat=remat)
        assert not fT.requires_grad
        (fA * R).sum().backward()
        grads[remat] = [A0.grad] + [q.grad for q in params]
    for a, b in zip(grads[False], grads[True]):
        assert a is not None and float(a.abs().max()) > 0
        _close(b.numpy(), a.numpy(), 1e-6 * float(a.abs().max()))


def test_batched_step_takes_a_sample_transform():
    """``_step_samples`` hands the transform the per-sample d-major gradient
    [B, C, M, D*F] and takes [B, C, M, 2F] back; the lane-layout step wraps
    a transform of the JAX layout into one of these."""
    x, nrm, je, te = _sphere()
    _, _, cfg, tp = _model()
    A, _ = _inputs(10)
    S = te.scatter(torch.from_numpy(A))
    u = torch.zeros(S.shape[:-1])
    weights = TCS._mlp_weights(tp, cfg, F, H, None)
    seen = []

    def swap(ga):
        seen.append(tuple(ga.shape))
        return torch.cat([ga[..., F:2 * F], -ga[..., :F]], dim=-1)

    got = TCS._step_samples(cfg, te, weights, S, u, 1.0, True, swap)
    assert seen == [tuple(S.shape[:-1]) + (3 * F,)]
    bf = B * F
    lanes = TCS.nca_step_cells_batched(
        tp, cfg, te, TB.to_lanes(S), B, torch.Generator(), H, fire_rate=1.0,
        perception_transform=lambda gaB: torch.cat(
            [gaB[..., bf:2 * bf], -gaB[..., :bf]], dim=-1))
    assert torch.equal(TB.to_samples(lanes, B), got)


def test_prediffusion_matches_jax_band():
    """The random surface seed's pre-diffusion at radius 0.2 (lerp 0, unit
    activity) on a cell engine with the poly6 table alone, against the JAX
    CLI's ``diffuse_band`` on a band engine (tests/test_surface.py:214's
    scene: the 2048-point sphere), 3 passes."""
    x = JM.fibonacci_sphere(2048)
    n = JM.sphere_normals(x)
    rng = np.random.default_rng(11)
    t = np.array(JS.orthogonalize(jnp.asarray(n), JS.normalize(
        jnp.asarray(rng.normal(size=(2048, 3)).astype(np.float32)))))
    beng = jax_build_band(x, 0.2)
    ones = jnp.ones((2048, 16))
    want = jnp.asarray(t)
    for _ in range(3):
        want = JS.diffuse_band(beng, jnp.asarray(n), want, ones,
                               lerp_multiplier=0.0)
    eng = build_cell_engine(x, 0.2, pair_tables="float32", w6_only=True,
                            device="cpu")
    got = prediffuse_tangents(eng, torch.from_numpy(n), torch.from_numpy(t),
                              3)
    _close(got.numpy(), want, ATOL)
    # the w6-only engine's blur equals the full-table engine's
    full = build_cell_engine(x, 0.2, pair_tables="float32", device="cpu")
    assert torch.equal(full.blk_w6, eng.blk_w6)
    assert torch.equal(prediffuse_tangents(full, torch.from_numpy(n),
                                           torch.from_numpy(t), 3), got)


def test_w6_only_needs_pair_tables():
    x = JM.fibonacci_sphere(200)
    with pytest.raises(ValueError, match="w6_only"):
        build_cell_engine(x, 0.3, w6_only=True, device="cpu")
    eng = build_cell_engine(x, 0.3, pair_tables="bfloat16", w6_only=True,
                            device="cpu")
    assert eng.blk_w6.dtype == torch.bfloat16 and eng.blk_md is None
    with pytest.raises(ValueError, match="pair_tables"):
        TS.rollout_mesh_batched(
            *_model()[2:], eng, torch.zeros(1, 200, F), torch.zeros(200, 3),
            torch.zeros(1, 200, 3), torch.Generator(), 1, 0.3)

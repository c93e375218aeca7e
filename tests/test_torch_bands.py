"""Port parity: the band engine (``ops/bands.py``), its native host build
(``native/``) and its ops, against the JAX package on the CPU.

The scene is the JAX band tests' (tests/test_bands.py): 220 points uniform
in [-1, 1]^3, h = 0.3, blocks of 16 rows and far groups of 8, so the far
buckets are exercised; open and periodic, float32 and bfloat16 tables,
poly6 / Wendland C2 / Wendland C4 smoothing. Inputs are made with numpy
from a seed.

Tolerances.
- The build: every integer field and the tables exactly (bfloat16 by its
  bits: the same native fill, the same numpy around it); gsum within 1e-6
  of its largest entry (measured 0).
- The ops: both sides sum the same float32 (or bfloat16, exact in float32)
  products in float32, in another order: 1e-5 of the largest output; an
  output in bfloat16 (``out_dtype="bfloat16"``) 1e-2 of the largest entry.
  Inputs handed to bfloat16 tables are bfloat16 numbers, so neither side
  rounds them differently.
- The perception's autograd gradient (float32 tables) against ``jax.grad``:
  1e-5 of the largest entry.
"""

import ast
import functools
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sph_nca_tpu.ops import bands as JB
from sph_nca_tpu_torch import native
from sph_nca_tpu_torch.ops import bands as TB
from sph_nca_tpu_torch.ops import batched as TBT

ROOT = Path(__file__).resolve().parent.parent
N, H, B, F = 220, 0.3, 3, 8
RTOL = 1e-5
BF16_RTOL = 1e-2
GSUM_RTOL = 1e-6


@functools.cache
def _scene(periodic, dtype, smoothing="poly6"):
    x = np.random.default_rng(0).uniform(-1, 1, (N, 3)).astype(np.float32)
    kw = dict(period=[2.0] * 3 if periodic else None, block_rows=16,
              far_group=8, table_dtype=dtype, smoothing=smoothing)
    je = JB.build_band_engine(jnp.asarray(x), H, **kw)
    te = TB.build_band_engine(torch.from_numpy(x), H, device="cpu", **kw)
    return je, te


# every value of each axis at least once (the ops are the same code on
# each engine)
OPS_SCENES = [(False, "float32", "poly6"), (True, "bfloat16", "wendlandC2"),
              (True, "float32", "wendlandC4")]


def _ids(c):
    return "-".join(["periodic" if c[0] else "open", c[1], c[2]])


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def _tbits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


def _close(got, want, rtol, mask=None):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if mask is not None:
        got, want = got[mask], want[mask]
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * scale, (err, scale)


def _inputs(te, shape, seed, dtype):
    """Normal values [nb, P, *shape], bfloat16 numbers for bfloat16 tables;
    alpha lanes (every F-th from 3) uniform in [0, 0.3], 0.005 away from the
    alive threshold."""
    X = np.random.default_rng(seed).normal(
        size=(te.num_cells, te.slots_per_cell) + shape).astype(np.float32)
    if dtype == "bfloat16":
        X = torch.from_numpy(X).bfloat16().float().numpy()
    return X


def _alpha_lanes(X, b, f, seed):
    a = np.random.default_rng(seed).uniform(0.0, 0.3, X.shape[:2] + (b,))
    a = np.where(np.abs(a - 0.1) < 0.005, 0.12, a).astype(np.float32)
    X = X.copy()
    X[..., 3::f] = torch.from_numpy(a).bfloat16().float().numpy()
    return X


# ---- the build ---------------------------------------------------------------


@pytest.mark.parametrize("smoothing", ["poly6", "wendlandC2", "wendlandC4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
def test_build_matches_jax(periodic, dtype, smoothing):
    je, te = _scene(periodic, dtype, smoothing)
    assert len(te.far_tabs) > 0 and te.device.type == "cpu"
    for name in ("slot_of_particle", "xs", "vs", "nbr_count", "far_perm"):
        np.testing.assert_array_equal(getattr(te, name).numpy(),
                                      np.asarray(getattr(je, name)), name)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert te.Tband.dtype == tdt
    np.testing.assert_array_equal(_tbits(te.Tband), _bits(je.Tband))
    for name in ("far_blocks", "far_groups"):
        got, want = getattr(te, name), getattr(je, name)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    # the JAX package's far real-row mask (the port gathers the far alive
    # columns instead) follows from the group lists and the volumes
    g = te.far_group_size
    for grp, want in zip(te.far_groups, je.far_vwmask):
        rows = (grp[:, :, None] * g + torch.arange(g)).reshape(len(grp), -1)
        np.testing.assert_array_equal(
            (te.vs.reshape(-1)[rows] > 0).float().numpy(),
            np.asarray(want, np.float32), "far_vwmask")
    assert len(te.far_tabs) == len(je.far_tabs)
    for g, w in zip(te.far_tabs, je.far_tabs):
        assert g.dtype == tdt
        np.testing.assert_array_equal(_tbits(g), _bits(w))
    _close(te.gsum, je.gsum, GSUM_RTOL)
    assert (te.h, te.sig_w, te.sig_g) == (float(je.h), float(je.sig_w),
                                          float(je.sig_g))
    assert te.far_group_size == je.far_group_size == 8
    assert (te.num_cells, te.slots_per_cell, te.num_particles, te.dim) == (
        je.num_cells, je.slots_per_cell, je.num_particles, je.dim)


def test_bucket_cuts_match_jax():
    rng = np.random.default_rng(3)
    for k in (1, 3, 16):
        widths = rng.integers(0, 40, 300)
        assert TB._bucket_cuts(widths, k) == JB._bucket_cuts(widths, k)
    assert TB._bucket_cuts(np.zeros(5, np.int64), 4) == []


def test_engine_layout_and_moves():
    _, te = _scene(False, "float32")
    A = torch.from_numpy(np.random.default_rng(1).normal(
        size=(B, N, F)).astype(np.float32))
    S = te.scatter(A)
    assert S.shape == (B, te.num_cells, te.slots_per_cell, F)
    assert torch.equal(te.gather_back(S), A)
    pad = torch.ones(te.num_cells * te.slots_per_cell, dtype=torch.bool)
    pad[te.slot_of_particle] = False
    assert (S.reshape(B, -1, F)[:, pad] == 0).all()
    assert torch.equal(TBT.batched_gather_back(
        te, TBT.batched_scatter(te, A), B), A)
    moved = te.to("cpu")
    assert moved.Tband is te.Tband and moved.far_tabs[0] is te.far_tabs[0]
    band, far = te.table_bytes()
    assert band == te.Tband.numel() * 4 and far > 0
    assert torch.equal(te.count(), te.nbr_count)


def test_build_refusals():
    x = np.random.default_rng(0).uniform(-1, 1, (50, 3))
    with pytest.raises(ValueError, match="unknown smoothing"):
        TB.build_band_engine(x, H, smoothing="gauss", device="cpu")
    with pytest.raises(ValueError, match="table_dtype"):
        TB.build_band_engine(x, H, table_dtype="float16", device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        TB.build_band_engine(x, H, block_rows=16, far_group=5, device="cpu")


@pytest.mark.parametrize("name", ["poly6", "wendlandC2", "wendlandC4"])
def test_smoothing_kernels_match_jax(name):
    """The registry's kernels against the JAX package's: values on d2 in
    [0, 1.2 h^2] (zero past h, 1 at 0 for Wendland), normalizations in 2D
    and 3D, and a finite autograd derivative at d2 = 0 (the d2 > 0
    guards); float32 arithmetic in both, 1e-6 of the largest value."""
    from sph_nca_tpu.ops import kernels as JK
    from sph_nca_tpu_torch.ops import kernels as TK

    h = 0.3
    d2 = np.linspace(0.0, 1.2 * h * h, 97).astype(np.float32)
    got = TK.get_smoothing_kernel(name)
    want = JK.get_smoothing_kernel(name)
    _close(got.w(torch.from_numpy(d2), h), want.w(jnp.asarray(d2), h), 1e-6)
    for dim in (2, 3):
        assert got.norm(h, dim) == want.norm(h, dim)
    x = torch.zeros(1, requires_grad=True)
    (g,) = torch.autograd.grad(got.w(x, h).sum(), x)
    assert torch.isfinite(g).all()
    assert TK.get_gradient_kernel().norm(h, 3) == \
        JK.get_gradient_kernel().norm(h, 3)
    with pytest.raises(ValueError, match="unknown smoothing"):
        TK.get_smoothing_kernel("gauss")
    with pytest.raises(ValueError, match="unknown gradient"):
        TK.get_gradient_kernel("poly6")


# ---- the native build ----------------------------------------------------------


def test_sphgrid_source_is_vendored():
    """The port's sphgrid.cpp is the JAX package's byte for byte, and no
    port module reads the JAX package's copy."""
    assert (ROOT / "sph_nca_tpu_torch" / "native" / "sphgrid.cpp"
            ).read_bytes() == (ROOT / "sph_nca_tpu" / "native" / "sphgrid.cpp"
                               ).read_bytes()
    assert native.SOURCE == ROOT / "sph_nca_tpu_torch" / "native" / \
        "sphgrid.cpp"
    for path in (ROOT / "sph_nca_tpu_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
                and n.body and isinstance(n.body[0], ast.Expr)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and id(node) not in docs:
                assert "sph_nca_tpu/" not in node.value, (path, node.value)
                assert node.value != "sph_nca_tpu", path
    lib = native.library_path()
    assert lib.parent == ROOT / "sph_nca_tpu_torch" / "_build"
    assert lib.name.startswith("libsphgrid_") and lib.suffix == ".so"
    assert native.build_command(lib)[:5] == ["g++", "-O3", "-march=native",
                                             "-shared", "-fPIC"]


def test_native_build_raises_with_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "sphgrid.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="(?s)g[+][+] failed.*error"):
        native.build()
    assert not native.library_path().exists()


def test_native_true_pairs_match_jax():
    from sph_nca_tpu import native as jax_native

    x = np.random.default_rng(2).uniform(-1, 1, (300, 3))
    for per in (None, np.asarray([2.0] * 3)):
        got = native.true_pairs(x, 0.3, per)
        want = jax_native.true_pairs(x, 0.3, per, with_sums=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# ---- the pair passes and ops ---------------------------------------------------


@pytest.mark.parametrize("case", OPS_SCENES, ids=_ids)
def test_ops_match_jax(case):
    """band_md_pass, band_blur_pass, band_md_pass_axis, mask_blur_band,
    blur_band, gradient_band, divergence_band and volume_consistency."""
    periodic, dtype, smoothing = case
    je, te = _scene(periodic, dtype, smoothing)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    X = _inputs(te, (B * F,), 1, dtype)
    jX, tX = jnp.asarray(X).astype(jdt), torch.from_numpy(X)
    # one JAX program for the unjitted passes (op by op they compile slowly)
    want = jax.jit(lambda e, a: (JB.band_md_pass(e, a), JB.band_blur_pass(e, a))
                   + tuple(JB.band_md_pass_axis(e, a, i) for i in range(3)))(
        je, jX)
    got = (TB.band_md_pass(te, tX), TB.band_blur_pass(te, tX)) + tuple(
        TB.band_md_pass_axis(te, tX, i) for i in range(3))
    for g, w in zip(got, want):
        _close(g, w, RTOL)
    XA = _alpha_lanes(X, B, F, 2)
    for use_alpha in (True, False):
        _close(TB.mask_blur_band(te, torch.from_numpy(XA), B, use_alpha),
               JB.mask_blur_band(je, jnp.asarray(XA), B, use_alpha), RTOL)
    Y = _inputs(te, (4,), 3, dtype)
    _close(TB.blur_band(te, torch.from_numpy(Y)),
           JB.blur_band(je, jnp.asarray(Y)), RTOL)
    A = _inputs(te, (F,), 4, dtype)
    _close(TB.gradient_band(te, torch.from_numpy(A)),
           JB.gradient_band(je, jnp.asarray(A)), RTOL)
    V = _inputs(te, (F, 3), 5, dtype)
    _close(TB.divergence_band(te, torch.from_numpy(V)),
           JB.divergence_band(je, jnp.asarray(V)), RTOL)
    _close(te.volume_consistency(), jax.jit(type(je).volume_consistency)(je),
           RTOL)


# the options of perceive_band_batched: each value of each once or more
PERCEIVE_OPTIONS = [(True, None), (False, None), (True, "bfloat16"),
                    (False, "bfloat16")]


@pytest.mark.parametrize("options", PERCEIVE_OPTIONS,
                         ids=lambda o: f"alpha{int(o[0])}-{o[1] or 'float32'}")
@pytest.mark.parametrize("case", OPS_SCENES[:2], ids=_ids)
def test_perceive_band_batched_matches_jax(case, options):
    use_alpha, out_dtype = options
    je, te = _scene(*case)
    dtype = case[1]
    XB = _alpha_lanes(_inputs(te, (B * F,), 6, dtype), B, F, 7)
    want = JB.perceive_band_batched(je, jnp.asarray(XB), B, use_alpha,
                                    out_dtype=out_dtype)
    got = TB.perceive_band_batched(te, torch.from_numpy(XB), B, use_alpha,
                                   out_dtype=out_dtype)
    assert len(got) == len(want) == 2
    assert got[0].dtype == (torch.bfloat16 if out_dtype else torch.float32)
    _close(got[0], want[0], BF16_RTOL if out_dtype else RTOL)
    assert got[1].dtype == torch.float32
    _close(got[1], want[1], RTOL)
    # the lane-layout dispatch of ops/batched.py
    lanes = TBT.perceive_cells_batched(te, torch.from_numpy(XB), B,
                                       use_alpha, out_dtype=out_dtype)
    assert all(torch.equal(a, b) for a, b in zip(lanes, got))
    # the sample-layout seam computes the same function
    S = torch.from_numpy(XB).reshape(te.num_cells, te.slots_per_cell, B,
                                     F).permute(2, 0, 1, 3)
    ga, sm = TBT.perceive_samples(te, S, use_alpha, out_dtype=out_dtype)
    assert torch.equal(TBT.dmajor_to_lanes(ga, 3), got[0])
    assert torch.equal(sm, got[1].permute(2, 0, 1))
    # and the lane-layout dispatch of ops/batched.py
    lanes = TBT.perceive_cells_batched(te, torch.from_numpy(XB), B,
                                       use_alpha, out_dtype=out_dtype)
    assert torch.equal(lanes[0], got[0])


def test_sample_layout_mask_and_blur():
    _, te = _scene(True, "bfloat16")
    XB = _alpha_lanes(_inputs(te, (B * F,), 9, "bfloat16"), B, F, 10)
    S = torch.from_numpy(XB).reshape(te.num_cells, te.slots_per_cell, B,
                                     F).permute(2, 0, 1, 3)
    for use_alpha in (True, False):
        assert torch.equal(
            TBT.mask_blur_samples(te, S, use_alpha),
            TB.mask_blur_band(te, torch.from_numpy(XB), B,
                              use_alpha).permute(2, 0, 1))
    X = torch.from_numpy(_inputs(te, (B * 4,), 11, "bfloat16"))
    Xs = X.reshape(te.num_cells, te.slots_per_cell, B, 4).permute(2, 0, 1, 3)
    assert torch.equal(TBT.to_lanes(TBT.blur_samples(te, Xs)),
                       TBT.blur_batched(te, X, B))


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
def test_perception_grad_matches_jax(periodic):
    """d/dXB of a weighted sum of gaB: plain autograd over bmm, the rolls,
    the concat and the far gather, against jax.grad (float32 tables)."""
    je, te = _scene(periodic, "float32")
    XB = _alpha_lanes(_inputs(te, (B * F,), 12, "float32"), B, F, 13)
    W = _inputs(te, (3 * B * F,), 14, "float32")

    def jloss(X):
        return jnp.sum(JB.perceive_band_batched(je, X, B, True)[0] * W)

    want = jax.grad(jloss)(jnp.asarray(XB))
    X = torch.from_numpy(XB).requires_grad_(True)
    (TB.perceive_band_batched(te, X, B, True)[0]
     * torch.from_numpy(W)).sum().backward()
    _close(X.grad, want, RTOL)
    # the sample-layout seam's gradient is the same
    S = torch.from_numpy(XB).reshape(te.num_cells, te.slots_per_cell, B,
                                     F).permute(2, 0, 1, 3).contiguous()
    S.requires_grad_(True)
    ga, _ = TBT.perceive_samples(te, S)
    (TBT.dmajor_to_lanes(ga, 3) * torch.from_numpy(W)).sum().backward()
    _close(TBT.to_lanes(S.grad), want, RTOL)


# ---- the fixed-order backward of the static gathers ---------------------------

GATHER_RTOL = 1e-6


def _plain_md_pass(eng, X):
    """band_md_pass as it was written before its gathers got a fixed-order
    backward: PyTorch's own X[idx] indexing, whose backward accumulates."""
    cols = slice(0, eng.dim * eng.slots_per_cell)
    out = TB._pair_dot(eng.Tband[:, :, cols], eng.window_rows(X))
    src, L = eng.far_rows(X), X.shape[-1]
    outs = [TB._pair_dot(tab[:, :, cols],
                         src[grp].reshape(grp.shape[0], -1, L))
            for grp, tab in zip(eng.far_groups, eng.far_tabs)]
    n_far = sum(o.shape[0] for o in outs)
    outs.append(out.new_zeros((max(out.shape[0] - n_far, 1),)
                              + out.shape[1:]))
    return out + torch.cat(outs)[eng.far_perm]


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
def test_static_gathers_backward_fixed_order(periodic):
    """The band pass's far gather (a reverse map of the group lists, pad
    groups all reading group 0), the far_perm combine (the inverse
    permutation) and gather_back (a copy into distinct slots): their
    backward against autograd's of the plain indexing, and a float64
    gradcheck of each on the engine's own indices."""
    from sph_nca_tpu_torch.ops import gather as GA

    _, te = _scene(periodic, "float32")
    assert len(te.far_tabs) > 1
    X = torch.from_numpy(_inputs(te, (B * F,), 21, "float32"))
    G = torch.from_numpy(_inputs(te, (B * F,), 22, "float32"))
    grads = []
    for fn in (TB.band_md_pass, _plain_md_pass):
        Xg = X.clone().requires_grad_(True)
        out = fn(te, Xg)
        grads.append(torch.autograd.grad(out, Xg, torch.cat([G] * 3, 1))[0])
    _close(grads[0], grads[1].numpy(), GATHER_RTOL)
    # the same backward, two runs, bit for bit
    again = X.clone().requires_grad_(True)
    assert torch.autograd.grad(TB.band_md_pass(te, again), again,
                               torch.cat([G] * 3, 1))[0].equal(grads[0])

    rng = np.random.default_rng(23)
    n_src = te.num_cells * te.slots_per_cell // te.far_group_size
    src = torch.tensor(rng.normal(size=(n_src, 3)), dtype=torch.float64,
                       requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda s: GA.gather_rows(s, te.far_index), (src,))
    n_rows = sum(g.shape[0] for g in te.far_groups)
    Y = torch.tensor(rng.normal(size=(n_rows, 2)), dtype=torch.float64,
                     requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda y: GA.permute_rows(y, te.far_perm), (Y,))
    S = torch.tensor(rng.normal(size=(2, te.num_cells, te.slots_per_cell,
                                      2)), dtype=torch.float64,
                     requires_grad=True)
    assert torch.autograd.gradcheck(te.gather_back, (S,))
    # gather_back's backward equals indexing's, exactly
    Sf = S.detach().float().requires_grad_(True)
    Gp = torch.from_numpy(rng.normal(size=(2, N, 2)).astype(np.float32))
    flat = Sf.reshape(2, -1, 2)
    want = torch.autograd.grad(flat[:, te.slot_of_particle], Sf, Gp)[0]
    assert torch.equal(torch.autograd.grad(te.gather_back(Sf), Sf, Gp)[0],
                       want)
    SB = TBT.batched_scatter(te, torch.from_numpy(rng.normal(
        size=(2, N, 3))).double()).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda sb: TBT.batched_gather_back(te, sb, 2), (SB,))

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The file
imports neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch and the CUDA toolkit; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: kernel and plain version are both float32 and sum the window in
other orders (the kernel in 4 interleaved partial sums), so gA agrees to
1e-5 of max|gA| and the blurs to 1e-5 relative; a few steps of the rollout
to 1e-4 absolute (|A| <~ 1).
"""

import math

import numpy as np
import pytest
import torch

from sph_nca_tpu_torch.models.cell_step import rollout_cells
from sph_nca_tpu_torch.models.nca import MLPParams, SPHNCAConfig
from sph_nca_tpu_torch.ops import pair_kernel as PK
from sph_nca_tpu_torch.ops.cells import build_cell_engine

GA_RTOL = 1e-5
SM_RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cloud(device, dim=3):
    """A random periodic cloud that fills both window-size buckets."""
    x = np.random.default_rng(1).uniform(-1, 1, (600, dim)).astype(np.float32)
    eng = build_cell_engine(x, 0.25, period=[2.0] * dim, device=device)
    assert eng.blk_xs.shape[0] > 0 and eng.blk2_xs.shape[0] > 0
    S = torch.from_numpy(np.random.default_rng(2).normal(
        size=tuple(eng.xs.shape[:2]) + (16,)).astype(np.float32)).to(device)
    return eng, S


def _rand(device, shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32)).to(device)


def _misaligned(x):
    """A contiguous copy of x whose data starts 4 bytes past a 16-byte
    boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


def _close(got, want, real, rtol):
    got, want, real = got.cpu(), want.cpu(), real.cpu()
    scale = max(float(want.abs()[real].max()), 1e-30)
    err = float((got - want).abs()[real].max())
    assert err <= rtol * scale, (err, scale)


# Batch sizes of the recompute forward and adjoint: None the unbatched call;
# 1 and 2 one 2-sample tile, 3 one ragged tile of 8, 8 one full tile, 11 a
# full tile and a ragged one, 20 three tiles of 8 with the last ragged.
RC_BATCHES = [None, 1, 2, 3, 8, 11, 20]


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("use_alpha", [True, False])
@pytest.mark.parametrize("bsz", RC_BATCHES)
def test_bucket_kernels_match_plain(cuda, dim, use_alpha, bsz):
    eng, S = _cloud(cuda, dim)
    if bsz is not None:
        S = _rand(cuda, (bsz,) + tuple(S.shape), 12)
    lead = () if bsz is None else (bsz,)
    scal = PK.scal_vec(eng)
    nb1 = eng.blk_xs.shape[0]
    real = (eng.vs > 0).reshape(-1, 64)
    rows = S.reshape(*lead, -1, 64, 16)
    n_fwd, n_mask = PK.fwd_bucket.launches, PK.mask_bucket.launches
    for xs_b, xw_b, vw_b, win, ab, rr in (
        (eng.blk_xs, eng.blk_xw, eng.blk_vw, eng.blk_win_cells,
         rows[..., :nb1, :, :], real[:nb1].expand(*lead, -1, -1)),
        (eng.blk2_xs, eng.blk2_xw, eng.blk2_vw, eng.blk2_win_cells,
         rows[..., nb1:, :, :], real[nb1:].expand(*lead, -1, -1)),
    ):
        args = (scal, xs_b, ab, xw_b, vw_b, S, win)
        ga_k, sm_k = PK.fwd_bucket(*args, use_alpha=use_alpha)
        ga_p, sm_p = PK.fwd_bucket_plain(*args, use_alpha=use_alpha)
        margs = (scal, xs_b, xw_b, vw_b, S, win)
        mk = PK.mask_bucket(*margs, use_alpha=use_alpha)
        mp = PK.mask_bucket_plain(*margs, use_alpha=use_alpha)
        torch.cuda.synchronize()
        _close(ga_k, ga_p, rr, GA_RTOL)
        _close(sm_k, sm_p, rr, SM_RTOL)
        _close(mk, mp, rr, SM_RTOL)
    assert PK.fwd_bucket.launches == n_fwd + 2
    assert PK.mask_bucket.launches == n_mask + 2


@pytest.mark.cuda
def test_entry_points_match_plain(cuda):
    eng, S = _cloud(cuda)
    real = eng.vs > 0
    for d_major in (True, False):
        ga_k, sm_k = PK.fused_perception(eng, S, d_major=d_major)
        ga_p, sm_p = PK.fused_perception(eng, S, d_major=d_major,
                                         use_kernels=False)
        _close(ga_k, ga_p, real, GA_RTOL)
        _close(sm_k, sm_p, real, SM_RTOL)
    _close(PK.mask_blur(eng, S), PK.mask_blur(eng, S, use_kernels=False),
           real, SM_RTOL)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernel_does_not_take(cuda):
    eng, S = _cloud(cuda)
    scal = PK.scal_vec(eng)
    ab = S.reshape(-1, 64, 16)[: eng.blk_xs.shape[0]]
    args = [scal, eng.blk_xs, ab, eng.blk_xw, eng.blk_vw, S,
            eng.blk_win_cells]
    with pytest.raises(ValueError):  # F = 8: the kernel is built for F = 16
        PK.fwd_bucket(scal, eng.blk_xs, ab[..., :8].contiguous(), eng.blk_xw,
                      eng.blk_vw, S[..., :8].contiguous(), eng.blk_win_cells,
                      use_alpha=True)
    with pytest.raises(ValueError):  # int64 window table
        PK.fwd_bucket(*args[:-1], eng.blk_win_cells.long(), use_alpha=True)
    with pytest.raises(ValueError):  # state on the CPU, geometry on the card
        PK.fwd_bucket(*args[:5], S.cpu(), args[6], use_alpha=True)
    # the TMA and its bulk copies take 16-byte aligned sources
    S_off = _misaligned(S)
    with pytest.raises(ValueError):
        PK.fwd_bucket(*args[:5], S_off, args[6], use_alpha=True)
    with pytest.raises(ValueError):
        PK.fwd_bucket(scal, eng.blk_xs, ab, _misaligned(eng.blk_xw),
                      eng.blk_vw, S, eng.blk_win_cells, use_alpha=True)
    with pytest.raises(ValueError):
        PK.fwd_bucket(scal, eng.blk_xs, ab, eng.blk_xw,
                      _misaligned(eng.blk_vw), S, eng.blk_win_cells,
                      use_alpha=True)
    with pytest.raises(ValueError):  # M = 4 slots a cell: the kernel takes 8
        c, m = S.shape[:2]
        PK.fwd_bucket(scal, eng.blk_xs, ab, eng.blk_xw, eng.blk_vw,
                      S.reshape(2 * c, m // 2, 16),
                      eng.blk_win_cells.repeat_interleave(2, 1).contiguous(),
                      use_alpha=True)


@pytest.mark.cuda
def test_rollout_kernels_match_plain(cuda):
    eng, _ = _cloud(cuda)
    g = torch.Generator(device="cpu").manual_seed(0)
    cfg = SPHNCAConfig(fire_rate=1.0, normalize_perception=4.0)
    params = MLPParams(
        torch.randn(48, 256, generator=g) * 0.1, torch.zeros(256),
        torch.randn(256, 33, generator=g) * 0.1, torch.zeros(33))
    params = MLPParams(*(p.to(cuda) for p in params))
    A = torch.rand(eng.num_particles, 16, generator=g).to(cuda)
    out = {}
    for use_kernels in (True, False):
        gen = torch.Generator(device=cuda).manual_seed(0)
        out[use_kernels] = eng.gather_back(rollout_cells(
            params, cfg, eng, eng.scatter(A), gen, 4, 0.25, fire_rate=1.0,
            use_kernels=use_kernels))
    assert torch.isfinite(out[True]).all()
    assert float((out[True] - out[False]).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_empty_second_bucket_launches_nothing(cuda):
    """A 24x24 grid at h = 0.1 fills one bucket: one launch per pass."""
    m = 24
    g = (np.stack(np.meshgrid(np.arange(m), np.arange(m), indexing="ij"),
                  -1) + 0.5) / m * 2 - 1
    x = np.pad(g.reshape(-1, 2).astype(np.float32), ((0, 0), (0, 1)))
    eng = build_cell_engine(x, 0.1, device=cuda)
    assert eng.blk2_xs.shape[0] == 0
    S = torch.from_numpy(np.random.default_rng(4).normal(
        size=tuple(eng.xs.shape[:2]) + (16,)).astype(np.float32)).to(cuda)
    n_fwd, n_mask = PK.fwd_bucket.launches, PK.mask_bucket.launches
    ga_k, sm_k = PK.fused_perception(eng, S)
    mk = PK.mask_blur(eng, S)
    assert (PK.fwd_bucket.launches, PK.mask_bucket.launches) == (
        n_fwd + 1, n_mask + 1)
    ga_p, sm_p = PK.fused_perception(eng, S, use_kernels=False)
    real = eng.vs > 0
    _close(ga_k, ga_p, real, GA_RTOL)
    _close(sm_k, sm_p, real, SM_RTOL)
    _close(mk, PK.mask_blur(eng, S, use_kernels=False), real, SM_RTOL)


DA_RTOL = 1e-5  # of max|dA|


def _bucket_rows(eng, X, bucket):
    """(first block, blocks) of one bucket and X's rows [..., nb, P, K]."""
    nb1 = eng.blk_xs.shape[0]
    lo, hi = (0, nb1) if bucket == 1 else (nb1, nb1 + eng.blk2_xs.shape[0])
    rows = X.reshape(*X.shape[:-3], -1, 64, X.shape[-1])
    return lo, hi, rows[..., lo:hi, :, :]


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("bsz", RC_BATCHES)
def test_bwd_kernel_matches_plain(cuda, dim, bsz):
    eng, _ = _cloud(cuda, dim)
    lead = () if bsz is None else (bsz,)
    G = torch.from_numpy(np.random.default_rng(5).normal(
        size=lead + tuple(eng.xs.shape[:2]) + (dim * 16,)).astype(np.float32)
    ).to(cuda)
    scal = PK.scal_vec(eng)
    real = (eng.vs > 0).reshape(-1, 64).expand(*lead, -1, -1)
    vs = eng.vs.reshape(-1, 64)
    gs = eng.gsum.reshape(-1, 64, dim)
    n_bwd = PK.bwd_bucket.launches
    for bucket, xs_b, xw_b, win in ((1, eng.blk_xs, eng.blk_xw,
                                     eng.blk_win_cells),
                                    (2, eng.blk2_xs, eng.blk2_xw,
                                     eng.blk2_win_cells)):
        lo, hi, gb = _bucket_rows(eng, G, bucket)
        args = (scal, xs_b, vs[lo:hi], gs[lo:hi], gb, xw_b, G, win)
        dk = PK.bwd_bucket(*args)
        dp = PK.bwd_bucket_plain(*args)
        torch.cuda.synchronize()
        rr = real[..., lo:hi, :]
        _close(dk, dp, rr, DA_RTOL)
        assert torch.all(dk[~rr] == 0)  # pad rows: exactly 0
    assert PK.bwd_bucket.launches == n_bwd + 2
    _close(PK.gradient_adjoint_dmajor(eng, G),
           PK.gradient_adjoint_dmajor(eng, G, use_kernels=False),
           (eng.vs > 0).expand(*lead, -1, -1), DA_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("bsz", [8, 2, 11, 20])
def test_batched_launches_equal_per_sample(cuda, bsz):
    """One launch for a batch of B gives each sample what a launch of its
    own gives, for all three kernels: 8 in one tile of 8, 2 in one 2-sample
    tile, 11 in a full tile and a ragged one, 20 in three tiles of 8."""
    eng, _ = _cloud(cuda)
    rng = np.random.default_rng(6)
    c, m = eng.xs.shape[:2]
    S = torch.from_numpy(rng.normal(size=(bsz, c, m, 16)).astype(
        np.float32)).to(cuda)
    G = torch.from_numpy(rng.normal(size=(bsz, c, m, 48)).astype(
        np.float32)).to(cuda)
    counts = (PK.fwd_bucket.launches, PK.mask_bucket.launches,
              PK.bwd_bucket.launches)
    ga, sm = PK.fused_perception(eng, S, d_major=True)
    mk = PK.mask_blur(eng, S)
    da = PK.gradient_adjoint_dmajor(eng, G)
    assert (PK.fwd_bucket.launches, PK.mask_bucket.launches,
            PK.bwd_bucket.launches) == tuple(n + 2 for n in counts)
    for b in range(bsz):
        ga1, sm1 = PK.fused_perception(eng, S[b], d_major=True)
        assert torch.equal(ga[b], ga1) and torch.equal(sm[b], sm1)
        assert torch.equal(mk[b], PK.mask_blur(eng, S[b]))
        assert torch.equal(da[b], PK.gradient_adjoint_dmajor(eng, G[b]))


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("bsz", [1, 2, 3, 8, 11, 20])
def test_mask_kernel_launches_equal_per_sample(cuda, dim, bsz):
    """The recompute mask kernel within 1e-5 of max of its plain version
    (use_alpha on and off, states of 16 and of 5 channels), exactly 0 where
    the plain version is (most pad rows: in this periodic 3D cloud some pad
    rows sit within h of window slots at the same offset, and both versions
    sum those, as the Pallas kernel does:
    tests/test_torch_pair_kernel.py::test_mask_blur_pad_rows_match_pallas),
    one launch a bucket, and one launch of B samples equal to B
    launches of one, bit for bit: 1 in a 1-sample tile, 2 and 3 in one ragged
    tile of 8, 8 in a full one, 11 in a full and a ragged one, 20 in
    three."""
    eng, _ = _cloud(cuda, dim)
    c, m = eng.xs.shape[:2]
    scal = PK.scal_vec(eng)
    real = (eng.vs > 0).reshape(-1, 64)
    nb1 = eng.blk_xs.shape[0]
    for f in (16, 5):
        S = _rand(cuda, (bsz, c, m, f), 13)
        for use_alpha in (True, False):
            for xs_b, xw_b, vw_b, win, rr in (
                (eng.blk_xs, eng.blk_xw, eng.blk_vw, eng.blk_win_cells,
                 real[:nb1]),
                (eng.blk2_xs, eng.blk2_xw, eng.blk2_vw, eng.blk2_win_cells,
                 real[nb1:]),
            ):
                margs = (scal, xs_b, xw_b, vw_b)
                n0 = PK.mask_bucket.launches
                mk = PK.mask_bucket(*margs, S, win, use_alpha=use_alpha)
                assert PK.mask_bucket.launches == n0 + 1
                mp = PK.mask_bucket_plain(*margs, S, win, use_alpha=use_alpha)
                torch.cuda.synchronize()
                _close(mk, mp, rr.expand(bsz, -1, -1), SM_RTOL)
                assert torch.equal(mk == 0, mp == 0)
                for b in range(bsz):
                    assert torch.equal(mk[b], PK.mask_bucket(
                        *margs, S[b], win, use_alpha=use_alpha))


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
def test_recompute_forward_cancels_a_constant_field(cuda, dim):
    """The recompute forward kernel's split TF32 products keep f32
    accuracy: a constant state cancels against the rowsum of the A tile it
    computes to |gA| < 1e-4, the CPU emulation's bound (one TF32 product
    would not: tests/test_torch_recompute_split.py)."""
    eng, _ = _cloud(cuda, dim)
    S = eng.scatter(torch.full((eng.num_particles, 16), 1.7, device=cuda))
    count = PK.fwd_bucket.launches
    for lead in ((), (3,)):
        Sb = S.expand(*lead, *S.shape).contiguous()
        ga, _ = PK.fused_perception(eng, Sb, d_major=True)
        torch.cuda.synchronize()
        assert float(eng.gather_back(ga).abs().max()) < 1e-4
    assert PK.fwd_bucket.launches == count + 4


@pytest.mark.cuda
def test_function_kernel_grad_matches_plain_autograd(cuda):
    eng, S = _cloud(cuda)
    rng = np.random.default_rng(7)
    S = S[None].repeat(2, 1, 1, 1) + 0.1 * torch.from_numpy(
        rng.normal(size=(2,) + tuple(S.shape)).astype(np.float32)).to(cuda)
    R = torch.from_numpy(rng.normal(size=tuple(S.shape[:-1]) + (48,)).astype(
        np.float32)).to(cuda)
    R[:, eng.vs == 0] = 0.0  # training puts no cotangent on pad rows
    Sk = S.clone().requires_grad_(True)
    n_bwd = PK.bwd_bucket.launches
    (PK.perceive_cells_dmajor(eng, Sk)[0] * R).sum().backward()
    assert PK.bwd_bucket.launches == n_bwd + 2
    Sp = S.clone().requires_grad_(True)
    (PK.fused_perception(eng, Sp, d_major=True, use_kernels=False)[0]
     * R).sum().backward()
    _close(Sk.grad, Sp.grad, (eng.vs > 0).expand(2, -1, -1), DA_RTOL)


@pytest.mark.cuda
def test_bwd_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    eng, _ = _cloud(cuda)
    c, m = eng.xs.shape[:2]
    G = torch.zeros((2, c, m, 48), device=cuda)
    lo, hi, gb = _bucket_rows(eng, G, 1)
    vs = eng.vs.reshape(-1, 64)[lo:hi]
    gs = eng.gsum.reshape(-1, 64, 3)[lo:hi]
    scal = PK.scal_vec(eng)
    ok = [scal, eng.blk_xs, vs, gs, gb, eng.blk_xw, G, eng.blk_win_cells]
    PK.bwd_bucket(*ok)
    bad = {
        4: gb[..., :32].contiguous(),  # F = 8 cotangent rows
        6: G.double(),  # float64 cotangent
        2: vs.double(),  # float64 volumes
        7: eng.blk_win_cells.long(),  # int64 window table
        3: gs[..., :2].contiguous(),  # gsum of the wrong D
        5: eng.blk_xw.cpu(),  # geometry off the card
    }
    for i, arg in bad.items():
        args = list(ok)
        args[i] = arg
        with pytest.raises(ValueError):
            PK.bwd_bucket(*args)
    G2 = torch.zeros((2, c, m, 32), device=cuda)  # F = 8 everywhere
    _, _, gb2 = _bucket_rows(eng, G2, 1)
    with pytest.raises(ValueError):
        PK.bwd_bucket(scal, eng.blk_xs, vs, gs, gb2, eng.blk_xw, G2,
                      eng.blk_win_cells)
    # the TMA and its bulk copies take 16-byte aligned sources
    for i, arg in ((6, _misaligned(G)), (5, _misaligned(eng.blk_xw))):
        args = list(ok)
        args[i] = arg
        with pytest.raises(ValueError):
            PK.bwd_bucket(*args)


@pytest.mark.cuda
def test_rollout_grads_kernels_match_plain(cuda):
    """Parameter gradients of a 3-step batched BPTT rollout through the
    kernels (forward recomputed in the backward) equal the plain versions'."""
    eng, _ = _cloud(cuda)
    g = torch.Generator(device="cpu").manual_seed(1)
    cfg = SPHNCAConfig(fire_rate=1.0, normalize_perception=4.0)
    base = MLPParams(
        torch.randn(48, 64, generator=g) * 0.1, torch.zeros(64),
        torch.randn(64, 33, generator=g) * 0.1, torch.zeros(33))
    A = torch.rand(2, eng.num_particles, 16, generator=g).to(cuda)
    grads = {}
    for use_kernels in (True, False):
        params = MLPParams(*(p.to(cuda).requires_grad_(True) for p in base))
        gen = torch.Generator(device=cuda).manual_seed(0)
        final = rollout_cells(params, cfg, eng, eng.scatter(A), gen, 3, 0.25,
                              fire_rate=1.0, use_kernels=use_kernels)
        eng.gather_back(final).square().sum().backward()
        grads[use_kernels] = [p.grad for p in params]
    for gk, gp in zip(grads[True], grads[False]):
        assert float((gk - gp).abs().max()) <= 1e-4 * float(gp.abs().max())


# ---- the pair-table kernels (engines built with pair_tables) --------------

TAB_DTYPES = ["float32", "bfloat16"]


def _tab_cloud(device, dim=3, dtype="float32"):
    """A random periodic cloud with pair tables that fills both buckets."""
    x = np.random.default_rng(1).uniform(-1, 1, (600, dim)).astype(np.float32)
    eng = build_cell_engine(x, 0.25, period=[2.0] * dim, pair_tables=dtype,
                            device=device)
    assert eng.blk_xs.shape[0] > 0 and eng.blk2_xs.shape[0] > 0
    return eng


def _tab_buckets(eng):
    """Per bucket: (lo, hi, win, vw, md, w6)."""
    nb1 = eng.blk_xs.shape[0]
    nb = nb1 + eng.blk2_xs.shape[0]
    return ((0, nb1, eng.blk_win_cells, eng.blk_vw, eng.blk_md, eng.blk_w6),
            (nb1, nb, eng.blk2_win_cells, eng.blk2_vw, eng.blk2_md,
             eng.blk2_w6))


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", TAB_DTYPES)
@pytest.mark.parametrize("bsz", [1, 3, 2, 20, 11])
def test_table_kernels_match_plain(cuda, dim, dtype, bsz):
    """Each table kernel against its plain version (1e-5 of max: both sum
    the same f32 products of the same upcast table, in other orders), pad
    rows exactly 0, one launch per bucket and call. B = 1 and 2 take the
    forward, adjoint and mask's 2-sample tiles, 3 one ragged tile of 8, 20
    three tiles of 8 with the last ragged, 11 a full tile and a ragged one."""
    eng = _tab_cloud(cuda, dim, dtype)
    c, m, _ = eng.xs.shape
    S = _rand(cuda, (bsz, c, m, 16), 2)
    G = _rand(cuda, (bsz, c, m, dim * 16), 3)
    X = _rand(cuda, (bsz, c, m, 4), 4)
    scal = PK.scal_vec(eng)
    real = (eng.vs > 0).reshape(-1, 64)
    vs = eng.vs.reshape(-1, 64)
    gs = eng.gsum.reshape(-1, 64, dim)
    counts = [f.launches for f in (PK.fwd_tab_bucket, PK.bwd_tab_bucket,
                                   PK.mask_tab_bucket, PK.blur_bucket)]
    for lo, hi, win, vw, md, w6 in _tab_buckets(eng):
        rr = real[lo:hi]
        ab = S.reshape(bsz, -1, 64, 16)[:, lo:hi]
        gb = G.reshape(bsz, -1, 64, dim * 16)[:, lo:hi]
        for use_alpha in (True, False):
            args = (scal, ab, gs[lo:hi], vw, S, win, md, w6)
            ga_k, sm_k = PK.fwd_tab_bucket(*args, use_alpha=use_alpha)
            ga_p, sm_p = PK.fwd_tab_bucket_plain(*args, use_alpha=use_alpha)
            margs = (scal, vw, S, win, w6)
            mk = PK.mask_tab_bucket(*margs, use_alpha=use_alpha)
            mp = PK.mask_tab_bucket_plain(*margs, use_alpha=use_alpha)
            torch.cuda.synchronize()
            _close(ga_k, ga_p, rr.expand(bsz, -1, -1), GA_RTOL)
            _close(sm_k, sm_p, rr.expand(bsz, -1, -1), SM_RTOL)
            _close(mk, mp, rr.expand(bsz, -1, -1), SM_RTOL)
            assert torch.all(ga_k[:, ~rr] == 0) and torch.all(sm_k[:, ~rr] == 0)
            assert torch.all(mk[:, ~rr] == 0)
        bargs = (scal, vs[lo:hi], gs[lo:hi], gb, G, win, md)
        dk = PK.bwd_tab_bucket(*bargs)
        dp = PK.bwd_tab_bucket_plain(*bargs)
        xk = PK.blur_bucket(scal, vw, X, win, w6)
        xp = PK.blur_bucket_plain(scal, vw, X, win, w6)
        torch.cuda.synchronize()
        _close(dk, dp, rr.expand(bsz, -1, -1), DA_RTOL)
        _close(xk, xp, rr.expand(bsz, -1, -1), SM_RTOL)
        assert torch.all(dk[:, ~rr] == 0) and torch.all(xk[:, ~rr] == 0)
    assert [f.launches for f in (PK.fwd_tab_bucket, PK.bwd_tab_bucket,
                                 PK.mask_tab_bucket, PK.blur_bucket)] == [
        counts[0] + 4, counts[1] + 2, counts[2] + 4, counts[3] + 2]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TAB_DTYPES)
@pytest.mark.parametrize("bsz", [8, 2, 20, 11])
def test_table_batched_launches_equal_per_sample(cuda, dtype, bsz):
    """One launch of B samples equals B launches of one, bit for bit: 2
    samples in one 2-sample tile, 8 in one tile of 8, 20 in three tiles of 8
    with the last ragged, 11 in a full tile and a ragged one."""
    eng = _tab_cloud(cuda, 3, dtype)
    c, m, _ = eng.xs.shape
    S = _rand(cuda, (bsz, c, m, 16), 5)
    G = _rand(cuda, (bsz, c, m, 48), 6)
    X = _rand(cuda, (bsz, c, m, 4), 7)
    ga, sm = PK.fused_perception(eng, S, d_major=True)
    mk = PK.mask_blur(eng, S)
    da = PK.gradient_adjoint_dmajor(eng, G)
    bl = PK.blur_cells(eng, X)
    for b in range(bsz):
        ga1, sm1 = PK.fused_perception(eng, S[b], d_major=True)
        assert torch.equal(ga[b], ga1) and torch.equal(sm[b], sm1)
        assert torch.equal(mk[b], PK.mask_blur(eng, S[b]))
        assert torch.equal(da[b], PK.gradient_adjoint_dmajor(eng, G[b]))
        assert torch.equal(bl[b], PK.blur_cells(eng, X[b]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TAB_DTYPES)
@pytest.mark.parametrize("bsz", [1, 2, 3, 8, 11])
def test_blur_kernel_matches_plain(cuda, dtype, bsz):
    """The blur table kernel within 1e-5 of max of its plain version, pad
    rows exactly 0, one launch a bucket, and one launch of B samples equal to
    B launches of one, bit for bit: 1 in a 1-sample tile, 2 and 3 in one
    ragged tile of 4, 8 in two full ones, 11 in two and a ragged one."""
    eng = _tab_cloud(cuda, 3, dtype)
    c, m, _ = eng.xs.shape
    X = _rand(cuda, (bsz, c, m, 4), 14)
    scal = PK.scal_vec(eng)
    real = (eng.vs > 0).reshape(-1, 64)
    for lo, hi, win, vw, _, w6 in _tab_buckets(eng):
        rr = real[lo:hi]
        n0 = PK.blur_bucket.launches
        xk = PK.blur_bucket(scal, vw, X, win, w6)
        assert PK.blur_bucket.launches == n0 + 1
        xp = PK.blur_bucket_plain(scal, vw, X, win, w6)
        torch.cuda.synchronize()
        _close(xk, xp, rr.expand(bsz, -1, -1), SM_RTOL)
        assert torch.all(xk[:, ~rr] == 0)
        for b in range(bsz):
            assert torch.equal(xk[b], PK.blur_bucket(scal, vw, X[b], win, w6))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TAB_DTYPES)
@pytest.mark.parametrize("bsz", [1, 3, 11])
def test_mask_kernel_takes_other_channel_counts(cuda, dtype, bsz):
    """The mask table kernel reads channel 3 of states of any F >= 4 (here
    5): within 1e-5 of max of its plain version with use_alpha on and off,
    pad rows exactly 0, one launch a bucket, and one launch of B samples
    equal to B launches of one, bit for bit."""
    eng = _tab_cloud(cuda, 3, dtype)
    c, m, _ = eng.xs.shape
    S = _rand(cuda, (bsz, c, m, 5), 10)
    scal = PK.scal_vec(eng)
    real = (eng.vs > 0).reshape(-1, 64)
    for lo, hi, win, vw, _, w6 in _tab_buckets(eng):
        rr = real[lo:hi]
        for use_alpha in (True, False):
            n0 = PK.mask_tab_bucket.launches
            mk = PK.mask_tab_bucket(scal, vw, S, win, w6, use_alpha=use_alpha)
            assert PK.mask_tab_bucket.launches == n0 + 1
            mp = PK.mask_tab_bucket_plain(scal, vw, S, win, w6,
                                          use_alpha=use_alpha)
            torch.cuda.synchronize()
            _close(mk, mp, rr.expand(bsz, -1, -1), SM_RTOL)
            assert torch.all(mk[:, ~rr] == 0)
            for b in range(bsz):
                assert torch.equal(mk[b], PK.mask_tab_bucket(
                    scal, vw, S[b], win, w6, use_alpha=use_alpha))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TAB_DTYPES)
def test_table_forward_cancels_a_constant_field(cuda, dtype):
    """The forward kernel's split TF32 products keep f32 accuracy: a
    constant state cancels against the quantized gsum to |gA| < 1e-4, the
    CPU test's bound (one TF32 product would not:
    tests/test_torch_tf32_split.py)."""
    eng = _tab_cloud(cuda, 3, dtype)
    S = eng.scatter(torch.full((eng.num_particles, 16), 1.7, device=cuda))
    count = PK.fwd_tab_bucket.launches
    ga, _ = PK.fused_perception(eng, S, d_major=True)
    torch.cuda.synchronize()
    assert PK.fwd_tab_bucket.launches == count + 2
    assert float(eng.gather_back(ga).abs().max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TAB_DTYPES)
def test_table_function_grad_matches_plain(cuda, dtype):
    """The perception's gradient through the table kernels (forward and
    adjoint) against the same custom backward through the plain versions."""
    eng = _tab_cloud(cuda, 3, dtype)
    c, m, _ = eng.xs.shape
    S = _rand(cuda, (2, c, m, 16), 8)
    R = _rand(cuda, (2, c, m, 16, 3), 9)
    R[:, eng.vs == 0] = 0.0
    grads = {}
    for use_kernels in (True, False):
        Sg = S.clone().requires_grad_(True)
        ga, _ = PK.perceive_cells(eng, Sg, use_kernels=use_kernels)
        (ga * R).sum().backward()
        grads[use_kernels] = Sg.grad
    _close(grads[True], grads[False], (eng.vs > 0).expand(2, -1, -1),
           DA_RTOL)


@pytest.mark.cuda
def test_table_wrappers_reject_what_the_kernels_do_not_take(cuda):
    eng = _tab_cloud(cuda, 3, "bfloat16")
    c, m, _ = eng.xs.shape
    scal = PK.scal_vec(eng)
    nb1 = eng.blk_xs.shape[0]
    S = torch.zeros((c, m, 16), device=cuda)
    ab = S.reshape(-1, 64, 16)[:nb1]
    gs = eng.gsum.reshape(-1, 64, 3)[:nb1]
    ok = [scal, ab, gs, eng.blk_vw, S, eng.blk_win_cells, eng.blk_md,
          eng.blk_w6]
    PK.fwd_tab_bucket(*ok, use_alpha=True)
    bad = {
        6: eng.blk_md.half(),  # float16 tables
        7: eng.blk_w6.float(),  # md and w6 of two dtypes
        4: S.double(),  # float64 state
        3: eng.blk_vw.cpu(),  # volumes off the card
        5: eng.blk_win_cells.long(),  # int64 window table
        2: gs[..., :2].contiguous(),  # gsum of the wrong D
    }
    for i, arg in bad.items():
        args = list(ok)
        args[i] = arg
        with pytest.raises(ValueError):
            PK.fwd_tab_bucket(*args, use_alpha=True)
    with pytest.raises(ValueError):  # F = 8
        PK.fwd_tab_bucket(scal, ab[..., :8].contiguous(), gs, eng.blk_vw,
                          S[..., :8].contiguous(), eng.blk_win_cells,
                          eng.blk_md, eng.blk_w6, use_alpha=True)
    with pytest.raises(ValueError):  # a table of another bucket's width
        PK.mask_tab_bucket(scal, eng.blk_vw, S, eng.blk_win_cells,
                           eng.blk2_w6[:nb1], use_alpha=True)
    with pytest.raises(ValueError):  # F = 3 blur (the kernel takes 4)
        PK.blur_bucket(scal, eng.blk_vw, torch.zeros((c, m, 3), device=cuda),
                       eng.blk_win_cells, eng.blk_w6)
    with pytest.raises(ValueError):  # cotangent of the wrong width
        PK.bwd_tab_bucket(scal, eng.vs.reshape(-1, 64)[:nb1], gs,
                          torch.zeros((nb1, 64, 32), device=cuda),
                          torch.zeros((c, m, 32), device=cuda),
                          eng.blk_win_cells, eng.blk_md)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TAB_DTYPES)
def test_surface_rollout_kernels_match_plain(cuda, dtype):
    from sph_nca_tpu_torch.models.surface import rollout_mesh_cells
    from sph_nca_tpu_torch.utils.meshes import (
        fibonacci_sphere,
        sphere_normals,
    )
    from sph_nca_tpu_torch.utils.seeds import surface_radial_seed

    x = fibonacci_sphere(3000, 1.0)
    eng = build_cell_engine(x, 0.2, pair_tables=dtype, device=cuda)
    xt = torch.from_numpy(x).to(cuda)
    nrm = torch.from_numpy(sphere_normals(x)).to(cuda)
    A0, t0 = surface_radial_seed(xt, nrm, 16, 5, 0.2,
                                 torch.Generator().manual_seed(0))
    g = torch.Generator(device="cpu").manual_seed(0)
    cfg = SPHNCAConfig(fire_rate=1.0, use_alpha=False,
                       normalize_perception=5.0)
    params = MLPParams(
        torch.randn(48, 256, generator=g) * 0.1, torch.zeros(256),
        torch.randn(256, 33, generator=g) * 0.1, torch.zeros(33))
    params = MLPParams(*(p.to(cuda) for p in params))
    out = {}
    for use_kernels in (True, False):
        gen = torch.Generator(device=cuda).manual_seed(0)
        out[use_kernels] = rollout_mesh_cells(
            params, cfg, eng, A0, nrm, t0, gen, 6, 0.2, fire_rate=1.0,
            use_kernels=use_kernels)
    for k, p in zip(out[True][:2], out[False][:2]):
        assert torch.isfinite(k).all()
        assert float((k - p).abs().max()) <= 1e-4


# ---- the update-MLP kernel and the batched-lane path ----------------------

# Kernel vs plain MLP: float32 sums in another order, 1e-5 of the largest
# output. With bfloat16 inputs the products are exact in float32 in both, but
# a hidden unit whose two float32 sums round to different bfloat16 values
# moves the outputs by one bfloat16 ulp of that unit (2^-8 to 2^-7 of it)
# times its weights in W2: with this test's weights one such unit moved the
# largest output by 1.02e-3 of it on the card, so a few of them stay within
# 1e-2 of the largest output. Such flips are rare: all outputs but
# MLP_FLIP_SHARE of them agree within 1e-5 of the largest (summing the first
# product in float64 instead of float32 moves ~0.06% of them past it), where a
# kernel that skipped rounding H to bfloat16 would move ~97% of them.
MLP_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
MLP_FLIP_SHARE = 0.005


def _mlp_args(device, dtype, k, hid=256, lead=(3, 40, 8), seed=0):
    """S [*lead, 16], ga [*lead, 48] (the perception's layout; the MLP reads
    its first 32 features), w1k [48, hid], b1, w2 [hid, k], b2."""
    g = torch.Generator().manual_seed(seed)
    S = torch.randn(*lead, 16, generator=g)
    ga = torch.randn(*lead, 48, generator=g)
    w1k = torch.randn(48, hid, generator=g) * 0.2
    b1 = torch.randn(hid, generator=g) * 0.1
    w2 = torch.randn(hid, k, generator=g) * 0.1
    b2 = torch.randn(k, generator=g) * 0.1
    S, ga, w1k, w2 = (t.to(device=device, dtype=dtype)
                      for t in (S, ga, w1k, w2))
    return [S, ga[..., :32], w1k, b1.to(device), w2, b2.to(device)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [33, 16])
@pytest.mark.parametrize("lead,hid", [
    ((3, 40, 8), 256),
    *(((n,), hid) for n in (1, 37, 161_792 + 37) for hid in (100, 256, 512)),
])
def test_mlp_kernel_matches_plain(cuda, dtype, k, lead, hid):
    """The kernel against its plain version, also where n is not a multiple
    of its 32-item tiles (and below one) and hid not a multiple of its
    64-unit padding or at the largest it takes. The share of outputs past
    1e-5 of max is held where there are enough of them: one flipped bf16
    hidden unit of one item moves several of the few outputs of n <= 37."""
    from sph_nca_tpu_torch.ops import mlp_kernel as MK

    args = _mlp_args(cuda, dtype, k, hid=hid, lead=lead,
                     seed=0 if lead == (3, 40, 8) else lead[0] + hid + k)
    n0 = MK.mlp_forward.launches
    got = MK.mlp_forward(*args)
    want = MK.mlp_ref(*args)
    torch.cuda.synchronize()
    assert MK.mlp_forward.launches == n0 + 1
    past = []
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == torch.float32 and g.shape == w.shape
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= MLP_RTOL[dtype] * scale
        past.append(((g - w).abs() > 1e-5 * scale).reshape(-1))
    share = float(torch.cat(past).float().mean())
    assert math.prod(lead) < 100 or share <= MLP_FLIP_SHARE


@pytest.mark.cuda
def test_mlp_kernel_grad_matches_plain(cuda):
    """Gradients through mlp_fused (kernel forward, recomputing backward)
    against autograd through mlp_ref, for every input."""
    from sph_nca_tpu_torch.ops import mlp_kernel as MK

    grads = {}
    for use_kernel in (True, False):
        args = [t.clone().requires_grad_(True) for t in _mlp_args(cuda,
                torch.float32, 33)]
        g = torch.Generator(device=cuda).manual_seed(1)
        outs = (MK.mlp_fused(*args) if use_kernel else MK.mlp_ref(*args))
        loss = sum((o * torch.randn(o.shape, generator=g, device=cuda)).sum()
                   for o in outs)
        loss.backward()
        grads[use_kernel] = [a.grad for a in args]
    for gk, gp in zip(grads[True], grads[False]):
        assert float((gk - gp).abs().max()) <= 1e-5 * float(gp.abs().max())


@pytest.mark.cuda
def test_mlp_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from sph_nca_tpu_torch.ops import mlp_kernel as MK

    ok = _mlp_args(cuda, torch.float32, 33, lead=(64,))
    MK.mlp_forward(*ok)
    S, ga, w1k, b1, w2, b2 = ok
    bad = [
        [S.double(), ga.double(), w1k.double(), b1, w2.double(), b2],
        [S.bfloat16(), ga, w1k, b1, w2, b2],  # mixed dtypes
        [S, ga, w1k, b1.double(), w2, b2],  # float64 bias
        [S[..., :8], ga[..., :16], w1k[:24], b1, w2[:, :17], b2[:17]],  # F 8
        [S, ga, w1k, b1, w2[:, :20].contiguous(), b2[:20]],  # K = 20
        [S, ga, *_mlp_args(cuda, torch.float32, 33, hid=600,
                           lead=(64,))[2:]],  # hid over the maximum
        [S, ga.cpu(), w1k, b1, w2, b2],  # off the card
        [S, torch.zeros(64, 36, device=cuda)[:, :32], w1k, b1, w2, b2],
        [S, ga[:32], w1k, b1, w2, b2],  # fewer rows of ga than of S
    ]
    for args in bad:
        with pytest.raises(ValueError):
            MK.mlp_forward(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TAB_DTYPES)
def test_batched_rollout_kernels_match_plain(cuda, dtype):
    """A 4-step batched rollout (B = 3, fire_rate 1) through the table and
    MLP kernels against the plain versions, with one launch per bucket and
    step of the forward and mask table kernels and one MLP launch a step."""
    from sph_nca_tpu_torch.models.cell_step import rollout_cells_batched
    from sph_nca_tpu_torch.ops import mlp_kernel as MK
    from sph_nca_tpu_torch.ops.batched import (
        batched_gather_back,
        batched_scatter,
    )

    eng = _tab_cloud(cuda, 3, dtype)
    g = torch.Generator(device="cpu").manual_seed(0)
    cfg = SPHNCAConfig(fire_rate=1.0, normalize_perception=4.0)
    params = MLPParams(
        torch.randn(48, 256, generator=g) * 0.1, torch.zeros(256),
        torch.randn(256, 33, generator=g) * 0.1, torch.zeros(33))
    params = MLPParams(*(p.to(cuda) for p in params))
    A = torch.rand(3, eng.num_particles, 16, generator=g).to(cuda)
    SB = batched_scatter(eng, A)
    out = {}
    for use_kernels in (True, False):
        counts = (PK.fwd_tab_bucket.launches, PK.mask_tab_bucket.launches,
                  MK.mlp_forward.launches)
        gen = torch.Generator(device=cuda).manual_seed(0)
        out[use_kernels] = batched_gather_back(eng, rollout_cells_batched(
            params, cfg, eng, SB, 3, gen, 4, 0.25, fire_rate=1.0,
            use_kernels=use_kernels), 3)
        got = (PK.fwd_tab_bucket.launches - counts[0],
               PK.mask_tab_bucket.launches - counts[1],
               MK.mlp_forward.launches - counts[2])
        assert got == ((8, 8, 4) if use_kernels else (0, 0, 0))
    assert torch.isfinite(out[True]).all()
    assert float((out[True] - out[False]).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TAB_DTYPES)
@pytest.mark.parametrize("dual", [False, True])
def test_batched_surface_rollout_kernels_match_plain(cuda, dtype, dual):
    """A 6-step batched surface rollout (B = 3, fire_rate 1) through the
    table and MLP kernels against the plain versions, with the diffusion at
    the engine's h or on a w6-only engine at 0.3, and one launch per bucket
    and step of the forward, mask and blur table kernels and one MLP launch
    a step. The scene of test_surface_rollout_kernels_match_plain: radial
    seeds (their tangents drawn per sample), a texture-mode model."""
    from sph_nca_tpu_torch.models.surface import rollout_mesh_batched_dual
    from sph_nca_tpu_torch.ops import mlp_kernel as MK
    from sph_nca_tpu_torch.utils.meshes import (
        fibonacci_sphere,
        sphere_normals,
    )
    from sph_nca_tpu_torch.utils.seeds import surface_radial_seed

    x = fibonacci_sphere(3000, 1.0)
    eng = build_cell_engine(x, 0.2, pair_tables=dtype, device=cuda)
    eng_d = (build_cell_engine(x, 0.3, pair_tables=dtype, w6_only=True,
                               device=cuda) if dual else eng)
    xt = torch.from_numpy(x).to(cuda)
    nrm = torch.from_numpy(sphere_normals(x)).to(cuda)
    seeds = [surface_radial_seed(xt, nrm, 16, 5, 0.2,
                                 torch.Generator().manual_seed(b))
             for b in range(3)]
    A0 = torch.stack([a for a, _ in seeds])
    t0 = torch.stack([t for _, t in seeds])
    g = torch.Generator(device="cpu").manual_seed(0)
    cfg = SPHNCAConfig(fire_rate=1.0, use_alpha=False,
                       normalize_perception=5.0)
    params = MLPParams(
        torch.randn(48, 256, generator=g) * 0.1, torch.zeros(256),
        torch.randn(256, 33, generator=g) * 0.1, torch.zeros(33))
    params = MLPParams(*(p.to(cuda) for p in params))
    wrappers = (PK.fwd_tab_bucket, PK.mask_tab_bucket, PK.blur_bucket,
                MK.mlp_forward)
    out = {}
    for use_kernels in (True, False):
        counts = [w.launches for w in wrappers]
        gen = torch.Generator(device=cuda).manual_seed(0)
        out[use_kernels] = rollout_mesh_batched_dual(
            params, cfg, eng, eng_d, A0, nrm, t0, gen, 6, 0.2,
            fire_rate=1.0, use_kernels=use_kernels)
        got = tuple(w.launches - c for w, c in zip(wrappers, counts))
        buckets = [int(e.blk_xs.shape[0] > 0) + int(e.blk2_xs.shape[0] > 0)
                   for e in (eng, eng_d)]
        want = (6 * buckets[0], 6 * buckets[0], 6 * buckets[1], 6)
        assert got == (want if use_kernels else (0, 0, 0, 0))
    for k, p in zip(out[True], out[False]):
        assert torch.isfinite(k).all()
        assert float((k - p).abs().max()) <= 1e-4


# ---- the band engine (ops/bands.py): library products, kernel 2.8 ----------


def _band_pair(device, dtype, periodic):
    """A band engine on the card and the same engine moved to the CPU (its
    plain version): 900 points, h = 0.25, blocks of 16 rows and far groups
    of 8, so the far buckets are exercised."""
    from sph_nca_tpu_torch.ops.bands import build_band_engine

    x = np.random.default_rng(5).uniform(-1, 1, (900, 3)).astype(np.float32)
    eng = build_band_engine(x, 0.25, period=[2.0] * 3 if periodic else None,
                            block_rows=16, far_group=8, table_dtype=dtype,
                            device=device)
    assert len(eng.far_tabs) > 0 and eng.device.type == "cuda"
    return eng, eng.to("cpu")


def _band_close(got, want, rtol):
    got, want = got.detach().cpu().float(), want.detach().float()
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= rtol * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("dtype", TAB_DTYPES)
def test_band_passes_match_plain(cuda, dtype, periodic):
    """Each band pass on the card (torch.bmm on the table's strided column
    slices, bfloat16 operands with float32 outputs; the far windows by one
    gather a bucket, put back in block order by far_perm) against its plain
    CPU version
    (float32 products): the same sums in another order, 1e-5 of max; a
    bfloat16 output 1e-2."""
    from sph_nca_tpu_torch.ops import bands as BD

    eng, cpu = _band_pair(cuda, dtype, periodic)
    b, f = 3, 16
    rng = np.random.default_rng(6)
    X = torch.from_numpy(rng.normal(size=(eng.num_cells, 16, b * f)).astype(
        np.float32))
    X[..., 3::f] = torch.from_numpy(rng.uniform(0, 0.3, (eng.num_cells, 16,
                                                         b)).astype(np.float32))
    E = torch.from_numpy(rng.normal(size=(eng.num_cells, 16, 4 * b)).astype(
        np.float32))
    for use_alpha in (True, False):
        for out_dtype in (None, "bfloat16"):
            got = BD.perceive_band_batched(eng, X.to(cuda), b, use_alpha,
                                           out_dtype=out_dtype)
            want = BD.perceive_band_batched(cpu, X, b, use_alpha,
                                            out_dtype=out_dtype)
            assert all(g.device.type == "cuda" for g in got)
            _band_close(got[0], want[0], 1e-2 if out_dtype else 1e-5)
            for g, w in zip(got[1:], want[1:]):
                _band_close(g, w, 1e-5)
        _band_close(BD.mask_blur_band(eng, X.to(cuda), b, use_alpha),
                    BD.mask_blur_band(cpu, X, b, use_alpha), 1e-5)
    _band_close(BD.blur_band(eng, E.to(cuda)), BD.blur_band(cpu, E), 1e-5)
    _band_close(BD.band_md_pass(eng, X.to(cuda)), BD.band_md_pass(cpu, X),
                1e-5)
    A = X[..., :f]
    _band_close(BD.gradient_band(eng, A.to(cuda)), BD.gradient_band(cpu, A),
                1e-5)
    _band_close(eng.volume_consistency(), cpu.volume_consistency(), 1e-5)


@pytest.mark.cuda
def test_band_perception_grad_matches_plain(cuda):
    """The perception's gradient on the card (autograd over bmm, the rolls,
    the concat and the far gather, whose backward sums over the group lists'
    reverse map in a fixed order) against the CPU's: 1e-5 of max."""
    from sph_nca_tpu_torch.ops import bands as BD

    eng, cpu = _band_pair(cuda, "float32", True)
    rng = np.random.default_rng(7)
    S = torch.from_numpy(rng.normal(size=(3, eng.num_cells, 16, 16)).astype(
        np.float32))
    W = torch.from_numpy(rng.normal(size=(3, eng.num_cells, 16, 48)).astype(
        np.float32))
    grads = []
    for e, dev in ((eng, cuda), (cpu, "cpu")):
        s = S.to(dev).requires_grad_(True)
        ga, _ = BD.perceive_band_samples(e, s)
        (ga * W.to(dev)).sum().backward()
        grads.append(s.grad)
    _band_close(grads[0], grads[1], 1e-5)


@pytest.mark.cuda
def test_band_bptt_backward_is_bit_reproducible(cuda):
    """Two backward passes of a 3-step band BPTT rollout (float32 tables,
    fire_rate 1, kernel 2.8's forward, the far gathers' and gather_back's
    fixed-order backward) give the same parameter gradients bit for bit."""
    from sph_nca_tpu_torch.models.cell_step import rollout_cells_batched
    from sph_nca_tpu_torch.ops import batched as BT

    eng, _ = _band_pair(cuda, "float32", True)
    cfg = SPHNCAConfig(channels=16, hidden=64, fire_rate=1.0,
                       normalize_perception=4.0)
    rng = np.random.default_rng(11)
    params = [torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.1)
              .to(cuda) for s in ((48, 64), (64,), (64, 33), (33,))]
    A0 = torch.from_numpy(rng.uniform(-0.5, 1.0, (2, 900, 16)).astype(
        np.float32)).to(cuda)

    def grads():
        p = [t.clone().requires_grad_(True) for t in params]
        gen = torch.Generator(device=cuda)
        gen.manual_seed(0)
        final = rollout_cells_batched(MLPParams(*p), cfg, eng,
                                      BT.batched_scatter(eng, A0), 2, gen, 3,
                                      0.25)
        loss = (BT.batched_gather_back(eng, final, 2) ** 2).mean()
        return torch.autograd.grad(loss, p)

    first, second = grads(), grads()
    assert any(float(g.abs().max()) > 0 for g in first)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mlp_dtype", [None, "bfloat16"])
def test_band_step_launches_the_mlp_kernel_once(cuda, mlp_dtype):
    """A batched step on a band engine on the card launches kernel 2.8 once
    and no pair-table kernel, and matches the same step on the CPU engine
    (1e-4 of max with a float32 MLP; with a bfloat16 MLP a hidden unit's
    rounding may flip, 1e-2)."""
    from sph_nca_tpu_torch.models.cell_step import nca_step_cells_batched
    from sph_nca_tpu_torch.ops import batched as BT
    from sph_nca_tpu_torch.ops import mlp_kernel as MK

    eng, cpu = _band_pair(cuda, "bfloat16", False)
    b = 4
    rng = np.random.default_rng(8)
    A = torch.from_numpy(rng.uniform(-0.5, 1.0, (b, 900, 16)).astype(
        np.float32))
    g = torch.Generator().manual_seed(1)
    params = MLPParams(torch.randn(48, 256, generator=g) * 0.1,
                       torch.zeros(256), torch.randn(256, 33, generator=g)
                       * 0.1, torch.zeros(33))
    cfg = SPHNCAConfig(fire_rate=1.0, normalize_perception=4.0)
    wrappers = (PK.fwd_tab_bucket, PK.bwd_tab_bucket, PK.mask_tab_bucket,
                PK.blur_bucket, PK.fwd_bucket, PK.mask_bucket, MK.mlp_forward)
    counts = [w.launches for w in wrappers]
    out = {}
    for e, dev in ((eng, cuda), (cpu, "cpu")):
        p = MLPParams(*(t.to(dev) for t in params))
        out[dev == "cpu"] = BT.batched_gather_back(e, nca_step_cells_batched(
            p, cfg, e, BT.batched_scatter(e, A.to(dev)), b,
            torch.Generator(device=dev).manual_seed(0), 0.25,
            mlp_dtype=mlp_dtype), b)
    assert [w.launches - c for w, c in zip(wrappers, counts)] == \
        [0, 0, 0, 0, 0, 0, 1]
    assert out[False].device.type == "cuda"
    _band_close(out[False], out[True], 1e-2 if mlp_dtype else 1e-4)


@pytest.mark.cuda
def test_band_engine_has_no_cpu_fallback(cuda):
    """A band engine on the card runs its passes on the card and refuses
    states on the CPU instead of carrying on there."""
    from sph_nca_tpu_torch.ops import bands as BD

    eng, _ = _band_pair(cuda, "float32", False)
    X = torch.zeros(eng.num_cells, 16, 16)
    assert BD.blur_band(eng, X.to(cuda)).device.type == "cuda"
    with pytest.raises(RuntimeError):
        BD.blur_band(eng, X)
    with pytest.raises(ValueError, match="no route"):
        BD._pair_dot(eng.Tband.to("meta"), X.to("meta"))


# ---- kernel 2.8's fused variant (ops/mlp_kernel.py fused_update) -----------


def _fused_args(device, b, nb, p, k, hid=256, seed=0):
    """The fused update's inputs at [B, nb, P] rows: moments mom [nb, 3P,
    B*16] bf16, states S in [-0.5, 1), a self term gsum, unit normals and
    unit tangents off them (components), fire draws u, and bf16 weights of
    K = k outputs."""
    g = torch.Generator().manual_seed(seed)
    mom = (torch.randn(nb, 3 * p, b * 16, generator=g) * 4).bfloat16()
    S = torch.rand(b, nb, p, 16, generator=g) * 1.5 - 0.5
    gsum = torch.randn(nb, p, 3, generator=g) * 2
    n = torch.nn.functional.normalize(torch.randn(nb, p, 3, generator=g),
                                      dim=-1)
    t = torch.randn(b, nb, p, 3, generator=g)
    t = torch.nn.functional.normalize(
        t - n * torch.sum(n * t, dim=-1, keepdim=True), dim=-1)
    u = torch.rand(b, nb, p, generator=g)
    weights = [(torch.randn(48, hid, generator=g) * 0.2).bfloat16(),
               torch.randn(hid, generator=g) * 0.1,
               (torch.randn(hid, k, generator=g) * 0.1).bfloat16(),
               torch.randn(k, generator=g) * 0.1]
    on = (lambda ts: [x.to(device) for x in ts])
    return dict(mom=mom.to(device), S=S.to(device), gsum=gsum.to(device),
                nd=on(n[..., i].contiguous() for i in range(3)),
                td=on(t[..., i].contiguous() for i in range(3)),
                weights=on(weights), u=u.to(device))


def _ulps(got, want):
    """|got - want| in units of want's last place (float32)."""
    ulp = torch.nextafter(want.abs(), torch.tensor(math.inf,
                                                   device=want.device)) \
        - want.abs()
    return (got - want).abs() / ulp


def _diffusion_strides(a, shape):
    """The tangents as the diffusion leaves them: [nb, P, B] in memory."""
    a["td"] = [t.permute(1, 2, 0).contiguous().permute(2, 0, 1)
               for t in a["td"]]
    assert a["td"][0].stride() == (1, shape[0] * shape[2], shape[0])


def _composition(a, rate, scale, sig_g=3.25):
    """The composition the fused variant replaces, on the card: the
    gradient's finish (``bands.band_gradient``), the tangent projection
    (``mlp_kernel.project_td``), kernel 2.8 on the inputs cast to the
    weights' dtype and the rule (``mlp_kernel.update_rule``). Returns the
    state and the MLP's input rows [S | x]."""
    from sph_nca_tpu_torch.ops import bands as BD
    from sph_nca_tpu_torch.ops import mlp_kernel as MK

    w = a["weights"]
    dt = w[0].dtype
    x = MK.project_td(BD.band_gradient(a["mom"], a["S"], a["gsum"], sig_g),
                      a["nd"], a["td"], include_normal=False)
    outs = MK.mlp_forward(a["S"].to(dt), x.to(dt), *w)
    return (MK.update_rule(a["S"], *outs, a["u"], rate, scale),
            torch.cat([a["S"].to(dt), x.to(dt)], dim=-1))


def _fused(a, rate, scale, sig_g=3.25):
    from sph_nca_tpu_torch.ops import mlp_kernel as MK

    return MK.fused_update(a["mom"], a["S"], a["gsum"], sig_g, a["nd"],
                           a["td"], a["weights"], a["u"], rate, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [33, 16])
@pytest.mark.parametrize("shape", [(8, 1600, 64), (3, 5, 13)])
def test_fused_update_kernel_matches_plain(cuda, shape, k):
    """The fused variant against the composition it replaces on the card,
    whose MLP is kernel 2.8: at the benchmark's surface shape (B = 8, 1600
    blocks of 64 rows) and at a ragged one (195 rows, not a whole 32-row
    tile), gated and orig; at the surface shape the tangents lie as the
    diffusion leaves them. The orig rule's state is bit-equal (the same
    input rows, the same products, the same float32 rule); the gated
    state is within 2 float32 ulps (sigmoid and tanh from two builds of the
    math library); a row that does not fire keeps its state exactly."""
    from sph_nca_tpu_torch.ops import mlp_kernel as MK

    a = _fused_args(cuda, *shape, k)
    if shape[1] > 5:
        _diffusion_strides(a, shape)
    rate, scale = 0.5, (1.0 if k == 33 else 2.0)
    n0 = MK.fused_update.launches, MK.mlp_forward.launches
    got = _fused(a, rate, scale)
    torch.cuda.synchronize()
    assert (MK.fused_update.launches, MK.mlp_forward.launches) == (
        n0[0] + 1, n0[1])
    want, _ = _composition(a, rate, scale)
    assert got.shape == want.shape and got.dtype == torch.float32
    if k == 16:
        assert torch.equal(got, want)
    else:
        assert float(_ulps(got, want).max()) <= 2.0
    still = a["u"] > rate
    assert torch.equal(got[still], a["S"][still])
    assert torch.equal(_fused(a, rate, scale), got)


def _readout(block, device):
    """Weights of the orig rule (K = 16, hid = 32) whose output is the MLP's
    input block ``block`` (0: bf16(S), 1: the tangent projection, 2: the
    bitangent's) exactly: relu(x) - relu(-x), every product by 1 or 0."""
    w1k = torch.zeros(48, 32)
    w2 = torch.zeros(32, 16)
    for i in range(16):
        w1k[16 * block + i, i], w1k[16 * block + i, 16 + i] = 1.0, -1.0
        w2[i, i], w2[16 + i, i] = 1.0, -1.0
    return [w1k.bfloat16().to(device), torch.zeros(32, device=device),
            w2.bfloat16().to(device), torch.zeros(16, device=device)]


@pytest.mark.cuda
@pytest.mark.parametrize("block", [0, 1, 2])
@pytest.mark.parametrize("shape", [(8, 1600, 64), (3, 5, 13)])
def test_fused_update_rows_match_composition(cuda, shape, block):
    """The MLP's input rows the fused variant forms are the composition's,
    bit for bit: with readout weights its output is one block of the row,
    so the orig rule's state, every row firing, is S + that block, and it
    equals the composition's at every element."""
    a = _fused_args(cuda, *shape, 16)
    if shape[1] > 5:
        _diffusion_strides(a, shape)
    a["weights"] = _readout(block, cuda)
    got = _fused(a, 1.0, 1.0)
    want, rows = _composition(a, 1.0, 1.0)
    blk = rows[..., 16 * block:16 * (block + 1)].float()
    assert torch.equal(want, a["S"] + blk)
    assert float(blk.abs().max()) > 0
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_fused_update_rejects_what_the_kernel_does_not_take(cuda):
    from sph_nca_tpu_torch.ops import mlp_kernel as MK

    a = _fused_args(cuda, 2, 3, 16, 33)
    MK.fused_update(a["mom"], a["S"], a["gsum"], 3.25, a["nd"], a["td"],
                    a["weights"], a["u"], 0.5)
    w1k, b1, w2, b2 = a["weights"]
    bad = [
        dict(mom=a["mom"].float()),
        dict(S=a["S"].bfloat16()),
        dict(mom=a["mom"][:, :, :16], S=a["S"][:1], u=a["u"][:1],
             td=[t[:1] for t in a["td"]]),  # ... with a non-contiguous mom
        dict(td=[a["td"][0]] + [t.transpose(1, 2).contiguous().transpose(
            1, 2) for t in a["td"][1:]]),  # tangents at two sets of strides
        dict(weights=[w1k.float(), b1, w2.float(), b2]),  # float32 MLP
        dict(weights=[w1k, b1, w2[:, :20].contiguous(), b2[:20]]),  # K 20
        dict(S=_misaligned(a["S"])),
        dict(u=a["u"].cpu()),  # off the card
    ]
    for change in bad:
        kw = dict(a, **change)
        with pytest.raises(ValueError):
            MK.fused_update(kw["mom"], kw["S"], kw["gsum"], 3.25, kw["nd"],
                            kw["td"], kw["weights"], kw["u"], 0.5)


@pytest.mark.cuda
def test_fused_surface_rollout_matches_composition(cuda):
    """8 steps of a bf16 surface rollout on a band engine on the card
    through the fused route (no gradient: one fused launch a step, no other
    launch of 2.8) against the same steps through the composition (the
    parameters under grad: 2.8 once a step), fire rate 0.5, from states
    alive at about one particle in seven: the same life decisions at every
    particle and step, and states within 1e-2 of the largest (a bf16 input
    of the MLP that the math library's last bit flips moves a row by that
    much)."""
    from sph_nca_tpu_torch.models.surface import rollout_mesh_batched
    from sph_nca_tpu_torch.ops import mlp_kernel as MK
    from sph_nca_tpu_torch.ops.bands import build_band_engine
    from sph_nca_tpu_torch.utils.meshes import (
        fibonacci_sphere,
        sphere_normals,
    )

    x = fibonacci_sphere(6000, 1.0)
    eng = build_band_engine(x, 0.12, table_dtype="bfloat16", device=cuda)
    nrm = torch.from_numpy(sphere_normals(x)).to(cuda)
    g = torch.Generator().manual_seed(4)
    b = 4
    A0 = torch.rand(b, x.shape[0], 16, generator=g) * 1.5 - 0.5
    A0[..., 3] = (torch.rand(b, x.shape[0], generator=g) < 0.15).float()
    A0 = A0.to(cuda)
    t0 = torch.randn(b, x.shape[0], 3, generator=g).to(cuda)
    t0 = torch.nn.functional.normalize(
        t0 - nrm * torch.sum(nrm * t0, dim=-1, keepdim=True), dim=-1)
    cfg = SPHNCAConfig(fire_rate=0.5, normalize_perception=1.0 / 0.12)
    params = MLPParams(
        torch.randn(48, 256, generator=g) * 0.2, torch.randn(256, generator=g)
        * 0.1, torch.randn(256, 33, generator=g) * 0.2,
        torch.randn(33, generator=g) * 0.1)
    out = {}
    for fused in (True, False):
        p = MLPParams(*(t.to(cuda).requires_grad_(not fused)
                        for t in params))
        counts = MK.fused_update.launches, MK.mlp_forward.launches
        out[fused] = rollout_mesh_batched(
            p, cfg, eng, A0, nrm, t0,
            torch.Generator(device=cuda).manual_seed(5), 8, 0.12,
            mlp_dtype="bfloat16", collect_all=True)
        assert (MK.fused_update.launches - counts[0],
                MK.mlp_forward.launches - counts[1]) == (
            (8, 0) if fused else (0, 8))
    states, plain = out[True][2], out[False][2].detach()
    alive = (states != 0).any(-1)
    assert torch.equal(alive, (plain != 0).any(-1))
    assert 0 < float(alive[-1].float().mean()) < 1
    assert float((states - plain).abs().max()) <= 1e-2 * float(
        plain.abs().max())


# ---- the OT loss (library calls: cuDNN convolutions, cuBLAS products) ----


def _ot_inputs(side, b, seed):
    rng = np.random.default_rng(seed)
    A = rng.uniform(-0.2, 1.2, (b, side * side, 16)).astype(np.float32)
    target = rng.random((side, side, 3)).astype(np.float32)
    return torch.from_numpy(A), torch.from_numpy(target)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gabor", "vgg_random"])
def test_ot_loss_and_grad_on_card_match_cpu(cuda, kind):
    """The OT loss and its gradient with respect to the states on the card
    against the CPU, fp32 (TF32 off): 1e-5 of the loss, 1e-4 of the largest
    |g|. At side 32 every feature set has at most 1024 rows, so the
    subsample draws do not enter."""
    from sph_nca_tpu_torch.training import losses as TL
    from sph_nca_tpu_torch.training.features import get_texture_features

    torch.backends.cudnn.allow_tf32 = False
    side = 32
    A, target = _ot_inputs(side, 3, seed=5)
    cfg = TL.OTLossConfig(image_size=side, use_alpha=False)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        fn = get_texture_features(kind, device=dev)
        t = target.to(dev)
        with torch.no_grad():
            feats = [f[0] for f in fn(t[None])]
        a = A.to(dev).requires_grad_(True)
        loss = TL.ot_loss(None, a, feats, t, fn,
                          torch.Generator(device=dev).manual_seed(0), cfg)
        loss.sum().backward()
        assert loss.device.type == dev.type
        out[dev.type] = (loss.detach().cpu(), a.grad.cpu())
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    assert torch.allclose(lg, lc, rtol=1e-5, atol=0)
    assert float((gg - gc).abs().max()) <= 1e-4 * float(gc.abs().max())


@pytest.mark.cuda
def test_ot_subsample_draws_on_the_card(cuda):
    """Above 1024 rows the loss draws its subsample from a generator on
    the card: the same seed gives the same loss, another seed another."""
    from sph_nca_tpu_torch.training import losses as TL
    from sph_nca_tpu_torch.training.features import gabor_texture_features

    side = 40
    A, target = _ot_inputs(side, 2, seed=6)
    fn = gabor_texture_features(device=cuda)
    t = target.to(cuda)
    feats = [f[0] for f in fn(t[None])]
    cfg = TL.OTLossConfig(image_size=side, use_alpha=False)

    def loss(seed):
        gen = torch.Generator(device=cuda).manual_seed(seed)
        return TL.ot_loss(None, A.to(cuda), feats, t, fn, gen, cfg)

    assert torch.equal(loss(0), loss(0))
    assert not torch.equal(loss(0), loss(1))


# ---- the fixed-K graph engine (plain PyTorch on the card) -----------------


def _graph_cloud(periodic):
    x = np.random.default_rng(7).uniform(-1, 1, (3000, 3)).astype(np.float32)
    x[:, 2] *= 0.25
    return torch.from_numpy(x), 0.2, ([2.0] * 3 if periodic else None)


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [False, True])
def test_graph_build_on_card_matches_cpu(cuda, periodic):
    """build_graph on the card: the neighbour set of every row and the drop
    count equal the CPU build's, an undersized K drops as many; the weights
    within 1e-5 of max."""
    from sph_nca_tpu_torch.ops import hashgrid as HG

    x, h, period = _graph_cloud(periodic)
    dims = HG.default_dims(h)
    mpc, k = HG.suggest_capacity(x, h, dims, period=period)
    for cap in (k, k // 2):
        lists = [HG.build_neighbor_list(x.to(dev), h, dims,
                                        max_per_cell=mpc, k=cap,
                                        period=period, chunk=1024)
                 for dev in (cuda, torch.device("cpu"))]
        assert lists[0].idx.device.type == "cuda"
        (ic, vc, dc), (ih, vh, dh) = [
            (nl.idx.cpu().numpy(), nl.valid.cpu().numpy(),
             int(nl.num_dropped)) for nl in lists]
        assert dc == dh and (dc == 0) == (cap == k)
        for row in range(len(x)):
            assert sorted(ic[row][vc[row]]) == sorted(ih[row][vh[row]])
    g, gh = [HG.build_graph(x.to(dev), h, dims, max_per_cell=mpc, k=k,
                            period=period)
             for dev in (cuda, torch.device("cpu"))]
    for name in ("v", "gv_sum"):
        got, want = getattr(g, name).cpu(), getattr(gh, name)
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max()), name


@pytest.mark.cuda
def test_graph_step_on_card_matches_cpu(cuda):
    """One graph NCA step of a batch of two on the card (fp32, TF32 off)
    against the same step on the CPU: 1e-5 of max; the state stays on the
    card and the step launches no kernel of the port."""
    from sph_nca_tpu_torch.models.nca import nca_step
    from sph_nca_tpu_torch.ops import hashgrid as HG

    x, h, period = _graph_cloud(True)
    dims = HG.default_dims(h)
    mpc, k = HG.suggest_capacity(x, h, dims, period=period)
    from sph_nca_tpu_torch.ops import mlp_kernel as MK

    cfg = SPHNCAConfig(hidden=64, fire_rate=1.0, normalize_perception=1 / h)
    gen = torch.Generator(device="cpu").manual_seed(1)
    p = MLPParams(
        torch.randn(48, 64, generator=gen) * 0.1, torch.zeros(64),
        torch.randn(64, 33, generator=gen) * 0.1, torch.zeros(33))
    A = _rand(torch.device("cpu"), (2, len(x), 16), 8)
    wrappers = (PK.fwd_bucket, PK.mask_bucket, PK.bwd_bucket,
                PK.fwd_tab_bucket, PK.bwd_tab_bucket, PK.mask_tab_bucket,
                PK.blur_bucket, MK.mlp_forward)
    before = [w.launches for w in wrappers]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        g = HG.build_graph(x.to(dev), h, dims, max_per_cell=mpc, k=k,
                           period=period)
        out[dev.type] = nca_step(
            MLPParams(*(t.to(dev) for t in p)), cfg, g, A.to(dev),
            torch.Generator(device=dev).manual_seed(0), h)
    assert out["cuda"].device.type == "cuda"
    assert [w.launches for w in wrappers] == before
    want = out["cpu"]
    assert float((out["cuda"].cpu() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


# ---- the sharded paths on one card ------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("tables", [None, "float32"])
def test_shard_major_cell_engine_matches_unsharded(cuda, tables):
    """An engine built with n_shards=2 run on one device (the bucket rows
    shard-major, split and merged by ``shards``) through its kernels (2.1 /
    2.2 / 2.3, or 2.4 / 2.5 / 2.6) against the n_shards=1 engine: 3 steps
    at fire_rate 1 to 1e-4, and the gradient of their loss to 1e-4 of
    max."""
    x = np.random.default_rng(1).uniform(-1, 1, (600, 3)).astype(np.float32)
    cfg = SPHNCAConfig(channels=16, hidden=64, fire_rate=1.0,
                       normalize_perception=4.0)
    g = torch.Generator().manual_seed(3)
    base = MLPParams(torch.randn(48, 64, generator=g) * 0.1, torch.zeros(64),
                     torch.randn(64, 33, generator=g) * 0.1, torch.zeros(33))
    A = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (600, 16)).astype(np.float32)).to(cuda)
    outs, grads = [], []
    for k in (1, 2):
        eng = build_cell_engine(x, 0.25, period=[2.0] * 3, n_shards=k,
                                pair_tables=tables, device=cuda)
        p = MLPParams(*(t.to(cuda).requires_grad_(True) for t in base))
        fin = eng.gather_back(rollout_cells(
            p, cfg, eng, eng.scatter(A), torch.Generator(device=cuda), 3,
            0.25, fire_rate=1.0))
        (fin ** 2).sum().backward()
        outs.append(fin.detach())
        grads.append([t.grad for t in p])
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-4
    for a, b in zip(grads[0], grads[1]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def _two_rank_band_rollout(eng, SB, params, cfg, b, h, steps):
    """One rank of test_two_ranks_share_a_card_over_gloo."""
    from sph_nca_tpu_torch.ops import mlp_kernel as MK
    from sph_nca_tpu_torch.parallel import band_shard as BS
    from sph_nca_tpu_torch.parallel import comm
    from sph_nca_tpu_torch.parallel import mesh as MS

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = MS.make_mesh(data=1, particle=2, backend="gloo")
    shards, st = BS.shard_band_engine(eng, 2)
    loc = BS.place_shards(shards, mesh, dev)
    comm.reset_stats()
    launches = MK.mlp_forward.launches
    with torch.no_grad():
        out = BS.rollout_band_sharded(
            MLPParams(*(t.to(dev) for t in params)), cfg, loc, st, mesh,
            MS.particle_slice(SB, mesh).to(dev), b, 0, steps, h,
            fire_rate=1.0)
    return {"final": MS.particle_gather(out, mesh).cpu(),
            "device": str(out.device), "stats": comm.read_stats(),
            "mlp_launches": MK.mlp_forward.launches - launches}


@pytest.mark.cuda
def test_two_ranks_share_a_card_over_gloo(cuda):
    """Two ranks on one card (gloo, the exchanges staged through pinned
    host buffers) run the halo-sharded band rollout, 4 steps at fire_rate
    1, each rank launching kernel 2.8 once a step; the result equals the
    unsharded rollout on the card to 1e-4 of max."""
    from sph_nca_tpu_torch.models.cell_step import rollout_cells_batched
    from sph_nca_tpu_torch.ops import _build
    from sph_nca_tpu_torch.ops.bands import build_band_engine
    from sph_nca_tpu_torch.ops.batched import batched_scatter
    from sph_nca_tpu_torch.parallel.comm import run_ranks

    _build.build()
    x = np.random.default_rng(5).uniform(-1, 1, (900, 3)).astype(np.float32)
    eng = build_band_engine(x, 0.25, block_rows=16, far_group=8,
                            block_multiple=2, device="cpu")
    b, steps = 3, 4
    g = torch.Generator().manual_seed(1)
    params = MLPParams(torch.randn(48, 256, generator=g) * 0.1,
                       torch.zeros(256), torch.randn(256, 33, generator=g)
                       * 0.1, torch.zeros(33))
    cfg = SPHNCAConfig(fire_rate=1.0, normalize_perception=4.0)
    A = torch.from_numpy(np.random.default_rng(8).uniform(
        -0.5, 1.0, (b, 900, 16)).astype(np.float32))
    SB = batched_scatter(eng, A)
    res = run_ranks(_two_rank_band_rollout, 2, eng, SB, params, cfg, b, 0.25,
                    steps, device="cuda", backend="gloo")
    geng = eng.to(cuda)
    with torch.no_grad():
        want = rollout_cells_batched(
            MLPParams(*(t.to(cuda) for t in params)), cfg, geng, SB.to(cuda),
            b, torch.Generator(device=cuda), steps, 0.25, fire_rate=1.0)
    for r in res:
        assert r["device"].startswith("cuda")
        assert r["mlp_launches"] == steps
        assert r["stats"]["staged_bytes"] > 0
        _band_close(r["final"], want.cpu(), 1e-4)


@pytest.mark.cuda
def test_step_timer_and_device_sync_wait_for_the_card(cuda):
    """A spin on the card returns to the host at once: StepTimer's interval
    and device_sync still wait for it to finish."""
    import time

    from sph_nca_tpu_torch.utils import profiling as TP

    cycles = 100_000_000  # tens of ms at the H100's clocks
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles // 10)  # warm-up
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    spin_ms = start.elapsed_time(end)
    t = time.perf_counter()
    torch.cuda._sleep(cycles)
    launch_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    assert launch_ms < 0.5 * spin_ms, (launch_ms, spin_ms)

    timer = TP.StepTimer(num_particles=10, warmup=0)
    for _ in range(2):
        with timer:
            torch.cuda._sleep(cycles)
    assert timer.summary()["mean_ms"] >= 0.9 * spin_ms

    x = torch.ones(16, device=cuda)
    torch.cuda._sleep(cycles)
    done = torch.cuda.Event()
    done.record()
    TP.device_sync({"x": [x]})
    assert done.query()

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


def _close(got, want, real, rtol):
    got, want, real = got.cpu(), want.cpu(), real.cpu()
    scale = max(float(want.abs()[real].max()), 1e-30)
    err = float((got - want).abs()[real].max())
    assert err <= rtol * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("use_alpha", [True, False])
def test_bucket_kernels_match_plain(cuda, dim, use_alpha):
    eng, S = _cloud(cuda, dim)
    scal = PK.scal_vec(eng)
    nb1 = eng.blk_xs.shape[0]
    real = (eng.vs > 0).reshape(-1, 64)
    rows = S.reshape(-1, 64, 16)
    n_fwd, n_mask = PK.fwd_bucket.launches, PK.mask_bucket.launches
    for xs_b, xw_b, vw_b, win, ab, rr in (
        (eng.blk_xs, eng.blk_xw, eng.blk_vw, eng.blk_win_cells, rows[:nb1],
         real[:nb1]),
        (eng.blk2_xs, eng.blk2_xw, eng.blk2_vw, eng.blk2_win_cells,
         rows[nb1:], real[nb1:]),
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

"""Port parity: the pair pass (fused perception, life-mask blur) against the
JAX package's Pallas kernels, which run in Pallas interpret mode on the CPU
as tests/test_pallas.py runs them.

On the CPU the port's wrappers run their plain PyTorch versions. The CUDA
kernels are held against those plain versions on the card by
tests/test_torch_cuda.py and by chip_smoke.py.

Tolerance: both sides sum the window in float32 in different orders; the
gradient is a difference of two sums of size |A| * sum|Tg r|, so its error is
bounded relative to the largest gradient entry (1e-5 * max|gA|, measured
~2e-6). The mask blur sums positive terms: 1e-5 relative.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sph_nca_tpu.ops.cells import build_cell_engine as jax_build
from sph_nca_tpu.ops.pallas import pair_kernel as JP
from sph_nca_tpu_torch.ops import pair_kernel as TP
from sph_nca_tpu_torch.ops.cells import PAD_POS, build_cell_engine

GA_RTOL = 1e-5  # of max|gA|
SM_RTOL = 1e-5


def _grid_xyz(m):
    g = (np.stack(np.meshgrid(np.arange(m), np.arange(m), indexing="ij"),
                  -1) + 0.5) / m * 2 - 1
    return np.pad(g.reshape(-1, 2).astype(np.float32), ((0, 0), (0, 1)))


def _scene(kind):
    """(jax engine, torch engine): the CLI's padded grid at h = 0.1 (one
    bucket) or a random 3D periodic cloud (both buckets)."""
    if kind == "grid":
        x, h, period = _grid_xyz(24), 0.1, None
    else:
        x = np.random.default_rng(1).uniform(-1, 1, (300, 3)).astype(
            np.float32)
        h, period = 0.25, [2.0] * 3
    je = jax_build(jnp.asarray(x), h,
                   period=None if period is None else jnp.asarray(period))
    return je, build_cell_engine(x, h, period=period, device="cpu")


@pytest.fixture(scope="module", params=["grid", "cloud"])
def engines(request):
    return _scene(request.param)


def _state(te, f=16, seed=0):
    S = np.random.default_rng(seed).normal(
        size=tuple(te.xs.shape[:2]) + (f,)).astype(np.float32)
    return S


def _close(got, want, real, rtol):
    scale = max(float(np.max(np.abs(want[real]))), 1e-30)
    err = float(np.max(np.abs(got - want)[real]))
    assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("use_alpha", [True, False])
@pytest.mark.parametrize("d_major", [True, False])
def test_fused_perception_matches_pallas(engines, use_alpha, d_major):
    je, te = engines
    S = _state(te)
    ga_j, sm_j = JP.fused_perception_pallas(
        je, jnp.asarray(S), use_alpha=use_alpha, d_major=d_major)
    ga_t, sm_t = TP.fused_perception(te, torch.from_numpy(S),
                                     use_alpha=use_alpha, d_major=d_major)
    assert ga_t.shape == ga_j.shape and sm_t.shape == sm_j.shape
    # pad slots hold phantom geometry in both packages and are never read
    real = te.vs.numpy() > 0
    _close(ga_t.numpy(), np.asarray(ga_j), real, GA_RTOL)
    _close(sm_t.numpy(), np.asarray(sm_j), real, SM_RTOL)


@pytest.mark.parametrize("use_alpha", [True, False])
def test_mask_blur_matches_pallas(engines, use_alpha):
    je, te = engines
    S = _state(te, seed=2)
    sm_j = np.asarray(JP.mask_blur_pallas(je, jnp.asarray(S),
                                          use_alpha=use_alpha))
    sm_t = TP.mask_blur(te, torch.from_numpy(S), use_alpha=use_alpha).numpy()
    _close(sm_t, sm_j, te.vs.numpy() > 0, SM_RTOL)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("use_alpha", [True, False])
def test_mask_blur_pad_rows_match_pallas(dim, use_alpha):
    """The pad rows of the recompute mask, on the periodic cloud that
    tests/test_torch_cuda.py holds the mask kernel on (600 points, h 0.25,
    period 2): in 3D the reference itself is nonzero on some pad rows (pad
    rows and window slots stored at the same large offset lie within h), in
    2D on none. The port is zero on exactly the pad rows where the Pallas
    kernel is, and within 1e-5 of max of it on all of them."""
    x = np.random.default_rng(1).uniform(-1, 1, (600, dim)).astype(
        np.float32)
    je = jax_build(jnp.asarray(x), 0.25, period=jnp.asarray([2.0] * dim))
    te = build_cell_engine(x, 0.25, period=[2.0] * dim, device="cpu")
    S = _state(te, seed=13)
    sm_j = np.asarray(JP.mask_blur_pallas(je, jnp.asarray(S),
                                          use_alpha=use_alpha))
    sm_t = TP.mask_blur(te, torch.from_numpy(S), use_alpha=use_alpha).numpy()
    pad = te.vs.numpy() <= 0
    np.testing.assert_array_equal(sm_t[pad] != 0, sm_j[pad] != 0)
    assert (np.count_nonzero(sm_j[pad]) > 0) == (dim == 3)
    scale = float(np.max(np.abs(sm_j)))
    assert float(np.max(np.abs(sm_t - sm_j)[pad])) <= SM_RTOL * scale


def _self_and_pad_bucket(d=3, f=16):
    """One block: row 0 is a real particle at (0.01, ...); its window holds
    one copy of that same slot (the self pair, d2 == 0 exactly) and M-1 pad
    slots at PAD_POS with nonzero volume (as pad window entries carry)."""
    m, p = 8, 64
    xs_b = np.full((1, d, p), PAD_POS, np.float32)
    xs_b[0, :, 0] = 0.01
    xw_b = np.full((1, d, m), 2 * PAD_POS, np.float32)
    xw_b[0, :, 0] = 0.01
    vw_b = np.full((1, m), 0.7, np.float32)
    S = np.random.default_rng(3).normal(size=(8, m, f)).astype(np.float32)
    S[0, 0, 3] = 1.0  # alive
    win = np.zeros((1, 1), np.int32)  # window cell 0
    ab = S.reshape(-1, p, f)[:1]
    return xs_b, ab, xw_b, vw_b, S, win


@pytest.mark.parametrize("use_alpha", [True, False])
def test_self_pair_and_pad_slots_contribute_nothing(use_alpha):
    h = 0.1
    scal = (float(np.float32(h)), float(np.float32(1e4)),
            float(np.float32(3e5)), float(np.float32(0.1)))
    xs_b, ab, xw_b, vw_b, S, win = _self_and_pad_bucket()
    t = torch.from_numpy
    ga, sm = TP.fwd_bucket(scal, t(xs_b), t(ab), t(xw_b), t(vw_b), t(S),
                           t(win), use_alpha=use_alpha)
    # gradient: mag(0) == 0 and pad pairs are beyond h -> exactly zero
    assert torch.all(ga[0, 0] == 0)
    # blur: only the self pair counts, W(0) = h^6
    h32 = np.float32(h)
    want = np.float32(scal[1]) * (h32 * h32) ** 3 * np.float32(0.7)
    np.testing.assert_allclose(sm[0, 0].item(), want, rtol=1e-6)
    sm2 = TP.mask_bucket(scal, t(xs_b), t(xw_b), t(vw_b), t(S), t(win),
                         use_alpha=use_alpha)
    assert sm2[0, 0].item() == sm[0, 0].item()
    # the Pallas kernels give the same on the same block
    Sw = S.reshape(8, -1)[win].reshape(1, 8, -1)
    ga_j, sm_j = JP.fwd_bucket(jnp.asarray(scal, jnp.float32), xs_b, ab,
                               xw_b, vw_b, Sw, use_alpha=use_alpha)
    assert np.all(np.asarray(ga_j)[0, 0] == 0)
    np.testing.assert_allclose(np.asarray(sm_j)[0, 0, 0], sm[0, 0].item(),
                               rtol=1e-6)


def test_scal_vec_is_float32_exact(engines):
    je, te = engines
    np.testing.assert_array_equal(np.asarray(TP.scal_vec(te), np.float32),
                                  np.asarray(JP.scal_vec(je)))


def test_split_merge_rows_round_trip():
    a = torch.arange(10 * 3).reshape(10, 3)
    r1, r2 = TP.split_rows(a, 7)
    assert torch.equal(TP.merge_rows(r1, r2), a)
    assert TP.merge_rows(a, a[:0]) is a


def test_wrappers_refuse_devices_without_kernel():
    """No silent fallback: a tensor that is neither on the CPU nor on a CUDA
    card gets an error, not the plain version."""
    xs_b, ab, xw_b, vw_b, S, win = (torch.from_numpy(a).to("meta")
                                    for a in _self_and_pad_bucket())
    scal = (0.1, 1.0, 1.0, 0.1)
    with pytest.raises(ValueError):
        TP.fwd_bucket(scal, xs_b, ab, xw_b, vw_b, S, win, use_alpha=True)
    with pytest.raises(ValueError):
        TP.mask_bucket(scal, xs_b, xw_b, vw_b, S, win, use_alpha=True)

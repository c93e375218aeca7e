"""Port parity: the perception's backward (the SPH-gradient adjoint) against
the JAX package, whose Pallas kernels run in interpret mode on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernel is held against those on the card by tests/test_torch_cuda.py and
chip_smoke.py.

Tolerances. gsum: both packages evaluate the same f32 formula, XLA with its
sums contracted into FMAs and in another order, so they agree to a few ulp of
the largest |gsum| (1e-6 of it; measured ~2e-7). The adjoint is a difference
of window sums like the forward gradient: 1e-5 of max |dA| (measured ~6e-7).
Gradients through the custom VJP: 1e-5 of the largest entry.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sph_nca_tpu.ops.cells import build_cell_engine as jax_build
from sph_nca_tpu.ops.pallas import pair_kernel as JP
from sph_nca_tpu_torch.ops import pair_kernel as TP
from sph_nca_tpu_torch.ops.cells import build_cell_engine

GSUM_RTOL = 1e-6  # of max |gsum|
DA_RTOL = 1e-5  # of max |dA|


def _scene(kind):
    """(jax engine, torch engine) on a random 3D cloud that fills both
    window-size buckets: periodic (the pair-kernel tests' cloud) or a
    non-periodic slab."""
    rng = np.random.default_rng(1)
    if kind == "periodic":
        x = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
        h, period = 0.25, [2.0] * 3
    else:
        x = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
        x[:, 2] *= 0.3
        h, period = 0.3, None
    je = jax_build(jnp.asarray(x), h,
                   period=None if period is None else jnp.asarray(period))
    te = build_cell_engine(x, h, period=period, device="cpu")
    assert te.blk_xs.shape[0] > 0 and te.blk2_xs.shape[0] > 0
    return je, te


@pytest.fixture(scope="module", params=["periodic", "slab"])
def engines(request):
    return _scene(request.param)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, rtol, mask=None):
    got, want = np.asarray(got), np.asarray(want)
    if mask is not None:
        got, want = got[mask], want[mask]
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * scale, (err, scale)


def test_gsum_matches_jax(engines):
    je, te = engines
    assert te.gsum.shape == tuple(je.gsum.shape)
    _close(te.gsum.numpy(), je.gsum, GSUM_RTOL)
    # pad slots carry no self term
    assert torch.all(te.gsum[te.vs == 0] == 0)


def test_bwd_bucket_plain_matches_pallas(engines):
    je, te = engines
    c, m, _ = te.xs.shape
    p = te.blk_xs.shape[2]
    G = _normal((c, m, 48), 3)
    scal = TP.scal_vec(te)
    nb1 = te.blk_xs.shape[0]
    rows = G.reshape(-1, p, 48)
    vs = te.vs.numpy().reshape(-1, p)
    gs = te.gsum.numpy().reshape(-1, p, 3)
    for lo, hi, xs_b, xw_b, win in (
        (0, nb1, te.blk_xs, te.blk_xw, te.blk_win_cells),
        (nb1, vs.shape[0], te.blk2_xs, te.blk2_xw, te.blk2_win_cells),
    ):
        gw = G.reshape(c, -1)[win.numpy()].reshape(hi - lo, -1, 48)
        want = JP.bwd_bucket(jnp.asarray(scal, jnp.float32), xs_b.numpy(),
                             vs[lo:hi, None, :], gs[lo:hi], rows[lo:hi],
                             xw_b.numpy(), gw)
        got = TP.bwd_bucket_plain(scal, xs_b, torch.from_numpy(vs[lo:hi]),
                                  torch.from_numpy(gs[lo:hi]),
                                  torch.from_numpy(rows[lo:hi]), xw_b,
                                  torch.from_numpy(G), win)
        assert got.shape == (hi - lo, p, 16)
        _close(got.numpy(), want, DA_RTOL)


def test_gradient_adjoint_matches_pallas(engines):
    je, te = engines
    G = _normal(tuple(te.xs.shape[:2]) + (48,), 4)
    want = JP.gradient_adjoint_dmajor_pallas(je, je.gsum, jnp.asarray(G))
    got = TP.gradient_adjoint_dmajor(te, torch.from_numpy(G))
    assert got.shape == tuple(want.shape)
    _close(got.numpy(), want, DA_RTOL)
    # pad rows (v = 0, gsum = 0) get exactly nothing
    assert torch.all(got[te.vs == 0] == 0)


def _loss_weights(te, seed):
    """A cotangent for gA that is zero on pad rows, as in training: pad
    rows hold phantom values that never reach a loss."""
    R = _normal(tuple(te.xs.shape[:2]) + (48,), seed)
    R[te.vs.numpy() == 0] = 0.0
    return R


@pytest.mark.parametrize("use_alpha", [True, False])
def test_function_grad_matches_jax_and_plain_autograd(engines, use_alpha):
    je, te = engines
    S = _normal(tuple(te.xs.shape[:2]) + (16,), 5)
    R = _loss_weights(te, 6)

    def jloss(s):
        ga, sm = JP.perceive_cells_dmajor(je, s, use_alpha)
        return jnp.sum(ga * R) + jnp.sum(sm)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(S)))

    St = torch.from_numpy(S).requires_grad_(True)
    ga, sm = TP.perceive_cells_dmajor(te, St, use_alpha)
    assert not sm.requires_grad  # the mask blur is stop-gradient
    (torch.sum(ga * torch.from_numpy(R)) + sm.sum()).backward()
    _close(St.grad.numpy(), want, DA_RTOL)

    # the same gradient by autograd through the plain forward
    Sp = torch.from_numpy(S).requires_grad_(True)
    gp, _ = TP.fused_perception(te, Sp, use_alpha=use_alpha, d_major=True,
                                use_kernels=False)
    torch.sum(gp * torch.from_numpy(R)).backward()
    _close(St.grad.numpy(), Sp.grad.numpy(), DA_RTOL)


def test_batch_axis_equals_per_sample(engines):
    """The batched entry points give each sample what it gets alone."""
    _, te = engines
    c, m, _ = te.xs.shape
    S = torch.from_numpy(_normal((3, c, m, 16), 7))
    G = torch.from_numpy(_normal((3, c, m, 48), 8))
    for d_major in (True, False):
        ga, sm = TP.fused_perception(te, S, d_major=d_major)
        for b in range(3):
            ga1, sm1 = TP.fused_perception(te, S[b], d_major=d_major)
            assert torch.equal(ga[b], ga1) and torch.equal(sm[b], sm1)
    sm = TP.mask_blur(te, S)
    da = TP.gradient_adjoint_dmajor(te, G)
    for b in range(3):
        assert torch.equal(sm[b], TP.mask_blur(te, S[b]))
        assert torch.equal(da[b], TP.gradient_adjoint_dmajor(te, G[b]))


def test_bwd_wrapper_refuses_devices_without_kernel(engines):
    """No silent fallback: meta tensors get an error, not the plain
    version."""
    _, te = engines
    c, m, _ = te.xs.shape
    p = te.blk_xs.shape[2]
    nb1 = te.blk_xs.shape[0]
    args = [te.blk_xs, te.vs.reshape(-1, p)[:nb1],
            te.gsum.reshape(-1, p, 3)[:nb1], torch.zeros(nb1, p, 48),
            te.blk_xw, torch.zeros(c, m, 48), te.blk_win_cells]
    with pytest.raises(ValueError):
        TP.bwd_bucket(TP.scal_vec(te), *(a.to("meta") for a in args))

"""Port parity: SPH kernel functions and normalizations against the JAX
package (sph_nca_tpu.ops.kernels), same numpy-seeded inputs.

Tolerance: the formulas are the same float32 expressions, so values agree to
a few ulps (rtol 1e-6); normalizations are float64 Python math and must be
equal.
"""

import numpy as np
import pytest
import torch

from sph_nca_tpu.ops import hashgrid as JH
from sph_nca_tpu.ops import kernels as JK
from sph_nca_tpu_torch.ops import hashgrid as TH
from sph_nca_tpu_torch.ops import kernels as TK


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("h", [0.1, 0.25])
def test_norms_equal(dim, h):
    assert TK.poly6_norm(h, dim) == JK.poly6_norm(h, dim)
    assert TK.spiky_norm(h, dim) == JK.spiky_norm(h, dim)


def test_norms_reject_other_dims():
    with pytest.raises(NotImplementedError):
        TK.poly6_norm(0.1, 4)
    with pytest.raises(NotImplementedError):
        TK.spiky_norm(0.1, 1)


def test_poly6_matches_jax(rng):
    h = np.float32(0.1)
    d2 = rng.uniform(0.0, 0.02, size=(512,)).astype(np.float32)
    d2[:4] = [0.0, h * h, 1e12, 1e-12]  # self pair, support edge, pad slot
    want = np.asarray(JK.poly6_w(d2, h))
    got = TK.poly6_w(torch.from_numpy(d2), torch.tensor(h)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[2] == 0.0 and got[1] == 0.0


@pytest.mark.parametrize("dim", [2, 3])
def test_spiky_grad_matches_jax(rng, dim):
    h = np.float32(0.1)
    r = rng.uniform(-0.12, 0.12, size=(512, dim)).astype(np.float32)
    r[0] = 0.0  # self pair: the d2 > 0 guard must give exactly 0
    r[1] = 1e6  # pad slot
    want = np.asarray(JK.spiky_grad(r, h))
    got = TK.spiky_grad(torch.from_numpy(r), torch.tensor(h)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.all(got[:2] == 0.0)


def test_spiky_grad_finite_gradient_at_zero():
    """The guard keeps autograd finite at r == 0, as in the JAX package."""
    r = torch.zeros((1, 2), requires_grad=True)
    TK.spiky_grad(r, 0.1).sum().backward()
    assert torch.isfinite(r.grad).all()


@pytest.mark.parametrize("dim", [2, 3])
def test_hashgrid_helpers_match_jax(dim):
    np.testing.assert_array_equal(TH._stencil_offsets(dim),
                                  JH._stencil_offsets(dim))
    dims = TH._dims_tuple(20, dim)
    assert dims == JH._dims_tuple(20, dim)
    np.testing.assert_array_equal(TH._strides(dims), JH._strides(dims))
    with pytest.raises(ValueError):
        TH._dims_tuple(2, dim)  # the 3^D stencil would double-count

"""Port parity: the cell-engine build against sph_nca_tpu.ops.cells.

Integer layouts must equal the JAX build exactly. Positions are the same
float64 -> float32 roundings, so they must be equal too. Volumes are float32
sums over the window in another order, so they agree to within 1e-6
relative.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sph_nca_tpu.ops.cells import build_cell_engine as jax_build
from sph_nca_tpu.ops.cells import _hilbert_code as jax_hilbert
from sph_nca_tpu.ops.cells import _morton_code as jax_morton
from sph_nca_tpu_torch.ops.cells import PAD_POS, _hilbert_code, _morton_code
from sph_nca_tpu_torch.ops.cells import build_cell_engine

INT_FIELDS = ["slot_of_particle", "win_cells", "blk_win_cells",
              "blk2_win_cells"]
POS_FIELDS = ["xs", "xw", "blk_xs", "blk_xw", "blk2_xs", "blk2_xw"]
VOL_FIELDS = ["vs", "vw", "blk_vw", "blk2_vw"]


def _engines(rng, n, dim, periodic, h=0.25):
    x = rng.uniform(-1, 1, (n, dim)).astype(np.float32)
    period = [2.0] * dim if periodic else None
    je = jax_build(jnp.asarray(x), h,
                   period=None if period is None else jnp.asarray(period))
    te = build_cell_engine(x, h, period=period, device="cpu")
    return x, je, te


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("periodic", [False, True])
def test_layout_matches_jax(rng, dim, periodic):
    _, je, te = _engines(rng, 300, dim, periodic)
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(te, name).numpy(),
                                      np.asarray(getattr(je, name)), name)
    for name in POS_FIELDS:
        np.testing.assert_array_equal(getattr(te, name).numpy(),
                                      np.asarray(getattr(je, name)), name)
    for name in VOL_FIELDS:
        np.testing.assert_allclose(getattr(te, name).numpy(),
                                   np.asarray(getattr(je, name)),
                                   rtol=1e-6, atol=0, err_msg=name)
    assert (te.h, te.sig_w, te.sig_g) == (
        float(je.h), float(je.sig_w), float(je.sig_g))
    # this scene fills both window-size buckets
    assert te.blk_xs.shape[0] > 0 and te.blk2_xs.shape[0] > 0


def test_padded_grid_layout_matches_jax():
    """The CLI's layout: a regular 2D grid padded to 3D (z = 0)."""
    m = 20
    g = (np.stack(np.meshgrid(np.arange(m), np.arange(m), indexing="ij"),
                  -1) + 0.5) / m * 2 - 1
    x = np.pad(g.reshape(-1, 2).astype(np.float32), ((0, 0), (0, 1)))
    je = jax_build(jnp.asarray(x), 0.1)
    te = build_cell_engine(x, 0.1, device="cpu")
    for name in INT_FIELDS + POS_FIELDS:
        np.testing.assert_array_equal(getattr(te, name).numpy(),
                                      np.asarray(getattr(je, name)), name)
    np.testing.assert_allclose(te.vs.numpy(), np.asarray(je.vs), rtol=1e-6)


def test_curve_codes_match_jax(rng):
    c = rng.integers(0, 37, size=(200, 3))
    np.testing.assert_array_equal(_morton_code(c), jax_morton(c))
    np.testing.assert_array_equal(_hilbert_code(c), jax_hilbert(c))


def test_scatter_gather_round_trip(rng):
    x, je, te = _engines(rng, 250, 2, False)
    A = rng.normal(size=(250, 5)).astype(np.float32)
    S = te.scatter(torch.from_numpy(A))
    np.testing.assert_array_equal(S.numpy(), np.asarray(je.scatter(A)))
    np.testing.assert_array_equal(te.gather_back(S).numpy(), A)
    # padded slots are zero and sit at PAD_POS
    pad = te.vs.numpy() == 0
    assert np.all(S.numpy()[pad] == 0)
    assert np.all(te.xs.numpy()[pad] >= PAD_POS / 2)


def test_window_gathers_match_jax(rng):
    _, je, te = _engines(rng, 300, 3, True)
    S = rng.normal(size=tuple(te.xs.shape[:2]) + (4,)).astype(np.float32)
    St = torch.from_numpy(S)
    np.testing.assert_array_equal(te.window(St).numpy(),
                                  np.asarray(je.window(jnp.asarray(S))))
    for bucket in (1, 2):
        np.testing.assert_array_equal(
            te.block_window(St, bucket).numpy(),
            np.asarray(je.block_window(jnp.asarray(S), bucket)))

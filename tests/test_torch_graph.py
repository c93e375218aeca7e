"""Port parity: the fixed-K graph engine's build (``ops/hashgrid.py``), the
dense oracle (``ops/dense.py``) and the neighbour ops (``ops/neighbor_ops.py``)
against the JAX package, on the CPU.

Neighbour lists are compared row by row as sets of valid lanes (no code
relies on the lane order), and their drop counts exactly. Weights and ops
hold to JAX within 1e-5 of the largest value (float32 sums in other orders);
their gradients in A and x (``torch.autograd`` against ``jax.grad``) too.
The golden fixtures' weight-free fields (``tests/golden/reference_forward.py``,
a float64 transcription of the reference independent of JAX) hold to 1e-9
relative in float64.
"""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sph_nca_tpu import ops as J
from sph_nca_tpu.ops import dense as JD
from sph_nca_tpu.ops import neighbor_ops as JN
from sph_nca_tpu_torch.io.convert import (
    graph_from_jax_numpy,
    neighbor_list_from_jax_numpy,
)
from sph_nca_tpu_torch.models.nca import life_mask
from sph_nca_tpu_torch.ops import dense as TD
from sph_nca_tpu_torch.ops import hashgrid as T
from sph_nca_tpu_torch.ops import neighbor_ops as TN

RTOL = 1e-5  # of max
GOLDEN_RTOL = 1e-9
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# (dimension, periodic): random clouds in [-1, 1)^D; periodic ones need
# cells that tile the period (2 / h whole), as in the JAX package
SCENES = [(2, False), (3, False), (2, True), (3, True)]
SCENE_IDS = ["2d", "3d", "2d-periodic", "3d-periodic"]


def _scene(d, periodic, n=500, h=0.25, seed=0):
    x = np.random.default_rng(seed).uniform(-1, 1, (n, d)).astype(np.float32)
    period = [2.0] * d if periodic else None
    return x, h, J.default_dims(h), period


def _jperiod(period):
    return None if period is None else jnp.asarray(period, jnp.float32)


def _gap(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _row_sets(idx, valid):
    idx, valid = np.asarray(idx), np.asarray(valid)
    return [sorted(r[v].tolist()) for r, v in zip(idx, valid)]


@functools.lru_cache(maxsize=None)
def _jax_list(d, periodic, n, h):
    """A scene's exact JAX neighbour list (each build compiles once)."""
    x, h, dims, period = _scene(d, periodic, n=n, h=h)
    mpc, k = J.suggest_capacity(x, h, dims, period=period)
    return J.build_neighbor_list(jnp.asarray(x), h, dims, max_per_cell=mpc,
                                 k=k, period=_jperiod(period))


def _carried(d, periodic, n, h):
    """A scene, JAX's exact neighbour list and graph on it, and both carried
    into the port: (x, h, period, jnl, jg, tnl, tg)."""
    x, h, _, period = _scene(d, periodic, n=n, h=h)
    jnl = _jax_list(d, periodic, n, h)
    jg = J.graph_from_neighbor_list(jnp.asarray(x), h, jnl,
                                    period=_jperiod(period))
    tnl = neighbor_list_from_jax_numpy(jnl.idx, jnl.valid, jnl.num_dropped,
                                       device="cpu")
    tg = graph_from_jax_numpy(*(np.asarray(a) for a in jg), device="cpu")
    return x, h, period, jnl, jg, tnl, tg


@pytest.mark.parametrize("d,periodic", SCENES, ids=SCENE_IDS)
def test_suggest_capacity_matches_jax(d, periodic):
    x, h, dims, period = _scene(d, periodic)
    want = J.suggest_capacity(x, h, dims, period=period)
    assert T.suggest_capacity(x, h, dims, period=period) == want
    assert T.suggest_capacity(torch.from_numpy(x), h, dims,
                              period=period) == want


@pytest.mark.parametrize("d,periodic", SCENES, ids=SCENE_IDS)
def test_build_neighbor_list_matches_jax(d, periodic):
    """Per-row neighbour sets and drop counts equal JAX's: exact capacities,
    an undersized K and an undersized cell capacity; the exact list's sets
    are the dense pairs within h."""
    x, h, dims, period = _scene(d, periodic)
    mpc, k = J.suggest_capacity(x, h, dims, period=period)
    for cap_mpc, cap_k in ((mpc, k), (mpc, k // 3), (mpc // 2, k)):
        jnl = J.build_neighbor_list(jnp.asarray(x), h, dims,
                                    max_per_cell=cap_mpc, k=cap_k,
                                    period=_jperiod(period))
        tnl = T.build_neighbor_list(torch.from_numpy(x), h, dims,
                                    max_per_cell=cap_mpc, k=cap_k,
                                    period=period, chunk=128)
        assert tnl.idx.dtype == torch.int32 and tnl.k == cap_k
        assert int(tnl.num_dropped) == int(jnl.num_dropped)
        assert _row_sets(tnl.idx, tnl.valid) == _row_sets(jnl.idx, jnl.valid)
        assert bool((tnl.idx[~tnl.valid] == 0).all())
    assert int(jnl.num_dropped) > 0  # the last capacities were undersized
    exact = T.build_neighbor_list(torch.from_numpy(x), h, dims,
                                  max_per_cell=mpc, k=k, period=period)
    assert int(exact.num_dropped) == 0
    d2 = np.sum(TD.displacements(torch.from_numpy(x), period).numpy() ** 2,
                -1)
    assert _row_sets(exact.idx, exact.valid) == [
        np.flatnonzero(r < np.float32(h * h)).tolist() for r in d2]


def test_build_graph_retry_ends_exact():
    """Capacities far too small: build_graph retries at 1.5x until the list
    is exact, as JAX's does (8 -> 16 -> 24 -> 40 for both), and the lists
    and volumes then equal the dense ones; exact=False keeps the undersized
    list."""
    x, h, dims, period = _scene(2, True, n=400)
    xt = torch.from_numpy(x)
    g = T.build_graph(xt, h, dims, max_per_cell=8, k=8, period=period)
    assert g.k == 40
    d2 = np.sum(TD.displacements(xt, period).numpy() ** 2, -1)
    assert _row_sets(g.idx, g.valid) == [
        np.flatnonzero(r < np.float32(h * h)).tolist() for r in d2]
    assert _gap(g.v, TD.volume(xt, h, period=period)) <= RTOL
    small = T.build_graph(xt, h, dims, max_per_cell=8, k=8, period=period,
                          exact=False)
    assert small.k == 8


@pytest.mark.parametrize("smoothing", ["poly6", "wendlandC2", "wendlandC4"])
@pytest.mark.parametrize("d,periodic", SCENES, ids=SCENE_IDS)
def test_graph_weights_match_jax(d, periodic, smoothing):
    """graph_from_neighbor_list on JAX's own lanes (carried across): v, wv,
    gv and gv_sum lane for lane."""
    x, h, _, period = _scene(d, periodic)
    jnl = _jax_list(d, periodic, 500, h)
    jg = J.graph_from_neighbor_list(jnp.asarray(x), h, jnl,
                                    period=_jperiod(period),
                                    smoothing=smoothing)
    tnl = neighbor_list_from_jax_numpy(jnl.idx, jnl.valid, jnl.num_dropped,
                                       device="cpu")
    tg = T.graph_from_neighbor_list(torch.from_numpy(x), h, tnl,
                                    period=period, smoothing=smoothing)
    for name in ("v", "wv", "gv", "gv_sum"):
        assert _gap(getattr(tg, name), getattr(jg, name)) <= RTOL, name
    assert tg.device.type == "cpu" and tg.n == x.shape[0]


def _jax_ops(mod, h, period, nl=None):
    """JAX's volume, count, gradient, divergence and blur of module ``mod``
    (dense, or the general neighbour ops on ``nl``) and the gradient in
    (x, A) of sum(gradient * R) + sum(blur * R[..., 0]), in one jitted
    call (one compile instead of one an op)."""
    lists = () if nl is None else (nl,)
    jp = _jperiod(period)

    def ops(x, A, V):
        v = mod.volume(x, h, *lists, period=jp)
        return (v, mod.count(x, h, *lists, period=jp),
                mod.gradient(x, v, A, h, *lists, period=jp),
                mod.divergence(x, v, V, h, *lists, period=jp),
                mod.blur(x, v, A, h, *lists, period=jp))

    def loss(x, A, R):
        _, _, ga, _, sa = ops(x, A, A[..., None])
        return jnp.sum(ga * R) + jnp.sum(sa * R[..., 0])

    return jax.jit(lambda x, A, V, R: (ops(x, A, V), jax.grad(
        loss, argnums=(0, 1))(x, A, R)))


def _hold_ops(t_ops, want, x, A, V, R):
    """The port's ops ``t_ops(x, A, V) -> (v, count, gradient, divergence,
    blur)`` and their gradient against ``_jax_ops``' results."""
    tx, tA, tV, tR = (torch.from_numpy(a) for a in (x, A, V, R))
    (v, cnt, ga, da, sa), (gx, gA) = want
    got = t_ops(tx, tA, tV)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(cnt))
    for name, g, w in zip(("volume", "gradient", "divergence", "blur"),
                          got[:1] + got[2:], (v, ga, da, sa)):
        assert _gap(g, w) <= RTOL, name
    xg, Ag = tx.clone().requires_grad_(True), tA.clone().requires_grad_(True)
    _, _, ga, _, sa = t_ops(xg, Ag, Ag[..., None])
    (torch.sum(ga * tR) + torch.sum(sa * tR[..., 0])).backward()
    assert _gap(xg.grad, gx) <= RTOL
    assert _gap(Ag.grad, gA) <= RTOL
    return got


def _inputs(n, d, seed, f=6):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, f)).astype(np.float32),
            rng.normal(size=(n, f, d)).astype(np.float32),
            rng.normal(size=(n, f, d)).astype(np.float32))


@pytest.mark.parametrize("periodic", [False, True])
def test_dense_ops_match_jax(periodic):
    """The O(N^2) oracle: every op, and the gradients in x and A of a
    scalar of the gradient and the blur."""
    x, h, _, period = _scene(3, periodic, n=300, h=0.35)
    A, V, R = _inputs(300, 3, 3)
    want = _jax_ops(JD, h, period)(x, A, V, R)

    def t_ops(x, A, V):
        v = TD.volume(x, h, period=period)
        return (v, TD.count(x, h, period=period),
                TD.gradient(x, v, A, h, period=period),
                TD.divergence(x, v, V, h, period=period),
                TD.blur(x, v, A, h, period=period))

    _hold_ops(t_ops, want, x, A, V, R)
    tx = torch.from_numpy(x)
    assert _gap(TD.displacements(tx, period),
                JD.displacements(jnp.asarray(x), _jperiod(period))) <= RTOL


@pytest.mark.parametrize("d,periodic", SCENES, ids=SCENE_IDS)
def test_general_ops_match_jax_and_dense(d, periodic):
    """The general ops on one neighbour list against JAX's (and against the
    dense oracle, which they equal on an exact list), with their gradients
    in x and A against jax.grad."""
    x, h, period, jnl, _, tnl, _ = _carried(d, periodic, 500, 0.25)
    A, V, R = _inputs(500, d, 4)
    want = _jax_ops(JN, h, period, jnl)(x, A, V, R)

    def t_ops(x, A, V):
        v = TN.volume(x, h, tnl, period=period)
        return (v, TN.count(x, h, tnl, period=period),
                TN.gradient(x, v, A, h, tnl, period=period),
                TN.divergence(x, v, V, h, tnl, period=period),
                TN.blur(x, v, A, h, tnl, period=period))

    got = _hold_ops(t_ops, want, x, A, V, R)
    tx, tA, tV = (torch.from_numpy(a) for a in (x, A, V))
    v = TD.volume(tx, h, period=period)
    dense = (v, TD.count(tx, h, period=period),
             TD.gradient(tx, v, tA, h, period=period),
             TD.divergence(tx, v, tV, h, period=period),
             TD.blur(tx, v, tA, h, period=period))
    for g, w in zip(got, dense):
        assert _gap(g.float(), w.float()) <= RTOL


@pytest.mark.parametrize("d,periodic", SCENES, ids=SCENE_IDS)
def test_graph_ops_match_jax(d, periodic):
    """The graph ops on JAX's graph carried across, one cloud and a batch
    of three (against jax.vmap), the pre-gathered forms, and the gradient
    in A; the graph ops equal the general ops."""
    x, h, period, _, jg, tnl, tg = _carried(d, periodic, 500, 0.25)
    rng = np.random.default_rng(5)
    A = rng.normal(size=(3, 500, 7)).astype(np.float32)
    V = rng.normal(size=(3, 500, 7, d)).astype(np.float32)
    R = rng.normal(size=(3, 500, 7, d)).astype(np.float32)

    def ops(N, g, A, V):
        one = {"gradient": N.graph_gradient(g, A[0]),
               "blur": N.graph_blur(g, A[0]),
               "gather": N.gather_neighbors(g, A[0]),
               "gradient_from": N.graph_gradient_from(
                   g, A[0], N.gather_neighbors(g, A[0])),
               "blur_from": N.graph_blur_from(g, N.gather_neighbors(g, A[0])),
               "divergence": N.graph_divergence(g, V[0])}
        return one

    def jax_side(A, V, R):
        out = ops(JN, jg, A, V)
        for name, op, a in (("gradient", JN.graph_gradient, A),
                            ("blur", JN.graph_blur, A),
                            ("divergence", JN.graph_divergence, V)):
            out["batched " + name] = jax.vmap(lambda b: op(jg, b))(a)
        out["batched gradient_from"] = jax.vmap(
            lambda b: JN.graph_gradient_from(
                jg, b, JN.gather_neighbors(jg, b)))(A)
        out["grad"] = jax.grad(lambda a: jnp.sum(jax.vmap(
            lambda b: JN.graph_gradient(jg, b))(a) * R))(A)
        return out

    want = jax.jit(jax_side)(A, V, R)
    tA, tV, tR = (torch.from_numpy(a) for a in (A, V, R))
    got = ops(TN, tg, tA, tV)
    got.update({"batched gradient": TN.graph_gradient(tg, tA),
                "batched blur": TN.graph_blur(tg, tA),
                "batched divergence": TN.graph_divergence(tg, tV),
                "batched gradient_from": TN.graph_gradient_from(
                    tg, tA, TN.gather_neighbors(tg, tA))})
    Ag = tA.clone().requires_grad_(True)
    torch.sum(TN.graph_gradient(tg, Ag) * tR).backward()
    got["grad"] = Ag.grad
    assert set(got) == set(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert _gap(got[name], w) <= RTOL, name
    # the graph's precomputed weights are the general ops' weights
    tx = torch.from_numpy(x)
    assert _gap(TN.graph_gradient(tg, tA[1]),
                TN.gradient(tx, tg.v, tA[1], h, tnl, period=period)) <= RTOL
    assert _gap(TN.graph_blur(tg, tA[1]),
                TN.blur(tx, tg.v, tA[1], h, tnl, period=period)) <= RTOL


@pytest.mark.parametrize("fixture,period", [("gecko_step_fixture", None),
                                            ("zebra_wrapped_fixture", 2.0)],
                         ids=["gecko", "zebra-wrapped"])
def test_golden_fixture_fields_in_float64(fixture, period):
    """The weight-free fields of the golden fixtures, from the graph engine
    built in float64: the volumes v, the perception gA and (gecko) the
    pre-update life mask."""
    with np.load(os.path.join(GOLDEN, fixture + ".npz")) as z:
        f = {k: z[k] for k in z.files}
    x = torch.from_numpy(f["x"])
    assert x.dtype == torch.float64
    h = float(f["h"])
    dims = T.default_dims(h)
    per = None if period is None else [period] * 2
    mpc, k = T.suggest_capacity(x, h, dims, period=per)
    g = T.build_graph(x, h, dims, max_per_cell=mpc, k=k, period=per)
    assert g.v.dtype == torch.float64
    assert _gap(g.v, f["v"]) <= GOLDEN_RTOL
    assert _gap(TN.graph_gradient(g, torch.from_numpy(f["A0"])),
                f["gA"]) <= GOLDEN_RTOL
    if "prev_mask" in f:
        mask = life_mask(g, torch.from_numpy(f["A0"])[:, 3])
        np.testing.assert_array_equal(mask.numpy(), f["prev_mask"])
        assert 0 < f["prev_mask"].sum() < len(f["prev_mask"])


def test_build_follows_the_tensor_device():
    """The build runs where its positions are and takes only tensors: a
    numpy array would have no device to follow."""
    x, h, dims, _ = _scene(2, False, n=100)
    g = T.build_graph(torch.from_numpy(x), h, dims, max_per_cell=16, k=16)
    assert all(t.device.type == "cpu" for t in g)
    with pytest.raises(TypeError, match="tensor"):
        T.build_neighbor_list(x, h, dims, max_per_cell=16, k=16)
    with pytest.raises(ValueError, match="candidates"):
        T.build_neighbor_list(torch.from_numpy(x), h, dims, max_per_cell=1,
                              k=16)


@pytest.mark.parametrize("piece", [None, 97], ids=["one-piece", "pieces"])
def test_gather_rows_backward_fixed_order(piece, monkeypatch):
    """gather_rows on a graph's own lists, whose pad lanes all read row 0
    (its reverse map takes more than one level): the backward against
    autograd's backward of X[idx] (1e-6 of max: the same sums in another
    order), bit-equal over two runs, and float64 gradchecks of the graph
    ops and of the general ops through it. ``piece`` cuts the first level's
    gathers into pieces of that many elements."""
    from sph_nca_tpu_torch.ops import gather as GA

    if piece is not None:
        monkeypatch.setattr(GA, "_PIECE_ELEMS", piece)

    x, h, dims, period = _scene(2, False, n=300, h=0.3)
    xt = torch.from_numpy(x)
    mpc, k = T.suggest_capacity(x, h, dims)
    g = T.build_graph(xt, h, dims, max_per_cell=mpc, k=2 * k)
    assert int((~g.valid).sum()) > 2 * k  # row 0 is read by many pads
    rng = np.random.default_rng(5)
    X = torch.from_numpy(rng.normal(size=(300, 6)))
    G = torch.from_numpy(rng.normal(size=(300, 2 * k, 6)))
    # float32, the cotangent zero on pad lanes (as the graph ops give it:
    # their weights are 0 there), and float64 with every lane random
    for dt, G_, tol in ((torch.float32, G * g.valid[..., None], 1e-6),
                        (torch.float64, G, 1e-12)):
        Xa = X.to(dt).requires_grad_(True)
        want = torch.autograd.grad(Xa[g.idx], Xa, G_.to(dt))[0]
        got = torch.autograd.grad(TN.gather_rows(Xa, g.idx), Xa,
                                  G_.to(dt))[0]
        assert _gap(got, want) <= tol
        assert torch.equal(torch.autograd.grad(
            TN.gather_rows(Xa, g.idx), Xa, G_.to(dt))[0], got)
    assert len(GA.reverse_map(g.idx, 300).tables) >= 2

    # the gradchecks on the first 60 points, in fast mode (random
    # projections of the Jacobians)
    xs, n = xt[:60].double(), 60
    mpc, k = T.suggest_capacity(xs.numpy(), h, dims)
    g64 = T.build_graph(xs, h, dims, max_per_cell=mpc, k=2 * k)
    A = torch.tensor(rng.normal(size=(2, n, 3)), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a: (TN.graph_gradient(g64, a), TN.graph_blur(g64, a)), (A,),
        fast_mode=True)
    nl = T.NeighborList(g64.idx, g64.valid, None)
    xd = xs.clone().requires_grad_(True)
    v = g64.v.detach()
    assert torch.autograd.gradcheck(
        lambda xx, a: TN.gradient(xx, v, a, h, nl), (xd, A[0]),
        fast_mode=True)

"""The numerical scheme of the table forward and adjoint kernels, emulated on
the CPU.

``sph_fwd_tab_kernel`` and ``sph_bwd_tab_kernel`` (csrc/table_kernels.cu)
run their products on the tensor cores in TF32 with the operands split,
x = big + small, big = rna_tf32(x), small = rna_tf32(x - big):

    f32 tables   acc = A_small B_big + A_big B_small + A_big B_big
    bf16 tables  acc = A B_small + A B_big    (a bf16 entry is exact in TF32)

with A the md table and B the right-hand side (v_w S_w in the forward, the
cotangents G in the adjoint), f32 sums (the kernels add each k8 step's
products to their sums in round-to-nearest f32). Here the same split is
made with bit masks and the partial products are f32 matmuls (a TF32 x TF32
product is exact in f32), on the pair tables of a small cloud, and held
against the plain versions ``fwd_tab_bucket_plain`` /
``bwd_tab_bucket_plain``: 1e-5 of the largest output, the card's
tolerance, and a constant field cancelling to |gA| < 1e-4
(tests/test_torch_tables.py's bound). A single TF32 product misses both
(the last test), so the checks can tell the schemes apart. No JAX.
"""

import functools

import numpy as np
import pytest
import torch

from sph_nca_tpu_torch.ops import pair_kernel as TP
from sph_nca_tpu_torch.ops.cells import build_cell_engine

RTOL = 1e-5  # of the largest output
CONST_ATOL = 1e-4  # |gA| of a constant field

SCENES = {  # (points, dim, h, periodic)
    "3d": (250, 3, 0.3, False),
    "2d-periodic": (300, 2, 0.25, True),
}


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero (cvt.rna.tf32.f32; the kernels do it with integer arithmetic)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_product(a: torch.Tensor, b: torch.Tensor, a_exact: bool,
                  terms: int = 3) -> torch.Tensor:
    """a @ b as the kernels form it: 3xTF32 (2 products when ``a`` is exact
    in TF32), or one TF32 product with ``terms=1``."""
    a_big, b_big = rna_tf32(a), rna_tf32(b)
    if terms == 1:
        return torch.matmul(a_big, b_big)
    b_small = rna_tf32(b - b_big)
    if a_exact:
        return torch.matmul(a, b_small) + torch.matmul(a, b_big)
    a_small = rna_tf32(a - a_big)
    return (torch.matmul(a_small, b_big) + torch.matmul(a_big, b_small)
            + torch.matmul(a_big, b_big))


def fwd_tab_split(scal, ab, gsum_b, vw_b, S, win_cells, md, terms=3):
    """The forward kernel's gA, emulated: sig_g md_d @ (v_w S_w) - S_b
    gsum_d, d-major."""
    _, _, sig_g, _ = TP._scalars(scal, vw_b.device)
    *lead, c, m, f = S.shape
    p = md.shape[1] // gsum_b.shape[-1]
    ddim = gsum_b.shape[-1]
    Sw = TP.window_from_flat(S.reshape(*lead, c, m * f), win_cells, m)
    mom = split_product(md.float(), Sw * vw_b[..., None],
                        md.dtype == torch.bfloat16, terms)
    return torch.cat([sig_g * mom[..., d * p:(d + 1) * p, :]
                      - ab * gsum_b[..., d:d + 1] for d in range(ddim)], -1)


def bwd_tab_split(scal, vs_b, gsum_b, gb, gflat, win_cells, md):
    """The adjoint kernel's dA, emulated: -sig_g v_b sum_d md_d @ G_d -
    sum_d gsum_d gbar_b,d."""
    _, _, sig_g, _ = TP._scalars(scal, vs_b.device)
    *lead, c, m, fd = gflat.shape
    p = vs_b.shape[-1]
    ddim = md.shape[1] // p
    f = fd // ddim
    Gw = TP.window_from_flat(gflat.reshape(*lead, c, m * fd), win_cells, m)
    acc = 0.0
    for d in range(ddim):
        acc = acc + split_product(md[:, d * p:(d + 1) * p].float(),
                                  Gw[..., d * f:(d + 1) * f],
                                  md.dtype == torch.bfloat16)
    t2 = 0.0
    for d in range(ddim):
        t2 = t2 + gsum_b[..., d:d + 1] * gb[..., d * f:(d + 1) * f]
    return -sig_g * vs_b[..., None] * acc - t2


@functools.cache
def _engine(scene, dtype):
    n, dim, h, periodic = SCENES[scene]
    x = np.random.default_rng(0).uniform(-1, 1, (n, dim)).astype(np.float32)
    eng = build_cell_engine(x, h, period=[2.0] * dim if periodic else None,
                            pair_tables=dtype, device="cpu")
    assert eng.blk_xs.shape[0] > 0 and eng.blk2_xs.shape[0] > 0
    return eng


def _buckets(eng):
    """Per bucket: (lo, hi, win_cells, vw, md, w6)."""
    nb1 = eng.blk_xs.shape[0]
    nb = nb1 + eng.blk2_xs.shape[0]
    return ((0, nb1, eng.blk_win_cells, eng.blk_vw, eng.blk_md, eng.blk_w6),
            (nb1, nb, eng.blk2_win_cells, eng.blk2_vw, eng.blk2_md,
             eng.blk2_w6))


def _normal(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


def _forward(eng, S, terms=3):
    """(emulated gA, plain gA) per bucket."""
    d = eng.xs.shape[-1]
    scal = TP.scal_vec(eng)
    rows = S.reshape(*S.shape[:-3], -1, 64, 16)
    gs = eng.gsum.reshape(-1, 64, d)
    out = []
    for lo, hi, wc, vw, md, w6 in _buckets(eng):
        ab = rows[..., lo:hi, :, :]
        want, _ = TP.fwd_tab_bucket_plain(scal, ab, gs[lo:hi], vw, S, wc, md,
                                          w6, use_alpha=True)
        out.append((fwd_tab_split(scal, ab, gs[lo:hi], vw, S, wc, md, terms),
                    want))
    return out


def test_rna_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # a TF32 value
    x = torch.tensor([1.0 + 2.0 ** -11,  # a tie: away from zero
                      -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -20,  # below the tie
                      one, 3.0], dtype=torch.float32)
    assert rna_tf32(x).tolist() == [one, -one, 1.0, one, 3.0]
    bf = torch.randn(1000).to(torch.bfloat16).float()
    assert torch.equal(rna_tf32(bf), bf)  # bf16 is exact in TF32
    y = torch.randn(1000)
    big = rna_tf32(y)
    err = (y - big - rna_tf32(y - big)).abs() / y.abs()
    assert float(err.max()) <= 2.0 ** -22


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("bsz", [None, 3])
def test_split_forward_matches_plain(scene, dtype, bsz):
    eng = _engine(scene, dtype)
    c, m, _ = eng.xs.shape
    lead = () if bsz is None else (bsz,)
    for got, want in _forward(eng, _normal(lead + (c, m, 16), 1)):
        err = float((got - want).abs().max())
        assert err <= RTOL * float(want.abs().max()), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("bsz", [None, 3])
def test_split_adjoint_matches_plain(scene, dtype, bsz):
    eng = _engine(scene, dtype)
    c, m, d = eng.xs.shape
    lead = () if bsz is None else (bsz,)
    G = _normal(lead + (c, m, d * 16), 2)
    scal = TP.scal_vec(eng)
    vs, gs = eng.vs.reshape(-1, 64), eng.gsum.reshape(-1, 64, d)
    grows = G.reshape(*lead, -1, 64, d * 16)
    for lo, hi, wc, _, md, _ in _buckets(eng):
        args = (scal, vs[lo:hi], gs[lo:hi], grows[..., lo:hi, :, :], G, wc,
                md)
        got, want = bwd_tab_split(*args), TP.bwd_tab_bucket_plain(*args)
        err = float((got - want).abs().max())
        assert err <= RTOL * float(want.abs().max()), err


def _constant_field(eng):
    return eng.scatter(torch.full((eng.num_particles, 16), 1.7))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_constant_field_cancels(dtype):
    eng = _engine("3d", dtype)
    for got, _ in _forward(eng, _constant_field(eng)):
        assert float(got.abs().max()) < CONST_ATOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_single_tf32_product_does_not(dtype):
    """One TF32 product of the same operands leaves |A| 2^-11 in gA: the
    constant field no longer cancels, and the random state misses 1e-5 of
    max."""
    eng = _engine("3d", dtype)
    c, m, _ = eng.xs.shape
    worst = max(float(got.abs().max())
                for got, _ in _forward(eng, _constant_field(eng), terms=1))
    assert worst > CONST_ATOL
    rel = max(float((got - want).abs().max() / want.abs().max())
              for got, want in _forward(eng, _normal((c, m, 16), 1),
                                        terms=1))
    assert rel > RTOL

"""The numerical scheme of the recompute forward and adjoint kernels, emulated
on the CPU.

``sph_fwd_kernel`` and ``sph_bwd_kernel`` (csrc/pair_kernels.cu) compute the
pair geometry of a block's rows and a stage of window slots once per tile of
samples, in f32, as their A tiles:

    forward   A_d = mag v_w (xw - xb)_d,  w6 = max(h^2 - d2, 0)^3
    adjoint   A_d = mag (xb - xw)_d

and run the products on the tensor cores in TF32 with both operands split,
x = big + small, big = rna_tf32(x), small = rna_tf32(x - big). A k8 step of
the window takes two passes, each from zero in the tensor core, which adds a
product's terms and the sum it chains onto exactly and truncates the result
to f32:

    pass 0   A_small B_big, then + A_big B_small   (two chained products)
    pass 1   A_big B_big

and the kernel adds each pass to its running sums in round-to-nearest f32,
k8 step after k8 step. A 16 x 8 A tile that is all zero (pairs beyond h, pad
slots, self pairs) is skipped, a choice made by the geometry alone (the
kernels also skip computing the tiles whose bounding boxes lie beyond h,
which holds only zeros, so it changes no sum and is not emulated). The
forward subtracts S_b times the rowsum of its A tile, taken by the geometry
threads (each row's 8 threads sum 4 slots of every 32-slot stage in order,
then add their sums by a butterfly):

    gA_d = sig_g A_d @ S_w - S_b sig_g rowsum_d
    sm   = (sig_w v_w w6) @ alive_w   (alive 1 or 0, exact in TF32: two
                                       products a step; 4 partial sums, one
                                       per k8 phase of a stage, added in
                                       order)
    dA   = sig_g v_b sum_d A_d @ G_d - sum_d gsum_d gbar_b,d

Here a product is an exact float64 matmul, truncated to f32 as the tensor
core does, on the buckets of a small cloud without pair tables, and the
result is held against the plain versions ``fwd_bucket_plain`` /
``bwd_bucket_plain``: 1e-5 of the largest output, the card's tolerance, and a
constant field cancelling to |gA| < 1e-4. A single TF32 product misses 1e-5
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
STAGE, THREADS_A_ROW = 32, 8  # the forward's stage width, geometry threads

SCENES = {  # (points, dim, h, periodic)
    "3d": (250, 3, 0.3, False),
    "2d-periodic": (300, 2, 0.25, True),
}


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero, by integer arithmetic as the kernels do."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def trunc_f32(x: torch.Tensor) -> torch.Tensor:
    """A float64 tensor to float32, rounded toward zero (the tensor core's
    sums)."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def k8_passes(a: torch.Tensor, b: torch.Tensor, terms: int = 3):
    """The passes of one k8 step: a [..., M, 8] @ b [..., 8, N] as the
    tensor core forms them (3xTF32, or one TF32 product with terms=1)."""
    a_big, b_big = rna_tf32(a), rna_tf32(b)
    big = trunc_f32(a_big.double() @ b_big.double())
    if terms == 1:
        return [big]
    a_small, b_small = rna_tf32(a - a_big), rna_tf32(b - b_big)
    small = trunc_f32(trunc_f32(a_small.double() @ b_big.double()).double()
                      + a_big.double() @ b_small.double())
    return [small, big]


def split_sum(a, b, skip=True, terms=3):
    """sum over k8 steps of a [..., M, W] @ b [..., W, N] with the passes of
    each step added in round-to-nearest f32; with ``skip`` a step adds
    nothing to the rows of an all-zero 16 x 8 tile of a."""
    *lead, m, w = a.shape
    acc = torch.zeros(())
    for k0 in range(0, w, 8):
        ak = a[..., k0:k0 + 8]
        nz = (ak.reshape(*lead, m // 16, 16, 8) != 0).flatten(-2).any(-1)
        keep = nz.repeat_interleave(16, -1)[..., None]
        for part in k8_passes(ak, b[..., k0:k0 + 8, :], terms):
            acc = torch.where(keep, acc + part, acc) if skip else acc + part
    return acc


def geometry(scal, xs_b, xw_b, vw_b, sign):
    """The kernels' A tiles in f32 from the positions: [nb, D, P, W] of
    mag * r_d with r = sign (xw - xb) (and v_w folded in for the forward,
    sign +1), and the poly6 core w6 [nb, P, W]."""
    h, _, _, _ = TP._scalars(scal, xs_b.device)
    r = sign * (xw_b[:, :, None, :] - xs_b[:, :, :, None])
    d2 = r[:, 0] * r[:, 0]
    for d in range(1, r.shape[1]):
        d2 = d2 + r[:, d] * r[:, d]
    rs = torch.rsqrt(torch.where(d2 > 0, d2, torch.ones_like(d2)))
    mag = torch.where((d2 > 0) & (d2 < h * h),
                      3.0 * ((h * h + d2) * rs - 2.0 * h),
                      torch.zeros_like(d2))
    if sign > 0:
        mag = mag * vw_b[:, None, :]
    cc = torch.clamp(h * h - d2, min=0.0)
    w6 = cc * cc * cc
    return mag[:, None] * r, w6


def stage_rowsum(A):
    """sum_w A [..., W] as the forward's geometry threads take it: thread q
    of a row sums slots 4q .. 4q + 3 of each 32-slot stage in order, and the
    8 threads' sums are added by a butterfly (xor 1, 2, 4)."""
    part = [torch.zeros(A.shape[:-1]) for _ in range(THREADS_A_ROW)]
    w = A.shape[-1]
    for t0 in range(0, w, STAGE):
        for q in range(THREADS_A_ROW):
            for c in range(4):
                k = t0 + 4 * q + c
                if k < w:
                    part[q] = part[q] + A[..., k]
    for step in (1, 2, 4):
        part = [part[q] + part[q ^ step] for q in range(THREADS_A_ROW)]
    return part[0]


def fwd_split(scal, xs_b, ab, xw_b, vw_b, S, win_cells, *, use_alpha=True,
              skip=True, terms=3):
    """The recompute forward kernel's (gA d-major, sm), emulated."""
    _, sig_w, sig_g, thr = TP._scalars(scal, xs_b.device)
    *lead, c, m, f = S.shape
    Sw = TP.window_from_flat(S.reshape(*lead, c, m * f), win_cells, m)
    A, w6 = geometry(scal, xs_b, xw_b, vw_b, 1.0)
    ga = []
    for d in range(A.shape[1]):
        mom = split_sum(A[:, d], Sw, skip, terms)
        gs = sig_g * stage_rowsum(A[:, d])
        ga.append(sig_g * mom - ab * gs[..., None])
    alive = (Sw[..., 3] > thr) if use_alpha else (vw_b > 0).expand(
        *lead, *vw_b.shape)
    col = alive.float()[..., None]
    w6 = w6 * (sig_w * vw_b)[:, None, :]
    # warp phase wn takes k8 step wn of every stage; phases added in order
    red = [torch.zeros(()) for _ in range(4)]
    for k0 in range(0, w6.shape[-1], 8):
        ak = w6[..., k0:k0 + 8]
        nz = (ak.reshape(ak.shape[0], -1, 16, 8) != 0).flatten(-2).any(-1)
        keep = nz.repeat_interleave(16, -1)[..., None]
        ph = (k0 // 8) % 4
        for part in k8_passes(ak, col[..., k0:k0 + 8, :], terms):
            red[ph] = (torch.where(keep, red[ph] + part, red[ph]) if skip
                       else red[ph] + part)
    sm = ((((0.0 + red[0]) + red[1]) + red[2]) + red[3])[..., 0]
    return torch.cat(ga, dim=-1), sm


def bwd_split(scal, xs_b, vs_b, gsum_b, gb, xw_b, gflat, win_cells, *,
              skip=True, terms=3):
    """The recompute adjoint kernel's dA, emulated (k8 steps outer, the D
    products of a step inner, as the kernel adds them)."""
    _, _, sig_g, _ = TP._scalars(scal, xs_b.device)
    *lead, c, m, fd = gflat.shape
    ddim = xs_b.shape[1]
    f = fd // ddim
    Gw = TP.window_from_flat(gflat.reshape(*lead, c, m * fd), win_cells, m)
    A, _ = geometry(scal, xs_b, xw_b, None, -1.0)
    nb, _, p, w = A.shape
    acc = torch.zeros(tuple(lead) + (nb, p, f))
    for k0 in range(0, w, 8):
        for d in range(ddim):
            ak = A[:, d, :, k0:k0 + 8]
            nz = (ak.reshape(nb, p // 16, 16, 8) != 0).flatten(-2).any(-1)
            keep = nz.repeat_interleave(16, -1)[..., None]
            for part in k8_passes(ak, Gw[..., k0:k0 + 8, d * f:(d + 1) * f],
                                  terms):
                acc = (torch.where(keep, acc + part, acc) if skip
                       else acc + part)
    t2 = 0.0
    for d in range(ddim):
        t2 = t2 + gsum_b[..., d:d + 1] * gb[..., d * f:(d + 1) * f]
    return sig_g * vs_b[..., None] * acc - t2


@functools.cache
def _engine(scene):
    n, dim, h, periodic = SCENES[scene]
    x = np.random.default_rng(0).uniform(-1, 1, (n, dim)).astype(np.float32)
    eng = build_cell_engine(x, h, period=[2.0] * dim if periodic else None,
                            device="cpu")
    assert eng.blk_xs.shape[0] > 0 and eng.blk2_xs.shape[0] > 0
    return eng


def _buckets(eng):
    """Per bucket: (lo, hi, xs_b, xw_b, vw_b, win_cells)."""
    nb1 = eng.blk_xs.shape[0]
    nb = nb1 + eng.blk2_xs.shape[0]
    return ((0, nb1, eng.blk_xs, eng.blk_xw, eng.blk_vw, eng.blk_win_cells),
            (nb1, nb, eng.blk2_xs, eng.blk2_xw, eng.blk2_vw,
             eng.blk2_win_cells))


def _normal(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


def _forward(eng, S, **kw):
    """(emulated (gA, sm), plain (gA, sm)) per bucket."""
    scal = TP.scal_vec(eng)
    rows = S.reshape(*S.shape[:-3], -1, 64, 16)
    out = []
    for lo, hi, xs_b, xw_b, vw_b, wc in _buckets(eng):
        args = (scal, xs_b, rows[..., lo:hi, :, :], xw_b, vw_b, S, wc)
        out.append((fwd_split(*args, **kw),
                    TP.fwd_bucket_plain(*args, use_alpha=True)))
    return out


def _adjoint(eng, G, **kw):
    """(emulated dA, plain dA) per bucket."""
    d = eng.xs.shape[-1]
    scal = TP.scal_vec(eng)
    vs, gs = eng.vs.reshape(-1, 64), eng.gsum.reshape(-1, 64, d)
    grows = G.reshape(*G.shape[:-3], -1, 64, d * 16)
    out = []
    for lo, hi, xs_b, xw_b, _, wc in _buckets(eng):
        args = (scal, xs_b, vs[lo:hi], gs[lo:hi], grows[..., lo:hi, :, :],
                xw_b, G, wc)
        out.append((bwd_split(*args, **kw), TP.bwd_bucket_plain(*args)))
    return out


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("bsz", [None, 3])
def test_recompute_split_forward_matches_plain(scene, bsz):
    eng = _engine(scene)
    c, m, _ = eng.xs.shape
    lead = () if bsz is None else (bsz,)
    for (ga, sm), (ga_p, sm_p) in _forward(eng, _normal(lead + (c, m, 16),
                                                        1)):
        assert ga.shape == ga_p.shape and sm.shape == sm_p.shape
        assert _rel(ga, ga_p) <= RTOL
        assert _rel(sm, sm_p) <= RTOL


@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("bsz", [None, 3])
def test_recompute_split_adjoint_matches_plain(scene, bsz):
    eng = _engine(scene)
    c, m, d = eng.xs.shape
    lead = () if bsz is None else (bsz,)
    for got, want in _adjoint(eng, _normal(lead + (c, m, d * 16), 2)):
        assert got.shape == want.shape
        assert _rel(got, want) <= RTOL


def _constant_field(eng):
    return eng.scatter(torch.full((eng.num_particles, 16), 1.7))


@pytest.mark.parametrize("scene", list(SCENES))
def test_recompute_split_constant_field_cancels(scene):
    eng = _engine(scene)
    for (ga, _), _ in _forward(eng, _constant_field(eng)):
        assert float(ga.abs().max()) < CONST_ATOL


def test_recompute_tile_skip_adds_nothing():
    """Most 16 x 8 A tiles are all zero, and skipping them leaves every sum
    as it is: the skip is a choice of the geometry alone."""
    eng = _engine("3d")
    c, m, d = eng.xs.shape
    scal = TP.scal_vec(eng)
    zero = total = 0
    for _, _, xs_b, xw_b, vw_b, _ in _buckets(eng):
        for sign in (1.0, -1.0):
            A, _ = geometry(scal, xs_b, xw_b, vw_b, sign)
            nb, _, p, w = A.shape
            tiles = A.reshape(nb, d, p // 16, 16, w // 8, 8)
            nz = (tiles != 0).any(-1).any(-2)
            zero += int((~nz).sum())
            total += nz.numel()
    assert zero > total / 2
    S = _normal((2, c, m, 16), 3)
    G = _normal((2, c, m, d * 16), 4)
    for (with_skip, _), (without, _) in zip(_forward(eng, S),
                                            _forward(eng, S, skip=False)):
        assert all(torch.equal(a, b) for a, b in zip(with_skip, without))
    for (with_skip, _), (without, _) in zip(_adjoint(eng, G),
                                            _adjoint(eng, G, skip=False)):
        assert torch.equal(with_skip, without)


def test_recompute_single_tf32_product_misses():
    """One TF32 product of the same operands leaves |A| 2^-11 in gA and dA:
    both miss 1e-5 of max."""
    eng = _engine("3d")
    c, m, d = eng.xs.shape
    fwd = max(_rel(ga, ga_p) for (ga, _), (ga_p, _) in _forward(
        eng, _normal((c, m, 16), 1), terms=1))
    bwd = max(_rel(got, want) for got, want in _adjoint(
        eng, _normal((c, m, d * 16), 2), terms=1))
    assert fwd > RTOL and bwd > RTOL

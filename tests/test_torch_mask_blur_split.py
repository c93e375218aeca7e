"""The numerical schemes of the mask kernel without tables and the table
blur kernel, emulated on the CPU.

``sph_mask_kernel`` (csrc/pair_kernels.cu, the post-update life-mask blur of
the recompute path) runs a thread block over 32 rows of a block (two 16-row
groups) and a tile of samples. It first marks, for each 16-row group and each
group of 8 window slots, whether their bounding boxes lie more than h apart:

    gap_d = max(lo_w,d - hi_r,d, lo_r,d - hi_w,d, 0),  far = sum_d gap_d^2 >
    h^2 1.0001

with pad rows and slots (at 1e6) inside the boxes, and skips the far tiles
whole (the recompute forward and adjoint skip the same tiles). For every
other pair it computes w6 = max(h^2 - d2, 0)^3 once for the tile's samples,
d2 = fmaf(r_d, r_d, ..) over the per-axis differences r_d, and adds w6
times the sample's column sig_w v_w alive_w with fmaf. Thread (warp
(mg, wq), lane (row, q)) takes the slot groups wq, wq + 4, .. in order and
slots 4q .. 4q + 3 of each; a row's 8 partial sums are added as

    ((q0 + q1) of wq 0 + (q0 + q1) of wq 1) + (.. of wq 2 + .. of wq 3).

``sph_blur_tab_kernel`` (csrc/table_kernels.cu) follows the mask table
kernel's design: a thread block owns 32 rows and a tile of samples (4
columns v_w X_w a sample), a stage is 512 bytes of each row of w6, and lane q
of a row sums the stage's slots q V .. q V + V - 1 (V = 4 f32 or 8 bf16
slots) with fmaf, stage after stage; the 32 lanes' sums are added by a
butterfly (xor 1, 2, 4, 8, 16: the kernel's recursive halving takes the
same sums) and scaled by sig_w.

Here fmaf is a float64 product and sum rounded to float32 (the product of
two float32 values is exact in float64). Each emulation is held against the
plain version (``mask_bucket_plain`` / ``blur_bucket_plain``) within 1e-5 of
the largest output, the card's tolerance, and each sample of a batch
against the same sample run alone, bit for bit. No JAX.
"""

import functools

import numpy as np
import pytest
import torch

from sph_nca_tpu_torch.ops import pair_kernel as TP
from sph_nca_tpu_torch.ops.cells import PAD_POS, build_cell_engine

RTOL = 1e-5  # of the largest output
CELL = 8  # slots a group
FAR = 1.0e6  # position of the window's tail slots
CUT = 1.0001  # the far cut, h^2 times this
BT_MASK, BT_BLUR = 8, 4  # samples a tile (one for B = 1)

SCENES = {  # (points, dim, h, periodic)
    "3d": (250, 3, 0.3, False),
    "2d-periodic": (300, 2, 0.25, True),
}


@functools.cache
def _engine(scene, tables=None):
    n, dim, h, periodic = SCENES[scene]
    x = np.random.default_rng(0).uniform(-1, 1, (n, dim)).astype(np.float32)
    eng = build_cell_engine(x, h, period=[2.0] * dim if periodic else None,
                            pair_tables=tables, device="cpu")
    assert eng.blk_xs.shape[0] > 0 and eng.blk2_xs.shape[0] > 0
    return eng


def _buckets(eng):
    """Per bucket: (xs_b, xw_b, vw_b, win_cells, w6)."""
    return ((eng.blk_xs, eng.blk_xw, eng.blk_vw, eng.blk_win_cells,
             eng.blk_w6),
            (eng.blk2_xs, eng.blk2_xw, eng.blk2_vw, eng.blk2_win_cells,
             eng.blk2_w6))


def _normal(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def fma(a, b, c):
    """fmaf: a b + c with one rounding to float32."""
    return (a.double() * b.double() + c.double()).float()


def far_tiles(scal, xs_b, xw_b):
    """The kernels' far bits: [nb, 4 row groups of 16, groups of 8 slots],
    True where the boxes lie more than h apart."""
    h = TP._scalars(scal, xs_b.device)[0]
    nb, ddim, p = xs_b.shape
    w = xw_b.shape[2]
    wp = -(-w // CELL) * CELL
    xw = torch.cat([xw_b, torch.full((nb, ddim, wp - w), FAR)], -1)
    rows = xs_b.reshape(nb, ddim, p // 16, 16)
    lo_r, hi_r = rows.amin(-1)[..., None], rows.amax(-1)[..., None]
    slots = xw.reshape(nb, ddim, wp // CELL, CELL)
    lo_w, hi_w = slots.amin(-1)[:, :, None], slots.amax(-1)[:, :, None]
    gap = torch.clamp(torch.maximum(lo_w - hi_r, lo_r - hi_w), min=0.0)
    g2 = gap[:, 0] * gap[:, 0]
    for d in range(1, ddim):
        g2 = g2 + gap[:, d] * gap[:, d]
    return g2 > (h * h) * torch.tensor(CUT, dtype=torch.float32)


def poly6_core(scal, xs_b, xw_b):
    """w6 [nb, P, W] as the mask kernel computes it: d2 = r_0^2, then
    fmaf(r_d, r_d, d2) over the per-axis differences r_d."""
    h = TP._scalars(scal, xs_b.device)[0]
    r = xw_b[:, :, None, :] - xs_b[:, :, :, None]
    d2 = r[:, 0] * r[:, 0]
    for d in range(1, r.shape[1]):
        d2 = fma(r[:, d], r[:, d], d2)
    cc = torch.clamp(h * h - d2, min=0.0)
    return (cc * cc) * cc


def alive_col(scal, xw_b, vw_b, S, win_cells, use_alpha):
    """sig_w v_w alive_w [B, nb, W] of the samples S [B, C, M, F]."""
    _, sig_w, _, thr = TP._scalars(scal, vw_b.device)
    bsz, c, m, f = S.shape
    if use_alpha:
        alive = TP.window_from_flat(S.reshape(bsz, c, m * f), win_cells,
                                    m)[..., 3] > thr
    else:
        alive = (vw_b > 0).expand(bsz, *vw_b.shape)
    return torch.where(alive, sig_w * vw_b, torch.zeros(()))


def mask_split(scal, xs_b, xw_b, vw_b, S, win_cells, *, use_alpha,
               cull=True):
    """sph_mask_kernel's sm [B, nb, P], emulated tile by tile of samples."""
    bsz = S.shape[0]
    bt = 1 if bsz == 1 else BT_MASK
    nb, _, p = xs_b.shape
    w = xw_b.shape[2]
    w6 = poly6_core(scal, xs_b, xw_b)
    kept = ~far_tiles(scal, xs_b, xw_b) if cull else torch.ones(
        nb, p // 16, -(-w // CELL), dtype=torch.bool)
    kept = kept.repeat_interleave(16, 1)  # [nb, P, groups]
    out = []
    for y0 in range(0, bsz, bt):
        col = alive_col(scal, xw_b, vw_b, S[y0:y0 + bt], win_cells,
                        use_alpha)  # [bt, nb, W]
        part = []
        for wq in range(4):  # the 4 warps of a row group
            acc = []
            for q in range(2):  # the row's 2 lanes in a warp
                a = torch.zeros(col.shape[0], nb, p)
                for cg in range(wq, kept.shape[-1], 4):
                    for k in range(4):
                        s = cg * CELL + 4 * q + k
                        if s < w:
                            a = torch.where(kept[:, :, cg],
                                            fma(w6[:, :, s],
                                                col[:, :, None, s], a), a)
                acc.append(a)
            part.append(acc[0] + acc[1])
        out.append((part[0] + part[1]) + (part[2] + part[3]))
    return torch.cat(out)


def blur_split(scal, vw_b, X, win_cells, w6):
    """sph_blur_tab_kernel's out [B, nb, P, 4], emulated tile by tile of
    samples."""
    _, sig_w, _, _ = TP._scalars(scal, vw_b.device)
    bsz, c, m, f = X.shape
    bt = 1 if bsz == 1 else BT_BLUR
    tw = 512 // w6.element_size()  # slots a stage
    v = 16 // w6.element_size()  # slots a lane's piece
    tab = w6.float()
    w = tab.shape[2]
    out = []
    for y0 in range(0, bsz, bt):
        Xw = TP.window_from_flat(X[y0:y0 + bt].reshape(-1, c, m * f),
                                 win_cells, m)
        col = Xw * vw_b[..., None]  # [bt, nb, W, 4]
        lanes = [torch.zeros(col.shape[0], tab.shape[0], tab.shape[1], f)
                 for _ in range(32)]
        for t0 in range(0, w, tw):
            for q in range(32):
                for e in range(v):
                    s = t0 + q * v + e
                    if s < w:
                        lanes[q] = fma(tab[:, :, s, None],
                                       col[:, :, None, s, :], lanes[q])
        for off in (1, 2, 4, 8, 16):
            lanes = [lanes[q] + lanes[q ^ off] for q in range(32)]
        out.append(sig_w * lanes[0])
    return torch.cat(out)


@pytest.mark.parametrize("scene", list(SCENES))
def test_far_tiles_hold_no_pair_within_h(scene):
    """The bounding-box cull that the recompute forward, adjoint and mask
    kernels share is sound: no tile it marks holds a pair with d2 < h^2
    (where the poly6 core and the spiky magnitude are not 0), pad rows and
    slots included. A share of the tiles is culled (printed)."""
    eng = _engine(scene)
    scal = TP.scal_vec(eng)
    h = TP._scalars(scal, "cpu")[0]
    culled = total = 0
    for xs_b, xw_b, _, _, _ in _buckets(eng):
        nb, _, p = xs_b.shape
        w = xw_b.shape[2]
        far = far_tiles(scal, xs_b, xw_b)  # [nb, 4, groups]
        _, d2 = TP._pair_d2(xs_b, xw_b)
        wp = far.shape[-1] * CELL
        d2 = torch.cat([d2, torch.full((nb, p, wp - w), FAR * FAR)], -1)
        near = (d2 < h * h).reshape(nb, p // 16, 16, wp // CELL, CELL)
        near = near.any(-1).any(2)  # a pair within h in the tile
        assert not bool((far & near).any())
        culled += int(far.sum())
        total += far.numel()
    share = culled / total
    print(f"{scene}: {culled} of {total} tiles (16 rows x 8 slots) culled "
          f"({share:.1%})")
    assert 0.0 < share < 1.0


@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("use_alpha", [True, False])
@pytest.mark.parametrize("bsz", [3, 8])
def test_mask_split_matches_plain(scene, use_alpha, bsz):
    """sph_mask_kernel's scheme within 1e-5 of max of mask_bucket_plain;
    each sample of a batch bit-equal to the same sample alone."""
    eng = _engine(scene)
    scal = TP.scal_vec(eng)
    c, m, _ = eng.xs.shape
    S = _normal((bsz, c, m, 16), 1)
    for xs_b, xw_b, vw_b, wc, _ in _buckets(eng):
        got = mask_split(scal, xs_b, xw_b, vw_b, S, wc, use_alpha=use_alpha)
        want = TP.mask_bucket_plain(scal, xs_b, xw_b, vw_b, S, wc,
                                    use_alpha=use_alpha)
        assert got.shape == want.shape
        assert _rel(got, want) <= RTOL
        pad = xs_b[:, 0] >= PAD_POS  # pad rows: exactly 0
        assert bool(pad.any()) and bool((got[:, pad] == 0).all())
        for b in range(bsz):
            one = mask_split(scal, xs_b, xw_b, vw_b, S[b:b + 1], wc,
                             use_alpha=use_alpha)
            assert torch.equal(one[0], got[b])


@pytest.mark.parametrize("scene", list(SCENES))
def test_mask_cull_changes_no_sum(scene):
    """Skipping the far tiles leaves every sum of the mask scheme as it is:
    the cull is a choice of the positions alone."""
    eng = _engine(scene)
    scal = TP.scal_vec(eng)
    c, m, _ = eng.xs.shape
    S = _normal((2, c, m, 16), 2)
    for xs_b, xw_b, vw_b, wc, _ in _buckets(eng):
        assert bool(far_tiles(scal, xs_b, xw_b).any())
        assert torch.equal(
            mask_split(scal, xs_b, xw_b, vw_b, S, wc, use_alpha=True),
            mask_split(scal, xs_b, xw_b, vw_b, S, wc, use_alpha=True,
                       cull=False))


@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bsz", [1, 3, 8])
def test_blur_split_matches_plain(scene, dtype, bsz):
    """sph_blur_tab_kernel's scheme within 1e-5 of max of blur_bucket_plain
    on f32 and bf16 tables; each sample of a batch bit-equal to the same
    sample alone (B = 3: one ragged tile of 4; B = 8: two tiles)."""
    eng = _engine(scene, dtype)
    scal = TP.scal_vec(eng)
    c, m, _ = eng.xs.shape
    X = _normal((bsz, c, m, 4), 3)
    for _, _, vw_b, wc, w6 in _buckets(eng):
        got = blur_split(scal, vw_b, X, wc, w6)
        want = TP.blur_bucket_plain(scal, vw_b, X, wc, w6)
        assert got.shape == want.shape
        assert _rel(got, want) <= RTOL
        for b in range(bsz if bsz > 1 else 0):
            assert torch.equal(blur_split(scal, vw_b, X[b:b + 1], wc, w6)[0],
                               got[b])

"""The cell engine's SPH pair pass: fused perception, its adjoint, and the
life-mask blur.

Counterpart of ``sph_nca_tpu/ops/pallas/pair_kernel.py`` (recompute path, one
shard). Each pass runs once per window-size bucket of the engine (see
``ops/cells.py``) over blocks of P = 64 rows and their union window.

Three kernels, each with its plain PyTorch version beside it:

  ``fwd_bucket``   the SPH gradient of the state (d-major [P, D*F]) plus the
                   pre-update life-mask blur — CUDA ``sph_fwd_kernel``,
                   replacing the TPU kernel ``_fwd_kernel``;
  ``bwd_bucket``   the adjoint of that gradient, dA [P, F] — CUDA
                   ``sph_bwd_kernel``, replacing the TPU kernel
                   ``_bwd_kernel``;
  ``mask_bucket``  the post-update life-mask blur — CUDA ``sph_mask_kernel``,
                   replacing the TPU kernel ``_mask_kernel``.

A wrapper runs the plain version only for tensors on the CPU; for CUDA tensors
it launches the kernel or raises. Each wrapper counts its launches in its
``launches`` attribute. The kernels read the window states (and cotangents)
straight from the cell-layout tensor through the bucket's ``win_cells`` table,
so both versions take the whole state S [B, C, M, F] and the table rather than
a window copy. A leading batch axis B runs all samples in one launch (the JAX
trainer vmaps the pallas_call); the geometry is shared.

``perceive_cells_dmajor`` is the differentiable perception: a
``torch.autograd.Function`` whose forward is ``fwd_bucket`` and whose
backward is ``bwd_bucket``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import kernels as K
from .cells import CellEngine

# alive threshold of the life mask (scal[3] of the TPU kernels)
ALIVE_THR = 0.1

Scal = Tuple[float, float, float, float]  # h, sig_w, sig_g, alive threshold


def scal_vec(eng: CellEngine) -> Scal:
    """The pair pass's scalars (h, sig_w, sig_g, alive threshold), each
    exactly representable in float32."""
    return tuple(
        torch.tensor([eng.h, eng.sig_w, eng.sig_g, ALIVE_THR],
                     dtype=torch.float32).tolist()
    )


def window_from_flat(flat: torch.Tensor, win_cells: torch.Tensor,
                     m: int) -> torch.Tensor:
    """flat [..., C, M*F] -> union-window rows [..., nb, Wu*M, F] (one
    cell-granularity gather)."""
    nb, wu = win_cells.shape
    lead = tuple(flat.shape[:-2])
    return flat[..., win_cells.long(), :].reshape(
        lead + (nb, wu * m, flat.shape[-1] // m))


def split_rows(arr: torch.Tensor, nb1: int, dim: int = 0):
    """Block-major rows -> (bucket-1 rows, bucket-2 rows), split on the
    block axis ``dim`` (views)."""
    return arr.narrow(dim, 0, nb1), arr.narrow(dim, nb1, arr.shape[dim] - nb1)


def merge_rows(r1: torch.Tensor, r2: torch.Tensor,
               dim: int = 0) -> torch.Tensor:
    """Inverse of split_rows."""
    if r2.shape[dim] == 0:
        return r1
    return torch.cat([r1, r2], dim=dim)


def _spiky_mag(d2: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """3(h-d)^2/d in the rsqrt form 3((h^2+d2) rsqrt(d2) - 2h) on
    0 < d2 < h^2, else 0."""
    r = torch.rsqrt(torch.where(d2 > 0.0, d2, torch.ones_like(d2)))
    inside = (d2 > 0.0) & (d2 < h * h)
    return torch.where(inside, 3.0 * ((h * h + d2) * r - 2.0 * h),
                       torch.zeros_like(d2))


def _pair_d2(xs_b: torch.Tensor, xw_b: torch.Tensor):
    """[nb, D, P] x [nb, D, W] -> per-axis displacements [nb, D, P, W] and
    d2 [nb, P, W], from direct differences (cancellation-free)."""
    rs = xw_b[:, :, None, :] - xs_b[:, :, :, None]
    d2 = rs[:, 0] * rs[:, 0]
    for d in range(1, rs.shape[1]):
        d2 = d2 + rs[:, d] * rs[:, d]
    return rs, d2


def _scalars(scal: Scal, device):
    return torch.tensor(scal, dtype=torch.float32, device=device).unbind()


def fwd_bucket_plain(scal: Scal, xs_b, ab, xw_b, vw_b, S, win_cells, *,
                     use_alpha: bool):
    """Plain version of ``fwd_bucket``: the same function in PyTorch ops,
    differentiable in S and ab. Leading batch axes of S and ab broadcast
    over the shared geometry."""
    h, sig_w, sig_g, thr = _scalars(scal, xs_b.device)
    *lead, c, m, f = S.shape
    Sw = window_from_flat(S.reshape(*lead, c, m * f), win_cells, m)
    rs, d2 = _pair_d2(xs_b, xw_b)
    v = vw_b[:, None, :]
    Tg = sig_g * _spiky_mag(d2, h) * v
    Tw = sig_w * K.poly6_w(d2, h) * v
    if use_alpha:
        alive = Sw[..., 3] > thr
    else:
        alive = (vw_b > 0.0).expand(*lead, *vw_b.shape)
    sm = torch.sum(Tw * alive.to(Tw.dtype)[..., None, :], dim=-1)
    out = []
    for d in range(rs.shape[1]):
        td = Tg * rs[:, d]
        out.append(torch.matmul(td, Sw) - ab * torch.sum(td, -1, keepdim=True))
    return torch.cat(out, dim=-1), sm


def mask_bucket_plain(scal: Scal, xs_b, xw_b, vw_b, S, win_cells, *,
                      use_alpha: bool):
    """Plain version of ``mask_bucket``."""
    h, sig_w, _, thr = _scalars(scal, xs_b.device)
    *lead, c, m, f = S.shape
    if use_alpha:
        aw = window_from_flat(S.reshape(*lead, c, m * f), win_cells,
                              m)[..., 3] > thr
    else:
        aw = (vw_b > 0.0).expand(*lead, *vw_b.shape)
    _, d2 = _pair_d2(xs_b, xw_b)
    Tw = sig_w * K.poly6_w(d2, h) * vw_b[:, None, :]
    return torch.sum(Tw * aw.to(Tw.dtype)[..., None, :], dim=-1)


def bwd_bucket_plain(scal: Scal, xs_b, vs_b, gsum_b, gb, xw_b, gflat,
                     win_cells):
    """Plain version of ``bwd_bucket``: the adjoint of the SPH gradient over
    one bucket, in PyTorch ops.

    dA[p] = sig_g v_b[p] sum_w sum_d mag r_d G_w[d-block]
            - sum_d gsum[p, d] gbar_p[d-block],  r = xb - xw
    """
    h, _, sig_g, _ = _scalars(scal, xs_b.device)
    *lead, c, m, fd = gflat.shape
    ddim = xs_b.shape[1]
    f = fd // ddim
    Gw = window_from_flat(gflat.reshape(*lead, c, m * fd), win_cells, m)
    rs, d2 = _pair_d2(xs_b, xw_b)  # rs = xw - xb
    mag = _spiky_mag(d2, h)
    acc = 0.0
    for d in range(ddim):
        acc = acc + torch.matmul(mag * -rs[:, d], Gw[..., d * f:(d + 1) * f])
    term1 = sig_g * vs_b[..., None] * acc
    t2 = 0.0
    for d in range(ddim):
        t2 = t2 + gsum_b[..., d:d + 1] * gb[..., d * f:(d + 1) * f]
    return term1 - t2


def _device_of(name: str, tensors: dict) -> torch.device:
    """The one device all ``tensors`` lie on; raise if they are split."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices: "
                         f"{ {k: str(t.device) for k, t in tensors.items()} }")
    return devs.pop()


def _check_cuda(name: str, tensors: dict, win_cells: torch.Tensor) -> None:
    """Validate what the CUDA launcher takes; raise on anything else."""
    for key, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if win_cells.dtype != torch.int32 or not win_cells.is_contiguous():
        raise ValueError(f"{name}: win_cells must be contiguous int32")


def _sample_stride(name: str, key: str, t: torch.Tensor) -> int:
    """The sample stride of a batched rows argument [B, nb, P, X]: each
    sample's rows must be contiguous (a slice of a contiguous batch is)."""
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: {key} must be float32, got {t.dtype}")
    _, nb, p, x = t.shape
    if t.stride()[1:] != (p * x, x, 1) and nb > 0:
        raise ValueError(f"{name}: each sample of {key} must be contiguous, "
                         f"got strides {t.stride()}")
    return t.stride(0)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def fwd_bucket(scal: Scal, xs_b, ab, xw_b, vw_b, S, win_cells, *,
               use_alpha: bool):
    """Fused SPH gradient + pre-update life-mask blur over one bucket.

    xs_b [nb, D, P], ab [B, nb, P, F] (the blocks' own state rows), xw_b
    [nb, D, W], vw_b [nb, W], S [B, C, M, F], win_cells [nb, W/M] int32
    -> (ga [B, nb, P, D*F] d-major, sm [B, nb, P]). The batch axis B may be
    left out of S and ab together, and is then left out of the outputs.
    """
    dev = _device_of("fwd_bucket", dict(xs_b=xs_b, ab=ab, xw_b=xw_b,
                                        vw_b=vw_b, S=S, win_cells=win_cells))
    if dev.type == "cpu":
        return fwd_bucket_plain(scal, xs_b, ab, xw_b, vw_b, S, win_cells,
                                use_alpha=use_alpha)
    if dev.type != "cuda":
        raise ValueError(f"fwd_bucket: no kernel for device {dev}")
    from ._build import load_library

    squeeze = S.dim() == 3
    if squeeze:
        S, ab = S[None], ab[None]
    nb, ddim, p = xs_b.shape
    bsz, c, m, f = S.shape
    w = xw_b.shape[2]
    _check_cuda("fwd_bucket", dict(xs_b=xs_b, xw_b=xw_b, vw_b=vw_b, S=S),
                win_cells)
    if (p != 64 or f != 16 or ddim not in (2, 3)
            or ab.shape != (bsz, nb, p, f)
            or xw_b.shape != (nb, ddim, w) or vw_b.shape != (nb, w)
            or win_cells.shape != (nb, w // m) or w % m):
        raise ValueError(
            f"fwd_bucket: unsupported shapes xs_b {tuple(xs_b.shape)}, ab "
            f"{tuple(ab.shape)}, xw_b {tuple(xw_b.shape)}, S {tuple(S.shape)}"
            " (the kernel takes P=64, F=16, D in {2, 3})"
        )
    ab_bs = _sample_stride("fwd_bucket", "ab", ab)
    ga = torch.empty((bsz, nb, p, ddim * f), dtype=torch.float32, device=dev)
    sm = torch.empty((bsz, nb, p), dtype=torch.float32, device=dev)
    if nb and bsz:
        h, sig_w, sig_g, thr = scal
        rc = load_library().sph_fwd_launch(
            xs_b.data_ptr(), S.data_ptr(), c * m * f, ab.data_ptr(), ab_bs,
            xw_b.data_ptr(), vw_b.data_ptr(), win_cells.data_ptr(), bsz, nb,
            ddim, f, p, m, w, w // m, h, sig_w, sig_g, thr, int(use_alpha),
            ga.data_ptr(), sm.data_ptr(), _stream(dev),
        )
        if rc != 0:
            raise RuntimeError(f"sph_fwd_kernel launch failed: CUDA error {rc}")
        fwd_bucket.launches += 1
    return (ga[0], sm[0]) if squeeze else (ga, sm)


fwd_bucket.launches = 0


def mask_bucket(scal: Scal, xs_b, xw_b, vw_b, S, win_cells, *,
                use_alpha: bool):
    """Life-mask blur over one bucket: sm [B, nb, P] = sum_w sig_W
    max(h^2 - d2, 0)^3 v_w alive_w, alive_w = S_w[3] > thr (use_alpha) or
    v_w > 0. S [B, C, M, F], or [C, M, F] for an unbatched sm [nb, P]."""
    dev = _device_of("mask_bucket", dict(xs_b=xs_b, xw_b=xw_b, vw_b=vw_b,
                                         S=S, win_cells=win_cells))
    if dev.type == "cpu":
        return mask_bucket_plain(scal, xs_b, xw_b, vw_b, S, win_cells,
                                 use_alpha=use_alpha)
    if dev.type != "cuda":
        raise ValueError(f"mask_bucket: no kernel for device {dev}")
    from ._build import load_library

    squeeze = S.dim() == 3
    if squeeze:
        S = S[None]
    nb, ddim, p = xs_b.shape
    bsz, c, m, f = S.shape
    w = xw_b.shape[2]
    _check_cuda("mask_bucket", dict(xs_b=xs_b, xw_b=xw_b, vw_b=vw_b, S=S),
                win_cells)
    if (p != 64 or f < 4 or ddim not in (2, 3)
            or xw_b.shape != (nb, ddim, w) or vw_b.shape != (nb, w)
            or win_cells.shape != (nb, w // m) or w % m):
        raise ValueError(
            f"mask_bucket: unsupported shapes xs_b {tuple(xs_b.shape)}, "
            f"xw_b {tuple(xw_b.shape)}, S {tuple(S.shape)} (the kernel "
            "takes P=64, F>=4, D in {2, 3})"
        )
    sm = torch.empty((bsz, nb, p), dtype=torch.float32, device=dev)
    if nb and bsz:
        h, sig_w, _, thr = scal
        rc = load_library().sph_mask_launch(
            xs_b.data_ptr(), S.data_ptr(), c * m * f, xw_b.data_ptr(),
            vw_b.data_ptr(), win_cells.data_ptr(), bsz, nb, ddim, f, p, m, w,
            w // m, h, sig_w, thr, int(use_alpha), sm.data_ptr(),
            _stream(dev),
        )
        if rc != 0:
            raise RuntimeError(
                f"sph_mask_kernel launch failed: CUDA error {rc}")
        mask_bucket.launches += 1
    return sm[0] if squeeze else sm


mask_bucket.launches = 0


def bwd_bucket(scal: Scal, xs_b, vs_b, gsum_b, gb, xw_b, gflat, win_cells):
    """Adjoint of the SPH gradient over one bucket (the perception's
    backward).

    xs_b [nb, D, P], vs_b [nb, P] (the rows' own volumes), gsum_b
    [nb, P, D], gb [B, nb, P, D*F] (the rows' own d-major cotangents), xw_b
    [nb, D, W], gflat [B, C, M, D*F] (the whole cotangent, read through
    win_cells), win_cells [nb, W/M] int32 -> dA [B, nb, P, F]. The batch
    axis may be left out of gb and gflat together.
    """
    dev = _device_of("bwd_bucket", dict(xs_b=xs_b, vs_b=vs_b, gsum_b=gsum_b,
                                        gb=gb, xw_b=xw_b, gflat=gflat,
                                        win_cells=win_cells))
    if dev.type == "cpu":
        return bwd_bucket_plain(scal, xs_b, vs_b, gsum_b, gb, xw_b, gflat,
                                win_cells)
    if dev.type != "cuda":
        raise ValueError(f"bwd_bucket: no kernel for device {dev}")
    from ._build import load_library

    squeeze = gflat.dim() == 3
    if squeeze:
        gflat, gb = gflat[None], gb[None]
    nb, ddim, p = xs_b.shape
    bsz, c, m, fd = gflat.shape
    f = fd // ddim
    w = xw_b.shape[2]
    _check_cuda("bwd_bucket", dict(xs_b=xs_b, vs_b=vs_b, gsum_b=gsum_b,
                                   xw_b=xw_b, gflat=gflat), win_cells)
    if (p != 64 or f != 16 or ddim not in (2, 3) or fd != ddim * f
            or vs_b.shape != (nb, p) or gsum_b.shape != (nb, p, ddim)
            or gb.shape != (bsz, nb, p, fd)
            or xw_b.shape != (nb, ddim, w)
            or win_cells.shape != (nb, w // m) or w % m):
        raise ValueError(
            f"bwd_bucket: unsupported shapes xs_b {tuple(xs_b.shape)}, gb "
            f"{tuple(gb.shape)}, xw_b {tuple(xw_b.shape)}, gflat "
            f"{tuple(gflat.shape)} (the kernel takes P=64, F=16, D in {{2, 3}})"
        )
    gb_bs = _sample_stride("bwd_bucket", "gb", gb)
    da = torch.empty((bsz, nb, p, f), dtype=torch.float32, device=dev)
    if nb and bsz:
        h, _, sig_g, _ = scal
        rc = load_library().sph_bwd_launch(
            xs_b.data_ptr(), vs_b.data_ptr(), gsum_b.data_ptr(),
            gb.data_ptr(), gb_bs, xw_b.data_ptr(), gflat.data_ptr(),
            c * m * fd, win_cells.data_ptr(), bsz, nb, ddim, f, p, m, w,
            w // m, h, sig_g, da.data_ptr(), _stream(dev),
        )
        if rc != 0:
            raise RuntimeError(f"sph_bwd_kernel launch failed: CUDA error {rc}")
        bwd_bucket.launches += 1
    return da[0] if squeeze else da


bwd_bucket.launches = 0


def fused_perception(eng: CellEngine, S: torch.Tensor, *,
                     use_alpha: bool = True, d_major: bool = False,
                     use_kernels: bool = True):
    """Fused SPH gradient + life-mask smoothing.

    S [..., C, M, F] (at most one leading batch axis) -> (gA [..., C, M, F,
    D], sm [..., C, M]); with ``d_major`` the gradient stays in the kernel's
    [..., C, M, D*F] layout (axis-major blocks), which is the NCA
    feature-concat order. ``sm`` is the smoothed alive indicator before the
    threshold. ``use_kernels=False`` runs the plain versions on any device
    (the reference the kernels are checked against).
    """
    fwd = fwd_bucket if use_kernels else fwd_bucket_plain
    *lead, c, m, f = S.shape
    ddim = eng.xs.shape[-1]
    p = eng.blk_xs.shape[2]
    scal = scal_vec(eng)
    S = S.contiguous()
    ab1, ab2 = split_rows(S.reshape(*lead, -1, p, f), eng.blk_xs.shape[0],
                          dim=-3)
    ga1, sm1 = fwd(scal, eng.blk_xs, ab1, eng.blk_xw, eng.blk_vw, S,
                   eng.blk_win_cells, use_alpha=use_alpha)
    ga2, sm2 = fwd(scal, eng.blk2_xs, ab2, eng.blk2_xw, eng.blk2_vw, S,
                   eng.blk2_win_cells, use_alpha=use_alpha)
    ga = merge_rows(ga1, ga2, dim=-3)
    sm = merge_rows(sm1, sm2, dim=-2).reshape(*lead, c, m)
    if d_major:
        return ga.reshape(*lead, c, m, ddim * f), sm
    return ga.reshape(*lead, c, m, ddim, f).transpose(-2, -1), sm


def gradient_adjoint_dmajor(eng: CellEngine, gflat: torch.Tensor, *,
                            use_kernels: bool = True) -> torch.Tensor:
    """dL/dS of the SPH gradient, the cotangent d-major: gflat [..., C, M,
    D*F] -> [..., C, M, F] (at most one leading batch axis), with
    ``eng.gsum`` as the self term.

    The window positions carry the forward's wrap shifts (the bucket arrays
    hold them); the cotangents themselves are frame-independent.
    """
    bwd = bwd_bucket if use_kernels else bwd_bucket_plain
    *lead, c, m, fd = gflat.shape
    ddim = eng.xs.shape[-1]
    f = fd // ddim
    p = eng.blk_xs.shape[2]
    scal = scal_vec(eng)
    gflat = gflat.contiguous()
    nb1 = eng.blk_xs.shape[0]
    gb1, gb2 = split_rows(gflat.reshape(*lead, -1, p, fd), nb1, dim=-3)
    vs1, vs2 = split_rows(eng.vs.reshape(-1, p), nb1)
    gs1, gs2 = split_rows(eng.gsum.reshape(-1, p, ddim), nb1)
    da1 = bwd(scal, eng.blk_xs, vs1, gs1, gb1, eng.blk_xw, gflat,
              eng.blk_win_cells)
    da2 = bwd(scal, eng.blk2_xs, vs2, gs2, gb2, eng.blk2_xw, gflat,
              eng.blk2_win_cells)
    return merge_rows(da1, da2, dim=-3).reshape(*lead, c, m, f)


class _PerceiveDmajor(torch.autograd.Function):
    """Kernel 2.1 forward, kernel 2.2 backward (the JAX package's
    ``perceive_cells_dmajor`` custom VJP). The mask blur is returned
    detached and takes no cotangent."""

    @staticmethod
    def forward(ctx, S, eng, use_alpha, use_kernels):
        ga, sm = fused_perception(eng, S, use_alpha=use_alpha, d_major=True,
                                  use_kernels=use_kernels)
        ctx.eng = eng
        ctx.use_kernels = use_kernels
        ctx.mark_non_differentiable(sm)
        return ga, sm

    @staticmethod
    def backward(ctx, gbar, _):
        da = gradient_adjoint_dmajor(ctx.eng, gbar,
                                     use_kernels=ctx.use_kernels)
        return da, None, None, None


def perceive_cells_dmajor(eng: CellEngine, S: torch.Tensor,
                          use_alpha: bool = True, *,
                          use_kernels: bool = True):
    """(gA [..., C, M, D*F] d-major, mask_smooth [..., C, M]),
    differentiable in S through gA only: the backward is the gradient
    adjoint (``bwd_bucket``) with ``eng.gsum`` as its self term."""
    return _PerceiveDmajor.apply(S, eng, use_alpha, use_kernels)


def mask_blur(eng: CellEngine, S: torch.Tensor, *, use_alpha: bool = True,
              use_kernels: bool = True) -> torch.Tensor:
    """Life-mask smoothing only: S [..., C, M, F] -> sm [..., C, M]."""
    blur = mask_bucket if use_kernels else mask_bucket_plain
    *lead, c, m, _ = S.shape
    scal = scal_vec(eng)
    S = S.contiguous()
    sm1 = blur(scal, eng.blk_xs, eng.blk_xw, eng.blk_vw, S,
               eng.blk_win_cells, use_alpha=use_alpha)
    sm2 = blur(scal, eng.blk2_xs, eng.blk2_xw, eng.blk2_vw, S,
               eng.blk2_win_cells, use_alpha=use_alpha)
    return merge_rows(sm1, sm2, dim=-2).reshape(*lead, c, m)

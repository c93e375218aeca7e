"""The cell engine's SPH pair pass: fused perception, its adjoint, the
life-mask blur and the table blur.

Counterpart of ``sph_nca_tpu/ops/pallas/pair_kernel.py``. Each pass runs
once per window-size bucket of the engine (see ``ops/cells.py``) over blocks
of P = 64 rows and their union window. An engine built with ``n_shards`` > 1
keeps its bucket rows shard-major; the entry points below split and merge
rows in that order (``split_rows`` / ``merge_rows``), so one device runs it
as it runs an unsharded one (``parallel/cell_shard.py`` runs each shard on
its own rank).

Recompute kernels (engines built without pair tables), each with its plain
PyTorch version beside it:

  ``fwd_bucket``   the SPH gradient of the state (d-major [P, D*F]) plus the
                   pre-update life-mask blur — CUDA ``sph_fwd_kernel``,
                   replacing the TPU kernel ``_fwd_kernel``;
  ``bwd_bucket``   the adjoint of that gradient, dA [P, F] — CUDA
                   ``sph_bwd_kernel``, replacing the TPU kernel
                   ``_bwd_kernel``;
  ``mask_bucket``  the post-update life-mask blur — CUDA ``sph_mask_kernel``,
                   replacing the TPU kernel ``_mask_kernel``.

Table kernels (engines built with ``pair_tables``; ``csrc/table_kernels.cu``):

  ``fwd_tab_bucket``   the same outputs as ``fwd_bucket``, from the stored
                       md / w6 tables — CUDA ``sph_fwd_tab_kernel``,
                       replacing ``_fwd_tab_kernel``;
  ``bwd_tab_bucket``   the adjoint over md — ``sph_bwd_tab_kernel``,
                       replacing ``_bwd_tab_kernel``;
  ``mask_tab_bucket``  the life-mask blur over w6 — ``sph_mask_tab_kernel``,
                       replacing ``_mask_tab_kernel``;
  ``blur_bucket``      the F-channel SPH blur over w6 — ``sph_blur_tab_kernel``,
                       replacing ``_blur_tab_kernel``.

``fused_perception``, ``gradient_adjoint_dmajor`` and ``mask_blur`` take the
table kernels when the engine has tables (``eng.blk_md is not None``), as the
JAX package does; ``blur_cells`` needs them.

A wrapper runs the plain version only for tensors on the CPU; for CUDA tensors
it launches the kernel or raises. Each wrapper counts its launches in its
``launches`` attribute. The kernels read the window states (and cotangents)
straight from the cell-layout tensor through the bucket's ``win_cells`` table,
so both versions take the whole state S [B, C, M, F] and the table rather than
a window copy. A leading batch axis B runs all samples in one launch (the JAX
trainer vmaps the pallas_call); the geometry and the tables are shared.

``perceive_cells_dmajor`` is the differentiable perception: a
``torch.autograd.Function`` whose forward is the forward kernel and whose
backward is the adjoint kernel; ``perceive_cells`` gives its gradient in the
[..., C, M, F, D] layout.
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


def split_rows(arr: torch.Tensor, nb1: int, dim: int = 0, shards: int = 1):
    """Block-major rows laid out shard-major, [b1 | b2] within each shard
    (``ops/cells.py``) -> (bucket-1 rows, bucket-2 rows), each shard-major,
    split on the block axis ``dim``. For one shard these are views; for
    more, contiguous copies."""
    if shards == 1:
        return (arr.narrow(dim, 0, nb1),
                arr.narrow(dim, nb1, arr.shape[dim] - nb1))
    dim %= arr.dim()
    nb = arr.shape[dim]
    a = arr.unflatten(dim, (shards, nb // shards))
    nb1_loc = nb1 // shards
    return (a.narrow(dim + 1, 0, nb1_loc).flatten(dim, dim + 1),
            a.narrow(dim + 1, nb1_loc, nb // shards - nb1_loc).flatten(
                dim, dim + 1))


def merge_rows(r1: torch.Tensor, r2: torch.Tensor, dim: int = 0,
               shards: int = 1) -> torch.Tensor:
    """Inverse of split_rows."""
    if r2.shape[dim] == 0:
        return r1
    if shards == 1:
        return torch.cat([r1, r2], dim=dim)
    dim %= r1.dim()
    out = torch.cat([r1.unflatten(dim, (shards, -1)),
                     r2.unflatten(dim, (shards, -1))], dim=dim + 1)
    return out.flatten(dim, dim + 1)


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


def fwd_tab_bucket_plain(scal: Scal, ab, gsum_b, vw_b, S, win_cells, md,
                         w6, *, use_alpha: bool):
    """Plain version of ``fwd_tab_bucket``, differentiable in S and ab:

    gA_d = sig_g md_d @ (v_w S_w) - ab gsum_d,  sm = w6 @ (sig_w v_w alive_w)

    with the tables upcast to f32 and the right-hand sides in f32."""
    _, sig_w, sig_g, thr = _scalars(scal, vw_b.device)
    *lead, c, m, f = S.shape
    p = w6.shape[1]
    ddim = md.shape[1] // p
    Sw = window_from_flat(S.reshape(*lead, c, m * f), win_cells, m)
    mom = torch.matmul(md.float(), Sw * vw_b[..., None])  # [..., nb, D*P, F]
    ga = torch.cat([sig_g * mom[..., d * p:(d + 1) * p, :]
                    - ab * gsum_b[..., d:d + 1] for d in range(ddim)], dim=-1)
    if use_alpha:
        alive = Sw[..., 3] > thr
    else:
        alive = (vw_b > 0.0).expand(*lead, *vw_b.shape)
    col = sig_w * vw_b * alive.to(vw_b.dtype)
    sm = torch.matmul(w6.float(), col[..., None])[..., 0]
    return ga, sm


def mask_tab_bucket_plain(scal: Scal, vw_b, S, win_cells, w6, *,
                          use_alpha: bool):
    """Plain version of ``mask_tab_bucket``: sm = w6 @ (sig_w v_w alive_w)."""
    _, sig_w, _, thr = _scalars(scal, vw_b.device)
    *lead, c, m, f = S.shape
    if use_alpha:
        alive = window_from_flat(S.reshape(*lead, c, m * f), win_cells,
                                 m)[..., 3] > thr
    else:
        alive = (vw_b > 0.0).expand(*lead, *vw_b.shape)
    col = sig_w * vw_b * alive.to(vw_b.dtype)
    return torch.matmul(w6.float(), col[..., None])[..., 0]


def blur_bucket_plain(scal: Scal, vw_b, X, win_cells, w6):
    """Plain version of ``blur_bucket``: out = sig_w w6 @ (v_w X_w)."""
    _, sig_w, _, _ = _scalars(scal, vw_b.device)
    *lead, c, m, f = X.shape
    Xw = window_from_flat(X.reshape(*lead, c, m * f), win_cells, m)
    return sig_w * torch.matmul(w6.float(), Xw * vw_b[..., None])


def bwd_tab_bucket_plain(scal: Scal, vs_b, gsum_b, gb, gflat, win_cells, md):
    """Plain version of ``bwd_tab_bucket``, the adjoint over the md table:

    dA = -sig_g v_b sum_d md_d @ G_d - sum_d gsum_d gbar_b,d
    """
    _, _, sig_g, _ = _scalars(scal, vs_b.device)
    *lead, c, m, fd = gflat.shape
    p = vs_b.shape[-1]
    ddim = md.shape[1] // p
    f = fd // ddim
    Gw = window_from_flat(gflat.reshape(*lead, c, m * fd), win_cells, m)
    mdf = md.float()
    acc = 0.0
    for d in range(ddim):
        acc = acc + torch.matmul(mdf[:, d * p:(d + 1) * p],
                                 Gw[..., d * f:(d + 1) * f])
    term1 = -sig_g * vs_b[..., None] * acc
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


def _check_aligned(name: str, tensors: dict) -> None:
    """The forward and adjoint kernels (table and recompute) copy these
    tensors with the TMA or read them 16 bytes at a time, which needs
    16-byte aligned addresses."""
    for key, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")


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
    left out of S and ab together, and is then left out of the outputs. The
    kernel takes P = 64, F = 16, M = 8 and D in {2, 3}, and 16-byte aligned
    S, xw_b and vw_b.
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
    if (p != 64 or f != 16 or m != 8 or ddim not in (2, 3)
            or ab.shape != (bsz, nb, p, f)
            or xw_b.shape != (nb, ddim, w) or vw_b.shape != (nb, w)
            or win_cells.shape != (nb, w // m) or w % m):
        raise ValueError(
            f"fwd_bucket: unsupported shapes xs_b {tuple(xs_b.shape)}, ab "
            f"{tuple(ab.shape)}, xw_b {tuple(xw_b.shape)}, S {tuple(S.shape)}"
            " (the kernel takes P=64, F=16, M=8, D in {2, 3})"
        )
    _check_aligned("fwd_bucket", dict(S=S, xw_b=xw_b, vw_b=vw_b))
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
    axis may be left out of gb and gflat together. The kernel takes P = 64,
    F = 16, M = 8 and D in {2, 3}, and 16-byte aligned gflat and xw_b.
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
    if (p != 64 or f != 16 or m != 8 or ddim not in (2, 3)
            or fd != ddim * f
            or vs_b.shape != (nb, p) or gsum_b.shape != (nb, p, ddim)
            or gb.shape != (bsz, nb, p, fd)
            or xw_b.shape != (nb, ddim, w)
            or win_cells.shape != (nb, w // m) or w % m):
        raise ValueError(
            f"bwd_bucket: unsupported shapes xs_b {tuple(xs_b.shape)}, gb "
            f"{tuple(gb.shape)}, xw_b {tuple(xw_b.shape)}, gflat "
            f"{tuple(gflat.shape)} (the kernel takes P=64, F=16, M=8, D in "
            "{2, 3})"
        )
    _check_aligned("bwd_bucket", dict(gflat=gflat, xw_b=xw_b))
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


def _check_tables(name: str, tables: dict, nb: int, w: int, m: int,
                  win_cells: torch.Tensor) -> int:
    """Validate the pair tables a table kernel reads: one dtype (float32 or
    bfloat16), contiguous, 16-byte aligned, [nb, rows, W] with W a multiple
    of 8 and of M. Returns 1 for bfloat16 tables, else 0."""
    dtypes = {t.dtype for t in tables.values()}
    if len(dtypes) != 1 or not dtypes <= {torch.float32, torch.bfloat16}:
        raise ValueError(f"{name}: tables must all be float32 or all "
                         f"bfloat16, got {dtypes}")
    for key, t in tables.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be contiguous and 16-byte "
                             "aligned")
        if t.dim() != 3 or t.shape[0] != nb or t.shape[2] != w:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected [{nb}, rows, {w}]")
    if w % 8 or w % m or win_cells.shape != (nb, w // m):
        raise ValueError(f"{name}: window of {w} slots does not fit M={m} "
                         f"and win_cells {tuple(win_cells.shape)}")
    return int(dtypes.pop() == torch.bfloat16)


def fwd_tab_bucket(scal: Scal, ab, gsum_b, vw_b, S, win_cells, md, w6, *,
                   use_alpha: bool):
    """Fused SPH gradient + pre-update life-mask blur over one bucket, from
    the pair tables.

    ab [B, nb, P, F] (the blocks' own state rows), gsum_b [nb, P, D] (from
    the quantized table), vw_b [nb, W], S [B, C, M, F], win_cells [nb, W/M]
    int32, md [nb, D*P, W] and w6 [nb, P, W] (float32 or bfloat16) ->
    (ga [B, nb, P, D*F] d-major, sm [B, nb, P]). The batch axis may be left
    out of S and ab together, and is then left out of the outputs.
    """
    dev = _device_of("fwd_tab_bucket", dict(
        ab=ab, gsum_b=gsum_b, vw_b=vw_b, S=S, win_cells=win_cells, md=md,
        w6=w6))
    if dev.type == "cpu":
        return fwd_tab_bucket_plain(scal, ab, gsum_b, vw_b, S, win_cells, md,
                                    w6, use_alpha=use_alpha)
    if dev.type != "cuda":
        raise ValueError(f"fwd_tab_bucket: no kernel for device {dev}")
    from ._build import load_library

    squeeze = S.dim() == 3
    if squeeze:
        S, ab = S[None], ab[None]
    nb, p, w = w6.shape
    ddim = md.shape[1] // p
    bsz, c, m, f = S.shape
    bf16 = _check_tables("fwd_tab_bucket", dict(md=md, w6=w6), nb, w, m,
                         win_cells)
    _check_cuda("fwd_tab_bucket", dict(gsum_b=gsum_b, vw_b=vw_b, S=S),
                win_cells)
    if (p != 64 or f != 16 or m != 8 or ddim not in (2, 3)
            or md.shape[1] != ddim * p or ab.shape != (bsz, nb, p, f)
            or gsum_b.shape != (nb, p, ddim) or vw_b.shape != (nb, w)):
        raise ValueError(
            f"fwd_tab_bucket: unsupported shapes md {tuple(md.shape)}, w6 "
            f"{tuple(w6.shape)}, ab {tuple(ab.shape)}, gsum_b "
            f"{tuple(gsum_b.shape)}, S {tuple(S.shape)} (the kernel takes "
            "P=64, F=16, M=8, D in {2, 3})")
    _check_aligned("fwd_tab_bucket", dict(S=S, vw_b=vw_b))
    ab_bs = _sample_stride("fwd_tab_bucket", "ab", ab)
    ga = torch.empty((bsz, nb, p, ddim * f), dtype=torch.float32, device=dev)
    sm = torch.empty((bsz, nb, p), dtype=torch.float32, device=dev)
    if nb and bsz:
        _, sig_w, sig_g, thr = scal
        rc = load_library().sph_fwd_tab_launch(
            bf16, md.data_ptr(), w6.data_ptr(), gsum_b.data_ptr(),
            S.data_ptr(), c * m * f, ab.data_ptr(), ab_bs, vw_b.data_ptr(),
            win_cells.data_ptr(), bsz, nb, ddim, f, p, m, w, w // m, sig_w,
            sig_g, thr, int(use_alpha), ga.data_ptr(), sm.data_ptr(),
            _stream(dev),
        )
        if rc != 0:
            raise RuntimeError(
                f"sph_fwd_tab_kernel launch failed: CUDA error {rc}")
        fwd_tab_bucket.launches += 1
    return (ga[0], sm[0]) if squeeze else (ga, sm)


fwd_tab_bucket.launches = 0


def bwd_tab_bucket(scal: Scal, vs_b, gsum_b, gb, gflat, win_cells, md):
    """Adjoint of the table forward's gradient over one bucket.

    vs_b [nb, P], gsum_b [nb, P, D], gb [B, nb, P, D*F] (the rows' own
    d-major cotangents), gflat [B, C, M, D*F] (read through win_cells),
    md [nb, D*P, W] -> dA [B, nb, P, F]. The batch axis may be left out of gb
    and gflat together.
    """
    dev = _device_of("bwd_tab_bucket", dict(
        vs_b=vs_b, gsum_b=gsum_b, gb=gb, gflat=gflat, win_cells=win_cells,
        md=md))
    if dev.type == "cpu":
        return bwd_tab_bucket_plain(scal, vs_b, gsum_b, gb, gflat, win_cells,
                                    md)
    if dev.type != "cuda":
        raise ValueError(f"bwd_tab_bucket: no kernel for device {dev}")
    from ._build import load_library

    squeeze = gflat.dim() == 3
    if squeeze:
        gflat, gb = gflat[None], gb[None]
    nb, p = vs_b.shape
    bsz, c, m, fd = gflat.shape
    w = md.shape[2]
    ddim = md.shape[1] // p if p else 0
    f = fd // ddim if ddim else 0
    bf16 = _check_tables("bwd_tab_bucket", dict(md=md), nb, w, m, win_cells)
    _check_cuda("bwd_tab_bucket", dict(vs_b=vs_b, gsum_b=gsum_b,
                                       gflat=gflat), win_cells)
    if (p != 64 or f != 16 or m != 8 or ddim not in (2, 3)
            or md.shape[1] != ddim * p or fd != ddim * f
            or gsum_b.shape != (nb, p, ddim)
            or gb.shape != (bsz, nb, p, fd)):
        raise ValueError(
            f"bwd_tab_bucket: unsupported shapes md {tuple(md.shape)}, gb "
            f"{tuple(gb.shape)}, gflat {tuple(gflat.shape)}, gsum_b "
            f"{tuple(gsum_b.shape)} (the kernel takes P=64, F=16, M=8, D in "
            "{2, 3})")
    _check_aligned("bwd_tab_bucket", dict(gflat=gflat))
    gb_bs = _sample_stride("bwd_tab_bucket", "gb", gb)
    da = torch.empty((bsz, nb, p, f), dtype=torch.float32, device=dev)
    if nb and bsz:
        _, _, sig_g, _ = scal
        rc = load_library().sph_bwd_tab_launch(
            bf16, md.data_ptr(), vs_b.data_ptr(), gsum_b.data_ptr(),
            gb.data_ptr(), gb_bs, gflat.data_ptr(), c * m * fd,
            win_cells.data_ptr(), bsz, nb, ddim, f, p, m, w, w // m, sig_g,
            da.data_ptr(), _stream(dev),
        )
        if rc != 0:
            raise RuntimeError(
                f"sph_bwd_tab_kernel launch failed: CUDA error {rc}")
        bwd_tab_bucket.launches += 1
    return da[0] if squeeze else da


bwd_tab_bucket.launches = 0


def mask_tab_bucket(scal: Scal, vw_b, S, win_cells, w6, *, use_alpha: bool):
    """Life-mask blur over one bucket from the poly6 table: sm [B, nb, P] =
    w6 @ (sig_w v_w alive_w), alive_w = S_w[3] > thr (use_alpha) or v_w > 0.
    S [B, C, M, F], or [C, M, F] for an unbatched sm [nb, P]."""
    dev = _device_of("mask_tab_bucket", dict(vw_b=vw_b, S=S,
                                             win_cells=win_cells, w6=w6))
    if dev.type == "cpu":
        return mask_tab_bucket_plain(scal, vw_b, S, win_cells, w6,
                                     use_alpha=use_alpha)
    if dev.type != "cuda":
        raise ValueError(f"mask_tab_bucket: no kernel for device {dev}")
    from ._build import load_library

    squeeze = S.dim() == 3
    if squeeze:
        S = S[None]
    nb, p, w = w6.shape
    bsz, c, m, f = S.shape
    bf16 = _check_tables("mask_tab_bucket", dict(w6=w6), nb, w, m, win_cells)
    _check_cuda("mask_tab_bucket", dict(vw_b=vw_b, S=S), win_cells)
    if p != 64 or f < 4 or vw_b.shape != (nb, w):
        raise ValueError(
            f"mask_tab_bucket: unsupported shapes w6 {tuple(w6.shape)}, vw_b "
            f"{tuple(vw_b.shape)}, S {tuple(S.shape)} (the kernel takes "
            "P=64, F>=4)")
    sm = torch.empty((bsz, nb, p), dtype=torch.float32, device=dev)
    if nb and bsz:
        _, sig_w, _, thr = scal
        rc = load_library().sph_mask_tab_launch(
            bf16, w6.data_ptr(), S.data_ptr(), c * m * f, f, vw_b.data_ptr(),
            win_cells.data_ptr(), bsz, nb, p, m, w, w // m, sig_w, thr,
            int(use_alpha), sm.data_ptr(), _stream(dev),
        )
        if rc != 0:
            raise RuntimeError(
                f"sph_mask_tab_kernel launch failed: CUDA error {rc}")
        mask_tab_bucket.launches += 1
    return sm[0] if squeeze else sm


mask_tab_bucket.launches = 0


def blur_bucket(scal: Scal, vw_b, X, win_cells, w6):
    """SPH blur over one bucket from the poly6 table: X [B, C, M, F] (the
    kernel takes F = 4, the tangent diffusion's; the batch axis may be left
    out) -> [B, nb, P, F] = sig_w w6 @ (v_w X_w)."""
    dev = _device_of("blur_bucket", dict(vw_b=vw_b, X=X, win_cells=win_cells,
                                         w6=w6))
    if dev.type == "cpu":
        return blur_bucket_plain(scal, vw_b, X, win_cells, w6)
    if dev.type != "cuda":
        raise ValueError(f"blur_bucket: no kernel for device {dev}")
    from ._build import load_library

    squeeze = X.dim() == 3
    if squeeze:
        X = X[None]
    nb, p, w = w6.shape
    bsz, c, m, f = X.shape
    bf16 = _check_tables("blur_bucket", dict(w6=w6), nb, w, m, win_cells)
    _check_cuda("blur_bucket", dict(vw_b=vw_b, X=X), win_cells)
    if p != 64 or f != 4 or vw_b.shape != (nb, w):
        raise ValueError(
            f"blur_bucket: unsupported shapes w6 {tuple(w6.shape)}, vw_b "
            f"{tuple(vw_b.shape)}, X {tuple(X.shape)} (the kernel takes "
            "P=64, F=4)")
    out = torch.empty((bsz, nb, p, f), dtype=torch.float32, device=dev)
    if nb and bsz:
        _, sig_w, _, _ = scal
        rc = load_library().sph_blur_tab_launch(
            bf16, w6.data_ptr(), X.data_ptr(), c * m * f, f, vw_b.data_ptr(),
            win_cells.data_ptr(), bsz, nb, p, m, w, w // m, sig_w,
            out.data_ptr(), _stream(dev),
        )
        if rc != 0:
            raise RuntimeError(
                f"sph_blur_tab_kernel launch failed: CUDA error {rc}")
        blur_bucket.launches += 1
    return out[0] if squeeze else out


blur_bucket.launches = 0


def fused_perception(eng: CellEngine, S: torch.Tensor, *,
                     use_alpha: bool = True, d_major: bool = False,
                     use_kernels: bool = True, window=None):
    """Fused SPH gradient + life-mask smoothing.

    S [..., C, M, F] (at most one leading batch axis) -> (gA [..., C, M, F,
    D], sm [..., C, M]); with ``d_major`` the gradient stays in the kernel's
    [..., C, M, D*F] layout (axis-major blocks), which is the NCA
    feature-concat order. ``sm`` is the smoothed alive indicator before the
    threshold. ``use_kernels=False`` runs the plain versions on any device
    (the reference the kernels are checked against). ``window`` is the
    state the windows read through ``win_cells`` when it is not S itself: a
    rank's shard passes the gathered state there and its own cells as S
    (``parallel/cell_shard.py``).
    """
    *lead, c, m, f = S.shape
    ddim = eng.xs.shape[-1]
    p = eng.blk_xs.shape[2]
    nb1 = eng.blk_xs.shape[0]
    k = eng.n_shards
    scal = scal_vec(eng)
    S = S.contiguous()
    ab1, ab2 = split_rows(S.reshape(*lead, -1, p, f), nb1, dim=-3, shards=k)
    S = S if window is None else window.contiguous()
    if eng.blk_md is not None:
        fwd = fwd_tab_bucket if use_kernels else fwd_tab_bucket_plain
        gs1, gs2 = split_rows(eng.gsum.reshape(-1, p, ddim), nb1, shards=k)
        ga1, sm1 = fwd(scal, ab1, gs1, eng.blk_vw, S, eng.blk_win_cells,
                       eng.blk_md, eng.blk_w6, use_alpha=use_alpha)
        ga2, sm2 = fwd(scal, ab2, gs2, eng.blk2_vw, S, eng.blk2_win_cells,
                       eng.blk2_md, eng.blk2_w6, use_alpha=use_alpha)
    else:
        fwd = fwd_bucket if use_kernels else fwd_bucket_plain
        ga1, sm1 = fwd(scal, eng.blk_xs, ab1, eng.blk_xw, eng.blk_vw, S,
                       eng.blk_win_cells, use_alpha=use_alpha)
        ga2, sm2 = fwd(scal, eng.blk2_xs, ab2, eng.blk2_xw, eng.blk2_vw, S,
                       eng.blk2_win_cells, use_alpha=use_alpha)
    ga = merge_rows(ga1, ga2, dim=-3, shards=k)
    sm = merge_rows(sm1, sm2, dim=-2, shards=k).reshape(*lead, c, m)
    if d_major:
        return ga.reshape(*lead, c, m, ddim * f), sm
    return ga.reshape(*lead, c, m, ddim, f).transpose(-2, -1), sm


def gradient_adjoint_dmajor(eng: CellEngine, gflat: torch.Tensor, *,
                            use_kernels: bool = True,
                            window=None) -> torch.Tensor:
    """dL/dS of the SPH gradient, the cotangent d-major: gflat [..., C, M,
    D*F] -> [..., C, M, F] (at most one leading batch axis), with
    ``eng.gsum`` as the self term (over the md table when the engine has
    one).

    The window positions carry the forward's wrap shifts (the bucket arrays
    hold them); the cotangents themselves are frame-independent. ``window``
    as in ``fused_perception``: the cotangent the windows read.
    """
    *lead, c, m, fd = gflat.shape
    ddim = eng.xs.shape[-1]
    f = fd // ddim
    p = eng.blk_xs.shape[2]
    scal = scal_vec(eng)
    gflat = gflat.contiguous()
    nb1 = eng.blk_xs.shape[0]
    k = eng.n_shards
    gb1, gb2 = split_rows(gflat.reshape(*lead, -1, p, fd), nb1, dim=-3,
                          shards=k)
    vs1, vs2 = split_rows(eng.vs.reshape(-1, p), nb1, shards=k)
    gs1, gs2 = split_rows(eng.gsum.reshape(-1, p, ddim), nb1, shards=k)
    gflat = gflat if window is None else window.contiguous()
    if eng.blk_md is not None:
        bwd = bwd_tab_bucket if use_kernels else bwd_tab_bucket_plain
        da1 = bwd(scal, vs1, gs1, gb1, gflat, eng.blk_win_cells, eng.blk_md)
        da2 = bwd(scal, vs2, gs2, gb2, gflat, eng.blk2_win_cells,
                  eng.blk2_md)
    else:
        bwd = bwd_bucket if use_kernels else bwd_bucket_plain
        da1 = bwd(scal, eng.blk_xs, vs1, gs1, gb1, eng.blk_xw, gflat,
                  eng.blk_win_cells)
        da2 = bwd(scal, eng.blk2_xs, vs2, gs2, gb2, eng.blk2_xw, gflat,
                  eng.blk2_win_cells)
    return merge_rows(da1, da2, dim=-3, shards=k).reshape(*lead, c, m, f)


class _PerceiveDmajor(torch.autograd.Function):
    """The forward kernel forward, the adjoint kernel backward (2.1 / 2.2,
    or 2.4 / 2.5 on a table engine; the JAX package's
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


def perceive_cells(eng: CellEngine, S: torch.Tensor, use_alpha: bool = True,
                   *, use_kernels: bool = True):
    """(gA [..., C, M, F, D], mask_smooth [..., C, M]): the layout of the
    JAX package's ``perceive_cells``, differentiable in S through gA only
    with the same backward (the adjoint kernel) as
    ``perceive_cells_dmajor``."""
    ga, sm = perceive_cells_dmajor(eng, S, use_alpha,
                                   use_kernels=use_kernels)
    *lead, c, m, _ = S.shape
    ddim = eng.xs.shape[-1]
    return ga.reshape(*lead, c, m, ddim, -1).transpose(-2, -1), sm


def _block_cells(eng: CellEngine, m: int) -> int:
    """The cells the engine's blocks cover (all C, or a rank's shard)."""
    return (eng.blk_xs.shape[0] + eng.blk2_xs.shape[0]) * eng.blk_xs.shape[2] \
        // m


def mask_blur(eng: CellEngine, S: torch.Tensor, *, use_alpha: bool = True,
              use_kernels: bool = True) -> torch.Tensor:
    """Life-mask smoothing only: S [..., C, M, F] -> sm [..., C, M] (the
    rows of the engine's blocks: a rank's shard reads the gathered state
    and gives its own cells)."""
    *lead, _, m, _ = S.shape
    c = _block_cells(eng, m)
    k = eng.n_shards
    scal = scal_vec(eng)
    S = S.contiguous()
    if eng.blk_w6 is not None:
        blur = mask_tab_bucket if use_kernels else mask_tab_bucket_plain
        sm1 = blur(scal, eng.blk_vw, S, eng.blk_win_cells, eng.blk_w6,
                   use_alpha=use_alpha)
        sm2 = blur(scal, eng.blk2_vw, S, eng.blk2_win_cells, eng.blk2_w6,
                   use_alpha=use_alpha)
    else:
        blur = mask_bucket if use_kernels else mask_bucket_plain
        sm1 = blur(scal, eng.blk_xs, eng.blk_xw, eng.blk_vw, S,
                   eng.blk_win_cells, use_alpha=use_alpha)
        sm2 = blur(scal, eng.blk2_xs, eng.blk2_xw, eng.blk2_vw, S,
                   eng.blk2_win_cells, use_alpha=use_alpha)
    return merge_rows(sm1, sm2, dim=-2, shards=k).reshape(*lead, c, m)


def blur_cells(eng: CellEngine, X: torch.Tensor, *,
               use_kernels: bool = True) -> torch.Tensor:
    """SPH blur in cell layout over the poly6 table: X [..., C, M, F] ->
    [..., C, M, F] (at most one leading batch axis), out_i = sig_W sum_w
    W(d2_iw) v_w X_w at the engine's h. Needs an engine built with
    ``pair_tables``; the tangent diffusion of the surface rollout runs it."""
    if eng.blk_w6 is None:
        raise ValueError(
            "blur_cells needs pair tables; rebuild the engine with "
            "build_cell_engine(..., pair_tables='float32'/'bfloat16')")
    blur = blur_bucket if use_kernels else blur_bucket_plain
    *lead, _, m, f = X.shape
    c = _block_cells(eng, m)
    scal = scal_vec(eng)
    X = X.contiguous()
    o1 = blur(scal, eng.blk_vw, X, eng.blk_win_cells, eng.blk_w6)
    o2 = blur(scal, eng.blk2_vw, X, eng.blk2_win_cells, eng.blk2_w6)
    return merge_rows(o1, o2, dim=-3, shards=eng.n_shards).reshape(
        *lead, c, m, f)

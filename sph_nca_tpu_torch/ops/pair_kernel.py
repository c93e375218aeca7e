"""The cell engine's SPH pair pass: fused perception and life-mask blur.

Counterpart of ``sph_nca_tpu/ops/pallas/pair_kernel.py`` (recompute path, one
shard). Each pass runs once per window-size bucket of the engine (see
``ops/cells.py``) over blocks of P = 64 rows and their union window.

Two kernels, each with its plain PyTorch version beside it:

  ``fwd_bucket``   the SPH gradient of the state (d-major [P, D*F]) plus the
                   pre-update life-mask blur — CUDA ``sph_fwd_kernel``,
                   replacing the TPU kernel ``_fwd_kernel``;
  ``mask_bucket``  the post-update life-mask blur — CUDA ``sph_mask_kernel``,
                   replacing the TPU kernel ``_mask_kernel``.

A wrapper runs the plain version only for tensors on the CPU; for CUDA tensors
it launches the kernel or raises. Each wrapper counts its launches in its
``launches`` attribute. The kernels read the window states straight from the
cell-layout state through the bucket's ``win_cells`` table, so both versions
take the state S [C, M, F] and the table rather than a window copy.
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
    """flat [C, M*F] -> union-window rows [nb, Wu*M, F] (one
    cell-granularity gather)."""
    nb, wu = win_cells.shape
    return flat[win_cells.long()].reshape(nb, wu * m, -1)


def split_rows(arr: torch.Tensor, nb1: int):
    """Block-major rows -> (bucket-1 rows, bucket-2 rows)."""
    return arr[:nb1], arr[nb1:]


def merge_rows(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Inverse of split_rows."""
    if r2.shape[0] == 0:
        return r1
    return torch.cat([r1, r2], dim=0)


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
    """Plain version of ``fwd_bucket``: the same function in PyTorch ops."""
    h, sig_w, sig_g, thr = _scalars(scal, xs_b.device)
    c, m, f = S.shape
    Sw = window_from_flat(S.reshape(c, m * f), win_cells, m)  # [nb, W, F]
    rs, d2 = _pair_d2(xs_b, xw_b)
    v = vw_b[:, None, :]
    Tg = sig_g * _spiky_mag(d2, h) * v
    Tw = sig_w * K.poly6_w(d2, h) * v
    alive = (Sw[..., 3] > thr) if use_alpha else (vw_b > 0.0)
    sm = torch.sum(Tw * alive.to(Tw.dtype)[:, None, :], dim=-1)
    out = []
    for d in range(rs.shape[1]):
        td = Tg * rs[:, d]
        out.append(torch.matmul(td, Sw) - ab * torch.sum(td, -1, keepdim=True))
    return torch.cat(out, dim=-1), sm


def mask_bucket_plain(scal: Scal, xs_b, xw_b, vw_b, S, win_cells, *,
                      use_alpha: bool):
    """Plain version of ``mask_bucket``."""
    h, sig_w, _, thr = _scalars(scal, xs_b.device)
    c, m, f = S.shape
    if use_alpha:
        aw = window_from_flat(S.reshape(c, m * f), win_cells, m)[..., 3] > thr
    else:
        aw = vw_b > 0.0
    _, d2 = _pair_d2(xs_b, xw_b)
    Tw = sig_w * K.poly6_w(d2, h) * vw_b[:, None, :]
    return torch.sum(Tw * aw.to(Tw.dtype)[:, None, :], dim=-1)


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


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def fwd_bucket(scal: Scal, xs_b, ab, xw_b, vw_b, S, win_cells, *,
               use_alpha: bool):
    """Fused SPH gradient + pre-update life-mask blur over one bucket.

    xs_b [nb, D, P], ab [nb, P, F] (the blocks' own state rows), xw_b
    [nb, D, W], vw_b [nb, W], S [C, M, F], win_cells [nb, W/M] int32
    -> (ga [nb, P, D*F] d-major, sm [nb, P]).
    """
    dev = _device_of("fwd_bucket", dict(xs_b=xs_b, ab=ab, xw_b=xw_b,
                                        vw_b=vw_b, S=S, win_cells=win_cells))
    if dev.type == "cpu":
        return fwd_bucket_plain(scal, xs_b, ab, xw_b, vw_b, S, win_cells,
                                use_alpha=use_alpha)
    if dev.type != "cuda":
        raise ValueError(f"fwd_bucket: no kernel for device {dev}")
    from ._build import load_library

    nb, ddim, p = xs_b.shape
    c, m, f = S.shape
    w = xw_b.shape[2]
    _check_cuda("fwd_bucket", dict(xs_b=xs_b, ab=ab, xw_b=xw_b, vw_b=vw_b,
                                   S=S), win_cells)
    if (p != 64 or f != 16 or ddim not in (2, 3) or ab.shape != (nb, p, f)
            or xw_b.shape != (nb, ddim, w) or vw_b.shape != (nb, w)
            or win_cells.shape != (nb, w // m) or w % m):
        raise ValueError(
            f"fwd_bucket: unsupported shapes xs_b {tuple(xs_b.shape)}, ab "
            f"{tuple(ab.shape)}, xw_b {tuple(xw_b.shape)}, S {tuple(S.shape)}"
            " (the kernel takes P=64, F=16, D in {2, 3})"
        )
    ga = torch.empty((nb, p, ddim * f), dtype=torch.float32, device=S.device)
    sm = torch.empty((nb, p), dtype=torch.float32, device=S.device)
    if nb == 0:
        return ga, sm
    h, sig_w, sig_g, thr = scal
    rc = load_library().sph_fwd_launch(
        xs_b.data_ptr(), S.data_ptr(), ab.data_ptr(), xw_b.data_ptr(),
        vw_b.data_ptr(), win_cells.data_ptr(), nb, ddim, f, p, m, w,
        w // m, h, sig_w, sig_g, thr, int(use_alpha), ga.data_ptr(),
        sm.data_ptr(), _stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"sph_fwd_kernel launch failed: CUDA error {rc}")
    fwd_bucket.launches += 1
    return ga, sm


fwd_bucket.launches = 0


def mask_bucket(scal: Scal, xs_b, xw_b, vw_b, S, win_cells, *,
                use_alpha: bool):
    """Life-mask blur over one bucket: sm [nb, P] = sum_w sig_W
    max(h^2 - d2, 0)^3 v_w alive_w, alive_w = S_w[3] > thr (use_alpha) or
    v_w > 0."""
    dev = _device_of("mask_bucket", dict(xs_b=xs_b, xw_b=xw_b, vw_b=vw_b,
                                         S=S, win_cells=win_cells))
    if dev.type == "cpu":
        return mask_bucket_plain(scal, xs_b, xw_b, vw_b, S, win_cells,
                                 use_alpha=use_alpha)
    if dev.type != "cuda":
        raise ValueError(f"mask_bucket: no kernel for device {dev}")
    from ._build import load_library

    nb, ddim, p = xs_b.shape
    c, m, f = S.shape
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
    sm = torch.empty((nb, p), dtype=torch.float32, device=S.device)
    if nb == 0:
        return sm
    h, sig_w, _, thr = scal
    rc = load_library().sph_mask_launch(
        xs_b.data_ptr(), S.data_ptr(), xw_b.data_ptr(), vw_b.data_ptr(),
        win_cells.data_ptr(), nb, ddim, f, p, m, w, w // m, h, sig_w, thr,
        int(use_alpha), sm.data_ptr(), _stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"sph_mask_kernel launch failed: CUDA error {rc}")
    mask_bucket.launches += 1
    return sm


mask_bucket.launches = 0


def fused_perception(eng: CellEngine, S: torch.Tensor, *,
                     use_alpha: bool = True, d_major: bool = False,
                     use_kernels: bool = True):
    """Fused SPH gradient + life-mask smoothing.

    S [C, M, F] -> (gA [C, M, F, D], sm [C, M]); with ``d_major`` the
    gradient stays in the kernel's [C, M, D*F] layout (axis-major blocks),
    which is the NCA feature-concat order. ``sm`` is the smoothed alive
    indicator before the threshold. ``use_kernels=False`` runs the plain
    versions on any device (the reference the kernels are checked against).
    """
    fwd = fwd_bucket if use_kernels else fwd_bucket_plain
    c, m, f = S.shape
    ddim = eng.xs.shape[-1]
    p = eng.blk_xs.shape[2]
    scal = scal_vec(eng)
    S = S.contiguous()
    nb1 = eng.blk_xs.shape[0]
    ab1, ab2 = split_rows(S.reshape(-1, p, f), nb1)

    ga1, sm1 = fwd(scal, eng.blk_xs, ab1, eng.blk_xw, eng.blk_vw, S,
                   eng.blk_win_cells, use_alpha=use_alpha)
    if eng.blk2_xs.shape[0]:
        ga2, sm2 = fwd(scal, eng.blk2_xs, ab2, eng.blk2_xw, eng.blk2_vw, S,
                       eng.blk2_win_cells, use_alpha=use_alpha)
    else:
        ga2 = S.new_zeros((0, p, f * ddim))
        sm2 = S.new_zeros((0, p))
    ga = merge_rows(ga1, ga2)
    sm = merge_rows(sm1, sm2).reshape(c, m)
    if d_major:
        return ga.reshape(c, m, ddim * f), sm
    return ga.reshape(c, m, ddim, f).transpose(2, 3), sm


def perceive_cells_dmajor(eng: CellEngine, S: torch.Tensor,
                          use_alpha: bool = True, *,
                          use_kernels: bool = True):
    """(gA [C, M, D*F] d-major, mask_smooth [C, M]) for inference: the
    backward of the perception comes with the training slice."""
    return fused_perception(eng, S, use_alpha=use_alpha, d_major=True,
                            use_kernels=use_kernels)


def mask_blur(eng: CellEngine, S: torch.Tensor, *, use_alpha: bool = True,
              use_kernels: bool = True) -> torch.Tensor:
    """Life-mask smoothing only: S [C, M, F] -> sm [C, M]."""
    blur = mask_bucket if use_kernels else mask_bucket_plain
    c, m, _ = S.shape
    scal = scal_vec(eng)
    S = S.contiguous()
    sm1 = blur(scal, eng.blk_xs, eng.blk_xw, eng.blk_vw, S,
               eng.blk_win_cells, use_alpha=use_alpha)
    if eng.blk2_xs.shape[0]:
        sm2 = blur(scal, eng.blk2_xs, eng.blk2_xw, eng.blk2_vw, S,
                   eng.blk2_win_cells, use_alpha=use_alpha)
    else:
        sm2 = S.new_zeros((0, sm1.shape[1]))
    return merge_rows(sm1, sm2).reshape(c, m)

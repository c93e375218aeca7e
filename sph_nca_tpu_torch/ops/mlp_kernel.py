"""The per-sample update MLP of the batched-lane cell path.

Counterpart of ``sph_nca_tpu/ops/pallas/mlp_kernel.py``. For every item (one
slot of one sample):

    X = [S | gA_x | gA_y]              [..., 3F]
    H = relu(X @ W1k + b1)             [..., hid], rounded to the input dtype
    O = H @ W2 + b2                    [..., K]

with the perception scale h k already folded into W1k's gA rows by the caller.
The gated rule (K = 2F + 1) returns the pre-activation (gate [..., F],
delta [..., F], mult [...]); the orig rule (K = F) returns (dA [..., F], None,
None): the JAX kernel leaves its delta and mult outputs as untouched padding
there, so the port returns nothing for them.

Layout. The JAX kernel takes the lane-batched [rows, B*F] state and restacks
each sample's 16 lanes in its BlockSpec; the port's batched path keeps the
samples apart ([B, C, M, F], ``ops/batched.py``), so here S is any
[..., F] tensor and ga any [..., >= 2F] tensor whose first 2F features are
gA_x | gA_y (the per-sample d-major perception; a z block is not read). Both
are in the MLP dtype (float32 or bfloat16); w1k [3F, hid] and w2 [hid, K] too;
b1 [hid] and b2 [K] are float32. Both products accumulate in float32 and every
output is float32.

``mlp_forward`` is the wrapper: the plain version ``mlp_ref`` for CPU tensors,
the CUDA kernel ``sph_mlp_kernel`` (``csrc/mlp_kernel.cu``, replacing the TPU
kernel ``_mlp_kernel``) for CUDA tensors, and a ``ValueError`` for what the
kernel does not take; it counts its launches in ``mlp_forward.launches``.
``mlp_fused`` is the differentiable form: its forward is ``mlp_forward`` and
its backward recomputes H and forms every cotangent of ``mlp_ref`` with
``torch.matmul``, as the JAX custom VJP runs ``jax.vjp`` over ``_mlp_ref``
(the JAX package has no backward kernel for it).

The fused route. ``fused_update`` is the whole update of the batched
surface step on a band engine, from the md pass's raw moments to the
pre-life-mask state: the gradient's finish (``bands.band_gradient``), the
tangent projection (``project_td``), the MLP and the rule with the fire
select (``update_rule``). Its plain version ``fused_update_ref`` is that
composition, written once here, and the models' composition calls the same
pieces. For CUDA tensors it is one launch of the fused variant of
``sph_mlp_kernel`` (bfloat16 moments and weights, F = 16, three axes), bit
for bit the composition up to the math library's sigmoid and tanh; it counts
its launches in ``fused_update.launches`` and every call in the counter
``step.fused_update``. The surface rollouts take it when no gradient is
needed, on a band engine with bfloat16 tables and MLP
(``models/surface.py``); every other step runs the composition.
"""

from __future__ import annotations

import torch

from ..utils.profiling import count
from .bands import band_gradient, rounded_scalar

F_KERNEL = 16  # the channels the kernel takes
HID_MAX = 512  # the hidden units the kernel takes at most (shared memory)


def mlp_ref(S, ga, w1k, b1, w2, b2):
    """Plain version of the update MLP (the JAX package's ``_mlp_ref``):
    float32 products and sums, H rounded to the input dtype before the
    second product. Returns (gate, delta, mult) pre-activation for the gated
    rule, (dA, None, None) for the orig rule."""
    f = S.shape[-1]
    X = torch.cat([S, ga[..., :2 * f]], dim=-1).float()
    H = torch.relu(torch.matmul(X, w1k.float()) + b1)
    H = H.to(S.dtype).float()
    O = torch.matmul(H, w2.float()) + b2
    if O.shape[-1] == 2 * f + 1:
        return O[..., :f], O[..., f:2 * f], O[..., 2 * f]
    return O, None, None


def _rows(name: str, key: str, t: torch.Tensor, width: int) -> int:
    """The row stride of ``t`` seen as [n, width] rows (its leading axes must
    collapse into one stride, its last axis be contiguous and each row
    16-byte aligned); raise otherwise."""
    try:
        rows = t.view(-1, t.shape[-1])
    except RuntimeError:
        raise ValueError(f"{name}: the leading axes of {key} must collapse "
                         f"into one stride, got strides {t.stride()}")
    ld = rows.stride(0) if rows.shape[0] > 1 else width
    if (t.shape[-1] < width or rows.stride(1) != 1 or ld % 8
            or t.data_ptr() % 16):
        raise ValueError(
            f"{name}: {key} {tuple(t.shape)} with strides {t.stride()} does "
            f"not give 16-byte aligned rows of {width} contiguous values")
    return ld


def _check(S, ga, w1k, b1, w2, b2):
    """Validate what the CUDA launcher takes; returns (bf16?, ld_s, ld_ga,
    hid, K)."""
    name = "mlp_forward"
    f = F_KERNEL
    if S.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: inputs must be float32 or bfloat16, got "
                         f"{S.dtype}")
    for key, t in dict(ga=ga, w1k=w1k, w2=w2).items():
        if t.dtype != S.dtype:
            raise ValueError(f"{name}: {key} is {t.dtype}, S is {S.dtype}")
    for key, t in dict(b1=b1, b2=b2).items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous float32")
    if not (w1k.is_contiguous() and w2.is_contiguous()):
        raise ValueError(f"{name}: w1k and w2 must be contiguous")
    hid = w1k.shape[-1]
    k = w2.shape[-1]
    if (S.dim() < 1 or S.shape[-1] != f or ga.shape[:-1] != S.shape[:-1]
            or ga.shape[-1] < 2 * f or w1k.shape != (3 * f, hid)
            or w2.shape != (hid, k) or k not in (2 * f + 1, f)
            or not 1 <= hid <= HID_MAX or b1.shape != (hid,)
            or b2.shape != (k,)):
        raise ValueError(
            f"{name}: unsupported shapes S {tuple(S.shape)}, ga "
            f"{tuple(ga.shape)}, w1k {tuple(w1k.shape)}, b1 "
            f"{tuple(b1.shape)}, w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)} "
            f"(the kernel takes F = {f}, K in {{{2 * f + 1}, {f}}}, "
            f"1 <= hid <= {HID_MAX})")
    ld_s = _rows(name, "S", S, f)
    ld_ga = _rows(name, "ga", ga, 2 * f)
    return int(S.dtype == torch.bfloat16), ld_s, ld_ga, hid, k


def mlp_forward(S, ga, w1k, b1, w2, b2):
    """The update MLP's forward: ``mlp_ref`` for CPU tensors, the CUDA
    kernel for CUDA tensors (or a ValueError for what it does not take)."""
    tensors = dict(S=S, ga=ga, w1k=w1k, b1=b1, w2=w2, b2=b2)
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError("mlp_forward: tensors on several devices: "
                         f"{ {k: str(t.device) for k, t in tensors.items()} }")
    dev = devs.pop()
    if dev.type == "cpu":
        return mlp_ref(S, ga, w1k, b1, w2, b2)
    if dev.type != "cuda":
        raise ValueError(f"mlp_forward: no kernel for device {dev}")
    from ._build import load_library

    bf16, ld_s, ld_ga, hid, k = _check(S, ga, w1k, b1, w2, b2)
    f = F_KERNEL
    lead = tuple(S.shape[:-1])
    n = S.numel() // f
    gate = torch.empty(lead + (f,), dtype=torch.float32, device=dev)
    gated = k == 2 * f + 1
    delta = torch.empty_like(gate) if gated else None
    mult = torch.empty(lead, dtype=torch.float32, device=dev) if gated \
        else None
    if n:
        rc = load_library().sph_mlp_launch(
            bf16, S.data_ptr(), ld_s, ga.data_ptr(), ld_ga, w1k.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), n, f, hid, k,
            gate.data_ptr(), delta.data_ptr() if gated else None,
            mult.data_ptr() if gated else None,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"sph_mlp_kernel launch failed: CUDA error {rc}")
        mlp_forward.launches += 1
    return gate, delta, mult


mlp_forward.launches = 0


class _MLPFused(torch.autograd.Function):
    """Forward: the kernel (or the plain version); backward: ``mlp_ref``'s
    cotangents written out with ``torch.matmul``, recomputing H (the JAX
    custom VJP's ``jax.vjp(_mlp_ref)``), without a nested autograd call."""

    @staticmethod
    def forward(ctx, S, ga, w1k, b1, w2, b2, use_kernel):
        ctx.save_for_backward(S, ga, w1k, b1, w2, b2)
        fwd = mlp_forward if use_kernel else mlp_ref
        return tuple(o for o in fwd(S, ga, w1k, b1, w2, b2) if o is not None)

    @staticmethod
    def backward(ctx, *douts):
        S, ga, w1k, b1, w2, b2 = ctx.saved_tensors
        f, dt = S.shape[-1], S.dtype
        X = torch.cat([S, ga[..., :2 * f]], dim=-1).float().reshape(-1, 3 * f)
        w1f, w2f = w1k.float(), w2.float()
        Z = torch.matmul(X, w1f) + b1
        H = torch.relu(Z).to(dt).float()
        dO = torch.cat([d.reshape(X.shape[0], -1) for d in douts], dim=-1)
        # the casts to and from the input dtype round the cotangents as
        # autograd through mlp_ref rounds them
        dZ = torch.matmul(dO, w2f.t()).to(dt).float() * (Z > 0)
        need = ctx.needs_input_grad
        dS = dga = None
        if need[0] or need[1]:
            dX = torch.matmul(dZ, w1f.t()).to(dt)
            dS = dX[:, :f].reshape(S.shape)
            dga = torch.nn.functional.pad(
                dX[:, f:], (0, ga.shape[-1] - 2 * f)).reshape(ga.shape)
        return (dS, dga,
                torch.matmul(X.t(), dZ).to(w1k.dtype) if need[2] else None,
                dZ.sum(0) if need[3] else None,
                torch.matmul(H.t(), dO).to(w2.dtype) if need[4] else None,
                dO.sum(0) if need[5] else None,
                None)


def mlp_fused(S, ga, w1k, b1, w2, b2, *, use_kernel: bool = True):
    """The differentiable update MLP: (gate, delta, mult) pre-activation for
    the gated rule, (dA, None, None) for the orig rule. ``use_kernel=False``
    runs the plain version in the forward on any device."""
    out = _MLPFused.apply(S, ga, w1k, b1, w2, b2, use_kernel)
    return tuple(out) + (None,) * (3 - len(out))


# ---- the fused route: band moments to the pre-life-mask state ---------------


def project_td(ga: torch.Tensor, nd, td,
               include_normal: bool = True) -> torch.Tensor:
    """Tangent projection of per-sample d-major gradients ga [B, C, M, 3*F]
    with per-sample tangents td (three [B, C, M]) and shared normals nd
    (three [C, M]) -> [B, C, M, K*F], blocks [gA.t | gA.bitan (| gA.n)],
    float32 (reference nca.py:325-330; the JAX package's ``_project_td``,
    and its ``project_tangent_space_lanes`` without the lane layout).
    ``include_normal=False`` drops the normal block: the update reads only
    the first two (nca.py:23-31)."""
    f = ga.shape[-1] // 3
    g = [ga[..., i * f:(i + 1) * f] for i in range(3)]
    bd = (nd[1] * td[2] - nd[2] * td[1],
          nd[2] * td[0] - nd[0] * td[2],
          nd[0] * td[1] - nd[1] * td[0])
    bases = [td, bd] + ([nd] if include_normal else [])
    return torch.cat([g[0] * e[0][..., None] + g[1] * e[1][..., None]
                      + g[2] * e[2][..., None] for e in bases], dim=-1)


def update_rule(S, g_pre, d_pre, m_pre, u, fire_rate: float,
                scale: float = 1.0):
    """The update rule on the MLP's outputs and the fire select: the gated
    rule S sigmoid(gate) + tanh(delta) sigmoid(mult) when ``d_pre`` is
    given, else the orig rule S + dA ``scale``; the new state where u <=
    ``fire_rate``, S elsewhere (a select, not a lerp: S + 1 * (nS - S) can
    differ from nS by an ulp)."""
    if d_pre is not None:
        nS = (S * torch.sigmoid(g_pre)
              + torch.tanh(d_pre) * torch.sigmoid(m_pre)[..., None])
    else:
        nS = S + g_pre * scale
    return torch.where((u <= fire_rate)[..., None], nS, S)


def fused_update_ref(mom, S, gsum, sig_g: float, nd, td, weights, u,
                     fire_rate: float, scale: float = 1.0):
    """Plain version of ``fused_update``: the composition it replaces,
    ``band_gradient`` -> ``project_td`` (no normal block) -> ``mlp_ref`` on
    inputs cast to the weights' dtype -> ``update_rule``."""
    dt = weights[0].dtype
    x = project_td(band_gradient(mom, S, gsum, sig_g), nd, td,
                   include_normal=False)
    return update_rule(S, *mlp_ref(S.to(dt), x.to(dt), *weights), u,
                       fire_rate, scale)


def _check_fused(mom, S, gsum, nd, td, weights, u):
    """Validate what the fused launcher takes; returns (B, nb, P, hid, K)."""
    name = "fused_update"
    w1k, b1, w2, b2 = weights
    if S.dim() != 4 or S.shape[-1] != F_KERNEL:
        raise ValueError(f"{name}: S must be [B, nb, P, {F_KERNEL}], got "
                         f"{tuple(S.shape)}")
    b, nb, p, f = S.shape
    hid, k = w1k.shape[-1], w2.shape[-1]
    want = dict(mom=((nb, 3 * p, b * f), torch.bfloat16),
                S=((b, nb, p, f), torch.float32),
                gsum=((nb, p, 3), torch.float32),
                u=((b, nb, p), torch.float32),
                w1k=((3 * f, hid), torch.bfloat16),
                b1=((hid,), torch.float32),
                w2=((hid, k), torch.bfloat16),
                b2=((k,), torch.float32))
    if len(nd) != 3 or len(td) != 3:
        raise ValueError(f"{name}: three normal and three tangent "
                         f"components, got {len(nd)} and {len(td)}")
    got = dict(mom=mom, S=S, gsum=gsum, u=u, w1k=w1k, b1=b1, w2=w2, b2=b2)
    for i in range(3):
        got[f"nd[{i}]"], want[f"nd[{i}]"] = nd[i], ((nb, p), torch.float32)
        got[f"td[{i}]"], want[f"td[{i}]"] = td[i], ((b, nb, p),
                                                    torch.float32)
    for key, (shape, dtype) in want.items():
        t = got[key]
        # the tangents may lie at any strides, all three at the same
        laid = (t.stride() == td[0].stride() and min(t.stride()) >= 0
                if key.startswith("td") else t.is_contiguous())
        if tuple(t.shape) != shape or t.dtype != dtype or not laid:
            raise ValueError(
                f"{name}: {key} must be {dtype} {shape}, contiguous (the "
                f"tangents: at one set of strides), got {t.dtype} "
                f"{tuple(t.shape)} with strides {t.stride()}")
    if k not in (2 * f + 1, f) or not 1 <= hid <= HID_MAX:
        raise ValueError(f"{name}: the kernel takes K in {{{2 * f + 1}, "
                         f"{f}}} and 1 <= hid <= {HID_MAX}, got K {k}, "
                         f"hid {hid}")
    if mom.data_ptr() % 16 or S.data_ptr() % 16:
        raise ValueError(f"{name}: mom and S must start on a 16-byte "
                         "boundary")
    return b, nb, p, hid, k


def fused_update(mom, S, gsum, sig_g: float, nd, td, weights, u,
                 fire_rate: float, scale: float = 1.0, *,
                 use_kernel: bool = True):
    """The batched surface step's update from the band md pass's raw
    moments mom [nb, 3P, B*F] (``bands.perceive_band_moments``), the states
    S [B, nb, P, F], the self term gsum [nb, P, 3] and sigma_g, the normals
    nd (three [nb, P]) and tangents td (three [B, nb, P]), the MLP's
    ``weights`` (``models.cell_step._mlp_weights``), the fire draws u [B,
    nb, P], the fire rate and the orig rule's factor: the pre-life-mask
    state [B, nb, P, F] float32. ``fused_update_ref`` for CPU tensors or
    ``use_kernel=False``, the fused kernel for CUDA tensors (or a
    ValueError for what it does not take)."""
    count("step.fused_update")
    tensors = [mom, S, gsum, *nd, *td, *weights, u]
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"fused_update: tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu" or not use_kernel:
        return fused_update_ref(mom, S, gsum, sig_g, nd, td, weights, u,
                                fire_rate, scale)
    if dev.type != "cuda":
        raise ValueError(f"fused_update: no kernel for device {dev}")
    from ._build import load_library

    b, nb, p, hid, k = _check_fused(mom, S, gsum, nd, td, weights, u)
    out = torch.empty_like(S)
    if out.numel():
        w1k, b1, w2, b2 = weights
        rc = load_library().sph_mlp_fused_launch(
            mom.data_ptr(), S.data_ptr(), gsum.data_ptr(),
            *(t.data_ptr() for t in td), *td[0].stride(),
            *(t.data_ptr() for t in nd),
            u.data_ptr(), w1k.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), b, nb, p, F_KERNEL, hid, k,
            rounded_scalar(sig_g, torch.bfloat16), fire_rate, scale,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"sph_mlp_kernel (fused) launch failed: CUDA "
                               f"error {rc}")
        fused_update.launches += 1
    return out


fused_update.launches = 0

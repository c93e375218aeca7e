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
"""

from __future__ import annotations

import torch

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

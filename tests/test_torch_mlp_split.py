"""The numerical schemes of the update-MLP kernel and the mask table kernel,
emulated on the CPU.

``sph_mlp_kernel`` (csrc/mlp_kernel.cu) runs both layers of the update MLP on
the tensor cores. With float32 inputs each product is split, x = big + small,
big = rna_tf32(x), small = rna_tf32(x - big) (X and H as their fragments are
made, the weights as they are read), and a k step of 8 takes two passes:

    pass 0   A_small B_big, then + A_big B_small   (two chained products)
    pass 1   A_big B_big                           (one product)

With bfloat16 inputs a k step of 16 is one pass, one product of exact
terms. Each pass starts from zero in the tensor core, which adds a
product's terms and the sum it chains onto exactly (the TF32 and bf16
products are exact in f32) and truncates the result to f32; the kernel adds
each pass to its running sums in round-to-nearest f32, k step after k step
(both layers, the hidden units in order), then adds the bias; H is relu(Z +
b1), rounded to bf16 for bf16 inputs. Here a product is an exact float64
matmul, and the result is held against the plain version ``mlp_ref`` at the
training widths (48 -> 256 -> 33 and -> 16) within the card's tolerance,
1e-5 of the largest output for float32 (1e-2 for bfloat16, where a hidden
unit's bf16 rounding may flip); a single TF32 product misses 1e-5.

``sph_mask_tab_kernel`` (csrc/table_kernels.cu) sums each row in 32 pieces
(the 16-byte pieces of each 512-byte stage of its table rows, slot after slot
with f32 FMAs) and adds the pieces by a butterfly; emulated the same way on
the pair tables of a small cloud, it stays within 1e-5 of the largest output
of the plain version ``mask_tab_bucket_plain``. No JAX.
"""

import functools

import numpy as np
import pytest
import torch

from sph_nca_tpu_torch.ops import mlp_kernel as MK
from sph_nca_tpu_torch.ops import pair_kernel as TP
from sph_nca_tpu_torch.ops.cells import build_cell_engine

MLP_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
MLP_FLIP_SHARE = 0.005  # outputs past 1e-5 of max with bf16 inputs
MASK_RTOL = 1e-5
ITEMS = 300


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


def products(a: torch.Tensor, b: torch.Tensor, kstep: int, terms: int):
    """The exact (float64) products of each k step of a @ b, as [k steps]
    lists in the kernel's order: 3xTF32 (terms=3: small terms first, the big
    one last), one TF32 product (terms=1), or bf16 inputs as they are
    (terms=0)."""
    out = []
    for k0 in range(0, a.shape[-1], kstep):
        ak, bk = a[:, k0:k0 + kstep], b[k0:k0 + kstep]
        if terms == 0:
            parts = [(ak, bk)]
        else:
            a_big, b_big = rna_tf32(ak), rna_tf32(bk)
            parts = [(a_big, b_big)]
            if terms == 3:
                a_small, b_small = rna_tf32(ak - a_big), rna_tf32(bk - b_big)
                parts = [(a_small, b_big), (a_big, b_small)] + parts
        out.append([torch.matmul(x.double(), y.double()) for x, y in parts])
    return out


def chain(c: torch.Tensor, prods) -> torch.Tensor:
    """Products chained in the tensor core onto c: each added exactly, the
    sum truncated to float32."""
    for p in prods:
        c = trunc_f32(c.double() + p)
    return c


def accumulate(steps) -> torch.Tensor:
    """The running sums: each pass of a step (3xTF32: the two small terms
    chained, then the big one; else the one product) from zero, added in
    round-to-nearest f32."""
    acc = torch.zeros(steps[0][0].shape)
    for prods in steps:
        for part in (prods[:2], prods[2:]) if len(prods) == 3 else (prods,):
            acc = acc + chain(torch.zeros_like(acc), part)
    return acc


def mlp_split(S, ga, w1k, b1, w2, b2, terms: int = 3):
    """sph_mlp_kernel's outputs, emulated: (gate, delta, mult) or (dA, None,
    None), float32."""
    f = S.shape[-1]
    bf16 = S.dtype == torch.bfloat16
    X = torch.cat([S, ga[..., :2 * f]], dim=-1).float().reshape(-1, 3 * f)
    kstep, terms = (16, 0) if bf16 else (8, terms)
    Z = accumulate(products(X, w1k.float(), kstep, terms)) + b1
    H = torch.relu(Z)
    if bf16:
        H = H.to(torch.bfloat16).float()
    O = accumulate(products(H, w2.float(), kstep, terms)) + b2
    O = O.reshape(*S.shape[:-1], -1)
    if O.shape[-1] == 2 * f + 1:
        return O[..., :f], O[..., f:2 * f], O[..., 2 * f]
    return O, None, None


def _mlp_args(dtype, k, seed):
    """Random inputs at the training widths, the weights at the scale of
    torch.nn.Linear's init (as chip_smoke.py's)."""
    g = torch.Generator().manual_seed(seed)
    S = torch.randn(ITEMS, 16, generator=g)
    ga = torch.randn(ITEMS, 48, generator=g)
    w1k = torch.randn(48, 256, generator=g) * 48 ** -0.5
    b1 = torch.randn(256, generator=g) * 0.1
    w2 = torch.randn(256, k, generator=g) * 256 ** -0.5
    b2 = torch.randn(k, generator=g) * 0.1
    S, ga, w1k, w2 = (t.to(dtype) for t in (S, ga, w1k, w2))
    return S, ga[..., :32], w1k, b1, w2, b2


def _gaps(got, want):
    """(largest error / largest |want|, share of outputs past 1e-5 of it)
    over every output."""
    pairs = [(g, w) for g, w in zip(got, want) if w is not None]
    assert all(g is not None for g, _ in pairs)
    diff = torch.cat([(g - w).abs().reshape(-1) for g, w in pairs])
    top = max(float(w.abs().max()) for _, w in pairs)
    return float(diff.max()) / top, float((diff > 1e-5 * top).float().mean())


def test_trunc_f32_rounds_toward_zero():
    x = torch.tensor([1.0 + 2.0 ** -30, -(1.0 + 2.0 ** -30), 3.0,
                      1.0 - 2.0 ** -40], dtype=torch.float64)
    assert trunc_f32(x).tolist() == [1.0, -1.0, 3.0, 1.0 - 2.0 ** -24]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [33, 16])
def test_split_mlp_matches_plain(dtype, k):
    args = _mlp_args(dtype, k, seed=k)
    got = mlp_split(*args)
    want = MK.mlp_ref(*args)
    rel, share = _gaps(got, want)
    assert rel <= MLP_RTOL[dtype], rel
    if dtype == torch.bfloat16:
        assert share <= MLP_FLIP_SHARE, share


@pytest.mark.parametrize("k", [33, 16])
def test_single_tf32_product_misses(k):
    """One TF32 product of the same f32 operands leaves ~2^-11 of each
    product: past 1e-5 of the largest output."""
    args = _mlp_args(torch.float32, k, seed=k)
    rel, _ = _gaps(mlp_split(*args, terms=1), MK.mlp_ref(*args))
    assert rel > MLP_RTOL[torch.float32], rel


# ---- the mask table kernel ------------------------------------------------

PIECES = 32  # 16-byte pieces of a 512-byte stage of a table row


def pairwise(x: torch.Tensor) -> torch.Tensor:
    """The butterfly's sum over the last axis (a power of 2): neighbours
    first, ((0+1)+(2+3))+((4+5)+(6+7)) ..., in float32."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def mask_split(scal, vw_b, S, win_cells, w6):
    """sph_mask_tab_kernel's sm [B, nb, P], use_alpha on, emulated: piece q
    of a row takes the slots t TW + q V .. + V - 1 of every stage t (TW = 512
    bytes of table, V = 16 bytes), each added by an FMA (an f64 product and
    sum rounded to f32); the pieces are added by the butterfly."""
    _, sig_w, _, thr = TP._scalars(scal, vw_b.device)
    *lead, c, m, f = S.shape
    alive = TP.window_from_flat(S.reshape(*lead, c, m * f), win_cells,
                                m)[..., 3] > thr
    col = torch.where(alive, sig_w * vw_b, torch.zeros_like(vw_b))
    v = 16 // w6.element_size()
    tw = PIECES * v
    w = w6.shape[-1]
    pad = (-w) % tw
    tab = torch.nn.functional.pad(w6.float(), (0, pad))
    col = torch.nn.functional.pad(col, (0, pad))
    nt = tab.shape[-1] // tw
    tab = tab.reshape(*tab.shape[:-1], nt, PIECES, v)   # [nb, P, nt, 32, V]
    col = col.reshape(*col.shape[:-1], nt, PIECES, v)   # [B, nb, nt, 32, V]
    acc = torch.zeros(*col.shape[:-3], tab.shape[1], PIECES)  # [B, nb, P, 32]
    for it in range(nt):
        for e in range(v):
            prod = (tab[:, :, it, :, e].double()
                    * col[..., None, it, :, e].double())
            acc = (prod + acc.double()).float()
    return pairwise(acc)


@functools.cache
def _engine(dtype):
    x = np.random.default_rng(0).uniform(-1, 1, (300, 2)).astype(np.float32)
    eng = build_cell_engine(x, 0.25, period=[2.0, 2.0], pair_tables=dtype,
                            device="cpu")
    assert eng.blk_xs.shape[0] > 0 and eng.blk2_xs.shape[0] > 0
    return eng


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_mask_matches_plain(dtype):
    eng = _engine(dtype)
    c, m, _ = eng.xs.shape
    S = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, c, m, 16)).astype(np.float32))
    scal = TP.scal_vec(eng)
    nb1 = eng.blk_xs.shape[0]
    for wc, vw, w6 in ((eng.blk_win_cells, eng.blk_vw, eng.blk_w6),
                       (eng.blk2_win_cells, eng.blk2_vw, eng.blk2_w6)):
        assert w6.shape[0] in (nb1, eng.blk2_xs.shape[0])
        got = mask_split(scal, vw, S, wc, w6)
        want = TP.mask_tab_bucket_plain(scal, vw, S, wc, w6, use_alpha=True)
        assert got.shape == want.shape
        err = float((got - want).abs().max())
        assert err <= MASK_RTOL * float(want.abs().max()), err

"""ctypes bindings for the band engine's host-side build (``sphgrid.cpp``).

Counterpart of the bindings of ``sph_nca_tpu/native/__init__.py`` that
``ops/bands.build_band_engine`` calls: ``true_pairs``, ``band_cols``,
``fill_band_bf16``, ``accum_table``, ``fill_cast_bf16``, ``cast_bf16_gsum``,
``far_groups`` and ``far_meta``, with the big-buffer allocator ``_alloc``;
``capacity``, which sizes the fixed-K neighbour lists of
``ops/hashgrid.py``; and the rest of the JAX module's public bindings,
``available``, ``fps`` (farthest-point sampling) and ``cell_hash``.
``sphgrid.cpp`` is a byte-for-byte copy of the JAX package's source.

The library is built at first use with ``g++ -O3 -march=native -shared
-fPIC`` into ``sph_nca_tpu_torch/_build/``, under a name carrying the hash of
the source and the flags (as ``ops/_build.py`` names the CUDA library), and
loaded with ctypes. There is no numpy fallback: when the library cannot be
built, every entry point raises with the compiler's message (the JAX
module's return ``None`` instead); ``available()`` only reports whether the
library builds and loads. One route keeps
the band tables bit-identical to the JAX package's, whose bfloat16 tables
come from the same fused native fill.

bfloat16 results are returned as their raw ``uint16`` bits, which the caller
views as ``torch.bfloat16`` (so the port needs no ``ml_dtypes``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import mmap
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "sphgrid.cpp"
BUILD_DIR = _DIR.parent / "_build"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_HUGE_MIN = 16 << 20  # bytes; below this plain numpy allocation is fine


def _alloc(shape, dtype, zero: bool = False) -> np.ndarray:
    """Big-buffer allocator: anonymous mmap + MADV_HUGEPAGE. Pages arrive
    zeroed from the kernel, so ``zero=True`` costs no memset pass, and 2 MB
    pages fault in far fewer steps than 4 KB ones for the table outputs."""
    dt = np.dtype(dtype)
    nbytes = int(np.prod(np.asarray(shape, np.int64))) * dt.itemsize
    if nbytes < _HUGE_MIN:
        return np.zeros(shape, dt) if zero else np.empty(shape, dt)
    mm = mmap.mmap(-1, nbytes)
    try:
        mm.madvise(mmap.MADV_HUGEPAGE)
    except (AttributeError, OSError):
        pass
    return np.frombuffer(mm, dt).reshape(shape)


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libsphgrid_{digest.hexdigest()[:16]}.so"


def build_command(out: Path) -> list:
    return ["g++", *GXX_FLAGS, "-o", str(out), str(SOURCE)]


def build() -> Path:
    """Compile the library unless it exists for this source; returns its
    path, raises with g++'s output on failure. Concurrent processes each
    compile into a temporary file and rename it into place."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = Path(tmp) / out.name
        try:
            proc = subprocess.run(build_command(lib), capture_output=True,
                                  text=True)
        except OSError as exc:
            raise RuntimeError(
                f"cannot build the band engine's native library: {exc}"
            ) from exc
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed ({proc.returncode}) building the band engine's "
                f"native library:\n{' '.join(build_command(lib))}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(lib, out)
    return out


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_D = ctypes.c_double


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C signatures."""
    lib = ctypes.CDLL(str(build()))
    lib.sphgrid_capacity.restype = _INT
    lib.sphgrid_capacity.argtypes = [
        _P, _I64, _INT, ctypes.c_float, _P, _P,  # x, n, d, h, dims, period
        _P, _P,  # max_occupancy, max_neighbors
    ]
    lib.sphgrid_cell_hash.restype = None
    lib.sphgrid_cell_hash.argtypes = [
        _P, _I64, _INT, ctypes.c_float, _P, _P,  # x, n, d, h, dims, out
    ]
    lib.sphgrid_fps.restype = None
    lib.sphgrid_fps.argtypes = [
        _P, _I64, _INT, _I64, _I64, _P,  # x, n, d, m, start, out
    ]
    lib.sphgrid_true_pairs.restype = _I64
    lib.sphgrid_true_pairs.argtypes = [
        _P, _I64, _INT, _D, _P,  # x, n, d, h, period (nullable)
        _I64, _P, _P, _P, _P,  # cap, pi, pj, dx, d2
        _P, _P,  # w6sum, nbr (nullable)
    ]
    lib.sphgrid_band_cols.restype = None
    lib.sphgrid_band_cols.argtypes = [_P, _P, _I64, _I64, _I64, _P]
    lib.sphgrid_fill_band_bf16.restype = None
    lib.sphgrid_fill_band_bf16.argtypes = [
        _P, _P, _I64, _P, _P, _P,  # pi, band_col, e, dx, d2, pj
        _P, _D, _INT, _I64, _I64,  # v, h, d, p, nrows
        _P, _P,  # out (bf16 bits), gs
    ]
    lib.sphgrid_accum_table.restype = None
    lib.sphgrid_accum_table.argtypes = [
        _P, _P, _P, _P, _P,  # rows, cols, ri, mdv, w6v
        _I64, _INT, _I64, _I64, _P,  # e, d, p, wcols, tab
    ]
    lib.sphgrid_fill_cast_bf16.restype = None
    lib.sphgrid_fill_cast_bf16.argtypes = [
        _P, _P, _P, _P, _I64,  # rows, cols, ri, psel (nullable), e
        _P, _P, _P, _P, _D, _INT,  # dx, d2, pj, v, h, d
        _I64, _I64, _I64,  # p, wcols, nrows
        _P, _P,  # out (bf16 bits), gs
    ]
    lib.sphgrid_cast_bf16_gsum.restype = None
    lib.sphgrid_cast_bf16_gsum.argtypes = [
        _P, _P, _I64, _I64, _I64, _P,  # src, dst, nrows, wrows, cc, gs
    ]
    lib.sphgrid_far_groups.restype = _I64
    lib.sphgrid_far_groups.argtypes = [
        _P, _P, _P, _I64, _I64, _I64, _I64,  # pi, pj, band_col, e, p, g, nb
        _P, _P, _P,  # grp_count, offsets, groups_flat
    ]
    lib.sphgrid_far_meta.restype = None
    lib.sphgrid_far_meta.argtypes = [
        _P, _P, _P, _I64, _I64, _I64, _I64,  # pi, pj, band_col, e, p, g, nb
        _P, _P, _P,  # grp_count, offsets, groups_flat
        _P, _I64,  # cuts, T
        _P, _P, _P, _P,  # block_bucket, block_row, bucket_nblocks, _npairs
        _P, _P, _P,  # pair_bucket, pair_row, pair_col
    ]
    return lib


def available() -> bool:
    """Whether the library builds and loads here. The entry points do not
    consult it: each builds and loads on its own and raises with the
    reason when that fails."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a):
    return None if a is None else a.ctypes.data


def _c(a, dtype) -> np.ndarray:
    return np.ascontiguousarray(a, dtype)


def capacity(x: np.ndarray, h: float, dims, period=None):
    """Exact (max hash-cell occupancy, max neighbour count within h, self
    included) of positions x [N, D] on the periodic cell grid of ``dims``
    cells per axis (minimum-image distances with ``period``), in float32 as
    the JAX package computes them."""
    lib = load_library()
    x = _c(x, np.float32)
    n, d = x.shape
    dims_arr = _c(np.broadcast_to(np.asarray(dims, np.int32), (d,)),
                  np.int32)
    per = None if period is None else _c(
        np.broadcast_to(np.asarray(period, np.float32), (d,)), np.float32)
    occ = np.zeros(1, np.int32)
    nbrs = np.zeros(1, np.int32)
    rc = lib.sphgrid_capacity(_ptr(x), n, d, h, _ptr(dims_arr), _ptr(per),
                              _ptr(occ), _ptr(nbrs))
    if rc != 0:
        raise ValueError(f"sphgrid_capacity: unsupported dimension {d}")
    return int(occ[0]), int(nbrs[0])


def cell_hash(x: np.ndarray, h: float, dims) -> np.ndarray:
    """Mixed-radix hash int32 [N] of each point's periodic cell
    floor(x / h) mod dims (axis 0 fastest): ``cell_index`` of
    ``ops/hashgrid.py`` folded with its strides."""
    lib = load_library()
    x = _c(x, np.float32)
    n, d = x.shape
    dims_arr = _c(np.broadcast_to(np.asarray(dims, np.int32), (d,)),
                  np.int32)
    out = np.empty(n, np.int32)
    lib.sphgrid_cell_hash(_ptr(x), n, d, h, _ptr(dims_arr), _ptr(out))
    return out


def fps(x: np.ndarray, m: int, start: int = 0) -> np.ndarray:
    """Greedy farthest-point sampling: int32 [m] indices into x [N, D].
    The first is ``start``; each next maximizes the float32 squared distance
    to the nearest one taken (ties to the lowest index)."""
    x = _c(x, np.float32)
    n, d = x.shape
    if m < 1 or not 0 <= start < n:
        raise ValueError(f"fps: m={m}, start={start} for {n} points")
    lib = load_library()
    out = np.empty(m, np.int32)
    lib.sphgrid_fps(_ptr(x), n, d, m, start, _ptr(out))
    return out


def true_pairs(x: np.ndarray, h: float, period=None):
    """All true SPH pairs |r| < h of rank-ordered positions x [N, D]
    (self pairs included; periodic pairs once per contributing image), with
    the per-particle poly6 sums and neighbour counts accumulated in the scan.
    Returns (pi, pj int32 [E], dx float32 [E, D], d2 float32 [E], w6sum
    float64 [N], nbr int32 [N]); the pairs are sorted by pi."""
    lib = load_library()
    x = _c(x, np.float64)
    n, d = x.shape
    per = None if period is None else _c(
        np.broadcast_to(np.asarray(period, np.float64), (d,)), np.float64)
    w6sum = _alloc(n, np.float64)
    nbr = _alloc(n, np.int32)
    # room for ~33 neighbours a point, the kernel-support packing of the
    # repo's geometries; the scan runs again only if that overflows
    cap = 33 * n + 1024
    while True:
        pi = _alloc(cap, np.int32)
        pj = _alloc(cap, np.int32)
        dx = _alloc((cap, d), np.float32)
        d2 = _alloc(cap, np.float32)
        e = lib.sphgrid_true_pairs(_ptr(x), n, d, h, _ptr(per), cap,
                                   _ptr(pi), _ptr(pj), _ptr(dx), _ptr(d2),
                                   _ptr(w6sum), _ptr(nbr))
        if e < 0:
            raise ValueError(
                f"sphgrid_true_pairs: degenerate grid for {n} points in "
                f"{d}D at h={h} (too many cells)")
        if e <= cap:
            return pi[:e], pj[:e], dx[:e], d2[:e], w6sum, nbr
        cap = e


def band_cols(pi: np.ndarray, pj: np.ndarray, p: int, nb: int) -> np.ndarray:
    """Per-pair band-window column slot*P + pj%P (slot 0/1/2 = block
    b-1 / b / b+1, mod nb), -1 for a far pair."""
    pi, pj = _c(pi, np.int32), _c(pj, np.int32)
    out = np.empty(len(pi), np.int32)
    load_library().sphgrid_band_cols(_ptr(pi), _ptr(pj), len(pi), p, nb,
                                     _ptr(out))
    return out


def fill_band_bf16(pi, band_col, pairs, v, h: float, nrows: int, p: int):
    """Band-table fill, bfloat16 quantization (round to nearest even) and
    the quantized row sums, driven by the pi-sorted pair arrays; far pairs
    (band_col < 0) are skipped. Returns (uint16 bits [nrows, 3P, (D+1)P],
    gs float32 [nrows, (D+1)P])."""
    _, pj, dx, d2 = pairs
    d = dx.shape[1]
    pi, band_col, pj = (_c(a, np.int32) for a in (pi, band_col, pj))
    dx, d2, v = _c(dx, np.float32), _c(d2, np.float32), _c(v, np.float64)
    cc = (d + 1) * p
    out = _alloc((nrows, 3 * p, cc), np.uint16)
    gs = _alloc((nrows, cc), np.float32, zero=True)
    load_library().sphgrid_fill_band_bf16(
        _ptr(pi), _ptr(band_col), len(pi), _ptr(dx), _ptr(d2), _ptr(pj),
        _ptr(v), h, d, p, nrows, _ptr(out), _ptr(gs))
    return out, gs


def accum_table(rows, cols, ri, mdv, w6v, nrows: int, wcols: int,
                p: int) -> np.ndarray:
    """Accumulate pair weights (float64 mdv [E, D], w6v [E]) into a fresh
    float32 table [nrows, wcols, (D+1)P]: component c < D of pair k at
    [rows[k], cols[k], c*P + ri[k]], w6v at column D*P + ri[k]."""
    e, d = mdv.shape
    rows, cols, ri = (_c(a, np.int32) for a in (rows, cols, ri))
    mdv, w6v = _c(mdv, np.float64), _c(w6v, np.float64)
    tab = _alloc((nrows, wcols, (d + 1) * p), np.float32, zero=True)
    load_library().sphgrid_accum_table(
        _ptr(rows), _ptr(cols), _ptr(ri), _ptr(mdv), _ptr(w6v), e, d, p,
        wcols, _ptr(tab))
    return tab


def fill_cast_bf16(rows, cols, ri, psel, pairs, v, h: float, nrows: int,
                   wcols: int, p: int):
    """Fused table fill + bfloat16 quantization + quantized row sums from
    the raw pair data (``pairs`` = (pi, pj, dx, d2) of ``true_pairs``;
    ``psel`` indexes them, aligned with rows / cols / ri; rows
    non-decreasing). Returns (uint16 bits [nrows, wcols, (D+1)P], gs float32
    [nrows, (D+1)P])."""
    _, pj, dx, d2 = pairs
    e = len(rows)
    d = dx.shape[1]
    rows, cols, ri, pj = (_c(a, np.int32) for a in (rows, cols, ri, pj))
    dx, d2, v = _c(dx, np.float32), _c(d2, np.float32), _c(v, np.float64)
    if psel is not None:
        psel = _c(psel, np.int64)
        if len(psel) != e:
            raise ValueError(f"psel has {len(psel)} entries for {e} rows")
    cc = (d + 1) * p
    out = _alloc((nrows, wcols, cc), np.uint16)
    gs = _alloc((nrows, cc), np.float32, zero=True)
    load_library().sphgrid_fill_cast_bf16(
        _ptr(rows), _ptr(cols), _ptr(ri), _ptr(psel), e, _ptr(dx), _ptr(d2),
        _ptr(pj), _ptr(v), h, d, p, wcols, nrows, _ptr(out), _ptr(gs))
    return out, gs


def far_groups(pi, pj, band_col, e_far_cap: int, p: int, g: int, nb: int):
    """Per-block distinct far group ids (ascending) and their counts, in
    one pass over the pi-sorted pairs. Returns (grp_count int32 [nb],
    offsets int64 [nb+1], groups_flat int32 [total])."""
    pi, pj, band_col = (_c(a, np.int32) for a in (pi, pj, band_col))
    grp_count = np.empty(nb, np.int32)
    offsets = np.empty(nb + 1, np.int64)
    flat = _alloc(max(int(e_far_cap), 1), np.int32)
    total = load_library().sphgrid_far_groups(
        _ptr(pi), _ptr(pj), _ptr(band_col), len(pi), p, g, nb,
        _ptr(grp_count), _ptr(offsets), _ptr(flat))
    return grp_count, offsets, flat[:total]


def far_meta(pi, pj, band_col, p: int, g: int, nb: int, grp_count, offsets,
             groups_flat, cuts):
    """Per-block bucket / row and per-pair (bucket, row, column) of the far
    tables, in one pass. Returns (block_bucket int8 [nb], block_row int32
    [nb], bucket_nblocks int64 [T], bucket_npairs int64 [T], pair_bucket
    int8 [E], pair_row int32 [E], pair_col int32 [E])."""
    pi, pj, band_col = (_c(a, np.int32) for a in (pi, pj, band_col))
    grp_count, groups_flat = _c(grp_count, np.int32), _c(groups_flat,
                                                         np.int32)
    offsets, cuts = _c(offsets, np.int64), _c(cuts, np.int64)
    t, e = len(cuts), len(pi)
    block_bucket = np.empty(nb, np.int8)
    block_row = np.empty(nb, np.int32)
    bucket_nblocks = np.empty(t, np.int64)
    bucket_npairs = np.empty(t, np.int64)
    pair_bucket = _alloc(e, np.int8)
    pair_row = _alloc(e, np.int32)
    pair_col = _alloc(e, np.int32)
    load_library().sphgrid_far_meta(
        _ptr(pi), _ptr(pj), _ptr(band_col), e, p, g, nb, _ptr(grp_count),
        _ptr(offsets), _ptr(groups_flat), _ptr(cuts), t, _ptr(block_bucket),
        _ptr(block_row), _ptr(bucket_nblocks), _ptr(bucket_npairs),
        _ptr(pair_bucket), _ptr(pair_row), _ptr(pair_col))
    return (block_bucket, block_row, bucket_nblocks, bucket_npairs,
            pair_bucket, pair_row, pair_col)


def cast_bf16_gsum(tab: np.ndarray):
    """Round-to-nearest-even float32 -> bfloat16 cast of a table [nrows,
    wrows, cc] and the float32 sums of the quantized values over the
    window-row axis [nrows, cc]. Returns (uint16 bits, gs)."""
    tab = _c(tab, np.float32)
    nrows, wrows, cc = tab.shape
    dst = _alloc(tab.shape, np.uint16)
    gs = _alloc((nrows, cc), np.float32, zero=True)
    load_library().sphgrid_cast_bf16_gsum(_ptr(tab), _ptr(dst), nrows,
                                          wrows, cc, _ptr(gs))
    return dst, gs

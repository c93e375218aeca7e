"""Build the CUDA kernels with plain nvcc and load them with ctypes.

One ``nvcc`` process per source in ``sph_nca_tpu_torch/csrc/*.cu``, all started
together, compiles it for ``sm_90a``; one more links the objects into a shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds). The library lands in ``sph_nca_tpu_torch/_build/`` under a name
carrying the hash of the sources, their headers (``csrc/*.cuh``) and the flags:
it is built at first use and again only when one of them changes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from ..utils.profiling import count

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _headers():
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current sources lives."""
    digest = hashlib.sha256()
    for src in _sources() + _headers():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsph_nca_kernels_{digest.hexdigest()[:16]}.so"


def _run(cmds, verbose: bool) -> None:
    """Run the commands in parallel; raise with the output of any that
    failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
        elif verbose and out:
            print(out, flush=True)
    if failed:
        raise RuntimeError("\n".join(failed))


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless the library for these sources exists.
    Returns the library path; raises with nvcc's output on failure. A build
    that runs nvcc adds 1 to the counter ``kernels.compiled``."""
    out = library_path()
    if out.exists():
        return out
    count("kernels.compiled")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in _sources()]
        ptxas = ["-Xptxas=-v"] if verbose else []
        _run([[nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", obj, str(src)]
              for obj, src in zip(objs, _sources())], verbose)
        lib = os.path.join(tmp, out.name)
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]], verbose)
        os.replace(lib, out)
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the launchers' C signatures."""
    lib = ctypes.CDLL(str(build()))
    lib.sph_fwd_launch.argtypes = [
        _P, _P, _L, _P, _L,  # xs_b, S, S's sample stride, ab, ab's stride
        _P, _P, _P,  # xw_b, vw_b, win
        _I, _I, _I, _I, _I, _I, _I, _I,  # B, nb, D, F, P, M, W, Wu
        _F, _F, _F, _F, _I,  # h, sig_w, sig_g, thr, use_alpha
        _P, _P, _P,  # ga, sm, stream
    ]
    lib.sph_fwd_launch.restype = _I
    lib.sph_mask_launch.argtypes = [
        _P, _P, _L, _P, _P, _P,  # xs_b, S, S's sample stride, xw_b, vw_b, win
        _I, _I, _I, _I, _I, _I, _I, _I,  # B, nb, D, F, P, M, W, Wu
        _F, _F, _F, _I,  # h, sig_w, thr, use_alpha
        _P, _P,  # sm, stream
    ]
    lib.sph_mask_launch.restype = _I
    lib.sph_bwd_launch.argtypes = [
        _P, _P, _P,  # xs_b, vs_b, gsum_b
        _P, _L, _P, _P, _L,  # gb, gb's stride, xw_b, gflat, gflat's stride
        _P,  # win
        _I, _I, _I, _I, _I, _I, _I, _I,  # B, nb, D, F, P, M, W, Wu
        _F, _F,  # h, sig_g
        _P, _P,  # da, stream
    ]
    lib.sph_bwd_launch.restype = _I
    lib.sph_fwd_tab_launch.argtypes = [
        _I, _P, _P, _P,  # bf16 tables?, md, w6, gsum_b
        _P, _L, _P, _L,  # S, S's sample stride, ab, ab's stride
        _P, _P,  # vw_b, win
        _I, _I, _I, _I, _I, _I, _I, _I,  # B, nb, D, F, P, M, W, Wu
        _F, _F, _F, _I,  # sig_w, sig_g, thr, use_alpha
        _P, _P, _P,  # ga, sm, stream
    ]
    lib.sph_fwd_tab_launch.restype = _I
    lib.sph_bwd_tab_launch.argtypes = [
        _I, _P, _P, _P,  # bf16 tables?, md, vs_b, gsum_b
        _P, _L, _P, _L,  # gb, gb's stride, gflat, gflat's stride
        _P,  # win
        _I, _I, _I, _I, _I, _I, _I, _I,  # B, nb, D, F, P, M, W, Wu
        _F,  # sig_g
        _P, _P,  # da, stream
    ]
    lib.sph_bwd_tab_launch.restype = _I
    lib.sph_mask_tab_launch.argtypes = [
        _I, _P, _P, _L, _I,  # bf16 tables?, w6, S, S's stride, S's F
        _P, _P,  # vw_b, win
        _I, _I, _I, _I, _I, _I,  # B, nb, P, M, W, Wu
        _F, _F, _I,  # sig_w, thr, use_alpha
        _P, _P,  # sm, stream
    ]
    lib.sph_mask_tab_launch.restype = _I
    lib.sph_blur_tab_launch.argtypes = [
        _I, _P, _P, _L, _I,  # bf16 tables?, w6, X, X's stride, X's F
        _P, _P,  # vw_b, win
        _I, _I, _I, _I, _I, _I,  # B, nb, P, M, W, Wu
        _F,  # sig_w
        _P, _P,  # out, stream
    ]
    lib.sph_blur_tab_launch.restype = _I
    lib.sph_mlp_launch.argtypes = [
        _I, _P, _L, _P, _L,  # bf16 inputs?, S, S's row stride, ga, its stride
        _P, _P, _P, _P,  # w1k, b1, w2, b2
        _L, _I, _I, _I,  # n items, F, hid, K
        _P, _P, _P, _P,  # gate, delta, mult, stream
    ]
    lib.sph_mlp_launch.restype = _I
    lib.sph_mlp_fused_launch.argtypes = [
        _P, _P, _P,  # mom, S, gsum
        _P, _P, _P, _L, _L, _L,  # t0, t1, t2, their strides
        _P, _P, _P, _P,  # n0, n1, n2, u
        _P, _P, _P, _P,  # w1k, b1, w2, b2
        _I, _I, _I, _I, _I, _I,  # B, nb, P, F, hid, K
        _F, _F, _F,  # sigma_g (bf16), fire rate, the orig rule's factor
        _P, _P,  # out, stream
    ]
    lib.sph_mlp_fused_launch.restype = _I
    return lib

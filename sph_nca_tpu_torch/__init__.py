"""sph_nca_tpu_torch — the SPH Neural Cellular Automata port to PyTorch + CUDA.

The counterpart of ``sph_nca_tpu`` (JAX/Pallas), written for an NVIDIA
Hopper GPU. The layout mirrors the JAX package so each counterpart is easy
to find:

  ops/       SPH kernel functions, the cell, band and graph engines (the
             graph: fixed-K neighbour lists, the dense oracle), the
             pair-pass kernels
  csrc/      the hand-written sm_90a CUDA kernels (built with plain nvcc)
  native/    the band engine's host build (sphgrid.cpp, built with g++)
  models/    the NCA model, the step and the rollouts, the surface mode
  training/  the trainer, pools, losses and texture features
  io/        JSON weights, checkpoints (the JAX package's layout, a
             flax-free msgpack codec), carrying JAX weights across
  utils/     grids, meshes, seeds and targets
  eval.py    PSNR / SSIM, the density sweep, texture statistics
  cli/       the training, inference and evaluation command lines
  assets/    targets and two of the JAX package's checkpoints, for the
             card's machine (no PIL, no runs/)

Every kernel has a plain PyTorch version beside it. A wrapper uses the plain
version only for tensors on the CPU; for a CUDA tensor it launches the kernel
or raises. Entry points default to ``device="cuda"`` and raise when no card is
present; the tests pass ``device="cpu"``.

Each subpackage re-exports the JAX counterpart's public names (its
``__all__``, in its order), bound to the port's functions of the same
meaning; the few that name JAX or XLA machinery are left out, and each
subpackage's docstring says which and why. The package imports ``ops``, as
the JAX package does; importing it needs no card, no compiler and no JAX,
since the CUDA and host libraries are built at their first use.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.

    Raises if a CUDA device is asked for and none is present: the port never
    falls back to the CPU on its own; pass ``device="cpu"`` for that.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path"
        )
    return dev


from . import ops  # noqa: E402,F401  (needs resolve_device above)

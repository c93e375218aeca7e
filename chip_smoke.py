#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, the CUDA
toolkit and g++. Thirty main paths, each driven through its entry
point with every launch counter set to 0 just before it and read just
after:

  inference  the cell-engine gecko rollout (16 channels, 256 hidden units,
             h = 0.1) on a 128x128 grid for 128 steps, as
             ``python -m sph_nca_tpu_torch.cli.test`` runs it;
  batched    the batched-lane path at inference: the same gecko, 8 rollouts
             at once on bfloat16 pair tables with a bfloat16 update MLP,
             through ``sph_nca_tpu_torch.models.cell_step.
             rollout_cells_batched``;
  training   plane-mode MSE training at the JAX train CLI's defaults (128x128
             padded to 3D, h = 0.08, 16 channels, 256 hidden, gated rule,
             batch 8, pool 1024, Adam 3e-3), as
             ``python -m sph_nca_tpu_torch.cli.train`` runs it (float32 pair
             tables, the batched-lane rollout, a device pool), for 60
             iterations of the progressive schedule;
  surface    the cell-engine surface rollout of the in-repo stripes texture
             model (16 channels, 256 hidden, h = 0.1, texture mode) on a
             25,600-point sphere of radius 1 with bfloat16 pair tables, 10
             farthest-point radial seeds, 128 steps at fire_rate 0.5, through
             ``sph_nca_tpu_torch.models.surface.rollout_mesh_cells``;
  surface-batched  the same stripes sphere, 8 rollouts at once on bfloat16
             tables with a bfloat16 update MLP, 128 steps at fire_rate 0.5,
             through ``models.surface.rollout_mesh_batched``;
  surface-cli  ``python -m sph_nca_tpu_torch.cli.test --surface`` on a
             procedural mesh written to a temporary directory, 25,600
             points, 128 steps: stripes (random seed), gecko (radial seeds)
             and stripes at --h 0.08 (the diffusion on a second engine);
  surface-bench  bench.py's configuration in the port: 8 rollouts on a
             102,400-point sphere of radius 0.8 with h sized for ~30
             neighbours, 128 steps, bfloat16 tables and MLP, random-init
             parameters (16 channels, 256 hidden), through
             ``rollout_mesh_batched``;
  band-train  the train CLI at its defaults, now ``--engine band`` (float32
             band tables), 60 iterations, and a ``--smoothing_kernel
             wendlandC2`` run;
  band-inference  the test CLI's image mode at its default ``--engine
             band`` (bfloat16 band tables, the batched rollout at B = 1),
             the gecko, 128 steps;
  band-bench  bench.py's configuration on the band engine, as the JAX
             package runs it;
  band-surface-cli  ``cli.test --surface --engine band`` on the procedural
             mesh, the random and the radial seeds;
  texture-train  exemplar-texture training, ``cli.train --loss ot`` (the
             Gabor features) at runs/ot_gabor_dotted's configuration (64x64
             wrapped plane, h = 0.08, 16 channels, 256 hidden, batch 4 from
             a pool of 128, 24-36-step rollouts) on the in-repo exemplar
             (sph_nca_tpu_torch/assets/dotted_synth_64.npy), band engine,
             200 iterations with a checkpoint every 100, then
             ``--resume auto`` for 20 more;
  texture-cells  the same run on the cell engine, 20 iterations;
  texture-cli  ``cli.test --checkpoint`` on the trained checkpoint, image
             and surface mode, both engines;
  texture-eval  ``cli.eval --texture true`` on the JAX package's
             800-iteration checkpoint of that run (assets/ot_gabor_dotted_800);
  eval       ``cli.eval`` (the density study) on the JAX package's face
             model (assets/gecko_full_8000, target assets/face_target_64.npy)
             at 0.5 / 1 / 2 / 4x, 160-step rollouts;
  clip-train  text-guided training, ``cli.train --loss clip_multiscale``
             at runs/clip_smoke's configuration (48x48 plane in 3D, h =
             0.08, 16 channels, 256 hidden, batch 4 from a pool of 64,
             the warm-up towards 8-12-step rollouts, the guide "a red and
             yellow spiral", the fixed-seed random ViT-B/32 towers at full
             size, the fallback tokenizer), 30 iterations from the JAX run's
             initial parameters, on the cell engine (float32 pair tables)
             and on the band engine;
  optimizers  each of the JAX trainer's seven optimizers (written as optax
             defines them) for 3 updates, and ``cli.train --optimizer lamb``
             (band engine, MSE) for 5 iterations, a checkpoint and
             ``--resume auto`` for 2 more;
  graph-inference  ``cli.test --engine graph``: the gecko on the fixed-K
             graph engine (neighbour lists built on the card), 128x128,
             128 steps;
  graph-train  ``cli.train --engine graph`` at the JAX train CLI's
             defaults, 20 iterations and 2 at full depth;
  graph-surface-cli  ``cli.test --surface --engine graph`` on the
             procedural mesh, the random and the radial seeds;
  graph-rebuild  ``models.rollout.rollout_rebuild`` (the lists rebuilt
             every step) on the gecko's grid, still and drifting;
  parallel-band, parallel-band-grad, parallel-surface, parallel-cells,
  parallel-train  the sharded paths of ``sph_nca_tpu_torch.parallel`` at
             full width, two ranks sharing the card over gloo (spawned by
             ``parallel.comm.run_ranks`` after the build): bench.py's
             configuration through ``rollout_band_sharded``; its BPTT at
             the train CLI's defaults; ``rollout_mesh_band_sharded`` on the
             stripes sphere; the gecko through the cell engine's kernels
             on each rank's blocks (recompute, float32 tables, the batched
             B = 8 bfloat16 tables); ``make_sharded_train_step`` on the
             graph engine at the train CLI's defaults;
  parallel-nccl  the band rollout over NCCL, one rank a card;
  demo-serve  the interactive demo server, ``python -m
             sph_nca_tpu_torch.demo.server``, in a thread at --size 64 and
             256 with the shipped gecko (the band engine over the demo's
             2-D points, float32 tables, B = 1): 32 ``/frame`` requests,
             a brush, ``/config`` to a hex lattice and to the stripes
             model, ``/reset``; and its headless ``--record`` mode;
  api        the port as a library: only ``from sph_nca_tpu_torch import
             io, models, ops, utils``, the golden recipe of the verify
             skill (the face model's checkpoint, 64x64, ``ops.build_graph``,
             ``utils.plane_seed``, ``models.rollout_states``, 128 steps at
             fire_rate 1) and ``utils.profiling.StepTimer`` / ``trace``
             around single ``models.surface.rollout_mesh_batched`` steps
             on ``ops.build_band_engine``'s engine at the bench shape.
The cell-engine paths above pass ``--engine cells`` to the CLIs. The graph
paths are plain PyTorch (as the JAX package's are XLA): they launch no
kernel of the port, and the script checks that every counter stays 0.

Phases, each printing one line with its wall time:

  device         the card's name and power limit; TF32 off
  build          the nvcc build of sph_nca_tpu_torch/csrc/*.cu for sm_90a,
                 with nvcc's -Xptxas -v output (registers, shared memory and
                 spills of every kernel instantiation), and the g++ build of
                 the band engine's native library (its command printed)
  kernels        the recompute forward and mask kernels against their plain
                 PyTorch versions at the gecko 128x128 bucket shapes, both
                 buckets, use_alpha on and off; a constant state cancelling
                 through the recompute forward (|gA| < 1e-4)
  rollout        the inference CLI's 128-step rollout and its PNG frames
                 (one a state; the last one's signature and IHDR read with
                 struct: the card has no PIL); then 16 steps at fire_rate
                 1.0 with the kernels and with the plain versions
  batched        the batched gecko: launch counts (fwd_tab, mask_tab and the
                 MLP kernel only), finite states, each sample's alive share
                 near the unbatched CLI's
  batched-check  16 steps at fire_rate 1.0 from the grown states, kernels vs
                 plain versions (with a bfloat16 MLP one step, held by the
                 share of states that part), and the batched rollout against
                 8 unbatched rollout_cells runs
  adjoint        at the training shapes (B = 8): the recompute adjoint kernel
                 against its plain version, and the batched forward and mask
                 kernels against their plain versions and B = 1 launches; a
                 constant state cancelling through the recompute forward
  grad           the perception's autograd gradient through the kernels
                 against autograd through the plain forward
  mlp            the update-MLP kernel against its plain version at the
                 training and the batched gecko shapes, gated and orig,
                 float32 and bfloat16 inputs (largest error and the share of
                 outputs past 1e-5 of max); its wrapper's refusals
  mlp-grad       gradients through mlp_fused (kernel forward) against autograd
                 through the plain version
  train          the train CLI for 60 iterations: finite, falling losses,
                 launch counts equal to what the drawn schedule implies, and
                 its weights JSON running 8 steps in the inference CLI
  train-depth    2 iterations of full 32-48-step BPTT through the train CLI,
                 with each step recomputed in the backward and without: ms
                 per iteration and peak device memory
  train-recompute 2 full-depth iterations of the Trainer on the engine
                 without tables (the recompute kernels), with launch counts
  train-turns    full-depth Trainer iterations on the two training paths in
                 turns (batched on float32 tables, recompute, recompute,
                 batched, twice): ms per BPTT step of each
  tables         the stripes sphere's engine with bfloat16 and float32 pair
                 tables (sizes, pairs, table bytes, build seconds); each
                 table kernel against its plain version in both dtypes at
                 B = 1 and B = 8 (the mask and the blur also at B = 3 and
                 11), one launch of B > 1 samples against B launches of one,
                 pad rows exactly 0, and a constant state cancelling through
                 the forward table kernel (|gA| < 1e-4; also on the training
                 engine in the times phase)
  surface        the surface path: launch counts, finite states, unit
                 tangents, the textured share of points at steps 0, 64 and
                 128; then 16 steps at fire_rate 1.0, kernels vs plain
                 versions, in both dtypes
  surface-grad   the gradient of a scalar loss on a 4-step surface rollout
                 through the table kernels (forward and adjoint) against the
                 same through the plain versions
  surface-batched  the batched surface path: launch counts, finite states,
                 unit tangents, the textured share of every sample at steps
                 0, 64 and 128; ms per step and the device's busy share
  surface-batched-check  16 steps at fire_rate 1.0 from the grown states,
                 kernels vs plain versions (float32 MLP 1e-4; a bfloat16
                 MLP one step, by the share of states that part), and B = 8
                 against 8 unbatched rollout_mesh_cells runs (float32)
  surface-cli    the three CLI runs: states.npz and PLY files (count,
                 shapes, finite, points on the normalized mesh), launch
                 counts (the random seed's 50 pre-diffusion blurs included),
                 the sampling's and the engines' host times; the blur kernel
                 against its plain version on the radius-0.2 engine
  surface-cli-check  the CLI's own engines rebuilt from its points: the
                 forward, mask and blur kernels (B = 1) and the MLP (float32)
                 against their plain versions, and 16 steps of each run from
                 its final state, kernels vs plain (1e-4)
  surface-bench  particle-steps per second (best of 3), ms per step, the
                 device's busy share (the profile's records of the port's
                 kernels held against their launch counters), peak memory,
                 table bytes, the engine's build time; the table and MLP
                 kernels at that shape against their plain versions, with
                 device times, bounds and library calls, torch.bmm also on
                 the bfloat16 tables (surface-bench-kernels)
  times          each kernel's device time (profiler kernel records) beside
                 its plain version's, its bound and, where one exists, a
                 library call's: the recompute kernels at the training and
                 gecko inference shapes (beside their first design's
                 recorded times; the forward and adjoint also beside the
                 table kernels' times on the same engine, and their bound on
                 their route: geometry on the CUDA cores, 3 TF32 products on
                 the tensor cores); the table kernels at the surface path's
                 shapes (the blur also at B = 8, beside its first design's
                 recorded time) and (forward, adjoint, mask) at the training
                 shapes beside one torch.bmm a bucket (forward and adjoint
                 beside their first design's recorded times), the forward
                 also at the batched gecko's shapes; the MLP kernel at the
                 training and batched gecko shapes beside addmm-relu-addmm
                 (float32 sums, bfloat16 products for the bfloat16 row);
                 ms per inference and per surface rollout step
  band-build     band engines at the gecko inference grid (bfloat16), the
                 train CLI's defaults (float32) and bench.py's configuration
                 (bfloat16): blocks, far buckets, table bytes, build seconds;
                 the band passes (perception, both masks, the blur) with
                 float32 tables against the cell engine's plain versions on
                 the same positions, the whole float32 gradient against a
                 float64 gradient of the same pairs (gradient_f64), the
                 path's engine on the card against its plain CPU version
                 (1e-5 of max), volume_consistency
  band-mlp       kernel 2.8 against mlp_ref at the lead shapes the band
                 paths give it (band-train, band-inference, band-bench)
  band-fused     2.8's fused variant (the surface rollouts' update without
                 a gradient) at the band bench shape against the
                 composition it replaces: the orig state bit-equal, the
                 gated state within 2 ulps, the input rows bit-equal
                 (readout weights); its time beside its byte bound, its
                 plain version and the composition
  band-train     finite, falling losses; kernel 2.8's launches (no pair-
                 table kernel); ms per iteration, peak memory, device time
                 per BPTT step of one full-depth iteration, no copy or cast
                 of a table in an iteration (a profile with shapes);
                 wendlandC2 runs
  band-inference launches, the gecko growing; 16 steps at fire_rate 1.0 on
                 float32 band tables against the cell engine (1e-4 of max),
                 the bfloat16 band rollout's gap printed
  band-bench     the fused variant's launches (one a step, no 2.8);
                 particle-steps per second (best of 3) beside the cell
                 engine's, busy share, peak memory; one torch.bmm a table
                 slice and pass, no copy or cast of a table (a profile with
                 shapes); each band pass's time beside its byte bound, and
                 the permuting copy of the state into lanes (band-bench-
                 passes)
  band-surface-cli  the two runs' files and launches
  texture-train  the losses at iterations 0 / 50 / 100 / 150 beside the JAX
                 CLI's (the one at 150 within 2x of JAX's), ms an iteration,
                 kernel 2.8's launches, the checkpoints (the last read back
                 bit-equal, one resume sidecar), the resumed run's
                 iterations and launches
  determinism    one iteration of the band engine's MSE training, OT
                 training and graph-engine training in a child process
                 under torch.use_deterministic_algorithms(True,
                 warn_only=True) with CUBLAS_WORKSPACE_CONFIG=:4096:8: the
                 ops of those paths that have no deterministic
                 implementation on the card (the mode is a detector only)
  texture-resume  10 OT iterations twice from the seed and 5 + a checkpoint
                 + --resume auto: the second straight run and the resumed
                 run bit-equal to the first in losses, parameters and
                 Adam's state (within 1e-4, 1e-3 and 3e-3 of max only
                 where [determinism] named an op, which it prints)
  texture-cells  finite losses; 2.4 / 2.5 / 2.6 / 2.8 launches as the drawn
                 schedule implies
  texture-cli    each run's states (shape, finite, the random seed the
                 texture mode derives) and launches: 2.8 on the band engine,
                 2.1 / 2.3 on the cell engine's image mode, 2.4 / 2.6 / 2.7
                 / 2.8 on its surface mode
  texture-cli-check  the texture CLI's surface engines rebuilt from its
                 points: 2.4 / 2.6 / 2.7 / 2.8 vs plain, 16 steps from the
                 cells run's final state, as surface-cli-check
  texture-kernels  each kernel vs plain at the texture paths' shapes: 2.1 /
                 2.3 on the periodic 64x64 cell engine (B = 1 and 4), 2.4-
                 2.7 on its float32 tables (B = 1 and 4), 2.7 on the
                 6,400-point surface's pre-diffusion engine, 2.8 at the
                 lead shapes of texture-train / -cells / -cli and of the
                 eval CLIs' largest grids
  texture-eval   the baselines against texture_eval_800.json (1e-5), every
                 cell's spectrum and colour L1 below half the blur4x anchor,
                 the gaps to the JAX package's six cells
  eval           PSNR / SSIM at each density beside the JAX package's; at 1x
                 over seeds 0-7, mean PSNR >= 25 dB and SSIM >= 0.88
  clip-parity    the random towers and clip_loss (scales 1 and 2) on the
                 card against the JAX package's float32 CPU numbers for
                 seeded inputs (sph_nca_tpu_torch/assets/clip_parity_*.npy):
                 features 1e-4, the loss 1e-4 of its value, its gradient
                 1e-3 of max; the image tower's forward and forward +
                 backward ms at B = 4
  clip-train     each engine's run: finite losses whose mean at iterations
                 0, 5, ..., 25 lies within 10% of the JAX run's (1.9618),
                 launches as the drawn schedule implies (2.4 / 2.5 / 2.6 /
                 2.8 on the cells, 2.8 on the band engine), the checkpoint
                 and meta.json (mode texture); ms an iteration, peak
                 memory, one full-depth iteration's busy share and the
                 towers' share of it; 2.4-2.6 against their plain versions
                 on the run's float32 tables (B = 1 and 4), 2.8 at both
                 engines' lead shapes
  optimizers     every optimizer's params and optax state on the card
                 within 1e-6 of max of the same updates on the CPU; the
                 lamb run's checkpoint in LAMB's optax layout, the resumed
                 iterations finite, 2.8's launches
  graph-build    graphs built on the card for the gecko's grid, the train
                 CLI's and a periodic 64x64: exact lists, each row's
                 neighbour set equal to the native true pairs, weights
                 against a float64 build; K, capacities, bytes, seconds
  graph-ops      on 2,000 points: the general ops against the dense oracle,
                 the graph ops against the general ops, the float32
                 gradient in x and A against a float64 one
  graph-inference  the gecko grows as on the cell engine (alive share within
                 0.03), no kernel launched; ms a step; 16 steps at
                 fire_rate 1.0 against the cell engine's kernels
  graph-train    falling losses, no kernel launched; ms a full-depth
                 iteration and peak memory; a 4-step BPTT gradient against
                 the cell engine's batched path (1e-4 of max)
  graph-surface-cli  the two runs' files, no kernel launched; 16 steps from
                 each run's final state against the cell engine (1e-4)
  graph-rebuild  the rebuild without motion equals the static rollout; with
                 a drift it stays finite and every list exact
  parallel-band  bench.py's configuration on 2 ranks sharing the card over
                 gloo (the band engine built with block_multiple=2): 16
                 steps of rollout_band_sharded at fire_rate 1.0 against the
                 unsharded rollout (1e-4 of max), the targeted and allgather
                 far exchanges equal, ms a sharded step with the bfloat16
                 MLP beside the unsharded one, comm_bytes_per_pass, the
                 bytes a rank sent and staged a step, each rank's busy share
  parallel-band-grad  the train CLI's defaults at float32: an 8-step BPTT
                 through rollout_band_sharded, the parameters' gradient
                 summed over the ranks against the unsharded one (1e-3 of
                 max)
  parallel-surface  the stripes model on the 25,600-point sphere, 16 steps
                 of rollout_mesh_band_sharded against rollout_mesh_batched
                 (1e-4)
  parallel-cells  the gecko on engines built with n_shards=2: shards=2 on
                 one device (2.1-2.3) and 2 ranks (2.1-2.3) against the
                 n_shards=1 engine (1e-4); 3-step gradients through 2.1-2.3
                 and float32 tables (2.4-2.6) against the same layout on
                 one device (1e-4 of max); the batched B = 8 bfloat16 tables
                 (2.4 / 2.6 / 2.8, 1e-4); each kernel launched
  parallel-train  make_sharded_train_step on the graph engine at the train
                 CLI's defaults, data 2 x particle 1 (2 iterations) and 1 x
                 2 (1), each iteration against one process's from the same
                 parameters and Adam state: losses and Adam's moments within
                 1e-5 of max, the parameters within 1e-2 learning rates
                 (Adam's ties counted), the replicas bit-equal
  parallel-nccl  the parallel-band check over NCCL, one rank a card
                 (min(cards, 4) ranks; one on a one-card machine)
  demo-parity    the demo server on the card at size 32, fire_rate 1.0, 8
                 steps (square, hex with jitter 0.3, the stripes texture
                 with its period) against the port's numpy engine
                 (sph_nca_tpu_torch/demo/engine.py) within rtol 1e-3 / atol
                 1e-4, 2.8 launched once a step; 2.8 against mlp_ref at the
                 demo's row shapes (sizes 32 and 256)
  demo-serve     at each size: ms per /frame (median and p90 over 32
                 requests), ms a step by CUDA events, 2.8's launches a frame
                 (exactly 1), each build's seconds and table bytes (the
                 first and each /config), peak memory, the gecko's alpha
                 mass rising over the frames, the damage brush clearing its
                 disc; the --record run's PNG strip (read with struct); 2.8
                 at the 256 rows beside its bound and the library chain
  api            the golden recipe on the card against its plain CPU run
                 (1e-4 of max over the 128 steps; the gap after 16, 32, 64
                 and 128 steps printed), the alive shares within 0.03 and
                 growing, no launch (the graph engine); StepTimer around 12
                 single steps at the bench shape (102,400 points, B = 8,
                 bfloat16 band tables and MLP, 2 skipped): ms a step and
                 particle-steps/s, no bar; trace around 4 more: its Chrome
                 trace parses and holds a CUDA kernel event (whether
                 sph_mlp_kernel is among them is printed); 2.8 launched
                 exactly once a step, nothing else
The image-mode test CLI phases (rollout, band-inference, texture-cli's
image runs, graph-inference) check their PNG frames as [rollout] does.
Then one JSON line describing the eight kernels (all but 2.7 also with
their launches a rank on the sharded paths and those paths' gaps from
their unsharded twins, under ``parallel``; 2.4, 2.6, 2.7 and 2.8 also
with their launches on the batched surface paths and their numbers at the
bench shape; 2.8 also with its launches and errors on the band paths, and
its fused variant's launches (band-bench, [api], [band-fused]), errors
and times under ``fused``; all
but 2.2 with their launches and errors on the texture paths, under
``texture``; 2.4, 2.5, 2.6 and 2.8 with their launches and errors on the
CLIP paths, under ``clip``; 2.8 with its launches, errors and times on the
demo paths, under ``demo``, and with the StepTimer numbers of [api],
under ``api``), and
as the last line ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before that line. Without a card it exits non-zero and prints no
result.

``python3 chip_smoke.py --profile`` adds torch.profiler traces of 16 surface
rollout steps, of 16 batched surface and bench steps (the band engine's
too), of 16 inference rollout steps and of one full-depth training
iteration on each training path (the band engine's too), with device time
by kernel and the device's busy share, and [texture-profile]: one
full-depth OT iteration against its loss terms alone (wall and device ms,
the largest kernels).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from sph_nca_tpu_torch.cli import eval as cli_eval
from sph_nca_tpu_torch.cli import test as cli_test
from sph_nca_tpu_torch.cli import train as cli_train
from sph_nca_tpu_torch import native
from sph_nca_tpu_torch.io.weights_json import load_weights_json
from sph_nca_tpu_torch.models import cell_step
from sph_nca_tpu_torch.models.cell_step import (
    rollout_cells,
    rollout_cells_batched,
)
from sph_nca_tpu_torch.models.surface import (
    DIFFUSE_H,
    normalize,
    orthogonalize,
    rollout_mesh_batched,
    rollout_mesh_batched_dual,
    rollout_mesh_cells,
)
from sph_nca_tpu_torch.ops import _build
from sph_nca_tpu_torch.ops import mlp_kernel as MK
from sph_nca_tpu_torch.ops import pair_kernel as PK
from sph_nca_tpu_torch.ops.batched import batched_gather_back, batched_scatter
from sph_nca_tpu_torch.ops.cells import build_cell_engine
from sph_nca_tpu_torch.utils.geometry import grange
from sph_nca_tpu_torch.utils.meshes import (
    fibonacci_sphere,
    load_ply_points,
    sphere_normals,
)
from sph_nca_tpu_torch.utils.seeds import (
    plane_seed,
    surface_radial_seed,
    surface_random_seed,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
GECKO = os.path.join(ROOT, "sph_nca_tpu", "demo", "web", "weights",
                     "gecko.json")
IMAGE, STEPS = 128, 128
CHECK_STEPS = 16
SEED = 0
# the training path: the JAX train CLI's defaults
TRAIN_H, TRAIN_B, TRAIN_ITERS, DEPTH_ITERS = 0.08, 8, 60, 2
KERNELS = ("sph_fwd_kernel", "sph_mask_kernel", "sph_bwd_kernel")
TAB_KERNELS = ("sph_fwd_tab_kernel", "sph_bwd_tab_kernel",
               "sph_mask_tab_kernel", "sph_blur_tab_kernel")
WRAPPERS = {"sph_fwd_kernel": PK.fwd_bucket, "sph_mask_kernel": PK.mask_bucket,
            "sph_bwd_kernel": PK.bwd_bucket,
            "sph_fwd_tab_kernel": PK.fwd_tab_bucket,
            "sph_bwd_tab_kernel": PK.bwd_tab_bucket,
            "sph_mask_tab_kernel": PK.mask_tab_bucket,
            "sph_blur_tab_kernel": PK.blur_bucket,
            "sph_mlp_kernel": MK.mlp_forward}
# the launch counter of 2.8's fused variant (MK.fused_update: the surface
# rollouts' update without a gradient), counted apart from 2.8's
FUSED = "sph_mlp_kernel<K> fused"
NO_LAUNCHES = dict.fromkeys([*WRAPPERS, FUSED], 0)
# the surface path: the stripes texture model on the JAX test CLI's default
# surface size (--surface_numpoints 25600, --surface_numseed 10, a mesh
# normalized to radius 1 at --surface_scale 1.0), seed radius h
STRIPES = os.path.join(ROOT, "sph_nca_tpu", "demo", "web", "weights",
                       "stripes.json")
SURF_N, SURF_RADIUS, SURF_SEEDS, SURF_STEPS = 25600, 1.0, 10, 128
SURF_GRAD_STEPS, SURF_B = 4, 8
TAB_RTOL = 1e-5  # table kernel vs plain: the same f32 products, other order
# a constant state cancels in the table forward against the gsum of the
# quantized table to f32 rounding: |gA| below this (the CPU tests' bound; a
# single TF32 product instead of the kernel's split ones does not cancel it,
# tests/test_torch_tf32_split.py)
CONST_ATOL = 1e-4
# the first design of the forward and adjoint table kernels (one sample a
# thread block, f32 FMAs), as recorded in PERF.md: device ms at the training
# shapes (f32 tables, B = 8, both buckets) on an H100 80GB HBM3 at 700 W.
# Printed as a record beside the redesigned kernels' times, never measured
# here (the first design's code is gone) and not in the kernels JSON line
TAB_RECORDED_MS = {"sph_fwd_tab_kernel": 0.8850,
                   "sph_bwd_tab_kernel": 0.8543}
# the first design of the recompute forward and adjoint kernels (one thread
# block a block and sample, the geometry recomputed per sample, fp32 FMAs),
# as recorded in PERF.md: device ms at the training shapes (B = 8) and, for
# the forward, the gecko inference shapes (B = 1), on an H100 80GB HBM3 at
# 700 W. Printed as a record beside the redesigned kernels' times, never
# measured here (that code is gone) and not in the kernels JSON line
RC_RECORDED_MS = {("sph_fwd_kernel", "train"): 0.5236,
                  ("sph_fwd_kernel", "inference"): 0.1184,
                  ("sph_bwd_kernel", "train"): 0.4673,
                  ("sph_mask_kernel", "train"): 0.0860,
                  ("sph_mask_kernel", "inference"): 0.0316}
# the first design of the blur table kernel (one thread block a block and
# sample, the table read from device memory once per sample), as recorded in
# PERF.md: device ms at the surface path's shapes (bfloat16 tables, B = 1),
# on an H100 80GB HBM3 at 700 W; a record, as the ones above
BLUR_RECORDED_MS = 0.0367
# the batched-lane path at inference: the gecko on bfloat16 pair tables, B = 8
# rollouts at once with a bfloat16 update MLP (the JAX package's recipe)
BATCH_B = 8
# sph_mlp_kernel vs mlp_ref: float32 sums in another order, 1e-5 of the
# largest output; with bfloat16 inputs a hidden unit whose two float32 sums
# round to different bfloat16 values moves the outputs by one bfloat16 ulp of
# that unit (2^-8 to 2^-7 of it) times its weights in W2: a few such units in
# one item stay within 1e-2 of the largest output
MLP_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# ... and such flips are rare: all outputs but MLP_FLIP_SHARE of them agree
# within 1e-5 of the largest (summing the first product in float64 instead
# of float32 moves ~0.06% of them past it); a kernel that skipped rounding H
# to bfloat16 would move ~97% of them
MLP_FLIP_SHARE = 0.005
# 2.8's fused variant against the composition it replaces: the same input
# rows and products, so the orig rule's state is bit-equal; the gated
# rule's sigmoid and tanh come from two builds of the math library, within
# FUSED_ULPS float32 ulps of the state
FUSED_ULPS = 2.0
# the batched gecko's alive share against the unbatched CLI's: other fire
# draws and bfloat16 arithmetic, the same grown shape
ALIVE_ATOL = 0.03
# the update-MLP kernel's ragged and edge shapes: item counts that are not a
# multiple of its 32-item tiles (one below a tile, and the training shapes'
# 161,792 items plus 37), hidden widths that are not a multiple of its 64-unit
# padding and the largest it takes
MLP_RAGGED_N = (1, 37, 161_792 + 37)
MLP_RAGGED_HID = (100, 256, 512)
# the mask and blur table kernels' sample tiles besides B = 1 and 8: one
# ragged tile, and full tiles and a ragged one
MASK_RAGGED_B = (3, 11)
# bench.py's configuration (bench.py:43-51,148-154,184-189): 8 surface
# rollouts on a 102,400-point sphere of radius 0.8, h sized for ~30
# neighbours, 128 steps, bfloat16 tables and MLP
BENCH_N, BENCH_RADIUS, BENCH_B, BENCH_STEPS = 102_400, 0.8, 8, 128
BENCH_NEIGHBOURS = 30

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, dense TF32 and bf16 products with fp32 sums on the tensor cores, and
# HBM3 bandwidth. All assume the full 700 W power limit.
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# Kernel vs plain tolerance: both are float32, summing the window in other
# orders (the kernel in 4 interleaved partial sums, the plain version in
# matmul order), and rsqrtf may differ from torch.rsqrt by an ulp or two.
# gA and dA are differences of two sums of size |A| sum|Tg r|, so their error
# is held relative to the largest |gA| / |dA|; the blurs sum positive terms.
GA_RTOL = 1e-5  # of max |gA|
SM_RTOL = 1e-5  # of max |sm|
DA_RTOL = 1e-5  # of max |dA| (also the perception's gradient)
# 16 steps at fire_rate 1.0 through kernels vs plain versions: the states
# (|A| <~ 1) may drift apart by the per-step rounding differences above.
ROLLOUT_ATOL = 1e-4
# With a bfloat16 MLP the two paths part where a hidden unit's rounding flips
# (MLP_FLIP_SHARE above), and the alive threshold then amplifies that over
# the steps, so the 16-step gap is only printed; one step from the grown
# states moves no more than this share of the state values past
# ROLLOUT_ATOL (none on an H100), where an MLP kernel that skipped rounding H
# moved 4.3% of them
BF16_STEP_SHARE = 0.005

# Operations the functions need (D = 3, F = 16). The pair geometry is shared
# by the B samples of a pass, so it counts once per pass: every pair needs its
# d2 (3 sub, 3 mul, 2 add) and the support test; a pair inside the support
# needs, in the forward, the spiky magnitude (rsqrt + 4), Tg (2), Tw (5) and
# Tg r_d with its window sum (2 D); in the mask pass Tw (5); in the adjoint
# the magnitude (5) and mag r_d (D); and per row the adjoint's sig_g v_b (1).
# Per sample: for a pair in support the forward's alive-weighted mask sum (2)
# and its D * 2F gradient products, the mask pass's sum (2), the adjoint's
# D * 2F products; per row the forward's D * F self products (2 each) and the
# adjoint's scale and self term (F * (1 + 2D)).
GEO_EVERY_PAIR = 9
GEO_FWD_IN_SUPPORT = 5 + 2 + 5 + 2 * 3
GEO_MASK_IN_SUPPORT = 5
GEO_BWD_IN_SUPPORT = 5 + 3
GEO_BWD_ROW = 1
SAMPLE_FWD_IN_SUPPORT = 2 + 3 * 2 * 16
SAMPLE_FWD_ROW = 3 * 16 * 2
SAMPLE_MASK_IN_SUPPORT = 2
SAMPLE_BWD_IN_SUPPORT = 3 * 2 * 16
SAMPLE_BWD_ROW = 16 * (1 + 2 * 3)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase(name: str, t0: float, text: str) -> None:
    print(f"[{name}] {time.time() - t0:.2f}s {text}", flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of fn() over ``iters`` calls between two CUDA events: the
    device's time plus any gap the host leaves between launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, name=None, iters: int = 20, warmup: int = 3,
              readings: int = 3, attempts: int = 4) -> float:
    """Device time of fn() per call from the profiler's kernel records:
    the kernels whose name contains ``name``, or every kernel fn() launches
    when ``name`` is None. Host gaps between launches do not count.

    Single profiles on the H100 have read far too low: no record at all
    for a kernel recorded in every other run, 0.0041 ms for a ``torch.bmm``
    pair that read 0.053 ms in every other run, 0.0722 ms for a kernel
    that takes 0.187. So the time is the median of ``readings`` profiles,
    and a spread above 20% between them is printed. fn() launches the same
    kernels at every call, so a whole profile holds a multiple of ``iters``
    records: one that does not is printed, with the runtime's launch
    records beside it, and taken again, up to ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, attempt = [], 0
    while len(times) < readings:
        attempt += 1
        if attempt > attempts + readings - 1:
            fail(f"the profiler held no whole record of {name or 'fn'} in "
                 f"{attempt - 1} profiles")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us, records, launches, seen = 0.0, 0, 0, set()
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CPU:
                if "LaunchKernel" in ev.key:
                    launches += ev.count
                continue
            seen.add(ev.key[:48])
            if name is not None and name not in ev.key:
                continue
            total_us += getattr(ev, "self_device_time_total",
                                getattr(ev, "self_cuda_time_total", 0))
            records += ev.count
        if total_us > 0 and records % iters == 0:
            times.append(total_us / iters / 1e3)
            continue
        print(f"  the profiler holds {records} device records of "
              f"{name or 'fn'} over {iters} calls, not a whole multiple "
              f"({launches} kernel launches on the runtime's side; device "
              f"records: {sorted(seen)[:8]}); taken again", flush=True)
    times.sort()
    if times[-1] > 1.2 * times[0]:
        print(f"  device time of {name or 'fn'}: readings "
              f"{', '.join(f'{t:.4f}' for t in times)} ms, spread above "
              "20%; the median is kept", flush=True)
    return times[len(times) // 2]


def bucket_args(eng, S, bucket):
    nb1 = eng.blk_xs.shape[0]
    p, f = eng.blk_xs.shape[2], S.shape[-1]
    rows = S.reshape(*S.shape[:-3], -1, p, f)
    if bucket == 1:
        return (eng.blk_xs, rows[..., :nb1, :, :], eng.blk_xw, eng.blk_vw,
                eng.blk_win_cells)
    return (eng.blk2_xs, rows[..., nb1:, :, :], eng.blk2_xw, eng.blk2_vw,
            eng.blk2_win_cells)


def bwd_args(eng, G, bucket):
    """bwd_bucket's arguments (after scal) for one bucket of the cotangent
    G [B, C, M, D*F]."""
    nb1 = eng.blk_xs.shape[0]
    p, d = eng.blk_xs.shape[2], eng.blk_xs.shape[1]
    lo = 0 if bucket == 1 else nb1
    hi = nb1 if bucket == 1 else nb1 + eng.blk2_xs.shape[0]
    rows = G.reshape(*G.shape[:-3], -1, p, G.shape[-1])[..., lo:hi, :, :]
    xs_b, xw_b, wc = ((eng.blk_xs, eng.blk_xw, eng.blk_win_cells)
                      if bucket == 1 else
                      (eng.blk2_xs, eng.blk2_xw, eng.blk2_win_cells))
    return (xs_b, eng.vs.reshape(-1, p)[lo:hi],
            eng.gsum.reshape(-1, p, d)[lo:hi], rows, xw_b, G, wc)


def real_rows(eng, bucket):
    nb1 = eng.blk_xs.shape[0]
    real = (eng.vs > 0).reshape(-1, eng.blk_xs.shape[2])
    return real[:nb1] if bucket == 1 else real[nb1:]


def rel_err(got, want, real):
    """(max abs error, max abs error / max |want|) over real rows: real
    [nb, P]; got and want [..., nb, P] or [..., nb, P, K]."""
    diff, mag = (got - want).abs(), want.abs()
    if tuple(got.shape[-2:]) != tuple(real.shape):  # a trailing feature axis
        diff, mag = diff.amax(-1), mag.amax(-1)
    err = float(diff[..., real].max())
    return err, err / max(float(mag[..., real].max()), 1e-30)


def check_recompute(eng, S) -> dict:
    """sph_fwd_kernel and sph_mask_kernel against their plain versions on
    each non-empty bucket of ``eng`` (no tables) for S [C, M, 16] or
    [B, C, M, 16], use_alpha on and off: gA within GA_RTOL and sm within
    SM_RTOL of max over the real rows. Returns the largest absolute error
    per kernel."""
    scal = PK.scal_vec(eng)
    errs = {"sph_fwd_kernel": 0.0, "sph_mask_kernel": 0.0}
    lead = f"B={S.shape[0]} " if S.dim() == 4 else ""
    for bucket in (1, 2):
        xs_b, ab, xw_b, vw_b, wc = bucket_args(eng, S, bucket)
        if xs_b.shape[0] == 0:
            continue
        real = real_rows(eng, bucket)
        for use_alpha in (True, False):
            ga_k, sm_k = PK.fwd_bucket(scal, xs_b, ab, xw_b, vw_b, S, wc,
                                       use_alpha=use_alpha)
            ga_p, sm_p = PK.fwd_bucket_plain(scal, xs_b, ab, xw_b, vw_b, S,
                                             wc, use_alpha=use_alpha)
            mk = PK.mask_bucket(scal, xs_b, xw_b, vw_b, S, wc,
                                use_alpha=use_alpha)
            mp = PK.mask_bucket_plain(scal, xs_b, xw_b, vw_b, S, wc,
                                      use_alpha=use_alpha)
            torch.cuda.synchronize()
            ga_abs, ga_rel = rel_err(ga_k, ga_p, real)
            sm_abs, sm_rel = rel_err(sm_k, sm_p, real)
            mk_abs, mk_rel = rel_err(mk, mp, real)
            print(f"  {lead}bucket {bucket} use_alpha={use_alpha}: fwd gA "
                  f"max abs {ga_abs:.3e} (rel to max {ga_rel:.3e}), fwd sm "
                  f"max abs {sm_abs:.3e} (rel {sm_rel:.3e}); mask sm max abs "
                  f"{mk_abs:.3e} (rel {mk_rel:.3e})", flush=True)
            errs["sph_fwd_kernel"] = max(errs["sph_fwd_kernel"], ga_abs,
                                         sm_abs)
            errs["sph_mask_kernel"] = max(errs["sph_mask_kernel"], mk_abs)
            if not (ga_rel <= GA_RTOL and sm_rel <= SM_RTOL
                    and mk_rel <= SM_RTOL):
                fail(f"kernel vs plain out of tolerance ({lead}bucket "
                     f"{bucket}, use_alpha={use_alpha}): gA {ga_rel:.3e} > "
                     f"{GA_RTOL} or sm {sm_rel:.3e} / {mk_rel:.3e} > "
                     f"{SM_RTOL}")
    return errs


def work(eng, bsz: int, f: int = 16):
    """Bytes and operations the launches of each kernel need for one pass
    over both buckets with a batch of ``bsz``, counted from this run's
    engine: each input read once, each output written once; the geometry's
    operations once per pass and the state's once per sample, counting the
    in-support operations only for pairs within h (what the data needs)."""
    c, m = eng.xs.shape[:2]
    d = eng.xs.shape[-1]
    n_all = n_in = 0
    geo = 0
    for xs_b, xw_b, vw_b, wc in ((eng.blk_xs, eng.blk_xw, eng.blk_vw,
                                  eng.blk_win_cells),
                                 (eng.blk2_xs, eng.blk2_xw, eng.blk2_vw,
                                  eng.blk2_win_cells)):
        _, d2 = PK._pair_d2(xs_b, xw_b)
        n_all += d2.numel()
        n_in += int(((d2 < eng.h * eng.h) & (vw_b[:, None, :] > 0)).sum())
        geo += 4 * (xs_b.numel() + xw_b.numel() + vw_b.numel() + wc.numel())
    rows = c * m
    fwd_bytes = geo + 4 * bsz * (rows * f + rows * d * f + rows)
    mask_bytes = geo + 4 * bsz * (rows + rows)  # alpha channel in, sm out
    bwd_bytes = geo + 4 * (rows + rows * d) + 4 * bsz * (rows * d * f
                                                         + rows * f)
    every = n_all * GEO_EVERY_PAIR
    fwd_core = every + n_in * GEO_FWD_IN_SUPPORT + bsz * rows * SAMPLE_FWD_ROW
    bwd_core = (every + n_in * GEO_BWD_IN_SUPPORT + rows * GEO_BWD_ROW
                + bsz * rows * SAMPLE_BWD_ROW)
    return {"pairs": n_all, "pairs_in_support": n_in,
            # (bytes, CUDA-core operations, tensor-core products) of the
            # route the forward and adjoint kernels take (route_bound)
            "route": {"sph_fwd_kernel": (fwd_bytes, fwd_core,
                                         bsz * n_in * SAMPLE_FWD_IN_SUPPORT),
                      "sph_bwd_kernel": (bwd_bytes, bwd_core,
                                         bsz * n_in * SAMPLE_BWD_IN_SUPPORT)},
            "sph_fwd_kernel": (fwd_bytes, every
                               + n_in * GEO_FWD_IN_SUPPORT
                               + bsz * (n_in * SAMPLE_FWD_IN_SUPPORT
                                        + rows * SAMPLE_FWD_ROW)),
            "sph_mask_kernel": (mask_bytes, every
                                + n_in * GEO_MASK_IN_SUPPORT
                                + bsz * n_in * SAMPLE_MASK_IN_SUPPORT),
            "sph_bwd_kernel": (bwd_bytes, every
                               + n_in * GEO_BWD_IN_SUPPORT
                               + rows * GEO_BWD_ROW
                               + bsz * (n_in * SAMPLE_BWD_IN_SUPPORT
                                        + rows * SAMPLE_BWD_ROW))}


def route_bound(nbytes, core_ops, tc_ops):
    """The least time of a recompute forward or adjoint launch on its route:
    the bytes over HBM bandwidth against the geometry's and the epilogue's
    operations on the fp32 CUDA cores plus the products of the pairs within
    h as 3 TF32 products on the tensor cores (the two times added)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (core_ops / FP32_FLOPS + 3 * tc_ops / TF32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(nbytes, ops, peak=FP32_FLOPS):
    """The least time of a launch: its bytes over HBM bandwidth against its
    operations over ``peak``, the rate of the products' input type (bf16 only
    where both factors of every product are bf16; a bf16 table times a
    float32 state is a float32 product)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_launches() -> None:
    for fn in (*WRAPPERS.values(), MK.fused_update):
        fn.launches = 0


def read_launches() -> dict:
    """Launches by kernel name, the fused variant of 2.8 under FUSED."""
    return {**{name: fn.launches for name, fn in WRAPPERS.items()},
            FUSED: MK.fused_update.launches}


def launched_as(name: str, key: str) -> bool:
    """Whether the profiler record ``key`` is a launch counted under
    ``name``: the fused variant's records read sph_mlp_kernel<K>, 2.8's
    sph_mlp_kernel<T, K>."""
    fused = re.search(r"sph_mlp_kernel<\d", key) is not None
    return fused if name == FUSED else name in key and not fused


def expected_train_launches(steps, n_buckets: int, tables: bool) -> dict:
    """Launches a training run makes for the drawn rollout lengths: each of
    a rollout's n steps runs the forward and the mask pass once, and once
    more when it is recomputed in the backward (``cell_step.REMAT``); the
    backward runs the adjoint for every step but the first (whose input
    state needs no gradient). Each pass launches once per bucket for the
    whole batch. On a table engine (the batched-lane path) the passes are
    the table kernels and each forward of a step launches the update-MLP
    kernel once (its backward is torch.matmul)."""
    runs = 2 if cell_step.REMAT else 1
    fwd = n_buckets * sum(runs * n for n in steps)
    bwd = n_buckets * sum(n - 1 for n in steps)
    if tables:
        return {**NO_LAUNCHES, "sph_fwd_tab_kernel": fwd,
                "sph_mask_tab_kernel": fwd, "sph_bwd_tab_kernel": bwd,
                "sph_mlp_kernel": sum(runs * n for n in steps)}
    return {**NO_LAUNCHES, "sph_fwd_kernel": fwd, "sph_mask_kernel": fwd,
            "sph_bwd_kernel": bwd}


def make_trainer(eng, x2):
    """The port's Trainer at the train CLI's defaults on ``eng``, at full
    depth from the first iteration, with a pool of 16 states on the host
    (which changes no step)."""
    from sph_nca_tpu_torch.models.nca import SPHNCAConfig
    from sph_nca_tpu_torch.training.losses import MSELossConfig
    from sph_nca_tpu_torch.training.pool import Pool
    from sph_nca_tpu_torch.training.trainer import (
        TrainConfig,
        Trainer,
        make_mse_bundle,
    )
    from sph_nca_tpu_torch.utils.image import flat_color_target

    h = TRAIN_H
    cfg = SPHNCAConfig(channels=16, hidden=256, fire_rate=0.5,
                       normalize_perception=1.0 / h)
    img = torch.from_numpy(flat_color_target(64)).to(eng.device)
    loss = make_mse_bundle(img, MSELossConfig(
        gmin=(-1.0, -1.0), gsize=(2.0, 2.0), image_scale=64 / IMAGE))
    trainer = Trainer(cfg, TrainConfig(pool_size=16, steps_increment=0,
                                       seed=SEED), eng, x2, loss, h)
    seed_A = plane_seed(x2, 16, gmin=(-1.0, -1.0), gsize=(2.0, 2.0),
                        radius=h)
    pool = Pool(x2.numpy(), seed_A.numpy(), 16,
                rng=np.random.default_rng(SEED))
    return trainer, pool


def run_train_cli(out_dir: str, extra, engine: str = "cells") -> list:
    """The train CLI at its defaults on the card with ``--engine engine``;
    returns its per-iteration metrics rows."""
    rc = cli_train.main(["--device", "cuda", "--seed", str(SEED),
                         "--log_every", "10", "--output_dir", out_dir,
                         "--engine", engine] + list(extra))
    torch.cuda.synchronize()
    if rc != 0:
        fail(f"train CLI returned {rc}")
    (metrics,) = glob.glob(os.path.join(out_dir, "metrics-*.jsonl"))
    with open(metrics) as f:
        return [json.loads(line) for line in f]


def device_breakdown(prof, wall_us: float, per: float, unit: str) -> None:
    """Print device time by kernel from a profiler run, per ``unit`` (the
    12 largest and every kernel of the port), and the device's busy share of
    the traced wall time (the profiler's own overhead included)."""
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and ev.device_type != torch.autograd.DeviceType.CPU:
            rows.append((dev_us, ev.count, ev.key))
    if not rows:
        print("  profile: no device time recorded", flush=True)
        return
    total = sum(r[0] for r in rows)
    for i, (dev_us, count, key) in enumerate(sorted(rows, reverse=True)):
        if i >= 12 and "sph_" not in key:
            continue
        print(f"  {dev_us / per:9.2f} us/{unit} {100 * dev_us / total:5.1f}% "
              f"{count / per:6.1f} launches/{unit}  {key[:70]}", flush=True)
    print(f"  device busy {total / per:.2f} us/{unit} of {wall_us / per:.2f}"
          f" us/{unit} traced wall ({100 * total / wall_us:.1f}% busy), "
          f"{sum(r[1] for r in rows) / per:.1f} kernels/{unit}", flush=True)


def profile_steps(model, eng, S0, h, steps: int = 16) -> None:
    """Device time per inference rollout step by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=eng.device).manual_seed(SEED)
    with torch.no_grad():
        rollout_cells(model.params, model.cfg, eng, S0, gen, 4, h)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.time()
            rollout_cells(model.params, model.cfg, eng, S0, gen, steps, h)
            torch.cuda.synchronize()
            wall_us = (time.time() - t1) * 1e6
    device_breakdown(prof, wall_us, steps, "step")


def profile_train(teng, x2) -> None:
    """Device time by kernel for one full-depth training iteration at the
    train CLI's defaults on ``teng``, per BPTT step, and the device's busy
    share."""
    from torch.profiler import ProfilerActivity, profile

    trainer, pool = make_trainer(teng, x2)
    trainer.run_iteration(0, pool)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.time()
        trainer.run_iteration(1, pool)
        torch.cuda.synchronize()
        wall_us = (time.time() - t1) * 1e6
    print(f"  one iteration of {trainer.last_steps} BPTT steps, "
          f"B={trainer.cfg.batch_size}, "
          f"{'pair tables' if teng.blk_md is not None else 'recompute'}",
          flush=True)
    device_breakdown(prof, wall_us, trainer.last_steps, "BPTT step")


def train_turns(teng, x, x2, dev, rounds: int = 2) -> dict:
    """ms per BPTT step of full-depth Trainer iterations on the two
    training paths in turns (ABBA, ``rounds`` times): the batched path on
    float32 pair tables and the recompute path on ``teng`` (no tables). Both
    trainers draw the same rollout lengths."""
    tab_eng = build_cell_engine(x, TRAIN_H, pair_tables="float32",
                                device=dev)
    runs = {"batched": make_trainer(tab_eng, x2),
            "recompute": make_trainer(teng, x2)}
    out = {label: [] for label in runs}
    for label, (trainer, pool) in runs.items():  # warm-up
        trainer.run_iteration(0, pool)
    torch.cuda.synchronize()
    order = []
    for _ in range(rounds):
        order += ["batched", "recompute", "recompute", "batched"]
    for i, label in enumerate(order):
        trainer, pool = runs[label]
        t1 = time.time()
        loss = trainer.run_iteration(1 + i, pool)
        torch.cuda.synchronize()
        if not np.isfinite(loss):
            fail(f"{label} path: loss not finite in the turns")
        out[label].append((time.time() - t1) * 1e3 / trainer.last_steps)
    return out


def tab_buckets(eng):
    """Per window-size bucket of a table engine: (first block, end block,
    win_cells, vw, md, w6)."""
    nb1 = eng.blk_xs.shape[0]
    nb = nb1 + eng.blk2_xs.shape[0]
    return ((0, nb1, eng.blk_win_cells, eng.blk_vw, eng.blk_md, eng.blk_w6),
            (nb1, nb, eng.blk2_win_cells, eng.blk2_vw, eng.blk2_md,
             eng.blk2_w6))


def tab_stats(eng) -> dict:
    """Sizes of a table engine: pairs (every table entry of a real or pad
    row), pairs within h (real rows, v_w > 0, d2 < h^2, i.e. w6 > 0),
    table bytes."""
    stats = {"pairs": 0, "within_h": 0, "bytes": 0, "buckets": []}
    for lo, hi, _, vw, md, w6 in tab_buckets(eng):
        stats["pairs"] += w6.numel()
        stats["within_h"] += int(((w6 > 0) & (vw[:, None, :] > 0)).sum())
        if md is not None:  # a w6-only engine has no md
            stats["bytes"] += md.numel() * md.element_size()
        stats["bytes"] += w6.numel() * w6.element_size()
        stats["buckets"].append((hi - lo, w6.shape[2]))
    return stats


# Operations of the table kernels (D = 3, F = 16, the blur's F = 4), for what
# the data needs: per pair within h, per window slot and per row, each per
# sample (the tables hold every pair weight, so nothing is shared but reads).
TAB_OPS = {
    # mom (D * 2F) and sm (2) a pair; v S (F) and the column (2) a slot;
    # sig_g mom - S_b gsum (3 a value) a row
    "sph_fwd_tab_kernel": (3 * 2 * 16 + 2, 16 + 2, 3 * 16 * 3),
    # the D products (D * 2F) a pair; -sig_g v acc - gsum . gbar a row
    "sph_bwd_tab_kernel": (3 * 2 * 16, 0, 16 * (2 + 2 * 3) + 1),
    # w6 . column (2) a pair; the column (1, use_alpha off) a slot
    "sph_mask_tab_kernel": (2, 1, 0),
    # w6 @ (v X) (2F) a pair; v X (F) a slot; sig_W (F) a row
    "sph_blur_tab_kernel": (2 * 4, 4, 4),
}


def work_tab(eng, bsz: int, f: int = 16, fx: int = 4,
             use_alpha: bool = False) -> dict:
    """Bytes and operations of one pass of each table kernel over both
    buckets (the blur over F = 4), batch ``bsz``: each input read once (the
    tables once, in their stored type, shared by the samples), each output
    written once. ``use_alpha`` adds the alive test, one compare a window
    slot, to the forward and the mask."""
    c, m, d = eng.xs.shape
    rows = c * m
    st = tab_stats(eng)
    md_b = sum(md.numel() * md.element_size()
               for *_, md, _ in tab_buckets(eng))
    w6_b = st["bytes"] - md_b
    slots = sum(vw.numel() for _, _, _, vw, _, _ in tab_buckets(eng))
    win_b = sum(4 * wc.numel() for _, _, wc, *_ in tab_buckets(eng))
    vw_b = 4 * slots
    nbytes = {
        "sph_fwd_tab_kernel": md_b + w6_b + vw_b + win_b + 4 * rows * d
        + 4 * bsz * (rows * f + rows * d * f + rows),
        "sph_bwd_tab_kernel": md_b + win_b + 4 * rows * (1 + d)
        + 4 * bsz * (rows * d * f + rows * f),
        "sph_mask_tab_kernel": w6_b + vw_b + 4 * bsz * rows,
        "sph_blur_tab_kernel": w6_b + vw_b + win_b
        + 4 * bsz * (rows * fx + rows * fx),
    }
    out = {}
    for name, (per_pair, per_slot, per_row) in TAB_OPS.items():
        if use_alpha and name in ("sph_fwd_tab_kernel",
                                  "sph_mask_tab_kernel"):
            per_slot += 1
        ops = bsz * (st["within_h"] * per_pair + slots * per_slot
                     + rows * per_row)
        out[name] = (nbytes[name], ops)
    return out


def tab_calls(eng, S, G, X, plain: bool, use_alpha: bool) -> dict:
    """Per table kernel, a closure running it (or its plain version) over
    both buckets of ``eng`` on S [..., C, M, 16], G [..., C, M, D*16] and
    X [..., C, M, 4] (at most one leading batch axis)."""
    d = eng.xs.shape[-1]
    scal = PK.scal_vec(eng)
    vs, gs = eng.vs.reshape(-1, 64), eng.gsum.reshape(-1, 64, d)
    srows = S.reshape(*S.shape[:-3], -1, 64, 16)
    grows = G.reshape(*G.shape[:-3], -1, 64, d * 16)
    bks = tab_buckets(eng)
    fwd = PK.fwd_tab_bucket_plain if plain else PK.fwd_tab_bucket
    bwd = PK.bwd_tab_bucket_plain if plain else PK.bwd_tab_bucket
    msk = PK.mask_tab_bucket_plain if plain else PK.mask_tab_bucket
    blr = PK.blur_bucket_plain if plain else PK.blur_bucket
    return {
        "sph_fwd_tab_kernel": lambda: [
            fwd(scal, srows[..., lo:hi, :, :], gs[lo:hi], vw, S, wc, md, w6,
                use_alpha=use_alpha) for lo, hi, wc, vw, md, w6 in bks],
        "sph_bwd_tab_kernel": lambda: [
            bwd(scal, vs[lo:hi], gs[lo:hi], grows[..., lo:hi, :, :], G, wc,
                md) for lo, hi, wc, vw, md, w6 in bks],
        "sph_mask_tab_kernel": lambda: [
            msk(scal, vw, S, wc, w6, use_alpha=use_alpha)
            for lo, hi, wc, vw, md, w6 in bks],
        "sph_blur_tab_kernel": lambda: [
            blr(scal, vw, X, wc, w6) for lo, hi, wc, vw, md, w6 in bks],
    }


def tab_gap(got, want):
    """(max abs, max rel to the plain output's max |value|) between the
    outputs of a ``tab_calls`` closure and of its plain version."""
    flat = [(k, q) for kk, pp in zip(got, want)
            for k, q in (zip(kk, pp) if isinstance(kk, tuple)
                         else [(kk, pp)])]
    return (max(float((k - q).abs().max()) for k, q in flat),
            max(float((k - q).abs().max()) / max(float(q.abs().max()), 1e-30)
                for k, q in flat))


def mlp_inputs(dev, dtype, k: int, lead, seed: int, hid: int = 256):
    """Random inputs of the update MLP at a path's shapes: S [*lead, 16],
    ga [*lead, 48] of which the MLP reads the first 32 features (the
    perception's layout), w1k [48, hid], b1, w2 [hid, k], b2; weights at the
    scale of torch.nn.Linear's init."""
    g = torch.Generator(device=dev).manual_seed(seed)
    S = torch.randn(*lead, 16, generator=g, device=dev)
    ga = torch.randn(*lead, 48, generator=g, device=dev)
    w1k = torch.randn(48, hid, generator=g, device=dev) * 48 ** -0.5
    b1 = torch.randn(hid, generator=g, device=dev) * 0.1
    w2 = torch.randn(hid, k, generator=g, device=dev) * hid ** -0.5
    b2 = torch.randn(k, generator=g, device=dev) * 0.1
    if dtype != torch.float32:
        S, ga, w1k, w2 = (t.to(dtype) for t in (S, ga, w1k, w2))
    return [S, ga[..., :32], w1k, b1, w2, b2]


def work_mlp(n: int, hid: int, k: int, in_bytes: int):
    """Bytes and operations of one update-MLP launch over n items: each
    input read once (S, the 32 perception features the MLP reads, the
    weights, the biases), each output written once; a multiply-add is two
    operations (the function's, before the route's: 3xTF32 triples them)."""
    out_per_item = 2 * 16 + 1 if k == 2 * 16 + 1 else 16
    nbytes = (n * (16 + 32) * in_bytes + (48 * hid + hid * k) * in_bytes
              + 4 * (hid + k) + 4 * n * out_per_item)
    return nbytes, n * 2 * (48 * hid + hid * k)


def normal_cuda(rng, shape, dev):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)


def check_tab_kernels(eng, rng, dev, sizes=(1, SURF_B)) -> dict:
    """Each table kernel against its plain version on ``eng``: fwd, bwd,
    mask and blur (F = 4) at each B in ``sizes`` (1 and larger), the mask
    and the blur also at MASK_RAGGED_B, use_alpha on and off; each output
    within TAB_RTOL of the plain version's largest |value| over all rows;
    one launch of B > 1 samples equal to B launches of one; pad rows exactly
    0. Returns the largest absolute error per kernel."""
    c, m, d = eng.xs.shape
    scal = PK.scal_vec(eng)
    real = (eng.vs > 0).reshape(-1, 64)
    vs, gs = eng.vs.reshape(-1, 64), eng.gsum.reshape(-1, 64, d)
    big = max(sizes)
    SB = normal_cuda(rng, (big, c, m, 16), dev)
    GB = normal_cuda(rng, (big, c, m, d * 16), dev)
    X = normal_cuda(rng, (c, m, 4), dev)
    XB = normal_cuda(rng, (max(big, *MASK_RAGGED_B), c, m, 4), dev)
    errs = dict.fromkeys(TAB_KERNELS, 0.0)
    worst = dict.fromkeys(TAB_KERNELS, 0.0)  # relative to max |plain|

    def hold(name, got, want, rr):
        err = float((got - want).abs().max())
        rel = err / max(float(want.abs().max()), 1e-30)
        errs[name] = max(errs[name], err)
        worst[name] = max(worst[name], rel)
        if not rel <= TAB_RTOL:
            fail(f"{name} vs plain: {rel:.3e} > {TAB_RTOL} of max")
        pad = (got[..., ~rr] if tuple(got.shape[-2:]) == tuple(rr.shape)
               else got[..., ~rr, :])
        if not bool((pad == 0).all()):
            fail(f"{name}: nonzero output on pad rows")

    same = True
    for lo, hi, wc, vw, md, w6 in tab_buckets(eng):
        if hi == lo:  # an empty window-size bucket launches nothing
            continue
        rr = real[lo:hi]
        for bsz in sizes:
            S, G = SB[:bsz], GB[:bsz]
            ab = S.reshape(bsz, -1, 64, 16)[:, lo:hi]
            gb = G.reshape(bsz, -1, 64, d * 16)[:, lo:hi]
            for use_alpha in (False, True):
                args = (scal, ab, gs[lo:hi], vw, S, wc, md, w6)
                ga_k, sm_k = PK.fwd_tab_bucket(*args, use_alpha=use_alpha)
                ga_p, sm_p = PK.fwd_tab_bucket_plain(*args,
                                                     use_alpha=use_alpha)
                margs = (scal, vw, S, wc, w6)
                mk = PK.mask_tab_bucket(*margs, use_alpha=use_alpha)
                mp = PK.mask_tab_bucket_plain(*margs, use_alpha=use_alpha)
                torch.cuda.synchronize()
                hold("sph_fwd_tab_kernel", ga_k, ga_p, rr)
                hold("sph_fwd_tab_kernel", sm_k, sm_p, rr)
                hold("sph_mask_tab_kernel", mk, mp, rr)
            bargs = (scal, vs[lo:hi], gs[lo:hi], gb, G, wc, md)
            dk = PK.bwd_tab_bucket(*bargs)
            hold("sph_bwd_tab_kernel", dk, PK.bwd_tab_bucket_plain(*bargs),
                 rr)
            if bsz == 1:
                xk = PK.blur_bucket(scal, vw, X, wc, w6)
                hold("sph_blur_tab_kernel", xk,
                     PK.blur_bucket_plain(scal, vw, X, wc, w6), rr)
                continue
            xk = PK.blur_bucket(scal, vw, XB[:bsz], wc, w6)
            hold("sph_blur_tab_kernel", xk,
                 PK.blur_bucket_plain(scal, vw, XB[:bsz], wc, w6), rr)
            for b in range(bsz):
                same &= bool(torch.equal(xk[b], PK.blur_bucket(
                    scal, vw, XB[b], wc, w6)))
            ga_k, sm_k = PK.fwd_tab_bucket(scal, ab, gs[lo:hi], vw, S, wc,
                                           md, w6, use_alpha=False)
            mk = PK.mask_tab_bucket(scal, vw, S, wc, w6, use_alpha=False)
            for b in range(bsz):
                ga1, sm1 = PK.fwd_tab_bucket(scal, ab[b], gs[lo:hi], vw,
                                             S[b], wc, md, w6,
                                             use_alpha=False)
                mk1 = PK.mask_tab_bucket(scal, vw, S[b], wc, w6,
                                         use_alpha=False)
                dk1 = PK.bwd_tab_bucket(scal, vs[lo:hi], gs[lo:hi], gb[b],
                                        G[b], wc, md)
                same &= bool(torch.equal(ga1, ga_k[b])
                             and torch.equal(sm1, sm_k[b])
                             and torch.equal(mk1, mk[b])
                             and torch.equal(dk1, dk[b]))
    if not same:
        fail(f"a B = {big} table launch differs from B = 1 launches")
    # the mask's and the blur's other sample tiles: a ragged tile, full
    # tiles and a ragged one
    SM = normal_cuda(rng, (max(MASK_RAGGED_B), c, m, 16), dev)
    for lo, hi, wc, vw, _, w6 in tab_buckets(eng):
        if hi == lo:
            continue
        for bsz in MASK_RAGGED_B:
            for use_alpha in (False, True):
                margs = (scal, vw, SM[:bsz], wc, w6)
                mk = PK.mask_tab_bucket(*margs, use_alpha=use_alpha)
                hold("sph_mask_tab_kernel", mk,
                     PK.mask_tab_bucket_plain(*margs, use_alpha=use_alpha),
                     real[lo:hi])
                for b in range(bsz):
                    same &= bool(torch.equal(mk[b], PK.mask_tab_bucket(
                        scal, vw, SM[b], wc, w6, use_alpha=use_alpha)))
            xk = PK.blur_bucket(scal, vw, XB[:bsz], wc, w6)
            hold("sph_blur_tab_kernel", xk,
                 PK.blur_bucket_plain(scal, vw, XB[:bsz], wc, w6),
                 real[lo:hi])
            for b in range(bsz):
                same &= bool(torch.equal(xk[b], PK.blur_bucket(
                    scal, vw, XB[b], wc, w6)))
    if not same:
        fail(f"a B in {MASK_RAGGED_B} mask or blur launch differs from B = "
             "1 launches")
    const_field(eng, dev)
    print("  " + ", ".join(f"{n} max abs {errs[n]:.3e} (rel to max "
                           f"{worst[n]:.3e})" for n in TAB_KERNELS)
          + f"; B = {big} launch == {big} B = 1 launches (the mask "
          f"and the blur also at B = "
          f"{' and '.join(map(str, MASK_RAGGED_B))}): {same}; pad rows "
          "exactly 0", flush=True)
    return errs


def const_field(eng, dev) -> None:
    """A constant state (1.7 in every channel) through the forward kernel of
    ``eng``: |gA| must stay below CONST_ATOL. On a table engine the gsum of
    the quantized table cancels it (sph_fwd_tab_kernel); on an engine
    without tables the rowsum of the A tile the kernel computes
    (sph_fwd_kernel)."""
    S = eng.scatter(torch.full((eng.num_particles, 16), 1.7, device=dev))
    got = {}
    for use_kernels in (True, False):
        ga, _ = PK.fused_perception(eng, S, d_major=True,
                                    use_kernels=use_kernels)
        got[use_kernels] = float(eng.gather_back(ga).abs().max())
    if eng.blk_md is not None:
        what = f"{str(eng.blk_md.dtype)[6:]} tables"
        name = "sph_fwd_tab_kernel"
    else:
        what, name = "no tables", "sph_fwd_kernel"
    print(f"  constant field ({what}): max |gA| {got[True]:.3e} with "
          f"{name}, {got[False]:.3e} plain (bound {CONST_ATOL})", flush=True)
    if not got[True] < CONST_ATOL:
        fail(f"a constant field leaves |gA| = {got[True]:.3e} >= {CONST_ATOL}"
             f" through {name}")


def surface_rollout(params, cfg, eng, A0, nrm, t0, steps, h, *,
                    use_kernels=True, collect_all=False):
    gen = torch.Generator(device=eng.device).manual_seed(SEED)
    return rollout_mesh_cells(params, cfg, eng, A0, nrm, t0, gen, steps, h,
                              fire_rate=cfg.fire_rate, use_kernels=use_kernels,
                              collect_all=collect_all)


def surface_phases(dev, rng, smi: str):
    """The surface phases: the stripes surface engine with pair tables, each
    table kernel against its plain version, the surface path (launch counts
    reset just before it and read just after), its gradient, and the table
    kernels' times. Returns the table kernels' rows of the kernels line and
    the scene (model, config, engines by table dtype, points, normals, seed
    state) for the batched surface phases."""
    # ---- tables: the surface engine, each table kernel vs plain -------
    t0 = time.time()
    stripes = load_weights_json(STRIPES, device=dev)
    sh = stripes.h
    # texture mode, as the JAX test CLI derives it: no alpha, fire_rate 0.5
    scfg = dataclasses.replace(stripes.cfg, use_alpha=False, fire_rate=0.5)
    xs_np = fibonacci_sphere(SURF_N, SURF_RADIUS)
    xsph = torch.from_numpy(xs_np).to(dev)
    nsph = torch.from_numpy(sphere_normals(xs_np)).to(dev)
    seng, tab_errs = {}, dict.fromkeys(TAB_KERNELS, 0.0)
    for dt in ("bfloat16", "float32"):
        t1 = time.time()
        seng[dt] = build_cell_engine(xs_np, sh, pair_tables=dt, device=dev)
        torch.cuda.synchronize()
        secs = time.time() - t1
        st = tab_stats(seng[dt])
        if len(st["buckets"]) != 2 or min(nb for nb, _ in st["buckets"]) == 0:
            fail(f"expected two non-empty buckets, got {st['buckets']}")
        print(f"  {dt} tables: C={seng[dt].num_cells} M="
              f"{seng[dt].slots_per_cell}, blocks x W "
              + " + ".join(f"{nb} x {w}" for nb, w in st["buckets"])
              + f", {st['pairs']} pairs, {st['within_h']} within h, tables "
              f"{st['bytes'] / 1e6:.1f} MB, built in {secs:.2f} s (host "
              "numpy + device cast)", flush=True)
        for name, err in check_tab_kernels(seng[dt], rng, dev).items():
            tab_errs[name] = max(tab_errs[name], err)
    eng_s = seng["bfloat16"]  # the surface path's engine
    phase("tables", t0, f"stripes sphere N={SURF_N} h={sh}: each table kernel "
          f"== plain within {TAB_RTOL} of max in bfloat16 and float32, B = 1 "
          f"and B = {SURF_B}; pad rows 0")

    # ---- the surface path ---------------------------------------------
    t0 = time.time()
    A0s, t0s = surface_radial_seed(xsph, nsph, scfg.channels, SURF_SEEDS, sh,
                                   torch.Generator().manual_seed(SEED))
    reset_launches()
    t1 = time.time()
    with torch.no_grad():
        fA, ft, sstates = surface_rollout(stripes.params, scfg, eng_s, A0s,
                                          nsph, t0s, SURF_STEPS, sh,
                                          collect_all=True)
    torch.cuda.synchronize()
    surf_secs = time.time() - t1
    surf_launches = read_launches()
    want = 2 * SURF_STEPS
    if surf_launches != {**NO_LAUNCHES, "sph_fwd_tab_kernel": want,
                         "sph_mask_tab_kernel": want,
                         "sph_blur_tab_kernel": want}:
        fail(f"surface launch counts {surf_launches}, expected {want} for "
             "the table forward, mask and blur kernels, 0 for the others")
    if sstates.shape != (SURF_STEPS + 1, SURF_N, scfg.channels):
        fail(f"surface trajectory shape {tuple(sstates.shape)}")
    if not (bool(torch.isfinite(sstates).all())
            and bool(torch.isfinite(ft).all())):
        fail("non-finite states or tangents in the surface rollout")
    tnorm = float(ft.norm(dim=-1).max())
    if not tnorm <= 1.0 + 1e-5:
        fail(f"tangent norm {tnorm} > 1 + 1e-5")
    share = {k: float((sstates[k].abs().amax(-1) > 0).float().mean())
             for k in (0, SURF_STEPS // 2, SURF_STEPS)}
    k0, k1, k2 = share
    if not share[k0] < share[k1] <= share[k2]:
        fail(f"the texture did not spread: {share}")
    print(f"  launches {surf_launches}", flush=True)
    phase("surface", t0, f"stripes, {SURF_N} points, {SURF_SEEDS} seeds, "
          f"{SURF_STEPS} steps at fire_rate {scfg.fire_rate} in "
          f"{surf_secs:.2f} s (collecting every state): finite, max tangent "
          f"norm {tnorm:.7f}; share of points whose state left 0 at steps "
          + ", ".join(f"{k}: {v:.4f}" for k, v in share.items()))

    t0 = time.time()
    cfg1s = dataclasses.replace(scfg, fire_rate=1.0)
    sdiff = {}
    with torch.no_grad():
        for dt, e in seng.items():
            outs = [surface_rollout(stripes.params, cfg1s, e, A0s, nsph, t0s,
                                    CHECK_STEPS, sh, use_kernels=uk)
                    for uk in (True, False)]
            sdiff[dt] = max(float((a - b).abs().max())
                            for a, b in zip(outs[0][:2], outs[1][:2]))
    phase("surface-check", t0, f"{CHECK_STEPS} steps at fire_rate 1.0, "
          "kernels vs plain versions, max difference of states and tangents: "
          + ", ".join(f"{dt} {v:.3e}" for dt, v in sdiff.items())
          + f" (limit {ROLLOUT_ATOL})")
    if not all(v <= ROLLOUT_ATOL for v in sdiff.values()):
        fail(f"surface rollout kernels vs plain: {sdiff}")

    # ---- the gradient of a surface rollout through the table kernels ---
    t0 = time.time()
    R = normal_cuda(rng, (SURF_N, scfg.channels), dev)
    sgrads = {}
    for uk in (True, False):
        reset_launches()
        params = type(stripes.params)(*(q.detach().clone().requires_grad_(True)
                                        for q in stripes.params))
        A = A0s.clone().requires_grad_(True)
        fA_g, _, _ = surface_rollout(params, scfg, eng_s, A, nsph, t0s,
                                     SURF_GRAD_STEPS, sh, use_kernels=uk)
        (fA_g * R).sum().backward()
        torch.cuda.synchronize()
        if uk:
            grad_launches = read_launches()
        sgrads[uk] = [A.grad] + [q.grad for q in params]
    g_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(sgrads[True], sgrads[False]))
    g_abs = max(float((a - b).abs().max())
                for a, b in zip(sgrads[True], sgrads[False]))
    want_g = 2 * SURF_GRAD_STEPS
    phase("surface-grad", t0, f"d(loss)/d(A0, MLP parameters) of a "
          f"{SURF_GRAD_STEPS}-step surface rollout, table kernels vs plain "
          f"versions: max abs {g_abs:.3e}, rel to max {g_rel:.3e} (limit "
          f"{DA_RTOL}); launches {grad_launches}")
    if not g_rel <= DA_RTOL:
        fail(f"surface gradient through the kernels departs: {g_rel:.3e}")
    if grad_launches["sph_bwd_tab_kernel"] != want_g:
        fail(f"table adjoint launches {grad_launches}, expected {want_g}")
    del sgrads, sstates, R

    # ---- the table kernels' times --------------------------------------
    t0 = time.time()
    # the table kernels at the surface path's shapes (bfloat16, B = 1,
    # use_alpha off, the diffusion blur's F = 4)
    c_s, m_s, d_s = eng_s.xs.shape
    S1 = normal_cuda(rng, (c_s, m_s, 16), dev)
    G1 = normal_cuda(rng, (c_s, m_s, d_s * 16), dev)
    X1 = normal_cuda(rng, (c_s, m_s, 4), dev)

    # the yardstick: one torch.bmm of the f32 tables against a right-hand
    # side of the kernel's width, per bucket (timed here, used nowhere)
    lib_args = {name: [] for name in TAB_KERNELS}
    for lo, hi, _, _, md, w6 in tab_buckets(seng["float32"]):
        nb, w = w6.shape[0], w6.shape[2]
        lib_args["sph_fwd_tab_kernel"].append(
            (md, normal_cuda(rng, (nb, w, 16), dev)))
        lib_args["sph_bwd_tab_kernel"].append(
            (md, normal_cuda(rng, (nb, w, 16), dev)))
        lib_args["sph_mask_tab_kernel"].append(
            (w6, normal_cuda(rng, (nb, w, 1), dev)))
        lib_args["sph_blur_tab_kernel"].append(
            (w6, normal_cuda(rng, (nb, w, 4), dev)))
    kcalls = tab_calls(eng_s, S1, G1, X1, plain=False, use_alpha=False)
    pcalls = tab_calls(eng_s, S1, G1, X1, plain=True, use_alpha=False)
    sneed = work_tab(eng_s, 1)
    rows = []
    for name, replaces in (
        ("sph_fwd_tab_kernel", "sph_nca_tpu/ops/pallas/pair_kernel.py:134"),
        ("sph_bwd_tab_kernel", "sph_nca_tpu/ops/pallas/pair_kernel.py:208"),
        ("sph_mask_tab_kernel", "sph_nca_tpu/ops/pallas/pair_kernel.py:270"),
        ("sph_blur_tab_kernel", "sph_nca_tpu/ops/pallas/pair_kernel.py:249"),
    ):
        ms, plain_ms = device_ms(kcalls[name], name), device_ms(pcalls[name])
        lib_ms = device_ms(lambda args=lib_args[name]: [
            torch.bmm(a, b) for a, b in args])
        nbytes, ops = sneed[name]
        bound_ms, bound_by = bound(nbytes, ops)
        # the adjoint runs on no inference path: its launches are those of
        # the surface-grad phase's backward
        launches = (grad_launches[name] if name == "sph_bwd_tab_kernel"
                    else surf_launches[name])
        before = (f"; first design, recorded: {BLUR_RECORDED_MS:.4f} ms"
                  if name == "sph_blur_tab_kernel" else "")
        print(f"  {name} at the surface path's shapes (bfloat16 tables, "
              f"B=1, both buckets): {ms:.4f} ms device time "
              f"({cuda_ms(kcalls[name]):.4f} ms by CUDA events), plain "
              f"{plain_ms:.4f} ms, torch.bmm on f32 tables {lib_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB,"
              f" {ops / 1e9:.3f} G operations{before})", flush=True)
        rows.append({
            "name": name, "route": "cuda",
            "source": "sph_nca_tpu_torch/csrc/table_kernels.cu",
            "replaces": replaces,
            "shapes": f"surface stripes sphere N={SURF_N} h={sh} bfloat16 "
                      "tables B=1",
            "launches": launches,
            "launches_path": ("surface-grad" if name == "sph_bwd_tab_kernel"
                              else "surface"),
            "max_abs_err": tab_errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        })
    # the blur at B = SURF_B on the same engine: one launch a bucket for the
    # batch (tiles of 4 samples), beside one torch.bmm a bucket of the f32
    # tables with the batch's right-hand side
    name = "sph_blur_tab_kernel"
    XB = normal_cuda(rng, (SURF_B, c_s, m_s, 4), dev)
    kb = tab_calls(eng_s, S1, G1, XB, plain=False, use_alpha=False)[name]
    pb = tab_calls(eng_s, S1, G1, XB, plain=True, use_alpha=False)[name]
    b_ms, b_plain = device_ms(kb, name), device_ms(pb)
    blib = [(w6, normal_cuda(rng, (w6.shape[0], w6.shape[2], 4 * SURF_B),
                             dev))
            for *_, w6 in tab_buckets(seng["float32"])]
    b_lib = device_ms(lambda: [torch.bmm(a, b) for a, b in blib])
    nbytes, ops = work_tab(eng_s, SURF_B)[name]
    b_bound, b_by = bound(nbytes, ops)
    brow = next(r for r in rows if r["name"] == name)
    b1_ms = brow["ms"]
    print(f"  {name} at the surface path's shapes with B={SURF_B} (bfloat16 "
          f"tables, both buckets): {b_ms:.4f} ms device time, "
          f"{b_ms / b1_ms:.2f}x its B=1 time {b1_ms:.4f} ms; plain "
          f"{b_plain:.4f} ms, torch.bmm on f32 tables {b_lib:.4f} ms, bound "
          f"{b_bound:.4f} ms by {b_by} ({nbytes / 1e6:.2f} MB, "
          f"{ops / 1e9:.3f} G operations); first design, recorded at B=1: "
          f"{BLUR_RECORDED_MS:.4f} ms", flush=True)
    brow["batch"] = {
        "shapes": f"surface stripes sphere N={SURF_N} h={sh} bfloat16 "
                  f"tables B={SURF_B}",
        "ms": b_ms, "plain_ms": b_plain, "bound_ms": b_bound,
        "bound_by": b_by, "library_ms": b_lib, "ms_over_b1": b_ms / b1_ms}
    del XB, kb, pb, blib
    surf_ms = {}
    with torch.no_grad():
        for uk in (True, False):
            surface_rollout(stripes.params, scfg, eng_s, A0s, nsph, t0s, 4, sh,
                            use_kernels=uk)  # warm-up
            torch.cuda.synchronize()
            t1 = time.time()
            surface_rollout(stripes.params, scfg, eng_s, A0s, nsph, t0s,
                            SURF_STEPS, sh, use_kernels=uk)
            torch.cuda.synchronize()
            surf_ms[uk] = (time.time() - t1) * 1e3 / SURF_STEPS

    if "--profile" in sys.argv[1:]:
        tp = time.time()
        from torch.profiler import ProfilerActivity, profile

        with torch.no_grad():
            surface_rollout(stripes.params, scfg, eng_s, A0s, nsph, t0s, 4, sh)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t1 = time.time()
                surface_rollout(stripes.params, scfg, eng_s, A0s, nsph, t0s,
                                16, sh)
                torch.cuda.synchronize()
                wall_us = (time.time() - t1) * 1e6
        device_breakdown(prof, wall_us, 16, "step")
        phase("profile-surface", tp, "torch.profiler, 16 surface steps at "
              "fire_rate 0.5")

    phase("surface-times", t0, f"surface rollout step {surf_ms[True]:.4f} ms "
          f"with the kernels, {surf_ms[False]:.4f} ms with the plain versions "
          f"({SURF_STEPS} steps, no states collected, host clock around "
          f"synchronize); kernel times: device time from torch.profiler "
          f"kernel records, median of 3 profiles of 20 calls, L2-warm | "
          f"{smi}")
    return rows, (stripes, scfg, seng, xsph, nsph, A0s)


def write_mesh_obj(path: str, nu: int = 160, nv: int = 80) -> str:
    """A bumpy ellipsoid as an OBJ: bands of quads (``v/vt/vn`` entries),
    triangle fans at the poles; 12,642 vertices, 25,280 triangles."""
    verts = [(0.0, 1.0, 0.0), (0.0, -1.0, 0.0)]
    for j in range(1, nv):
        th = np.pi * j / nv
        for i in range(nu):
            ph = 2 * np.pi * i / nu
            r = 1.0 + 0.12 * np.sin(3 * th) * np.cos(2 * ph)
            verts.append((1.2 * r * np.sin(th) * np.cos(ph), r * np.cos(th),
                          0.9 * r * np.sin(th) * np.sin(ph)))
    lines = [f"v {a:.6f} {b:.6f} {c:.6f}" for a, b, c in verts]
    lines += ["vt 0 0", "vn 0 1 0"]

    def ring(j, i):  # 1-based vertex index of band j, column i
        return 3 + j * nu + i % nu

    for j in range(nv - 2):
        for i in range(nu):
            lines.append("f " + " ".join(f"{k}/1/1" for k in (
                ring(j, i), ring(j, i + 1), ring(j + 1, i + 1),
                ring(j + 1, i))))
    for i in range(nu):
        lines.append(f"f 1 {ring(0, i + 1)} {ring(0, i)}")
        lines.append(f"f 2 {ring(nv - 2, i)} {ring(nv - 2, i + 1)}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def tab_launches(eng, steps: int, extra_blur: int = 0) -> dict:
    """Launch counts of ``steps`` batched surface steps on ``eng``: the
    forward, the mask and the diffusion blur once per window-size bucket a
    step (every diffusion engine here has two buckets, as ``eng``), the
    update MLP once a step; ``extra_blur`` blur launches besides (the random
    seed's pre-diffusion)."""
    nbk = sum(1 for nb, _ in tab_stats(eng)["buckets"] if nb > 0)
    return {**NO_LAUNCHES, "sph_fwd_tab_kernel": nbk * steps,
            "sph_mask_tab_kernel": nbk * steps,
            "sph_blur_tab_kernel": nbk * steps + extra_blur,
            "sph_mlp_kernel": steps}


def busy_share(fn, steps: int, attempts: int = 4):
    """Run fn() under torch.profiler; returns (device us per step, traced
    wall us per step, device records in the profile, the port's kernel
    launches in it). Profiles taken after the batched surface phases have
    lost kernel records, so the records of the port's kernels are held
    against the launch counters over the same window: a profile that misses
    one is printed and taken again, up to ``attempts`` times. With
    ``--profile`` it prints the breakdown by kernel."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.time()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.time() - t1) * 1e6
        launched = {n: c for n, c in read_launches().items() if c}
        held = dict.fromkeys(launched, 0)
        dev_us, n_records = 0.0, 0
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CPU:
                continue
            dev_us += getattr(ev, "self_device_time_total",
                              getattr(ev, "self_cuda_time_total", 0))
            n_records += ev.count
            for name in launched:
                if launched_as(name, ev.key):
                    held[name] += ev.count
        if held == launched:
            break
        print(f"  the profiler holds {held} records of the port's kernels "
              f"where the window launched {launched}; taken again",
              flush=True)
    else:
        fail(f"no profile of {attempts} held every kernel record")
    if "--profile" in sys.argv[1:]:
        device_breakdown(prof, wall_us, steps, "step")
    return dev_us / steps, wall_us / steps, n_records, launched


def surface_batched_phases(dev, smi, stripes, scfg, seng, xsph, nsph,
                           A0s) -> dict:
    """The batched surface rollout (``rollout_mesh_batched``): the stripes
    sphere with SURF_B rollouts at once, bfloat16 tables and MLP, SURF_STEPS
    steps at fire_rate 0.5 (counters reset just before, read just after);
    then CHECK_STEPS steps at fire_rate 1.0 from the grown states with the
    kernels against the plain versions, and the batched rollout against
    SURF_B unbatched rollout_mesh_cells runs (float32 tables and MLP).
    Returns the path's launch counts and each kernel's bound at its
    shapes."""
    t0 = time.time()
    sh, eng = stripes.h, seng["bfloat16"]
    # SURF_B radial seeds: the same seed points, tangents of other draws
    T0 = torch.stack([surface_radial_seed(
        xsph, nsph, scfg.channels, SURF_SEEDS, sh,
        torch.Generator().manual_seed(SEED + b))[1] for b in range(SURF_B)])
    A0 = A0s[None].expand(SURF_B, -1, -1).contiguous()

    def gen():
        return torch.Generator(device=dev).manual_seed(SEED)

    reset_launches()
    t1 = time.time()
    with torch.no_grad():
        fA, fT, states = rollout_mesh_batched(
            stripes.params, scfg, eng, A0, nsph, T0, gen(), SURF_STEPS, sh,
            mlp_dtype="bfloat16", collect_all=True)
    torch.cuda.synchronize()
    secs = time.time() - t1
    launches = read_launches()
    want = tab_launches(eng, SURF_STEPS)
    if launches != want:
        fail(f"batched surface launch counts {launches}, expected {want}")
    if states.shape != (SURF_STEPS + 1, SURF_B, SURF_N, scfg.channels):
        fail(f"batched surface trajectory shape {tuple(states.shape)}")
    if not (bool(torch.isfinite(states).all())
            and bool(torch.isfinite(fT).all())):
        fail("non-finite states or tangents in the batched surface rollout")
    tnorm = float(fT.norm(dim=-1).max())
    if not tnorm <= 1.0 + 1e-5:
        fail(f"batched tangent norm {tnorm} > 1 + 1e-5")
    ks = (0, SURF_STEPS // 2, SURF_STEPS)
    share = torch.stack([(states[k].abs().amax(-1) > 0).float().mean(-1)
                         for k in ks])  # [3, B]
    if not bool(((share[0] < share[1]) & (share[1] <= share[2])).all()):
        fail(f"the texture did not spread in every sample: {share.tolist()}")
    del states
    print(f"  launches {launches}", flush=True)
    phase("surface-batched", t0, f"stripes, {SURF_N} points, B={SURF_B}, "
          f"{SURF_STEPS} steps at fire_rate {scfg.fire_rate}, bfloat16 "
          f"tables and MLP, in {secs:.2f} s (collecting every state): "
          f"finite, max tangent norm {tnorm:.7f}; share of points whose "
          f"state left 0 at steps {ks}, per sample: " + "; ".join(
              " ".join(f"{v:.4f}" for v in share[:, b].tolist())
              for b in range(SURF_B)))

    t0 = time.time()
    cfg1 = dataclasses.replace(scfg, fire_rate=1.0)
    with torch.no_grad():
        outs = {}
        for mlp_dtype, steps in ((None, CHECK_STEPS), ("bfloat16", 1),
                                 ("bfloat16", CHECK_STEPS)):
            outs[mlp_dtype, steps] = [rollout_mesh_batched(
                stripes.params, cfg1, eng, fA, nsph, fT, gen(), steps, sh,
                mlp_dtype=mlp_dtype, use_kernels=uk) for uk in (True, False)]
        gaps = {key: [(a - b).abs() for a, b in zip(*pair)]
                for key, pair in outs.items()}
        diff = max(float(g.max()) for g in gaps[None, CHECK_STEPS])
        share1 = float((gaps["bfloat16", 1][0] > ROLLOUT_ATOL).float()
                       .mean())
        gap16 = float(gaps["bfloat16", CHECK_STEPS][0].max())
        e32 = seng["float32"]
        bA, bT = rollout_mesh_batched(stripes.params, cfg1, e32, fA, nsph,
                                      fT, gen(), CHECK_STEPS, sh)
        per = 0.0
        for b in range(SURF_B):
            rA, rT, _ = rollout_mesh_cells(stripes.params, cfg1, e32, fA[b],
                                           nsph, fT[b], gen(), CHECK_STEPS,
                                           sh, fire_rate=1.0)
            per = max(per, float((bA[b] - rA).abs().max()),
                      float((bT[b] - rT).abs().max()))
    del outs, gaps
    phase("surface-batched-check", t0, f"{CHECK_STEPS} steps at fire_rate "
          f"1.0 from the grown states, bfloat16 tables: kernels vs plain "
          f"versions, max difference of states and tangents {diff:.3e} with "
          f"a float32 MLP (limit {ROLLOUT_ATOL}), {gap16:.3e} with a "
          f"bfloat16 MLP (printed; share of state values past "
          f"{ROLLOUT_ATOL} after one step {share1:.3e}, limit "
          f"{BF16_STEP_SHARE}); float32 tables and MLP, the B={SURF_B} "
          f"rollout vs {SURF_B} unbatched rollout_mesh_cells runs: {per:.3e}"
          f" (limit {ROLLOUT_ATOL})")
    if not (diff <= ROLLOUT_ATOL and per <= ROLLOUT_ATOL
            and share1 <= BF16_STEP_SHARE):
        fail(f"batched surface rollout kernels vs plain {diff:.3e} (bfloat16"
             f" MLP one step: {share1:.3e} of the states past "
             f"{ROLLOUT_ATOL}), vs unbatched {per:.3e}")

    step_ms = {}
    with torch.no_grad():
        for uk in (True, False):
            rollout_mesh_batched(stripes.params, scfg, eng, A0, nsph, T0,
                                 gen(), 4, sh, mlp_dtype="bfloat16",
                                 use_kernels=uk)  # warm-up
            torch.cuda.synchronize()
            t1 = time.time()
            rollout_mesh_batched(stripes.params, scfg, eng, A0, nsph, T0,
                                 gen(), SURF_STEPS, sh, mlp_dtype="bfloat16",
                                 use_kernels=uk)
            torch.cuda.synchronize()
            step_ms[uk] = (time.time() - t1) * 1e3 / SURF_STEPS
        busy, wall, recs, held = busy_share(lambda: rollout_mesh_batched(
            stripes.params, scfg, eng, A0, nsph, T0, gen(), 16, sh,
            mlp_dtype="bfloat16"), 16)
    # the bounds of each kernel of the path at its shapes
    c, m, _ = eng.xs.shape
    need = work_tab(eng, SURF_B, use_alpha=scfg.use_alpha)
    need["sph_mlp_kernel"] = work_mlp(SURF_B * c * m, 256, 33, 2)
    out = {}
    for name, (nbytes, ops) in need.items():
        if launches[name]:
            b_ms, b_by = bound(nbytes, ops, BF16_FLOPS
                               if name == "sph_mlp_kernel" else FP32_FLOPS)
            out[name] = {"launches": launches[name], "bound_ms": b_ms,
                         "bound_by": b_by}
    print(f"  batched surface step (B={SURF_B}): {step_ms[True]:.4f} ms with"
          f" the kernels ({SURF_B * SURF_N * 1e3 / step_ms[True]:.4e} "
          f"particle-steps/s), {step_ms[False]:.4f} ms with the plain "
          f"versions (host clock around synchronize, {SURF_STEPS} steps); "
          f"device busy {busy:.2f} of {wall:.2f} us a step traced "
          f"({100 * busy / wall:.1f}%; {recs} device records, the port's "
          f"kernels' equal to their launches {held}); bounds of one call at these shapes "
          f"(both buckets; the MLP one launch), ms: "
          + ", ".join(f"{n} {v['bound_ms']:.4f} by {v['bound_by']}"
                      for n, v in out.items())
          + f" | {smi}", flush=True)
    return out


def check_blur(eng, rng, dev, sizes) -> tuple:
    """sph_blur_tab_kernel against its plain version on each bucket of a w6
    engine (the random seed's pre-diffusion engine) at each B in ``sizes``;
    pad rows exactly 0. Returns (max abs, max rel to max |plain|)."""
    c, m, _ = eng.xs.shape
    scal = PK.scal_vec(eng)
    real = (eng.vs > 0).reshape(-1, 64)
    err = rel = 0.0
    for bsz in sizes:
        X = normal_cuda(rng, (bsz, c, m, 4), dev)
        for lo, hi, wc, vw, _, w6 in tab_buckets(eng):
            got = PK.blur_bucket(scal, vw, X, wc, w6)
            want = PK.blur_bucket_plain(scal, vw, X, wc, w6)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            err = max(err, e)
            rel = max(rel, e / max(float(want.abs().max()), 1e-30))
            if not bool((got[:, ~real[lo:hi]] == 0).all()):
                fail("sph_blur_tab_kernel: nonzero pad rows on the "
                     "pre-diffusion engine")
    return err, rel


def surface_cli_phase(dev, smi):
    """The test CLI's surface mode on a procedural mesh, SURF_N points,
    SURF_STEPS steps: stripes with the random seed, gecko with radial seeds,
    and stripes at --h 0.08 (the diffusion on a second engine at 0.1); the
    trajectory, the PLY files, the launch counts; then the blur kernel
    against its plain version on the random seed's engine at radius 0.2,
    and the kernels on the CLI's own engines (``cli_engine_checks``).
    Returns each run's launch counts and the kernels' largest errors
    there."""
    t0 = time.time()
    runs = {"stripes-random": (STRIPES, []), "gecko-radial": (GECKO, []),
            "stripes-dual": (STRIPES, ["--h", "0.08"])}
    every = 16
    counts, finals = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        obj = write_mesh_obj(os.path.join(tmp, "bumpy.obj"))
        for label, (weights, extra) in runs.items():
            out_dir = os.path.join(tmp, label)
            reset_launches()
            t1 = time.time()
            rc = cli_test.main([
                "--weights_json", weights, "--surface", obj,
                "--surface_numpoints", str(SURF_N), "--steps",
                str(SURF_STEPS), "--export_every", str(every), "--seed",
                str(SEED), "--device", "cuda", "--output_dir", out_dir,
                "--engine", "cells"] + extra)
            torch.cuda.synchronize()
            secs = time.time() - t1
            counts[label] = read_launches()
            if rc != 0:
                fail(f"surface CLI ({label}) returned {rc}")
            (run,) = os.listdir(out_dir)
            run = os.path.join(out_dir, run)
            with np.load(os.path.join(run, "states.npz")) as z:
                x, states = z["x"], z["states"]
            if (x.shape != (SURF_N, 3)
                    or states.shape != (SURF_STEPS + 1, SURF_N, 16)):
                fail(f"surface CLI ({label}) shapes {x.shape} {states.shape}")
            if not (np.isfinite(states).all() and np.abs(x).max() <= 1 + 1e-5):
                fail(f"surface CLI ({label}): non-finite states or points "
                     "off the normalized mesh")
            names = sorted(f for f in os.listdir(run) if f.endswith(".ply"))
            want_names = [f"{i:04d}.ply" for i in range(0, SURF_STEPS + 1,
                                                          every)]
            if names != want_names:
                fail(f"surface CLI ({label}) PLY files {names}")
            for name in names:
                pts, rgba = load_ply_points(os.path.join(run, name))
                if not (np.array_equal(pts, x)
                        and rgba.shape == (SURF_N, 4)):
                    fail(f"surface CLI ({label}) {name}: wrong points")
            finals[label] = states[-1]
            live = [float((np.abs(states[k]).max(-1) > 0).mean())
                    for k in (0, SURF_STEPS)]
            print(f"  {label}: {secs:.2f} s, {len(names)} PLY files, share "
                  f"of points whose state is not 0 at steps 0 and "
                  f"{SURF_STEPS}: {live[0]:.4f} {live[1]:.4f}; launches "
                  f"{counts[label]}", flush=True)

        # the random seed's pre-diffusion engine (radius 0.2, float32 w6)
        t1 = time.time()
        x, nrm, fps_s = cli_test.surface_points(
            obj, 1.0, SURF_N, np.random.default_rng(SEED), dev)
        points_s = time.time() - t1
    t1 = time.time()
    peng = build_cell_engine(x, cli_test.SEED_RADIUS_RANDOM,
                             pair_tables="float32", w6_only=True, device=dev)
    torch.cuda.synchronize()
    build_s = time.time() - t1
    st = tab_stats(peng)
    err, rel = check_blur(peng, np.random.default_rng(SEED), dev,
                          (1, SURF_B))
    # every engine here has both window-size buckets (the tables phase
    # checks the sphere's; the pre-diffusion engine's is checked here)
    if len(st["buckets"]) != 2 or min(nb for nb, _ in st["buckets"]) == 0:
        fail(f"expected two non-empty buckets at radius 0.2: {st['buckets']}")
    for name, (weights, _) in runs.items():
        want = tab_launches(
            peng, SURF_STEPS,
            extra_blur=(2 * cli_test.PREDIFFUSE_PASSES if weights == STRIPES
                        else 0))
        if counts[name] != want:
            fail(f"surface CLI ({name}) launch counts {counts[name]}, "
                 f"expected {want}")
    phase("surface-cli", t0, f"test CLI --surface on a procedural mesh, "
          f"{SURF_N} points, {SURF_STEPS} steps, runs "
          f"{', '.join(runs)}: states and PLYs as expected; points and "
          f"normals {points_s:.2f} s of which farthest-point sampling "
          f"({SURF_N} of {8 * SURF_N} candidates, on the card) {fps_s:.2f} "
          f"s; the random "
          f"seed's engine at radius 0.2: C={peng.num_cells}, blocks x W "
          + " + ".join(f"{nb} x {w}" for nb, w in st["buckets"])
          + f", float32 w6 table {st['bytes'] / 1e6:.1f} MB, built in "
          f"{build_s:.2f} s; sph_blur_tab_kernel == plain there at B = 1 and "
          f"{SURF_B}: max abs {err:.3e}, rel to max {rel:.3e} (limit "
          f"{TAB_RTOL}) | {smi}")
    if not rel <= TAB_RTOL:
        fail(f"sph_blur_tab_kernel vs plain at radius 0.2: {rel:.3e}")
    return counts, cli_engine_checks(dev, smi, runs, x, nrm, peng, finals)


def cli_engine_checks(dev, smi, runs, x, nrm, peng, finals,
                      phase_name: str = "surface-cli-check") -> dict:
    """The surface CLI's own engines, rebuilt from the same points as the
    CLI builds them (bfloat16 tables at each run's h; for h != DIFFUSE_H a
    bfloat16 w6-only diffusion engine at DIFFUSE_H), each run's kernels
    against their plain versions there: the forward and the mask on the
    perception engine and the blur on the diffusion engine (random inputs,
    B = 1, within TAB_RTOL of max), the update MLP at the run's shape
    (float32, as the CLI runs it), and CHECK_STEPS rollout steps at
    fire_rate 1 from the run's final state with the random seed's tangent
    field, kernels vs plain (ROLLOUT_ATOL). Returns the largest absolute
    error per kernel."""
    t0 = time.time()
    rng = np.random.default_rng(SEED + 2)
    xt, nt = torch.from_numpy(x).to(dev), torch.from_numpy(nrm).to(dev)
    with torch.no_grad():
        t_seed = surface_random_seed(
            xt, nt, 16, np.random.default_rng(SEED),
            torch.Generator(device=dev).manual_seed(SEED), peng,
            cli_test.PREDIFFUSE_PASSES)[1]
    engs, lines = {}, []
    errs = dict.fromkeys(("sph_fwd_tab_kernel", "sph_mask_tab_kernel",
                          "sph_blur_tab_kernel", "sph_mlp_kernel"), 0.0)

    def engine(h, w6_only):
        if (h, w6_only) not in engs:
            t1 = time.time()
            engs[h, w6_only] = build_cell_engine(
                x, h, pair_tables="bfloat16", w6_only=w6_only, device=dev)
            torch.cuda.synchronize()
            st = tab_stats(engs[h, w6_only])
            lines.append(f"h={h}{' w6 only' if w6_only else ''}: blocks x W "
                         + " + ".join(f"{nb} x {w}" for nb, w in st["buckets"])
                         + f", {st['bytes'] / 1e6:.1f} MB, built in "
                         f"{time.time() - t1:.2f} s")
        return engs[h, w6_only]

    def hold(name, kc, pc):
        abs_err, rel = tab_gap(kc[name](), pc[name]())
        errs[name] = max(errs[name], abs_err)
        return rel

    for label, (weights, extra) in runs.items():
        model = load_weights_json(weights, device=dev)
        h = float(extra[1]) if extra else model.h
        cfg = dataclasses.replace(model.cfg, fire_rate=1.0,
                                  use_alpha=model.mode == "image")
        eng = engine(h, False)
        eng_d = eng if abs(h - DIFFUSE_H) < 1e-9 else engine(DIFFUSE_H, True)
        rels = {}
        for e, names in ((eng, ("sph_fwd_tab_kernel", "sph_mask_tab_kernel")),
                         (eng_d, ("sph_blur_tab_kernel",))):
            c, m, d = e.xs.shape
            S = normal_cuda(rng, (1, c, m, 16), dev)
            X = normal_cuda(rng, (1, c, m, 4), dev)
            G = normal_cuda(rng, (1, c, m, d * 16), dev)
            kc = tab_calls(e, S, G, X, plain=False, use_alpha=cfg.use_alpha)
            pc = tab_calls(e, S, G, X, plain=True, use_alpha=cfg.use_alpha)
            for name in names:
                rels[name] = hold(name, kc, pc)
        c, m, _ = eng.xs.shape
        args = mlp_inputs(dev, torch.float32, 33, (1, c, m), seed=17)
        got, want = MK.mlp_forward(*args), MK.mlp_ref(*args)
        top = max(float(b.abs().max()) for b in want if b is not None)
        mlp_err = max(float((a - b).abs().max()) for a, b in zip(got, want)
                      if b is not None)
        errs["sph_mlp_kernel"] = max(errs["sph_mlp_kernel"], mlp_err)
        rels["sph_mlp_kernel"] = mlp_err / top
        del got, want, args
        A = torch.from_numpy(finals[label]).to(dev)[None]
        with torch.no_grad():
            (kA, kT), (pA, pT) = [rollout_mesh_batched_dual(
                model.params, cfg, eng, eng_d, A, nt, t_seed[None],
                torch.Generator(device=dev).manual_seed(SEED), CHECK_STEPS,
                h, use_kernels=uk) for uk in (True, False)]
        gap = max(float((kA - pA).abs().max()), float((kT - pT).abs().max()))
        lines.append(f"{label} (h={h}, diffusion at h="
                     f"{DIFFUSE_H if eng_d is not eng else h}): rel to max "
                     + ", ".join(f"{n} {v:.3e}" for n, v in rels.items())
                     + f"; {CHECK_STEPS} steps kernels vs plain {gap:.3e}")
        bad = [n for n, v in rels.items()
               if not v <= (MLP_RTOL[torch.float32] if n == "sph_mlp_kernel"
                            else TAB_RTOL)]
        if bad or not gap <= ROLLOUT_ATOL:
            fail(f"surface CLI ({label}) engines: kernels vs plain {rels}, "
                 f"rollout {gap:.3e}")
    for line in lines:
        print(f"  {line}", flush=True)
    phase(phase_name, t0, "the CLI's engines rebuilt from its "
          f"points: the table kernels at B = 1 within {TAB_RTOL} of max, the "
          f"float32 MLP within {MLP_RTOL[torch.float32]} of max, "
          f"{CHECK_STEPS} rollout steps at fire_rate 1.0 from each run's "
          f"final state within {ROLLOUT_ATOL} (states and tangents) | {smi}")
    return errs


def mlp_library(args):
    """The library chain addmm -> relu -> addmm computing the update MLP on
    ``mlp_inputs`` args [S, ga, w1k, b1, w2, b2]: in float32 with TF32 off,
    or on bfloat16 inputs with float32 sums and outputs and H rounded to
    bfloat16 between the two (the function the kernel computes)."""
    S_m, ga_m, w1k, b1, w2, b2 = args
    X = torch.cat([S_m, ga_m], -1).reshape(-1, 48)
    if S_m.dtype == torch.float32:
        return lambda: torch.addmm(b2, torch.relu(torch.addmm(b1, X, w1k)),
                                   w2)
    f32 = torch.float32
    return lambda: torch.addmm(b2, torch.relu(torch.addmm(
        b1, X, w1k, out_dtype=f32)).to(S_m.dtype), w2, out_dtype=f32)


def surface_bench_phase(dev, rng, smi) -> dict:
    """bench.py's configuration in the port: BENCH_B rollouts on a
    BENCH_N-point sphere of radius BENCH_RADIUS with h sized for
    BENCH_NEIGHBOURS neighbours, BENCH_STEPS steps, bfloat16 tables and MLP,
    random-init parameters (16 channels, 256 hidden, normalize_perception =
    1/h), uniform states and random unit tangents; particle-steps per
    second (best of 3, host clock around synchronize), the device's busy
    share, peak memory, table bytes and the engine's build time; then the
    table and MLP kernels at this shape against their plain versions, with
    their times (CUDA events), bounds and library calls. Returns their
    rows."""
    from sph_nca_tpu_torch.models.nca import SPHNCAConfig, init_params

    t0 = time.time()
    x = fibonacci_sphere(BENCH_N, BENCH_RADIUS)
    h = bench_h()
    t1 = time.time()
    eng = build_cell_engine(x, h, pair_tables="bfloat16", device=dev)
    torch.cuda.synchronize()
    build_s = time.time() - t1
    st = tab_stats(eng)
    cfg = SPHNCAConfig(normalize_perception=1.0 / h)
    params = init_params(cfg, torch.Generator().manual_seed(SEED), device=dev)
    nrm = torch.from_numpy(sphere_normals(x)).to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    A0 = torch.rand(BENCH_B, BENCH_N, cfg.channels, generator=g, device=dev)
    T0 = orthogonalize(nrm, normalize(torch.randn(BENCH_B, BENCH_N, 3,
                                                  generator=g, device=dev)))

    def run(steps, seed):
        return rollout_mesh_batched(
            params, cfg, eng, A0, nrm, T0,
            torch.Generator(device=dev).manual_seed(seed), steps, h,
            mlp_dtype="bfloat16")

    secs = []
    with torch.no_grad():
        run(4, SEED)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for i in range(3):
            if i == 0:
                reset_launches()
            t1 = time.time()
            fA, fT = run(BENCH_STEPS, SEED + i)
            torch.cuda.synchronize()
            secs.append(time.time() - t1)
            if i == 0:
                launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        busy, wall, recs, held = busy_share(lambda: run(16, SEED), 16)
    want = tab_launches(eng, BENCH_STEPS)
    if launches != want:
        fail(f"bench launch counts {launches}, expected {want}")
    if not (bool(torch.isfinite(fA).all()) and bool(torch.isfinite(fT).all())
            and float(fT.norm(dim=-1).max()) <= 1.0 + 1e-5):
        fail("bench rollout: non-finite states or tangents off unit length")
    pps = [BENCH_B * BENCH_N * BENCH_STEPS / s for s in secs]
    print(f"  engine: C={eng.num_cells}, blocks x W "
          + " + ".join(f"{nb} x {w}" for nb, w in st["buckets"])
          + f", {st['pairs']} pairs, {st['within_h']} within h, bfloat16 "
          f"tables {st['bytes'] / 1e6:.1f} MB, built in {build_s:.2f} s "
          f"(host numpy + device cast); launches {launches}", flush=True)
    phase("surface-bench", t0, f"bench.py's configuration: {BENCH_N} "
          f"points, h={h:.6f}, B={BENCH_B}, {BENCH_STEPS} steps, bfloat16 "
          f"tables and MLP: {max(pps):.4e} particle-steps/s (best of 3; "
          + ", ".join(f"{p:.4e}" for p in pps) + f"; "
          f"{min(secs) * 1e3 / BENCH_STEPS:.4f} ms a step, host clock "
          f"around synchronize); device busy {busy:.2f} of {wall:.2f} us a "
          f"step traced ({100 * busy / wall:.1f}%; {recs} device records, "
          f"the port's kernels' equal to their launches {held}); peak "
          f"device memory "
          f"{peak_gb:.3f} GiB (max_memory_allocated, tables included); "
          f"tables {st['bytes'] / 1e6:.1f} MB; engine build {build_s:.2f} s"
          f" | {smi}")
    del fA, fT

    # each kernel of the path at this shape: kernel vs plain, device times,
    # bound, and one PyTorch call computing the same function
    t0 = time.time()
    c, m, d = eng.xs.shape
    S = normal_cuda(rng, (BENCH_B, c, m, 16), dev)
    G = normal_cuda(rng, (BENCH_B, c, m, d * 16), dev)
    X = normal_cuda(rng, (BENCH_B, c, m, 4), dev)
    kc = tab_calls(eng, S, G, X, plain=False, use_alpha=True)
    pc = tab_calls(eng, S, G, X, plain=True, use_alpha=True)
    need = work_tab(eng, BENCH_B, use_alpha=True)
    widths = {"sph_fwd_tab_kernel": 16 * BENCH_B,
              "sph_mask_tab_kernel": BENCH_B,
              "sph_blur_tab_kernel": 4 * BENCH_B}
    shapes = (f"bench sphere N={BENCH_N} h={h:.6f} bfloat16 tables "
              f"B={BENCH_B}")
    out = {}
    for name, width in widths.items():
        abs_err, rel = tab_gap(kc[name](), pc[name]())
        if not rel <= TAB_RTOL:
            fail(f"{name} vs plain at the bench shape: {rel:.3e} of max")
        # torch.bmm twice: on float32 copies of the tables (the kernel's
        # function: float32 right-hand side and sums), and on the bfloat16
        # tables with a bfloat16 right-hand side (the table bytes the kernel
        # reads, one call)
        tabs = [md if name == "sph_fwd_tab_kernel" else w6
                for *_, md, w6 in tab_buckets(eng)]
        rhs = [normal_cuda(rng, (t.shape[0], t.shape[2], width), dev)
               for t in tabs]
        lib = [(t.float(), r) for t, r in zip(tabs, rhs)]
        lib16 = [(t, r.to(t.dtype)) for t, r in zip(tabs, rhs)]
        ms, plain_ms = cuda_ms(kc[name], 20, 3), cuda_ms(pc[name], 20, 3)
        lib_ms = cuda_ms(lambda: [torch.bmm(a, b) for a, b in lib], 20, 3)
        lib16_ms = cuda_ms(lambda: [torch.bmm(a, b) for a, b in lib16], 20,
                           3)
        del lib, lib16, rhs, tabs
        bound_ms, bound_by = bound(*need[name])
        print(f"  {name} at the bench shape (both buckets): {ms:.4f} ms "
              f"by CUDA events, plain {plain_ms:.4f} ms, torch.bmm "
              f"[nb, *, W] @ [nb, W, {width}] on float32 copies of the "
              f"tables {lib_ms:.4f} ms, on the bfloat16 tables with a "
              f"bfloat16 right-hand side {lib16_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by} ({100 * bound_ms / ms:.1f}% "
              f"of it); max abs {abs_err:.3e} from plain", flush=True)
        out[name] = {"shapes": shapes, "launches": launches[name],
                     "launches_path": "surface-bench",
                     "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms, "library_bf16_ms": lib16_ms}
    del S, G, X, kc, pc
    args = mlp_inputs(dev, torch.bfloat16, 33, (BENCH_B, c, m), seed=13)
    got, want_m = MK.mlp_forward(*args), MK.mlp_ref(*args)
    diff = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(got, want_m)
                      if b is not None])
    top = max(float(b.abs().max()) for b in want_m if b is not None)
    share = float((diff > 1e-5 * top).float().mean())
    if not (float(diff.max()) <= MLP_RTOL[torch.bfloat16] * top
            and share <= MLP_FLIP_SHARE):
        fail(f"sph_mlp_kernel vs mlp_ref at the bench shape: "
             f"{float(diff.max()) / top:.3e} of max, {share:.3e} past 1e-5")
    del got, want_m
    ms = cuda_ms(lambda: MK.mlp_forward(*args), 20, 3)
    plain_ms = cuda_ms(lambda: MK.mlp_ref(*args), 20, 3)
    lib_ms = cuda_ms(mlp_library(args), 20, 3)
    n = BENCH_B * c * m
    nbytes, ops = work_mlp(n, 256, 33, 2)
    bound_ms, bound_by = bound(nbytes, ops, BF16_FLOPS)
    print(f"  sph_mlp_kernel at the bench shape ({n} items, bfloat16 "
          f"inputs): {ms:.4f} ms by CUDA events, plain {plain_ms:.4f} ms, "
          f"library chain {lib_ms:.4f} ms, bound {bound_ms:.4f} ms by "
          f"{bound_by}; rel to max {float(diff.max()) / top:.3e}, share past"
          f" 1e-5 of max {share:.3e}", flush=True)
    out["sph_mlp_kernel"] = {
        "shapes": f"bench ({BENCH_B}, {c}, {m}) bfloat16 inputs",
        "launches": launches["sph_mlp_kernel"],
        "launches_path": "surface-bench", "max_abs_err": float(diff.max()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": lib_ms}
    phase("surface-bench-kernels", t0, "the table and MLP kernels at the "
          f"bench shape == plain (table kernels within {TAB_RTOL} of max, "
          f"the MLP within {MLP_RTOL[torch.bfloat16]} of max and "
          f"{MLP_FLIP_SHARE} of outputs past 1e-5); times by CUDA events "
          f"around 20 calls after 3 (each call takes 0.2 ms or more here, so "
          f"the host enqueues ahead of the device; profiles of 20 calls "
          f"after the earlier phases kept losing kernel records) | {smi}")
    return out, max(pps)


def mlp_shape_checks(dev, shapes: dict) -> dict:
    """sph_mlp_kernel against mlp_ref at each path's shapes (lead axes
    [B, C, M]), gated and orig, float32 and bfloat16 inputs, within MLP_RTOL
    of max and all but MLP_FLIP_SHARE of the outputs within 1e-5 of max.
    Returns the largest absolute error per (shapes, dtype)."""
    errs = {}
    for label, lead in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            for k in (33, 16):
                args = mlp_inputs(dev, dtype, k, lead, seed=k)
                got = MK.mlp_forward(*args)
                want = MK.mlp_ref(*args)
                torch.cuda.synchronize()
                if [g is None for g in got] != [w is None for w in want]:
                    fail(f"sph_mlp_kernel outputs {got} vs {want}")
                err = max(float((g - w).abs().max())
                          for g, w in zip(got, want) if w is not None)
                top = max(float(w.abs().max())
                          for w in want if w is not None)
                diff = torch.cat([(g - w).abs().reshape(-1)
                                  for g, w in zip(got, want) if w is not None])
                rel = float(diff.max()) / max(top, 1e-30)
                share = float((diff > 1e-5 * top).float().mean())
                key = (label, dtype)
                errs[key] = max(errs.get(key, 0.0), err)
                print(f"  {label} {tuple(lead)} {str(dtype)[6:]} K={k}: max "
                      f"abs {err:.3e} (rel to max {rel:.3e}, limit "
                      f"{MLP_RTOL[dtype]}); share of outputs past 1e-5 of max "
                      f"{share:.3e} (limit {MLP_FLIP_SHARE})", flush=True)
                if not (rel <= MLP_RTOL[dtype] and share <= MLP_FLIP_SHARE):
                    fail(f"sph_mlp_kernel vs mlp_ref: {rel:.3e} of max "
                         f"(limit {MLP_RTOL[dtype]}), {share:.3e} of outputs "
                         f"past 1e-5 of max (limit {MLP_FLIP_SHARE}) "
                         f"({label}, {dtype}, K={k})")
    return errs


def mlp_times(dev, lead, dtype, events: bool = False) -> dict:
    """Kernel 2.8 at lead shapes ``lead`` (gated, hid 256, K = 33): device
    ms of the kernel, its plain version (mlp_ref) and the library chain
    addmm -> relu -> addmm (``mlp_library``) from profiler records, or with
    ``events`` by CUDA events around 20 calls after 3 (after the surface
    phases' profiles, later profiles lose records; each call here takes 0.1
    ms or more, so the host enqueues ahead of the device), and its bound on
    its route:
    the tensor cores, 3 TF32 products for float32 inputs, one bf16 product
    for bfloat16 (``work_mlp``, ``bound``). Also the fp32 CUDA-core bound and
    the library chain's largest error from mlp_ref, for the text line."""
    args = mlp_inputs(dev, dtype, 33, lead, seed=11)
    S_m, ga_m, w1k, b1, w2, b2 = args
    X = torch.cat([S_m, ga_m], -1).reshape(-1, 48)
    library = mlp_library(args)
    lib_err = float((library() - torch.cat(
        [o.reshape(X.shape[0], -1) for o in MK.mlp_ref(*args)], -1)
    ).abs().max())
    if events:
        ms = cuda_ms(lambda: MK.mlp_forward(*args), 20, 3)
        plain_ms = cuda_ms(lambda: MK.mlp_ref(*args), 20, 3)
        lib_ms = cuda_ms(library, 20, 3)
    else:
        ms = device_ms(lambda: MK.mlp_forward(*args), "sph_mlp_kernel")
        plain_ms = device_ms(lambda: MK.mlp_ref(*args))
        lib_ms = device_ms(library)
    n = X.shape[0]
    nbytes, ops = work_mlp(n, w1k.shape[1], 33, S_m.element_size())
    tc_ops, peak = ((ops, BF16_FLOPS) if dtype == torch.bfloat16
                    else (3 * ops, TF32_FLOPS))
    bound_ms, bound_by = bound(nbytes, tc_ops, peak)
    core_ms, _ = bound(nbytes, ops, FP32_FLOPS)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "n": n,
            "hid": w1k.shape[1], "nbytes": nbytes, "tc_ops": tc_ops,
            "peak": peak, "core_ms": core_ms, "ops": ops,
            "library_err": lib_err}


def mlp_times_line(label, lead, dtype, t) -> str:
    return (f"sph_mlp_kernel at the {label} shapes ({t['n']} items, "
            f"{str(dtype)[6:]} inputs, gated, hid {t['hid']}): "
            f"{t['ms']:.4f} ms device time, plain {t['plain_ms']:.4f} ms, "
            f"library chain {t['library_ms']:.4f} ms (max abs "
            f"{t['library_err']:.3e} from mlp_ref), bound "
            f"{t['bound_ms']:.4f} ms by {t['bound_by']} on the tensor cores "
            f"({100 * t['bound_ms'] / t['ms']:.1f}% of it; "
            f"{t['nbytes'] / 1e6:.2f} MB, {t['tc_ops'] / 1e9:.3f} G "
            f"operations at {t['peak'] / 1e12:.0f} TFLOP/s; "
            f"{t['core_ms']:.4f} ms counting {t['ops'] / 1e9:.3f} G fp32 "
            "operations on the CUDA cores)")


def mlp_phases(dev, shapes: dict) -> dict:
    """``mlp_shape_checks`` at each path's shapes and at ragged and edge
    shapes; the wrapper refusing what the kernel does not take; the
    gradients through mlp_fused (kernel forward) against autograd through
    mlp_ref. Returns the largest absolute error per (shapes, dtype)."""
    t0 = time.time()
    errs = mlp_shape_checks(dev, shapes)
    # ragged and edge shapes, each against mlp_ref within MLP_RTOL (the
    # share of outputs past 1e-5 of max is held at the large n only: one
    # flipped bf16 hidden unit moves several of the few outputs of n <= 37)
    ragged = {}
    for n in MLP_RAGGED_N:
        for hid in MLP_RAGGED_HID:
            for dtype in (torch.float32, torch.bfloat16):
                for k in (33, 16):
                    args = mlp_inputs(dev, dtype, k, (n,), seed=n + hid + k,
                                      hid=hid)
                    got = MK.mlp_forward(*args)
                    want = MK.mlp_ref(*args)
                    torch.cuda.synchronize()
                    diff = torch.cat([(g - w).abs().reshape(-1)
                                      for g, w in zip(got, want)
                                      if w is not None])
                    top = max(float(w.abs().max())
                              for w in want if w is not None)
                    rel = float(diff.max()) / max(top, 1e-30)
                    share = float((diff > 1e-5 * top).float().mean())
                    ok = (bool(torch.isfinite(diff).all())
                          and rel <= MLP_RTOL[dtype]
                          and (n < 1000 or share <= MLP_FLIP_SHARE))
                    if not ok:
                        fail(f"sph_mlp_kernel vs mlp_ref at n={n} hid={hid}"
                             f" {dtype} K={k}: {rel:.3e} of max, {share:.3e}"
                             " of outputs past 1e-5 of max")
                    key = str(dtype)[6:]
                    ragged[key] = max(ragged.get(key, 0.0), rel)
    print(f"  ragged and edge shapes n in {MLP_RAGGED_N}, hid in "
          f"{MLP_RAGGED_HID}, K 33 and 16: largest error rel to max "
          + ", ".join(f"{k} {v:.3e}" for k, v in ragged.items()),
          flush=True)
    S, ga, w1k, b1, w2, b2 = mlp_inputs(dev, torch.float32, 33, (64,), 0)
    refused = 0
    for bad in ([S.double(), ga.double(), w1k.double(), b1, w2.double(), b2],
                [S.bfloat16(), ga, w1k, b1, w2, b2],
                [S[..., :8].contiguous(), ga[..., :16], w1k[:24], b1,
                 w2[:, :17].contiguous(), b2[:17].contiguous()],
                [S, ga, *mlp_inputs(dev, torch.float32, 33, (64,), 0,
                                    hid=600)[2:]],
                [S, ga.cpu(), w1k, b1, w2, b2]):
        try:
            MK.mlp_forward(*bad)
        except ValueError:
            refused += 1
    if refused != 5:
        fail(f"sph_mlp_kernel's wrapper took {5 - refused} bad argument sets")
    phase("mlp", t0, "sph_mlp_kernel == mlp_ref at " + ", ".join(
        f"{label} {tuple(lead)}" for label, lead in shapes.items())
        + f" and the ragged shapes, gated and orig, float32 / bfloat16 within "
        f"{MLP_RTOL[torch.float32]} / {MLP_RTOL[torch.bfloat16]} of max, all "
        f"but {MLP_FLIP_SHARE} of the outputs within 1e-5 of max; float64, "
        "mixed dtypes, F = 8, hid = 600 and a CPU tensor refused")

    t0 = time.time()
    lead = shapes["train"]
    grads = {}
    for use_kernel in (True, False):
        args = [t.clone().requires_grad_(True)
                for t in mlp_inputs(dev, torch.float32, 33, lead, 7)]
        g = torch.Generator(device=dev).manual_seed(8)
        outs = (MK.mlp_fused(*args) if use_kernel else MK.mlp_ref(*args))
        sum((o * torch.randn(o.shape, generator=g, device=dev)).sum()
            for o in outs).backward()
        grads[use_kernel] = [a.grad for a in args]
    torch.cuda.synchronize()
    g_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(grads[True], grads[False]))
    phase("mlp-grad", t0, f"d(loss)/d(S, ga, w1k, b1, w2, b2) through "
          f"mlp_fused (kernel forward) vs autograd through mlp_ref at "
          f"{tuple(lead)}: rel to max {g_rel:.3e} (limit {DA_RTOL})")
    if not g_rel <= DA_RTOL:
        fail(f"the MLP's gradient through the kernel departs: {g_rel:.3e}")
    return errs


def batched_phases(dev, model, x, h, A0, alive_ref: float) -> dict:
    """The batched-lane path at inference: the gecko on bfloat16 pair
    tables, BATCH_B rollouts of STEPS steps at fire_rate 0.5 with a
    bfloat16 update MLP (counters reset just before and read just after);
    then CHECK_STEPS steps at fire_rate 1.0 with the kernels against the
    plain versions, and the batched rollout against BATCH_B unbatched
    rollout_cells runs; ms per batched step. Returns the path's launch
    counts."""
    t0 = time.time()
    t1 = time.time()
    beng = build_cell_engine(x, h, pair_tables="bfloat16", device=dev)
    torch.cuda.synchronize()
    build_s = time.time() - t1
    st = tab_stats(beng)
    SB0 = batched_scatter(beng, A0[None].expand(BATCH_B, -1, -1))
    reset_launches()
    t1 = time.time()
    with torch.no_grad():
        SBf = rollout_cells_batched(
            model.params, model.cfg, beng, SB0, BATCH_B,
            torch.Generator(device=dev).manual_seed(SEED), STEPS, h,
            fire_rate=0.5, mlp_dtype="bfloat16")
    torch.cuda.synchronize()
    secs = time.time() - t1
    launches = read_launches()
    want = {**NO_LAUNCHES, "sph_fwd_tab_kernel": 2 * STEPS,
            "sph_mask_tab_kernel": 2 * STEPS, "sph_mlp_kernel": STEPS}
    Af = batched_gather_back(beng, SBf, BATCH_B)
    alive = [float(a) for a in (Af[..., 3] > 0.1).float().mean(-1)]
    print(f"  engine with bfloat16 tables: C={beng.num_cells}, blocks x W "
          + " + ".join(f"{nb} x {w}" for nb, w in st["buckets"])
          + f", tables {st['bytes'] / 1e6:.1f} MB, built in {build_s:.2f} s",
          flush=True)
    print(f"  launches {launches}", flush=True)
    phase("batched", t0, f"gecko, B={BATCH_B}, {STEPS} steps at fire_rate "
          f"0.5, bfloat16 tables and MLP, in {secs:.2f} s "
          f"({secs * 1e3 / STEPS:.4f} ms a step): alive share per sample "
          + " ".join(f"{a:.4f}" for a in alive)
          + f" (unbatched CLI {alive_ref:.4f}, limit +-{ALIVE_ATOL})")
    if launches != want:
        fail(f"batched launch counts {launches}, expected {want}")
    if not bool(torch.isfinite(Af).all()):
        fail("non-finite states in the batched rollout")
    if not all(abs(a - alive_ref) <= ALIVE_ATOL for a in alive):
        fail(f"the batched gecko did not grow as the unbatched one: {alive}")

    t0 = time.time()
    cfg1 = dataclasses.replace(model.cfg, fire_rate=1.0)
    diffs, shares = {}, {}
    with torch.no_grad():
        for mlp_dtype in (None, "bfloat16"):
            outs = [rollout_cells_batched(
                model.params, cfg1, beng, SBf, BATCH_B,
                torch.Generator(device=dev).manual_seed(SEED), CHECK_STEPS,
                h, fire_rate=1.0, mlp_dtype=mlp_dtype, use_kernels=uk)
                for uk in (True, False)]
            gap = (outs[0] - outs[1]).abs()
            diffs[mlp_dtype] = float(gap.max())
            shares[mlp_dtype] = float((gap > ROLLOUT_ATOL).float().mean())
        one = [rollout_cells_batched(
            model.params, cfg1, beng, SBf, BATCH_B,
            torch.Generator(device=dev).manual_seed(SEED), 1, h,
            fire_rate=1.0, mlp_dtype="bfloat16", use_kernels=uk)
            for uk in (True, False)]
        gap1 = (one[0] - one[1]).abs()
        share1 = float((gap1 > ROLLOUT_ATOL).float().mean())
        per = max(float((batched_gather_back(beng, outs_f32, BATCH_B)[b]
                         - beng.gather_back(rollout_cells(
                             model.params, cfg1, beng, beng.scatter(Af[b]),
                             torch.Generator(device=dev).manual_seed(SEED),
                             CHECK_STEPS, h, fire_rate=1.0))).abs().max())
                  for outs_f32 in [rollout_cells_batched(
                      model.params, cfg1, beng, SBf, BATCH_B,
                      torch.Generator(device=dev).manual_seed(SEED),
                      CHECK_STEPS, h, fire_rate=1.0)]
                  for b in range(BATCH_B))
    phase("batched-check", t0, f"{CHECK_STEPS} steps at fire_rate 1.0 from "
          f"the grown states: kernels vs plain versions, max state "
          f"difference {diffs[None]:.3e} with a float32 MLP (limit "
          f"{ROLLOUT_ATOL}), {diffs['bfloat16']:.3e} with a bfloat16 MLP "
          f"(a hidden unit's bfloat16 rounding may differ; share of state "
          f"values past {ROLLOUT_ATOL}: {shares['bfloat16']:.3e}, after one "
          f"step {share1:.3e} (max {float(gap1.max()):.3e}), limit "
          f"{BF16_STEP_SHARE}); the "
          f"B={BATCH_B} rollout vs {BATCH_B} unbatched rollout_cells runs: "
          f"{per:.3e} (limit {ROLLOUT_ATOL})")
    if not (diffs[None] <= ROLLOUT_ATOL and per <= ROLLOUT_ATOL
            and share1 <= BF16_STEP_SHARE):
        fail(f"batched rollout kernels vs plain {diffs} (bfloat16 MLP, one "
             f"step: {share1:.3e} of the states past {ROLLOUT_ATOL}), vs "
             f"unbatched {per}")

    step_ms = {}
    with torch.no_grad():
        for uk in (True, False):
            gen = torch.Generator(device=dev).manual_seed(SEED)
            rollout_cells_batched(model.params, model.cfg, beng, SB0,
                                  BATCH_B, gen, 4, h, fire_rate=0.5,
                                  mlp_dtype="bfloat16", use_kernels=uk)
            torch.cuda.synchronize()
            t1 = time.time()
            rollout_cells_batched(model.params, model.cfg, beng, SB0,
                                  BATCH_B, gen, STEPS, h, fire_rate=0.5,
                                  mlp_dtype="bfloat16", use_kernels=uk)
            torch.cuda.synchronize()
            step_ms[uk] = (time.time() - t1) * 1e3 / STEPS
    print(f"  batched gecko step (B={BATCH_B}): {step_ms[True]:.4f} ms with "
          f"the kernels, {step_ms[False]:.4f} ms with the plain versions "
          "(host clock around synchronize)", flush=True)
    return launches


# ---- the band engine (ops/bands.py): the default engine of both CLIs --------
#
# Its pair passes are torch.bmm products over static tables (the JAX package
# multiplies them outside Pallas too); the batched step's update MLP is
# kernel 2.8. The band paths launch no pair-table kernel.

# band passes against the cell engine's plain versions on the same positions
# (float32 tables: the same products summed in another order), and the card
# route against the CPU plain version (float32 sums of the same products).
# The gradient is sigma_g sum_j md_ij X_j - X_i gsum_i; each engine's gsum is
# the float32 sum of its own table's md entries, which nearly cancel (the
# spiky vectors of a full neighbourhood), so the two engines' gsums differ by
# their float32 roundings. Against the cell engine the moments
# sigma_g sum_j md_ij X_j (the gradient with each engine's self term added
# back) are held to BAND_RTOL and the whole gradient's gap is printed. The
# whole float32 band gradient is held to BAND_RTOL against gradient_f64, a
# float64 gradient from the same pairs with no table and no gsum (on the
# CPU at the bench shape, B = 1: the band engine 4.6e-7 of max from it, the
# cell engine 1.23e-5: the gap between the engines is the cell engine's
# self term). The card route against its CPU version shares the gsum and
# holds the whole gradient.
BAND_RTOL = 1e-5
# volume_consistency, sigma_W sum_w W v_w, is 1 wherever the neighbours'
# volumes equal a row's own: its median over real rows, within this of 1;
# on the closed bench sphere every row (a plane's boundary rows differ)
VOL_MEDIAN_ATOL = 1e-3
VOL_SPHERE_ATOL = 1e-2
WENDLAND_ITERS = 3


def bench_h() -> float:
    """bench.py's h for BENCH_NEIGHBOURS neighbours on the bench sphere."""
    return float(np.sqrt(BENCH_NEIGHBOURS * 4.0 * np.pi * BENCH_RADIUS ** 2
                         / BENCH_N / np.pi))


def band_stats(eng) -> str:
    """One line of a band engine's shape and table bytes."""
    band_b, far_b = eng.table_bytes()
    buckets = ", ".join(f"{int(b.shape[0])} x {int(g.shape[1])}"
                        for b, g in zip(eng.far_blocks, eng.far_groups))
    return (f"nb={eng.num_cells} P={eng.slots_per_cell}, "
            f"{int(eng.nbr_count.sum())} pairs within h, "
            f"{len(eng.far_tabs)} far buckets (blocks x groups of "
            f"{eng.far_group_size}): {buckets}; "
            f"{str(eng.Tband.dtype).split('.')[-1]} band table "
            f"{band_b / 1e6:.1f} MB + far tables {far_b / 1e6:.1f} MB")


def band_states(rng, bsz: int, n: int, dev) -> torch.Tensor:
    """[bsz, n, 16] normal states with the alpha lane uniform in [0, 0.3],
    0.005 away from the alive threshold."""
    A = rng.normal(size=(bsz, n, 16)).astype(np.float32)
    a = rng.uniform(0.0, 0.3, (bsz, n))
    A[..., 3] = np.where(np.abs(a - 0.1) < 0.005, 0.12, a)
    return torch.from_numpy(A).to(dev)


def band_passes(eng, A, X, cell: bool) -> dict:
    """Perception (gradient and pre-step mask), the post-update mask (alpha
    on and off) and the blur of A [B, N, 16] / X [B, N, 4] in particle
    order, through the engine seam (a cell engine's plain versions)."""
    from sph_nca_tpu_torch.ops import batched as BT

    S = eng.scatter(A)
    kw = {"use_kernels": False} if cell else {}
    ga, sm = BT.perceive_samples(eng, S, True, **kw)
    ga = eng.gather_back(ga)
    d = eng.gsum.shape[-1]
    gsum = eng.gather_back(eng.gsum).repeat_interleave(A.shape[-1], -1)
    return {"gradient": ga, "moments": ga + A.repeat(1, 1, d) * gsum,
            "pre-mask": eng.gather_back(sm[..., None]),
            "mask": eng.gather_back(BT.mask_blur_samples(
                eng, S, True, **kw)[..., None]),
            "mask (no alpha)": eng.gather_back(BT.mask_blur_samples(
                eng, S, False, **kw)[..., None]),
            "blur": eng.gather_back(BT.blur_samples(eng, eng.scatter(X),
                                                    **kw))}


def band_gap(got: dict, want: dict) -> dict:
    """Largest difference of each pass, relative to the largest output."""
    out = {}
    for k, w in want.items():
        w = w.float().to(got[k].device)
        out[k] = float((got[k].float() - w).abs().max()) / max(
            float(w.abs().max()), 1e-30)
    return out


def gradient_f64(x, h: float, A: torch.Tensor) -> torch.Tensor:
    """The SPH gradient sigma_g sum_j md_ij (A_j - A_i) of A [B, N, F] in
    float64, [B, N, D*F] d-major in particle order on A's device: the true
    pairs of x from the native scan, poly6 volumes v = 1 / (sigma_W sum_j
    W_ij) and spiky md_ij = mag(r_ij) dx_ij v_j, every sum in float64. No
    table and no gsum: an independent witness of both engines' float32
    gradients."""
    from sph_nca_tpu_torch.ops import kernels as KN

    x = np.asarray(x, np.float64)
    n, d = x.shape
    pi, pj, dx, d2, w6sum, _ = native.true_pairs(x, float(h))
    sig_w = float(KN.get_smoothing_kernel("poly6").norm(h, d))
    sig_g = float(KN.get_gradient_kernel("spiky").norm(h, d))
    v = 1.0 / (sig_w * w6sum)
    d2 = d2.astype(np.float64)
    dist = np.sqrt(np.where(d2 > 0.0, d2, 1.0))
    mag = np.where(d2 > 0.0, 3.0 * (h - dist) ** 2 / dist, 0.0)
    dev = A.device
    md = torch.from_numpy(mag[:, None] * dx.astype(np.float64)
                          * v[pj][:, None]).to(dev)  # [E, D]
    pi = torch.from_numpy(pi.astype(np.int64)).to(dev)
    pj = torch.from_numpy(pj.astype(np.int64)).to(dev)
    out = []
    for a in A.double():
        g = a.new_zeros((n, d, a.shape[-1]))
        g.index_add_(0, pi, md[:, :, None] * (a[pj] - a[pi])[:, None, :])
        out.append(sig_g * g.reshape(n, -1))
    return torch.stack(out)


def band_build_phase(dev, smi) -> dict:
    """The band engine at the gecko inference grid (bfloat16 tables), the
    train CLI's defaults (float32) and bench.py's configuration (bfloat16):
    shapes, far buckets, table bytes, build seconds; on each, the band
    passes with float32 tables against the cell engine's plain versions on
    the same positions (particle order), the path's own engine on the card
    against its plain CPU version, and volume_consistency. Returns the
    engines by label."""
    from sph_nca_tpu_torch.ops.bands import build_band_engine

    t0 = time.time()
    model_h = load_weights_json(GECKO, device=dev).h
    x2 = grange((IMAGE, IMAGE), (-1.0, -1.0), (2.0, 2.0)).reshape(-1, 2)
    plane = torch.nn.functional.pad(x2, (0, 1)).numpy()
    shapes = {"gecko": (plane, model_h, "bfloat16"),
              "train": (plane, TRAIN_H, "float32"),
              "bench": (fibonacci_sphere(BENCH_N, BENCH_RADIUS), bench_h(),
                        "bfloat16")}
    engines, lines = {}, []
    rng = np.random.default_rng(SEED)
    for label, (x, h, dtype) in shapes.items():
        t1 = time.time()
        eng = build_band_engine(x, h, table_dtype=dtype, device=dev)
        torch.cuda.synchronize()
        build_s = time.time() - t1
        engines[label] = eng
        n = x.shape[0]
        A = band_states(rng, BATCH_B, n, dev)
        X = normal_cuda(rng, (BATCH_B, n, 4), dev)
        # float32 band passes against the cell engine's plain versions
        e32 = eng if dtype == "float32" else build_band_engine(
            x, h, table_dtype="float32", device=dev)
        ceng = build_cell_engine(x, h, pair_tables="float32", device=dev)
        with torch.no_grad():
            got32 = band_passes(e32, A, X, False)
            cell32 = band_passes(ceng, A, X, True)
            cell_gap = band_gap(got32, cell32)
            ref = {"gradient": gradient_f64(x, h, A)}
            f64_gap = {k: band_gap({"gradient": g["gradient"]}, ref)[
                "gradient"] for k, g in (("band", got32), ("cell", cell32))}
        del e32, ceng, got32, cell32, ref
        torch.cuda.empty_cache()
        # the path's engine on the card against its plain CPU version
        with torch.no_grad():
            route_gap = band_gap(
                band_passes(eng, A, X, False),
                band_passes(eng.to("cpu"), A.cpu(), X.cpu(), False))
        vc = eng.volume_consistency()[eng.vs > 0]
        med = float(vc.median())
        dev1 = float((vc - 1.0).abs().max())
        within = float(((vc - 1.0).abs() <= 0.01).float().mean())
        lines.append(f"{label} (N={n}, h={h:.6f}): {band_stats(eng)}; "
                     f"built in {build_s:.2f} s")
        print(f"  {lines[-1]}", flush=True)
        print(f"    float32 band vs cell engine (plain), rel to max: "
              + ", ".join(f"{k} {v:.3e}" for k, v in cell_gap.items()),
              flush=True)
        print(f"    float32 gradient vs the float64 gradient of the same pairs "
              f"(gradient_f64), rel to max: band {f64_gap['band']:.3e} "
              f"(limit {BAND_RTOL}), cell engine {f64_gap['cell']:.3e}",
              flush=True)
        print(f"    {dtype} card route vs CPU plain, rel to max: "
              + ", ".join(f"{k} {v:.3e}" for k, v in route_gap.items()),
              flush=True)
        print(f"    volume_consistency on real rows: median {med:.6f}, "
              f"largest |v - 1| {dev1:.4f}, share within 1% {within:.4f}",
              flush=True)
        worst = max([v for k, v in cell_gap.items() if k != "gradient"]
                    + list(route_gap.values()) + [f64_gap["band"]])
        if not worst <= BAND_RTOL:
            fail(f"band passes at the {label} shape: {cell_gap} against the "
                 f"cell engine, {route_gap} against the CPU, the gradient "
                 f"{f64_gap['band']} against gradient_f64")
        if not (abs(med - 1.0) <= VOL_MEDIAN_ATOL
                and (label != "bench" or dev1 <= VOL_SPHERE_ATOL)):
            fail(f"volume_consistency at the {label} shape: median {med}, "
                 f"largest |v - 1| {dev1}")
    phase("band-build", t0, "band engines: " + "; ".join(lines)
          + f"; band passes == the cell engine's plain versions (float32, "
          f"B={BATCH_B}; the gradient's moments, the whole gradient's gap "
          f"printed), the whole float32 band gradient == its float64 "
          f"reference from the same pairs and the card route == CPU plain "
          f"within {BAND_RTOL} of "
          f"max; volume_consistency median within {VOL_MEDIAN_ATOL} of 1 "
          f"| {smi}")
    return engines


def band_mlp_phase(dev, smi, engines: dict) -> dict:
    """Kernel 2.8 against mlp_ref at the lead shapes [B, nb, P] the band
    paths give it: band-train (B = TRAIN_B, float32 on the path),
    band-inference (the gecko, B = 1, bfloat16) and band-bench (B =
    BATCH_B, bfloat16), both dtypes at each; then its device time at the
    band-train (float32) and band-bench (bfloat16) shapes beside its bound
    and the library chain (``mlp_times`` by CUDA events: this phase runs
    after the profiled surface phases). Returns (the largest absolute
    error per (label, dtype), the times by label)."""
    t0 = time.time()
    shapes = {f"band-{label}": (bsz, engines[name].num_cells,
                                engines[name].slots_per_cell)
              for label, name, bsz in (("train", "train", TRAIN_B),
                                       ("inference", "gecko", 1),
                                       ("bench", "bench", BATCH_B))}
    errs = mlp_shape_checks(dev, shapes)
    times = {}
    for label, dtype in (("band-train", torch.float32),
                         ("band-bench", torch.bfloat16)):
        t = mlp_times(dev, shapes[label], dtype, events=True)
        print(f"  {mlp_times_line(label, shapes[label], dtype, t)} (CUDA "
              "events)", flush=True)
        times[label] = {
            "shapes": f"{label} {shapes[label]} {str(dtype)[6:]} inputs",
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}}
    phase("band-mlp", t0, "sph_mlp_kernel == mlp_ref at the band paths' "
          "shapes " + ", ".join(f"{label} {lead}"
                                for label, lead in shapes.items())
          + f", gated and orig, float32 / bfloat16 within "
          f"{MLP_RTOL[torch.float32]} / {MLP_RTOL[torch.bfloat16]} of max, "
          f"all but {MLP_FLIP_SHARE} of the outputs within 1e-5 of max; "
          "device time at the band-train / band-bench shapes: "
          + ", ".join(f"{label} {t['ms']:.4f} ms (bound {t['bound_ms']:.4f} "
                      f"ms by {t['bound_by']}, library chain "
                      f"{t['library_ms']:.4f} ms)"
                      for label, t in times.items()) + f" | {smi}")
    return errs, times


def readout_weights(block: int, dev):
    """Orig-rule weights (K = 16, hid = 32) whose output is the MLP's input
    block ``block`` (0: bf16(S), 1: the tangent projection, 2: the
    bitangent's) exactly: relu(x) - relu(-x), every product by 1 or 0."""
    w1k = torch.zeros(48, 32)
    w2 = torch.zeros(32, 16)
    for i in range(16):
        w1k[16 * block + i, i], w1k[16 * block + i, 16 + i] = 1.0, -1.0
        w2[i, i], w2[16 + i, i] = 1.0, -1.0
    return (w1k.bfloat16().to(dev), torch.zeros(32, device=dev),
            w2.bfloat16().to(dev), torch.zeros(16, device=dev))


def ulps(got, want) -> torch.Tensor:
    """|got - want| in units of want's last place (float32)."""
    top = torch.nextafter(want.abs(), torch.full_like(want, float("inf")))
    return (got - want).abs() / (top - want.abs())


def work_fused(mom, S, gsum, nd, td, u, weights):
    """Bytes and operations of one fused launch from its inputs: each read
    once (the moments, the state, the self term, the frame, the draws, the
    weights; the normals and the self term are shared by the samples), the
    state written once (~243 B a row); the MLP's multiply-adds two
    operations each."""
    ins = [mom, S, gsum, *nd, *td, u, *weights]
    nbytes = (sum(t.numel() * t.element_size() for t in ins)
              + S.numel() * S.element_size())
    hid, k = weights[0].shape[1], weights[2].shape[1]
    return nbytes, u.numel() * 2 * (48 * hid + hid * k)


def band_fused_phase(dev, rng, smi, eng) -> dict:
    """[band-fused]: kernel 2.8's fused variant (``MK.fused_update``, the
    surface rollouts' update without a gradient) at the band bench shape
    [BENCH_B, nb, P] against the composition it replaces (``bands.
    band_gradient``, ``MK.project_td``, ``cell_step._update_samples`` with
    2.8), from the bench engine's moments of band states, the sphere's
    normals and tangents as one diffusion leaves them: the orig rule's
    state bit-equal, the gated state within FUSED_ULPS, rows that do not
    fire unchanged; with readout weights, each block of the MLP's input rows
    bit-equal. Then its time by CUDA events beside its bound from the run's
    inputs, its plain version and the composition. Returns the kernels
    line's entry."""
    from sph_nca_tpu_torch.models.nca import SPHNCAConfig, init_params
    from sph_nca_tpu_torch.models.surface import (
        _diffuse_td,
        normal_components,
    )
    from sph_nca_tpu_torch.ops import bands as BD

    t0 = time.time()
    h = bench_h()
    x = fibonacci_sphere(BENCH_N, BENCH_RADIUS)
    S = eng.scatter(band_states(rng, BENCH_B, BENCH_N, dev))
    nrm = torch.from_numpy(sphere_normals(x)).to(dev)
    nd = normal_components(eng.scatter(nrm))
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    T0 = orthogonalize(nrm, normalize(torch.randn(BENCH_B, BENCH_N, 3,
                                                  generator=g, device=dev)))
    with torch.no_grad():
        td = _diffuse_td(eng, nd, normal_components(eng.scatter(T0)), S)
        mom, _ = BD.perceive_band_moments(eng, S, True, torch.bfloat16)
    if td[0].is_contiguous():
        fail(f"band-fused: the diffusion left contiguous tangents, strides "
             f"{td[0].stride()}")
    u = torch.rand(S.shape[:-1], generator=g, device=dev)
    rate = 0.5
    models = {}
    for rule in ("gated", "orig"):
        cfg = SPHNCAConfig(update_rule=rule, normalize_perception=1.0 / h)
        params = init_params(cfg, torch.Generator().manual_seed(SEED),
                             device=dev)
        models[rule] = (cfg, cell_step._mlp_weights(params, cfg, 16, h,
                                                    "bfloat16"))

    def fused(cfg, weights, rate):
        return MK.fused_update(mom, S, eng.gsum, eng.sig_g, nd, td, weights,
                               u, rate, cfg.fire_rate / rate)

    def composition(cfg, weights, rate):
        ga = BD.band_gradient(mom, S, eng.gsum, eng.sig_g)
        xin = MK.project_td(ga, nd, td, include_normal=False)
        return cell_step._update_samples(cfg, weights, S, xin, u, rate,
                                         True), xin

    def plain(cfg, weights, rate):
        return MK.fused_update_ref(mom, S, eng.gsum, eng.sig_g, nd, td,
                                   weights, u, rate, cfg.fire_rate / rate)

    reset_launches()
    errs, lines = {}, []
    with torch.no_grad():
        for rule, (cfg, weights) in models.items():
            got = fused(cfg, weights, rate)
            want, _ = composition(cfg, weights, rate)
            gap = ulps(got, want)
            errs[rule] = {"max_abs_err": float((got - want).abs().max()),
                          "max_ulps": float(gap.max()),
                          "ulps_over_0": float((gap > 0).float().mean())}
            still = u > rate
            kept = torch.equal(got[still], S[still])
            lines.append(f"{rule} (K={weights[2].shape[1]}): max abs "
                         f"{errs[rule]['max_abs_err']:.3e}, "
                         f"{errs[rule]['max_ulps']:.0f} ulps at most, "
                         f"{errs[rule]['ulps_over_0']:.3e} of the elements "
                         f"off; unfired rows kept {kept}")
            ok = (torch.equal(got, want) if rule == "orig"
                  else errs[rule]["max_ulps"] <= FUSED_ULPS)
            if not (ok and kept):
                fail(f"band-fused: the fused variant parts from the "
                     f"composition, {rule}: {errs[rule]}, unfired rows kept "
                     f"{kept}")
        cfg1 = SPHNCAConfig(update_rule="orig", fire_rate=1.0)
        for block in range(3):
            weights = readout_weights(block, dev)
            got = fused(cfg1, weights, 1.0)
            want, xin = composition(cfg1, weights, 1.0)
            rows = torch.cat([S.bfloat16(), xin.bfloat16()], -1)
            blk = rows[..., 16 * block:16 * (block + 1)].float()
            if not (torch.equal(want, S + blk) and torch.equal(got, want)):
                fail(f"band-fused: input block {block} of the fused variant "
                     f"is not the composition's, "
                     f"{float((got - want).abs().max()):.3e} apart")
    lines.append("the input rows' three blocks bit-equal (readout weights)")
    launches = read_launches()
    if launches != {**NO_LAUNCHES, FUSED: 5, "sph_mlp_kernel": 5}:
        fail(f"band-fused launch counts {launches}")

    cfg, weights = models["gated"]
    with torch.no_grad():
        ms = cuda_ms(lambda: fused(cfg, weights, rate), 20, 3)
        plain_ms = cuda_ms(lambda: plain(cfg, weights, rate), 20, 3)
        lib_ms = cuda_ms(lambda: composition(cfg, weights, rate), 20, 3)
    nbytes, ops = work_fused(mom, S, eng.gsum, nd, td, u, weights)
    bound_ms, bound_by = bound(nbytes, ops, BF16_FLOPS)
    lead = tuple(S.shape[:-1])
    phase("band-fused", t0, f"sph_mlp_kernel's fused variant (MK."
          f"fused_update) at the band bench shape {lead}, bfloat16 moments "
          f"and MLP, hid 256, tangents at strides {td[0].stride()} (one "
          f"diffusion), fire rate {rate}, against the composition with 2.8: "
          + "; ".join(lines) + f" (limits: orig bit-equal, gated "
          f"{FUSED_ULPS:.0f} ulps); {ms:.4f} ms by CUDA events (20 calls "
          f"after 3), bound {bound_ms:.4f} ms by {bound_by} "
          f"({100 * bound_ms / ms:.1f}% of it; {nbytes / 1e6:.2f} MB, "
          f"{nbytes / u.numel():.1f} B a row, {ops / 1e9:.3f} G operations), "
          f"plain version {plain_ms:.4f} ms, the composition (2.8 and the "
          f"PyTorch ops around it) {lib_ms:.4f} ms | {smi}")
    return {"shapes": f"band-bench {lead} bfloat16 moments and MLP",
            "max_abs_err": errs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "library": "the composition: "
            "band_gradient, project_td, 2.8, update_rule",
            "launches": {"band-fused": launches[FUSED]}}


def band_train_device(teng, x2):
    """Device us per BPTT step, traced wall us per BPTT step and the steps
    of one full-depth Trainer iteration on ``teng`` (after one warm-up);
    the breakdown by kernel with ``--profile``."""
    from torch.profiler import ProfilerActivity, profile

    trainer, pool = make_trainer(teng, x2)
    trainer.run_iteration(0, pool)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.time()
        trainer.run_iteration(1, pool)
        torch.cuda.synchronize()
        wall_us = (time.time() - t1) * 1e6
    n = trainer.last_steps
    dev_us = sum(getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
                 for ev in prof.key_averages()
                 if ev.device_type != torch.autograd.DeviceType.CPU)
    if "--profile" in sys.argv[1:]:
        device_breakdown(prof, wall_us, n, "BPTT step")
    return dev_us / n, wall_us / n, n


def band_train_ops(teng, x2):
    """A CPU-side profile with shapes of one full-depth Trainer iteration on
    ``teng`` (forward, recompute and backward), for ``band_table_copies``."""
    from torch.profiler import ProfilerActivity, profile

    trainer, pool = make_trainer(teng, x2)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        trainer.run_iteration(0, pool)
        torch.cuda.synchronize()
    return prof


def band_train_phase(dev, smi, teng, x2) -> int:
    """The train CLI at its defaults (now --engine band, float32 tables) for
    TRAIN_ITERS iterations: finite, falling losses, launch counts (kernel
    2.8 only), ms per iteration, peak memory; one full-depth iteration's
    device time per BPTT step; a --smoothing_kernel wendlandC2 run of
    WENDLAND_ITERS iterations. Returns 2.8's launches."""
    t0 = time.time()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as out_dir:
        reset_launches()
        rows = run_train_cli(out_dir, ["--training_iter", str(TRAIN_ITERS)],
                             engine="band")
        launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    losses = [r["loss"] for r in rows]
    steps = [r["steps"] for r in rows]
    want = expected_train_launches(steps, 0, tables=True)
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    iter_ms = [1e3 * r["seconds"] for r in rows]
    dev_us, wall_us, depth = band_train_device(teng, x2)
    copies = band_table_copies(band_train_ops(teng, x2), teng)
    with tempfile.TemporaryDirectory() as out_dir:
        wrows = run_train_cli(out_dir, ["--training_iter",
                                        str(WENDLAND_ITERS),
                                        "--smoothing_kernel", "wendlandC2"],
                              engine="band")
    wlosses = [r["loss"] for r in wrows]
    print(f"  losses {' '.join(f'{l:.4f}' for l in losses)}", flush=True)
    print(f"  rollout lengths {steps}; launches {launches}", flush=True)
    phase("band-train", t0, f"train CLI --engine band (float32 tables) "
          f"{TRAIN_ITERS} iterations: loss {first:.4f} (mean of first 5) -> "
          f"{last:.4f} (last 5), median {np.median(iter_ms):.1f} ms an "
          f"iteration over {sum(steps)} steps, kernel 2.8 "
          f"{launches['sph_mlp_kernel'] / sum(steps):.2f} launches a step "
          f"(remat recomputes each), peak device memory {peak_gb:.3f} GiB; "
          f"one full-depth iteration ({depth} BPTT steps, B={TRAIN_B}): "
          f"{dev_us:.2f} us of device time a BPTT step of {wall_us:.2f} us "
          f"traced ({100 * dev_us / wall_us:.1f}% busy), no copy or cast "
          f"of a table in an iteration with its backward; "
          f"--smoothing_kernel wendlandC2, {WENDLAND_ITERS} iterations: "
          f"losses {' '.join(f'{l:.4f}' for l in wlosses)} | {smi}")
    if len(rows) != TRAIN_ITERS or not all(np.isfinite(losses)):
        fail(f"band training losses not finite or missing: {losses}")
    if not last < first:
        fail(f"the band training loss did not fall: {first} -> {last}")
    if launches != want:
        fail(f"band training launch counts {launches}, expected {want}")
    if len(wrows) != WENDLAND_ITERS or not all(np.isfinite(wlosses)):
        fail(f"wendlandC2 training losses not finite: {wlosses}")
    if copies:
        fail(f"band training: {len(copies)} copies of a table in one "
             f"iteration, the first {copies[:3]}")
    return launches["sph_mlp_kernel"]


def band_inference_phase(dev, smi, model, x) -> int:
    """The test CLI's image mode on the gecko with --engine band, STEPS
    steps (bfloat16 band tables, the batched rollout at B = 1): launch
    counts, finite states, the gecko growing; then CHECK_STEPS steps at
    fire_rate 1.0 from the grown state on float32 band tables against the
    cell engine's rollout (kernels), and the bfloat16 band rollout's gap.
    Returns 2.8's launches."""
    from sph_nca_tpu_torch.ops.bands import build_band_engine

    t0 = time.time()
    with tempfile.TemporaryDirectory() as out_dir:
        reset_launches()
        t1 = time.time()
        rc = cli_test.main([
            "--weights_json", GECKO, "--image_size", str(IMAGE),
            "--steps", str(STEPS), "--firerate", "0.5", "--seed", str(SEED),
            "--output_dir", out_dir, "--device", "cuda", "--engine", "band"])
        torch.cuda.synchronize()
        secs = time.time() - t1
        launches = read_launches()
        if rc != 0:
            fail(f"test CLI --engine band returned {rc}")
        (run,) = os.listdir(out_dir)
        with np.load(os.path.join(out_dir, run, "states.npz")) as z:
            states = z["states"]
        frames = check_png_frames(os.path.join(out_dir, run), IMAGE,
                                  STEPS + 1, 4)
    if launches != {**NO_LAUNCHES, "sph_mlp_kernel": STEPS}:
        fail(f"band inference launch counts {launches}")
    if states.shape != (STEPS + 1, IMAGE * IMAGE, model.cfg.channels):
        fail(f"band inference trajectory shape {states.shape}")
    alive0 = float((states[0][:, 3] > 0.1).mean())
    alive = float((states[-1][:, 3] > 0.1).mean())
    if not (np.isfinite(states).all() and alive0 < alive < 0.5):
        fail(f"the band gecko did not grow: {alive0} -> {alive}")
    h = model.h
    cfg1 = dataclasses.replace(model.cfg, fire_rate=1.0)
    grown = torch.from_numpy(states[-1]).to(dev)[None]
    finals = {}
    with torch.no_grad():
        for label, eng in (
                ("band float32", build_band_engine(x, h, device=dev)),
                ("band bfloat16", build_band_engine(
                    x, h, table_dtype="bfloat16", device=dev)),
                ("cells float32", build_cell_engine(
                    x, h, pair_tables="float32", device=dev))):
            out = rollout_cells_batched(
                model.params, cfg1, eng, batched_scatter(eng, grown), 1,
                torch.Generator(device=dev).manual_seed(SEED), CHECK_STEPS,
                h, fire_rate=1.0)
            finals[label] = batched_gather_back(eng, out, 1)
    top = float(finals["cells float32"].abs().max())
    gap = float((finals["band float32"] - finals["cells float32"]).abs()
                .max()) / top
    gap16 = float((finals["band bfloat16"] - finals["band float32"]).abs()
                  .max()) / top
    alive16 = [float((finals[k][0, :, 3] > 0.1).float().mean())
               for k in ("band bfloat16", "band float32")]
    phase("band-inference", t0, f"test CLI --engine band, gecko "
          f"{IMAGE}x{IMAGE}, {STEPS} steps at fire_rate 0.5 in {secs:.2f} s "
          f"(bfloat16 band tables, B = 1, every state kept): launches "
          f"{launches}, alive fraction {alive0:.4f} -> {alive:.4f}, "
          f"{frames}; "
          f"{CHECK_STEPS} steps at fire_rate 1.0 from the grown state: band "
          f"(float32 tables) vs the cell engine's kernels {gap:.3e} of max "
          f"(limit {ROLLOUT_ATOL}); bfloat16 band tables vs float32 "
          f"{gap16:.3e} of max (printed; alive share {alive16[0]:.4f} vs "
          f"{alive16[1]:.4f}, limit +-{ALIVE_ATOL}) | {smi}")
    if not gap <= ROLLOUT_ATOL:
        fail(f"band rollout vs cell engine rollout: {gap:.3e} of max")
    if not abs(alive16[0] - alive16[1]) <= ALIVE_ATOL:
        fail(f"bfloat16 band rollout alive share {alive16}")
    return launches["sph_mlp_kernel"]


def band_pass_work(eng, cols: str, width: int, out_bytes: int) -> tuple:
    """Bytes and operations of one band pass over the table columns
    ``cols`` ("md" or "w6") with ``width`` right-hand columns: the column
    slice of the band and far tables read once in their stored type, the
    right-hand side once in the table dtype, the output written once
    (``out_bytes`` a value); a multiply-add for every pair within h and
    column (D for md)."""
    d, p = eng.dim, eng.slots_per_cell
    es = eng.Tband.element_size()
    frac = d / (d + 1) if cols == "md" else 1 / (d + 1)
    tabs = eng.Tband.numel() + sum(t.numel() for t in eng.far_tabs)
    rows = eng.num_cells * p
    nbytes = (frac * tabs * es + rows * width * es
              + rows * width * out_bytes * (d if cols == "md" else 1))
    ops = 2 * int(eng.nbr_count.sum()) * width * (d if cols == "md" else 1)
    return nbytes, ops


def band_table_copies(prof, eng) -> list:
    """Copy or cast ops in a profile whose input has the shape of a band
    or far table or of one of their column slices (a per-step copy of a
    table)."""
    shapes = set()
    for t in (eng.Tband,) + tuple(eng.far_tabs):
        n, w, cc = t.shape
        p = eng.slots_per_cell
        for c in (cc, eng.dim * p, p):
            shapes |= {(n, w, c), (n, c, w)}
    hits = []
    for ev in prof.events():
        if ev.name in ("aten::copy_", "aten::_to_copy", "aten::clone",
                       "aten::contiguous"):
            for s in ev.input_shapes or ():
                if tuple(s) in shapes:
                    hits.append((ev.name, tuple(s)))
    return hits


def profiled_ms(fn, calls: int):
    """Device ms per call of fn() summed over one profile's kernel records
    (printed only: profiles after the batched surface phases have lost
    records, see ``device_ms``), and the number of records."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if ev.device_type != torch.autograd.DeviceType.CPU]
    us = sum(getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0)) for ev in evs)
    return us / calls / 1e3, sum(ev.count for ev in evs)


def band_bench_phase(dev, rng, smi, eng, cell_pps: float) -> int:
    """bench.py's configuration on the band engine: BENCH_B rollouts,
    BENCH_STEPS steps, bfloat16 tables and MLP, ``rollout_mesh_batched``
    (the inputs of [surface-bench]): particle-steps per second (best of 3),
    the device's busy share, peak memory, beside the cell engine's; the
    products a step and no per-step copy of a table (a profile with
    shapes); each band pass's time at this shape beside its byte bound and
    the permuting copy into lanes. Returns the launches of 2.8's fused
    variant, which takes every step's update here."""
    from torch.profiler import ProfilerActivity, profile

    from sph_nca_tpu_torch.models.nca import SPHNCAConfig, init_params
    from sph_nca_tpu_torch.ops import bands as BD

    t0 = time.time()
    h = bench_h()
    x = fibonacci_sphere(BENCH_N, BENCH_RADIUS)
    cfg = SPHNCAConfig(normalize_perception=1.0 / h)
    params = init_params(cfg, torch.Generator().manual_seed(SEED), device=dev)
    nrm = torch.from_numpy(sphere_normals(x)).to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    A0 = torch.rand(BENCH_B, BENCH_N, cfg.channels, generator=g, device=dev)
    T0 = orthogonalize(nrm, normalize(torch.randn(BENCH_B, BENCH_N, 3,
                                                  generator=g, device=dev)))

    def run(steps, seed):
        return rollout_mesh_batched(
            params, cfg, eng, A0, nrm, T0,
            torch.Generator(device=dev).manual_seed(seed), steps, h,
            mlp_dtype="bfloat16")

    secs = []
    with torch.no_grad():
        run(4, SEED)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for i in range(3):
            if i == 0:
                reset_launches()
            t1 = time.time()
            fA, fT = run(BENCH_STEPS, SEED + i)
            torch.cuda.synchronize()
            secs.append(time.time() - t1)
            if i == 0:
                launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        busy, wall, recs, held = busy_share(lambda: run(16, SEED), 16)
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as prof:
            run(2, SEED)
            torch.cuda.synchronize()
    bmm = sum(ev.count for ev in prof.key_averages()
              if ev.key == "aten::bmm") / 2
    copies = band_table_copies(prof, eng)
    if launches != {**NO_LAUNCHES, FUSED: BENCH_STEPS}:
        fail(f"band bench launch counts {launches}")
    if not (bool(torch.isfinite(fA).all()) and bool(torch.isfinite(fT).all())
            and float(fT.norm(dim=-1).max()) <= 1.0 + 1e-5):
        fail("band bench: non-finite states or tangents off unit length")
    nfar = len(eng.far_tabs)
    if bmm != 4 * (1 + nfar) or copies:
        fail(f"band bench: {bmm} products a step, expected {4 * (1 + nfar)}"
             f" (each table slice read once a pass); {len(copies)} copies "
             f"of a table, the first {copies[:3]}")
    pps = [BENCH_B * BENCH_N * BENCH_STEPS / s for s in secs]
    phase("band-bench", t0, f"bench.py's configuration on the band engine: "
          f"{BENCH_N} points, h={h:.6f}, B={BENCH_B}, {BENCH_STEPS} steps, "
          f"bfloat16 tables and MLP: {max(pps):.4e} particle-steps/s (best of"
          f" 3; " + ", ".join(f"{p:.4e}" for p in pps) + f"; "
          f"{min(secs) * 1e3 / BENCH_STEPS:.4f} ms a step) beside the cell "
          f"engine's {cell_pps:.4e} in [surface-bench] "
          f"({max(pps) / cell_pps:.3f}x); device busy {busy:.2f} of "
          f"{wall:.2f} us a step traced ({100 * busy / wall:.1f}%; {recs} "
          f"device records, the port's kernels' equal to their launches "
          f"{held}); peak device memory {peak_gb:.3f} GiB (tables "
          f"included); {bmm:.0f} torch.bmm a step (4 passes x (1 band + "
          f"{nfar} far buckets)), no copy or cast of a table; launches "
          f"{launches} | {smi}")
    del fA, fT

    # each band pass at this shape: CUDA events around 20 calls, beside its
    # byte bound, and the permuting copy of the state into lanes
    t0 = time.time()
    S = band_states(rng, BENCH_B, BENCH_N, dev)
    Sb = eng.scatter(S)
    Xb = eng.scatter(normal_cuda(rng, (BENCH_B, BENCH_N, 4), dev))
    passes = {
        "perception (md + w6)": (
            lambda: BD.perceive_band_samples(eng, Sb, True, "bfloat16"),
            [("md", 16 * BENCH_B, 2), ("w6", BENCH_B, 4)], 2),
        "post-update mask (w6)": (
            lambda: BD.mask_blur_band_samples(eng, Sb, True),
            [("w6", BENCH_B, 4)], 1),
        "diffusion blur (w6, K = 4)": (
            lambda: BD.blur_band_samples(eng, Xb),
            [("w6", 4 * BENCH_B, 4)], 1),
        "state into lanes (bfloat16)": (
            lambda: BD._to_lanes(Sb, eng.Tband.dtype), [], 0)}
    with torch.no_grad():
        for label, (fn, parts, npass) in passes.items():
            ms = cuda_ms(fn, 20, 3)
            dev_ms, recs = profiled_ms(fn, 5)
            if parts:
                work = [band_pass_work(eng, *p) for p in parts]
                bound_ms, bound_by = bound(sum(w[0] for w in work),
                                           sum(w[1] for w in work),
                                           BF16_FLOPS)
                extra = (f"bound {bound_ms:.4f} ms by {bound_by} "
                         f"({100 * bound_ms / ms:.1f}% of it), "
                         f"{npass * (1 + nfar)} torch.bmm a call")
            else:
                nbytes = Sb.numel() * (4 + eng.Tband.element_size())
                extra = (f"bound {1e3 * nbytes / HBM_BYTES_PER_S:.4f} ms by "
                         f"bytes (float32 read, bfloat16 written)")
            print(f"  {label}: {ms:.4f} ms by CUDA events (device time "
                  f"{dev_ms:.4f} ms in one profile of 5 calls, {recs} "
                  f"records), {extra}", flush=True)
    phase("band-bench-passes", t0, "each band pass at the bench shape "
          "(bfloat16 tables, B = 8), CUDA events around 20 calls after 3 "
          "(host gaps included: the passes are host-bound) and the "
          f"profiler's device time | {smi}")
    return launches[FUSED]


def band_surface_cli_phase(dev, smi) -> dict:
    """The test CLI's surface mode with --engine band on the procedural
    mesh of [surface-cli], SURF_N points, SURF_STEPS steps: stripes (the
    random seed, pre-diffused on a float32 band engine at radius 0.2) and
    gecko (radial seeds): the trajectory, the PLY files, kernel 2.8's
    launches and nothing else. Returns each run's 2.8 launches."""
    t0 = time.time()
    runs = {"stripes-random": STRIPES, "gecko-radial": GECKO}
    every = 16
    counts, lines = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        obj = write_mesh_obj(os.path.join(tmp, "bumpy.obj"))
        for label, weights in runs.items():
            out_dir = os.path.join(tmp, label)
            reset_launches()
            t1 = time.time()
            rc = cli_test.main([
                "--weights_json", weights, "--surface", obj,
                "--surface_numpoints", str(SURF_N), "--steps",
                str(SURF_STEPS), "--export_every", str(every), "--seed",
                str(SEED), "--device", "cuda", "--output_dir", out_dir,
                "--engine", "band"])
            torch.cuda.synchronize()
            secs = time.time() - t1
            launches = read_launches()
            if rc != 0:
                fail(f"band surface CLI ({label}) returned {rc}")
            if launches != {**NO_LAUNCHES, "sph_mlp_kernel": SURF_STEPS}:
                fail(f"band surface CLI ({label}) launches {launches}")
            counts[label] = launches["sph_mlp_kernel"]
            (run,) = os.listdir(out_dir)
            run = os.path.join(out_dir, run)
            with np.load(os.path.join(run, "states.npz")) as z:
                x, states = z["x"], z["states"]
            if (x.shape != (SURF_N, 3)
                    or states.shape != (SURF_STEPS + 1, SURF_N, 16)
                    or not np.isfinite(states).all()
                    or np.abs(x).max() > 1 + 1e-5):
                fail(f"band surface CLI ({label}): shapes {x.shape} "
                     f"{states.shape}, non-finite states or points off the "
                     "normalized mesh")
            names = sorted(f for f in os.listdir(run) if f.endswith(".ply"))
            if names != [f"{i:04d}.ply"
                         for i in range(0, SURF_STEPS + 1, every)]:
                fail(f"band surface CLI ({label}) PLY files {names}")
            for name in names:
                pts, rgba = load_ply_points(os.path.join(run, name))
                if not (np.array_equal(pts, x) and rgba.shape == (SURF_N,
                                                                  4)):
                    fail(f"band surface CLI ({label}) {name}: wrong points")
            live = [float((np.abs(states[k]).max(-1) > 0).mean())
                    for k in (0, SURF_STEPS)]
            lines.append(f"{label} {secs:.2f} s, {len(names)} PLY files, "
                         f"share of points not 0 at steps 0 and "
                         f"{SURF_STEPS}: {live[0]:.4f} {live[1]:.4f}")
    phase("band-surface-cli", t0, f"test CLI --surface --engine band on the "
          f"procedural mesh, {SURF_N} points, {SURF_STEPS} steps: "
          + "; ".join(lines) + f"; kernel 2.8 {SURF_STEPS} launches a run, "
          f"no pair-table kernel | {smi}")
    return counts


# ---- the texture slice: OT training, checkpoints, resume, the eval CLI ------

ASSETS = os.path.join(ROOT, "sph_nca_tpu_torch", "assets")
DOTTED = os.path.join(ASSETS, "dotted_synth_64.npy")
OT_CHECKPOINT = os.path.join(ASSETS, "ot_gabor_dotted_800")
FACE = os.path.join(ASSETS, "face_target_64.npy")
FACE_CHECKPOINT = os.path.join(ASSETS, "gecko_full_8000")
# runs/ot_gabor_dotted's configuration (its meta.json): 64x64 wrapped plane,
# h = 0.08, batch 4 from a pool of 128, rollouts of 24-36 steps
TEX_SIDE, TEX_TARGET, TEX_B, TEX_POOL, TEX_RANGE = 64, 64, 4, 128, "24,36"
TEX_ITERS, TEX_EVERY, TEX_RESUME, TEX_CELL_ITERS = 200, 100, 20, 20
# the JAX CLI's losses on this configuration, runs/ot_gabor_dotted/
# metrics-08181219.jsonl (iterations 0 and 50 re-run with the JAX CLI on
# a CPU: 1.024338, 0.109115); the port draws its own streams, so levels are
# compared: the loss at 150 within TEX_LOSS_FACTOR of JAX's
TEX_JAX_LOSSES = {0: 1.0243384838104248, 50: 0.10901100933551788,
                  100: 0.07447541505098343, 150: 0.06828755885362625}
TEX_BAR_ITER, TEX_LOSS_FACTOR = 150, 2.0
TEX_CLI_STEPS, TEX_SURF_N = 128, 6400
# runs/ot_gabor_dotted/texture_eval_800.json: the JAX package's texture_eval
# of the 800-iteration checkpoint ((density, jitter) -> spectrum, colour L1)
TEX_EVAL_JAX = {(1.0, 0.0): (0.2961973424283603, 0.24593098958333326),
                (1.0, 0.5): (0.36008814826826985, 0.25992838541666663),
                (2.0, 0.0): (0.2633585477389265, 0.24169921874999994),
                (2.0, 0.5): (0.3456058416238888, 0.25113932291666663),
                (4.0, 0.0): (0.2769807731177595, 0.25781249999999994),
                (4.0, 0.5): (0.25359899143638015, 0.26139322916666663)}
TEX_EVAL_BASELINES = {
    "baseline_self": (7.112366251504909e-17, 0.0),
    "baseline_blur4x": (0.8638397292696647, 1.104817708333333),
    "baseline_gray": (0.9999999999999853, 1.956217447916666),
    "baseline_noise": (0.7509533156481754, 1.2749023437499998)}
BASELINE_ATOL = 1e-5
TEX_EVAL_STEPS = 96  # the eval CLI's default
# the face model's density study: 160-step rollouts (RESULTS.md), seed 0
# at 0.5 / 1 / 2 / 4x, then 1x at seeds 0-7
EVAL_STEPS, EVAL_SEEDS = 160, 8
EVAL_DENSITIES = (0.5, 1.0, 2.0, 4.0)
# runs/gecko_full/eval_sweep.json (2026-08-16): PSNR dB, SSIM per density
EVAL_RECORDED = {0.5: (21.347944741351306, 0.8193509798527966),
                 1.0: (27.016395319582784, 0.9079157069314032),
                 2.0: (23.338156600325934, 0.867937599047272),
                 4.0: (24.41996414852287, 0.8873406030438604)}
# the JAX eval CLI today (python -m sph_nca_tpu.cli.eval --checkpoint
# runs/gecko_full/sphnca-08162133-8000 --steps 160 --seed s, on a CPU): seed
# 0 at each density, and 1x at seeds 0-7. No --steps reproduces
# eval_sweep.json (96 / 128 / 160 give 24.21 / 24.33 / 24.38 dB at 1x, seed
# 0): the fire draws map to other particles since that sweep; 1x spans
# 24.38-27.44 dB over the seeds
EVAL_JAX_SEED0 = {0.5: (19.772, 0.7594), 1.0: (24.376, 0.8873),
                  2.0: (24.068, 0.8798), 4.0: (24.326, 0.8892)}
EVAL_JAX_1X = [(24.376, 0.8873), (27.437, 0.9128), (26.550, 0.9039),
               (25.232, 0.8888), (24.787, 0.8792), (26.336, 0.9028),
               (24.612, 0.8812), (26.292, 0.9035)]
# the bar at 1x, held by the mean over the seeds (one draw of the JAX
# package's own falls below it: seed 0, 24.38 dB)
EVAL_PSNR_MIN, EVAL_SSIM_MIN = 25.0, 0.88


def texture_train_argv(out_dir: str, iters: int, engine: str = "band",
                       extra=()) -> list:
    """The train CLI at runs/ot_gabor_dotted's configuration on the card."""
    return ["--device", "cuda", "--seed", str(SEED), "--loss", "ot",
            "--texture_features", "gabor", "--img", DOTTED,
            "--image_size", str(TEX_SIDE), "--target_size", str(TEX_TARGET),
            "--wrap", "true", "--use_alpha", "false", "--initial_feature",
            "random", "--h", str(TRAIN_H), "--batch_size", str(TEX_B),
            "--pool_size", str(TEX_POOL), "--steps_range", TEX_RANGE,
            "--channels", "16", "--hidden", "256", "--log_every", "50",
            "--checkpoint_every", str(TEX_EVERY), "--training_iter",
            str(iters), "--engine", engine, "--output_dir", out_dir] + list(
                extra)


def metrics_rows(out_dir: str) -> dict:
    """iteration -> metrics row, over every metrics file of a run (a
    resumed run appends, or starts a file of its own minute)."""
    rows = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "metrics-*.jsonl"))):
        with open(path) as f:
            for line in f:
                r = json.loads(line)
                rows[r["iter"]] = r
    return rows


def texture_train_phase(dev, smi, out_dir: str):
    """[texture-train]: TEX_ITERS iterations of OT training on the band
    engine with a checkpoint every TEX_EVERY, then ``--resume auto`` for
    TEX_RESUME more. Returns (the last checkpoint, 2.8's launches)."""
    from sph_nca_tpu_torch.io import msgpack
    from sph_nca_tpu_torch.io.checkpoint import (
        has_resume_state,
        load_checkpoint,
        load_resume_state,
    )

    t0 = time.time()
    reset_launches()
    rc = cli_train.main(texture_train_argv(out_dir, TEX_ITERS))
    torch.cuda.synchronize()
    launches = read_launches()
    if rc != 0:
        fail(f"texture train CLI returned {rc}")
    rows = metrics_rows(out_dir)
    if sorted(rows) != list(range(TEX_ITERS)):
        fail(f"texture training wrote iterations {sorted(rows)[:5]}...")
    losses = [rows[i]["loss"] for i in range(TEX_ITERS)]
    steps = [rows[i]["steps"] for i in range(TEX_ITERS)]
    want = expected_train_launches(steps, 0, tables=True)
    secs = [rows[i]["seconds"] for i in range(TEX_ITERS)]
    full_ms = 1e3 * float(np.median(secs[TEX_ITERS // 2:]))
    print("  loss at " + ", ".join(
        f"{i}: {losses[i]:.4f} (JAX {TEX_JAX_LOSSES[i]:.4f})"
        for i in sorted(TEX_JAX_LOSSES)) + f"; at {TEX_ITERS - 1}: "
        f"{losses[-1]:.4f}", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"texture training losses not finite: {losses}")
    bar = TEX_LOSS_FACTOR * TEX_JAX_LOSSES[TEX_BAR_ITER]
    if not losses[TEX_BAR_ITER] <= bar:
        fail(f"texture loss at {TEX_BAR_ITER} {losses[TEX_BAR_ITER]:.4f} > "
             f"{TEX_LOSS_FACTOR} x JAX's {TEX_JAX_LOSSES[TEX_BAR_ITER]:.4f}")
    if launches != want:
        fail(f"texture training launches {launches}, expected {want}")

    # the checkpoints: the last reads back bit-equal (the codec re-encodes
    # its bytes; its params equal the weights JSON's), carries Adam's count
    # and the port's sidecar; the first's sidecar was pruned
    cks = sorted(glob.glob(os.path.join(out_dir, "sphnca-*-*[0-9]")))
    names = [os.path.basename(p).rsplit("-", 1)[1] for p in cks]
    if names != [f"{s:04d}" for s in range(TEX_EVERY, TEX_ITERS + 1,
                                           TEX_EVERY)]:
        fail(f"texture checkpoints {names}")
    last = cks[-1]
    with open(os.path.join(last, "checkpoint.msgpack"), "rb") as f:
        raw = f.read()
    ck = load_checkpoint(last, device=dev)
    weights = load_weights_json(last + ".json", device=dev)
    if (msgpack.packb(msgpack.unpackb(raw)) != raw
            or not all(torch.equal(a, b) for a, b in zip(ck["params"],
                                                          weights.params))
            or ck["step"] != TEX_ITERS
            or int(ck["opt_state"]["1"]["0"]["count"]) != TEX_ITERS
            or ck["meta"]["extra"]["mode"] != "texture"
            or weights.mode != "texture"):
        fail("the texture checkpoint does not read back bit-equal")
    if (not load_resume_state(last)["port"]
            or any(has_resume_state(p) for p in cks[:-1])):
        fail("texture checkpoints: the sidecar is not the last one's only")

    # resume from the last checkpoint
    reset_launches()
    t1 = time.time()
    rc = cli_train.main(texture_train_argv(
        out_dir, TEX_ITERS + TEX_RESUME, extra=("--resume", "auto")))
    torch.cuda.synchronize()
    resume_s = time.time() - t1
    rlaunches = read_launches()
    if rc != 0:
        fail(f"texture train CLI --resume auto returned {rc}")
    rows = metrics_rows(out_dir)
    resumed = list(range(TEX_ITERS, TEX_ITERS + TEX_RESUME))
    if sorted(rows) != list(range(TEX_ITERS + TEX_RESUME)):
        fail(f"the resumed run wrote iterations {sorted(rows)[-5:]}")
    rlosses = [rows[i]["loss"] for i in resumed]
    rwant = expected_train_launches([rows[i]["steps"] for i in resumed], 0,
                                    tables=True)
    if not all(np.isfinite(rlosses)) or rlaunches != rwant:
        fail(f"resumed texture training: losses {rlosses}, launches "
             f"{rlaunches}, expected {rwant}")
    phase("texture-train", t0, f"train CLI --loss ot (gabor) at "
          f"runs/ot_gabor_dotted's configuration ({TEX_SIDE}x{TEX_SIDE} "
          f"wrapped, B={TEX_B}, pool {TEX_POOL}, steps {TEX_RANGE}, band "
          f"engine): {TEX_ITERS} iterations, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, median {full_ms:.1f} ms an iteration over "
          f"iterations {TEX_ITERS // 2}-{TEX_ITERS - 1} (mean rollout "
          f"{np.mean(steps[TEX_ITERS // 2:]):.1f} steps), {sum(secs):.1f} s "
          f"in all; kernel 2.8 {launches['sph_mlp_kernel']} launches as "
          f"expected; checkpoints at {', '.join(names)}, the last read back "
          f"bit-equal; --resume auto: {TEX_RESUME} more iterations in "
          f"{resume_s:.1f} s, losses {rlosses[0]:.4f} .. {rlosses[-1]:.4f}, "
          f"2.8 {rlaunches['sph_mlp_kernel']} launches | {smi}")
    return last, launches["sph_mlp_kernel"] + rlaunches["sph_mlp_kernel"]


# [texture-resume]: a straight run, a second straight run of the same seed,
# and a run checkpointed half-way and resumed (--resume auto), as
# tests/test_torch_checkpoint.py's exact-resume test runs them on the CPU,
# where the three are bit-equal. On the card they are bit-equal too: every
# backward of the path sums in a fixed order (ops/gather.py, the resize's
# products, the convolutions' forward-convolution adjoints). Before that, the
# atomic sums of the bilinear resize's backward made two runs of one seed
# part: on an H100 80GB HBM3 (700 W) up to losses 1.4e-08, parameters
# 3.7e-05 and Adam's state 1.4e-04 of max (PERF.md). RESUME_RTOL, 20-70x
# those gaps, is the bar only where [determinism] names an op of the path
# that has no deterministic implementation on the card.
RESUME_ITERS = 10
RESUME_RTOL = {"losses": 1e-4, "params": 1e-3, "adam": 3e-3}


def texture_resume_phase(dev, smi, nondeterministic) -> dict:
    """[texture-resume]: RESUME_ITERS OT iterations at runs/ot_gabor_dotted's
    configuration (band engine) twice from the seed, and RESUME_ITERS / 2
    + a checkpoint + ``--resume auto`` to RESUME_ITERS; the losses of every
    iteration and the final parameters and Adam state compared: bit-equal,
    or within RESUME_RTOL where ``nondeterministic`` (the ops
    [determinism] named) is not empty. Returns the gaps (relative to
    max)."""
    from sph_nca_tpu_torch.io.checkpoint import load_checkpoint

    t0 = time.time()
    half = RESUME_ITERS // 2
    every = ("--checkpoint_every", str(half))
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        for label in ("straight", "again", "resumed"):
            out = os.path.join(root, label)
            plan = [(RESUME_ITERS, ())] if label != "resumed" else [
                (half, ()), (RESUME_ITERS, ("--resume", "auto"))]
            for iters, extra in plan:
                rc = cli_train.main(texture_train_argv(
                    out, iters, extra=every + extra))
                torch.cuda.synchronize()
                if rc != 0:
                    fail(f"texture-resume: the train CLI returned {rc}")
            rows = metrics_rows(out)
            if sorted(rows) != list(range(RESUME_ITERS)):
                fail(f"texture-resume {label}: iterations {sorted(rows)}")
            (ck,) = glob.glob(os.path.join(out, f"sphnca-*-"
                                                f"{RESUME_ITERS:04d}"))
            c = load_checkpoint(ck, device="cpu")
            runs[label] = {
                "losses": torch.tensor([rows[i]["loss"]
                                        for i in range(RESUME_ITERS)],
                                       dtype=torch.float64),
                "params": list(c["params"]),
                "opt": [torch.as_tensor(np.asarray(v)) for v in
                        _tree_leaves(c["opt_state"])]}

    def gaps(a, b):
        return {"losses": _gap(runs[a]["losses"], runs[b]["losses"]),
                "params": max(_gap(x, y) for x, y in zip(
                    runs[a]["params"], runs[b]["params"])),
                "adam": max(_gap(x.double(), y.double()) for x, y in zip(
                    runs[a]["opt"], runs[b]["opt"]))}
    noise = gaps("again", "straight")
    resume = gaps("resumed", "straight")
    bar = RESUME_RTOL if nondeterministic else dict.fromkeys(RESUME_RTOL, 0.0)
    phase("texture-resume", t0, f"OT training at runs/ot_gabor_dotted's "
          f"configuration (band engine), {RESUME_ITERS} iterations: a second "
          f"run of the seed against the first: "
          + ", ".join(f"{k} {v:.3e}" for k, v in noise.items())
          + f" of max; {half} + checkpoint + --resume auto against the "
          f"first: " + ", ".join(f"{k} {v:.3e} (limit {bar[k]:.3e})"
                                 for k, v in resume.items())
          + f"; bit-equal: {all(v == 0.0 for v in (*noise.values(), *resume.values()))}"
          + (f"; held to RESUME_RTOL for the ops without a deterministic "
             f"implementation: {nondeterministic}" if nondeterministic
             else "") + f" | {smi}")
    if not all(noise[k] <= bar[k] and resume[k] <= bar[k] for k in resume):
        fail(f"texture-resume: the second straight run parts by {noise}, the "
             f"resumed one by {resume}, more than {bar}")
    return {"noise": noise, "resume": resume}


def _tree_leaves(tree) -> list:
    """The array leaves of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k])]
    return [tree]


def texture_cells_phase(dev, smi, out_dir: str) -> dict:
    """[texture-cells]: TEX_CELL_ITERS iterations of the same run on the cell
    engine with float32 pair tables: the OT gradient through 2.4 / 2.5 /
    2.6 / 2.8. Returns the launches."""
    t0 = time.time()
    x2 = grange((TEX_SIDE, TEX_SIDE), (-1.0, -1.0), (2.0, 2.0)).reshape(-1, 2)
    eng = build_cell_engine(torch.nn.functional.pad(x2, (0, 1)), TRAIN_H,
                            period=[2.0, 2.0, 2.0], pair_tables="float32",
                            device=dev)
    nbk = sum(1 for nb, _ in tab_stats(eng)["buckets"] if nb > 0)
    del eng
    reset_launches()
    rc = cli_train.main(texture_train_argv(out_dir, TEX_CELL_ITERS,
                                           engine="cells"))
    torch.cuda.synchronize()
    launches = read_launches()
    if rc != 0:
        fail(f"texture train CLI --engine cells returned {rc}")
    rows = metrics_rows(out_dir)
    losses = [rows[i]["loss"] for i in range(TEX_CELL_ITERS)]
    want = expected_train_launches(
        [rows[i]["steps"] for i in range(TEX_CELL_ITERS)], nbk, tables=True)
    if not all(np.isfinite(losses)) or launches != want:
        fail(f"texture training on cells: losses {losses}, launches "
             f"{launches}, expected {want}")
    phase("texture-cells", t0, f"train CLI --loss ot --engine cells (float32 "
          f"pair tables, {nbk} buckets), {TEX_CELL_ITERS} iterations: losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches {launches} as "
          f"expected | {smi}")
    return launches


def texture_cli_phase(dev, smi, ck: str) -> dict:
    """[texture-cli]: the test CLI on the trained texture checkpoint, image
    mode (its 64x64 plane) and --surface (the procedural mesh, TEX_SURF_N
    points), on both engines, TEX_CLI_STEPS steps each: the checkpoint's
    texture mode (periodic plane, no alpha, the random seed), finite states,
    launch counts. Returns ({run: launches}, the cells surface run's final
    state)."""
    t0 = time.time()
    n_img = TEX_SIDE * TEX_SIDE
    x2 = grange((TEX_SIDE, TEX_SIDE), (-1.0, -1.0), (2.0, 2.0)).reshape(-1, 2)
    reng = build_cell_engine(torch.nn.functional.pad(x2, (0, 1)), TRAIN_H,
                             period=[2.0, 2.0, 2.0], device=dev)
    nbk = int(reng.blk_xs.shape[0] > 0) + int(reng.blk2_xs.shape[0] > 0)
    del reng
    counts, lines = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        obj = write_mesh_obj(os.path.join(tmp, "bumpy.obj"))
        for label, extra, n in (
                ("image-band", ["--image_size", str(TEX_SIDE)], n_img),
                ("image-cells", ["--image_size", str(TEX_SIDE), "--engine",
                                 "cells"], n_img),
                ("surface-band", ["--surface", obj, "--surface_numpoints",
                                  str(TEX_SURF_N), "--export_every", "64"],
                 TEX_SURF_N),
                ("surface-cells", ["--surface", obj, "--surface_numpoints",
                                   str(TEX_SURF_N), "--export_every", "64",
                                   "--engine", "cells"], TEX_SURF_N)):
            out = os.path.join(tmp, label)
            reset_launches()
            t1 = time.time()
            rc = cli_test.main(["--checkpoint", ck, "--steps",
                                str(TEX_CLI_STEPS), "--seed", str(SEED),
                                "--device", "cuda", "--output_dir", out]
                               + extra)
            torch.cuda.synchronize()
            secs = time.time() - t1
            got = read_launches()
            if rc != 0:
                fail(f"test CLI --checkpoint ({label}) returned {rc}")
            (run,) = os.listdir(out)
            with np.load(os.path.join(out, run, "states.npz")) as z:
                states = z["states"]
            if label.startswith("image"):
                lines.append(f"{label} " + check_png_frames(
                    os.path.join(out, run), TEX_SIDE, TEX_CLI_STEPS + 1, 3))
            a0 = states[0]
            if (states.shape != (TEX_CLI_STEPS + 1, n, 16)
                    or not np.isfinite(states).all()
                    or not (0 <= a0).all() or not (a0 < 1).all()
                    or a0.std() < 0.2):
                fail(f"test CLI --checkpoint ({label}): states "
                     f"{states.shape}, not finite or not the random seed")
            if label == "image-cells":
                want = {**NO_LAUNCHES,
                        "sph_fwd_kernel": nbk * TEX_CLI_STEPS,
                        "sph_mask_kernel": nbk * TEX_CLI_STEPS}
                ok = got == want
            elif label == "surface-cells":
                per = got["sph_fwd_tab_kernel"] // TEX_CLI_STEPS
                ok = (got["sph_mlp_kernel"] == TEX_CLI_STEPS and per > 0
                      and got["sph_fwd_tab_kernel"] == per * TEX_CLI_STEPS
                      and got["sph_mask_tab_kernel"]
                      == got["sph_fwd_tab_kernel"]
                      and got["sph_blur_tab_kernel"] > 0
                      and all(got[k] == 0 for k in KERNELS)
                      and got["sph_bwd_tab_kernel"] == 0)
            else:
                ok = got == {**NO_LAUNCHES, "sph_mlp_kernel": TEX_CLI_STEPS}
            if not ok:
                fail(f"test CLI --checkpoint ({label}) launches {got}")
            counts[label] = got
            if label == "surface-cells":
                final = states[-1]
            lines.append(f"{label} {secs:.2f} s, std of the state {a0.std():.3f}"
                         f" -> {states[-1].std():.3f}")
    phase("texture-cli", t0, f"test CLI --checkpoint <texture-train's "
          f"{TEX_ITERS}>, {TEX_CLI_STEPS} steps, the checkpoint's texture "
          f"mode (periodic plane, no alpha, random seed): "
          + "; ".join(lines) + f"; launches {counts} | {smi}")
    return counts, final


def texture_kernels_phase(dev, smi, ck: str, final) -> dict:
    """[texture-kernels]: each kernel against its plain version at the
    shapes the texture paths give it. 2.1 / 2.3 on the test CLI's periodic
    64x64 cell engine (no tables) at B = 1 and TEX_B; 2.4-2.7 on the train
    CLI's (float32 pair tables) at B = 1 and TEX_B; on the texture CLI's
    TEX_SURF_N-point surface the blur on the random seed's pre-diffusion
    engine and ``cli_engine_checks`` (2.4 / 2.6 / 2.7 / 2.8 on its engines,
    16 steps from ``final``); 2.8 at the lead shapes of texture-train,
    texture-cells, the band runs of texture-cli and the largest grids of
    texture-eval and eval. Returns {kernel: {path: max abs error}}."""
    from sph_nca_tpu_torch.io.checkpoint import load_checkpoint
    from sph_nca_tpu_torch.ops.bands import build_band_engine

    t0 = time.time()
    rng = np.random.default_rng(SEED + 3)
    period = [2.0, 2.0, 2.0]
    x2 = grange((TEX_SIDE, TEX_SIDE), (-1.0, -1.0), (2.0, 2.0)).reshape(-1, 2)
    x = torch.nn.functional.pad(x2, (0, 1))
    reng = build_cell_engine(x, TRAIN_H, period=period, device=dev)
    c, m = reng.num_cells, reng.slots_per_cell
    rc = {}
    for bsz in (1, TEX_B):
        lead = (c, m) if bsz == 1 else (bsz, c, m)
        for name, err in check_recompute(
                reng, normal_cuda(rng, (*lead, 16), dev)).items():
            rc[name] = max(rc.get(name, 0.0), err)
    const_field(reng, dev)
    del reng
    teng = build_cell_engine(x, TRAIN_H, period=period, pair_tables="float32",
                             device=dev)
    tab = check_tab_kernels(teng, rng, dev, sizes=(1, TEX_B))
    cell_lead = (TEX_B, teng.num_cells, teng.slots_per_cell)
    del teng

    with tempfile.TemporaryDirectory() as tmp:
        xs, nrm, _ = cli_test.surface_points(
            write_mesh_obj(os.path.join(tmp, "bumpy.obj")), 1.0, TEX_SURF_N,
            np.random.default_rng(SEED), dev)
    peng = build_cell_engine(xs, cli_test.SEED_RADIUS_RANDOM,
                             pair_tables="float32", w6_only=True, device=dev)
    blur, blur_rel = check_blur(peng, rng, dev, (1,))
    if not blur_rel <= TAB_RTOL:
        fail(f"sph_blur_tab_kernel vs plain on the texture surface's "
             f"pre-diffusion engine: {blur_rel:.3e}")
    surf = cli_engine_checks(dev, smi, {"texture-surface": (ck + ".json", [])},
                             xs, nrm, peng, {"texture-surface": final},
                             phase_name="texture-cli-check")
    del peng

    def band_lead(points, h, side_period, bsz=1):
        eng = build_band_engine(points, h, period=side_period,
                                table_dtype="float32", device=dev)
        return (bsz, eng.num_cells, eng.slots_per_cell)

    # the eval CLI's largest grids: base size (the training image_size)
    # times the root of the largest density
    face = load_checkpoint(FACE_CHECKPOINT, device=dev)
    face_base = int(face["meta"]["extra"]["args"]["image_size"])
    big = {"texture-eval": (TEX_SIDE, max(d for d, _ in TEX_EVAL_JAX),
                            TRAIN_H, period),
           "eval": (face_base, max(EVAL_DENSITIES), face["h"], None)}
    x_np = x.numpy()
    shapes = {"texture-train": band_lead(x_np, TRAIN_H, period, TEX_B),
              "texture-cells": cell_lead,
              "texture-cli image-band": band_lead(x_np, TRAIN_H, period),
              "texture-cli surface-band": band_lead(xs, TRAIN_H, None)}
    for label, (base, dens, h, per) in big.items():
        side = int(round(base * dens ** 0.5))
        g = grange((side, side), (-1.0, -1.0), (2.0, 2.0)).reshape(-1, 2)
        shapes[f"{label} {side}x{side}"] = band_lead(
            torch.nn.functional.pad(g, (0, 1)).numpy(), h, per)
    mlp = mlp_shape_checks(dev, shapes)

    out = {name: {"texture-cli image-cells": err} for name, err in rc.items()}
    for name in ("sph_fwd_tab_kernel", "sph_mask_tab_kernel"):
        out[name] = {"texture-cells": tab[name],
                     "texture-cli surface-cells": surf[name]}
    out["sph_bwd_tab_kernel"] = {"texture-cells": tab["sph_bwd_tab_kernel"]}
    out["sph_blur_tab_kernel"] = {
        "texture-cli surface-cells pre-diffusion": blur,
        "texture-cli surface-cells diffusion": surf["sph_blur_tab_kernel"]}
    out["sph_mlp_kernel"] = {f"{label} {str(dtype)[6:]}": err
                             for (label, dtype), err in mlp.items()}
    out["sph_mlp_kernel"]["texture-cli surface-cells float32"] = surf[
        "sph_mlp_kernel"]
    phase("texture-kernels", t0, f"the kernels at the texture paths' shapes: "
          f"2.1 / 2.3 on the periodic {TEX_SIDE}x{TEX_SIDE} cell engine (no "
          f"tables, B = 1 and {TEX_B}) within gA {GA_RTOL} / sm {SM_RTOL} of "
          f"max; 2.4-2.7 on it with float32 tables (B = 1 and {TEX_B}), the "
          f"blur on the {TEX_SURF_N}-point surface's pre-diffusion engine "
          f"within {TAB_RTOL}; 2.8 at "
          + ", ".join(f"{label} {lead}" for label, lead in shapes.items())
          + f" within {MLP_RTOL[torch.float32]} / "
          f"{MLP_RTOL[torch.bfloat16]} of max (float32 / bfloat16) | {smi}")
    return out


def texture_eval_phase(dev, smi) -> int:
    """[texture-eval]: ``cli.eval --texture true`` on the JAX package's
    800-iteration checkpoint and exemplar (assets): the baselines equal
    texture_eval_800.json's, every sweep cell's spectrum and colour L1 below
    half the blur4x anchor. Returns 2.8's launches."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "texture.json")
        reset_launches()
        rc = cli_eval.main(["--texture", "true", "--checkpoint",
                            OT_CHECKPOINT, "--img", DOTTED, "--out", out,
                            "--device", "cuda", "--seed", str(SEED)])
        torch.cuda.synchronize()
        launches = read_launches()
        if rc != 0:
            fail(f"eval CLI --texture returned {rc}")
        with open(out) as f:
            res = json.load(f)
    cells = {(r["density"], r["jitter"]): (r["spectrum_l1"], r["color_l1"])
             for r in res["sweep"]}
    if sorted(cells) != sorted(TEX_EVAL_JAX):
        fail(f"texture eval cells {sorted(cells)}")
    gap = max(abs(res[k][key] - v[i]) for k, v in TEX_EVAL_BASELINES.items()
              for i, key in enumerate(("spectrum_l1", "color_l1")))
    if not gap <= BASELINE_ATOL:
        fail(f"texture eval baselines {gap:.3e} from texture_eval_800.json")
    blur = TEX_EVAL_BASELINES["baseline_blur4x"]
    spec_max = max(v[0] for v in cells.values())
    color_max = max(v[1] for v in cells.values())
    for key, (s, c) in sorted(cells.items()):
        js, jc = TEX_EVAL_JAX[key]
        print(f"  density {key[0]:.0f} jitter {key[1]:.1f}: spectrum L1 "
              f"{s:.4f} (JAX {js:.4f}, gap {s - js:+.4f}), colour L1 "
              f"{c:.4f} (JAX {jc:.4f}, gap {c - jc:+.4f})", flush=True)
    want = {**NO_LAUNCHES, "sph_mlp_kernel": TEX_EVAL_STEPS * len(cells)}
    if launches != want:
        fail(f"texture eval launches {launches}, expected {want}")
    if not (spec_max < blur[0] / 2 and color_max < blur[1] / 2):
        fail(f"texture eval: worst cell {spec_max:.4f} / {color_max:.4f}, "
             f"bar {blur[0] / 2:.4f} / {blur[1] / 2:.4f}")
    phase("texture-eval", t0, f"eval CLI --texture true on "
          f"assets/ot_gabor_dotted_800 ({len(cells)} cells, "
          f"{TEX_EVAL_STEPS} steps): baselines within {gap:.2e} of "
          f"texture_eval_800.json; worst cell spectrum {spec_max:.4f}, colour "
          f"{color_max:.4f} (bar: half the blur4x anchor, {blur[0] / 2:.4f} / "
          f"{blur[1] / 2:.4f}; JAX's worst {max(v[0] for v in TEX_EVAL_JAX.values()):.4f}"
          f" / {max(v[1] for v in TEX_EVAL_JAX.values()):.4f}); kernel 2.8 "
          f"{launches['sph_mlp_kernel']} launches | {smi}")
    return launches["sph_mlp_kernel"]


def eval_phase(dev, smi) -> int:
    """[eval]: ``cli.eval`` on the face model (assets/gecko_full_8000) and
    its target at 0.5 / 1 / 2 / 4x, EVAL_STEPS steps, seed 0; then 1x at
    seeds 0 .. EVAL_SEEDS - 1, held to the bar by the mean. Returns 2.8's
    launches."""
    t0 = time.time()
    launches, by_seed, sweep = 0, [], None
    with tempfile.TemporaryDirectory() as tmp:
        for seed in range(EVAL_SEEDS):
            out = os.path.join(tmp, f"sweep{seed}.json")
            dens = EVAL_DENSITIES if seed == 0 else (1.0,)
            reset_launches()
            rc = cli_eval.main(["--checkpoint", FACE_CHECKPOINT, "--img",
                                FACE, "--steps", str(EVAL_STEPS),
                                "--densities", ",".join(map(str, dens)),
                                "--seed", str(seed), "--out", out,
                                "--device", "cuda"])
            torch.cuda.synchronize()
            got = read_launches()
            if rc != 0:
                fail(f"eval CLI (seed {seed}) returned {rc}")
            if got != {**NO_LAUNCHES,
                       "sph_mlp_kernel": EVAL_STEPS * len(dens)}:
                fail(f"eval CLI (seed {seed}) launches {got}")
            launches += got["sph_mlp_kernel"]
            with open(out) as f:
                rows = {r["density"]: r for r in json.load(f)}
            if seed == 0:
                sweep = rows
            by_seed.append((rows[1.0]["psnr"], rows[1.0]["ssim"]))
    for d in EVAL_DENSITIES:
        r = sweep[d]
        print(f"  {d}x ({r['n_particles']} particles): PSNR {r['psnr']:.2f} "
              f"dB, SSIM {r['ssim']:.4f}; JAX today {EVAL_JAX_SEED0[d][0]:.2f}"
              f" / {EVAL_JAX_SEED0[d][1]:.4f}; eval_sweep.json "
              f"{EVAL_RECORDED[d][0]:.2f} / {EVAL_RECORDED[d][1]:.4f}",
              flush=True)
    print("  1x by seed: " + ", ".join(
        f"{s}: {p:.2f} / {q:.4f} (JAX {EVAL_JAX_1X[s][0]:.2f} / "
        f"{EVAL_JAX_1X[s][1]:.4f})" for s, (p, q) in enumerate(by_seed)),
        flush=True)
    psnr_mean = float(np.mean([p for p, _ in by_seed]))
    ssim_mean = float(np.mean([q for _, q in by_seed]))
    jax_psnr = float(np.mean([p for p, _ in EVAL_JAX_1X]))
    jax_ssim = float(np.mean([q for _, q in EVAL_JAX_1X]))
    if not all(np.isfinite(v) for row in sweep.values()
               for v in (row["psnr"], row["ssim"])):
        fail(f"eval: non-finite PSNR / SSIM {sweep}")
    if not (psnr_mean >= EVAL_PSNR_MIN and ssim_mean >= EVAL_SSIM_MIN):
        fail(f"eval at 1x: mean PSNR {psnr_mean:.2f} dB / SSIM "
             f"{ssim_mean:.4f} over {EVAL_SEEDS} seeds, bar "
             f"{EVAL_PSNR_MIN} / {EVAL_SSIM_MIN}")
    phase("eval", t0, f"eval CLI on assets/gecko_full_8000 + "
          f"face_target_64.npy, {EVAL_STEPS}-step rollouts: 1x mean over "
          f"seeds 0-{EVAL_SEEDS - 1} PSNR {psnr_mean:.2f} dB, SSIM "
          f"{ssim_mean:.4f} (JAX today {jax_psnr:.2f} / {jax_ssim:.4f}; bar "
          f"{EVAL_PSNR_MIN} / {EVAL_SSIM_MIN}); kernel 2.8 {launches} "
          f"launches | {smi}")
    return launches


def texture_profile_phase(dev, smi) -> None:
    """[texture-profile]: where a full-depth OT training iteration's time
    goes: one iteration of the train CLI's trainer (band engine, the
    Gabor loss, B = TEX_B, 36 steps) against its loss terms alone (the
    ranking, the final state and the aux states' losses and their backward,
    on states of the same shapes): wall ms by the host clock, device ms from
    torch.profiler kernel records, the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from sph_nca_tpu_torch.models.nca import SPHNCAConfig
    from sph_nca_tpu_torch.ops.bands import build_band_engine
    from sph_nca_tpu_torch.training.features import (
        gabor_texture_features,
        resize_image,
    )
    from sph_nca_tpu_torch.training.losses import OTLossConfig
    from sph_nca_tpu_torch.training.pool import DevicePool
    from sph_nca_tpu_torch.training.trainer import (
        TrainConfig,
        Trainer,
        make_ot_bundle,
    )
    from sph_nca_tpu_torch.utils.image import load_image

    t0 = time.time()
    h, side = TRAIN_H, TEX_SIDE
    x2 = grange((side, side), (-1.0, -1.0), (2.0, 2.0)).reshape(-1, 2)
    eng = build_band_engine(torch.nn.functional.pad(x2, (0, 1)), h,
                            period=[2.0, 2.0, 2.0], table_dtype="float32",
                            device=dev)
    img = resize_image(torch.from_numpy(load_image(DOTTED, TEX_TARGET)).to(
        dev), (side, side))
    bundle = make_ot_bundle(img, gabor_texture_features(device=dev),
                            OTLossConfig(image_size=side, use_alpha=False))
    cfg = SPHNCAConfig(channels=16, hidden=256, use_alpha=False,
                       normalize_perception=1.0 / h)
    tcfg = TrainConfig(batch_size=TEX_B, pool_size=16, steps_range=(36, 37),
                       steps_increment=0, seed=SEED)
    trainer = Trainer(cfg, tcfg, eng, x2, bundle, h)
    pool = DevicePool(x2.numpy(), np.zeros((side * side, 16), np.float32),
                      16, randomized_feat=True,
                      rng=np.random.default_rng(SEED), device=dev)

    def iteration():
        trainer.run_iteration(1, pool)

    def loss_terms():
        gen = trainer.loss_generator
        A = torch.rand((5, TEX_B, side * side, 16), device=dev)
        with torch.no_grad():
            bundle.per_sample(trainer.x, A[0], gen)
        A.requires_grad_(True)
        total = bundle.batch_total(trainer.x, A[0], gen)
        for s in range(1, 5):
            total = total + 0.1 * bundle.batch_total(trainer.x, A[s], gen)
        total.backward()

    out = {}
    for label, fn in (("iteration", iteration), ("loss", loss_terms)):
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t1 = time.time()
            fn()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.time() - t1))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [(getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0)), ev.count,
                 ev.key) for ev in prof.key_averages()
                if ev.device_type != torch.autograd.DeviceType.CPU]
        kern = [k for k in kern if k[0] > 0]
        out[label] = (float(np.median(walls)), sum(k[0] for k in kern) / 1e3,
                      sum(k[1] for k in kern), sorted(kern, reverse=True))
    it_wall, it_dev, it_n, it_kern = out["iteration"]
    ls_wall, ls_dev, ls_n, ls_kern = out["loss"]
    for label, kern in (("iteration", it_kern), ("loss terms", ls_kern)):
        print(f"  largest kernels of the {label}: " + "; ".join(
            f"{us / 1e3:.2f} ms x{n} {key[:48]}" for us, n, key in kern[:6]),
            flush=True)
    ro_dev, ro_wall = it_dev - ls_dev, it_wall - ls_wall
    phase("texture-profile", t0, f"one OT training iteration (band engine, "
          f"gabor, B={TEX_B}, {trainer.last_steps} BPTT steps): "
          f"{it_wall:.1f} ms wall, {it_dev:.1f} ms device in {it_n} kernels "
          f"({100 * it_dev / it_wall:.1f}% busy); its loss terms alone "
          f"(ranking, final + 4 aux, backward): {ls_wall:.1f} ms wall, "
          f"{ls_dev:.1f} ms device in {ls_n} kernels; the rest (rollout, "
          f"its backward, the pool, the optimizer): {ro_wall:.1f} ms wall, "
          f"{ro_dev:.1f} ms device; host-bound share of the iteration "
          f"{100 * (1 - it_dev / it_wall):.1f}% | {smi}")


# ---- the CLIP slice: text-guided training and the optimizers ---------------

CLIP_GUIDE = "a red and yellow spiral"
# runs/clip_smoke's configuration (its meta.json): a 48x48 plane padded to
# 3D, h = 0.08, 16 channels, 256 hidden, batch 4 from a pool of 64, the
# progressive schedule towards 8-12-step rollouts, scale 1, the random towers
# and the fallback tokenizer, the cell engine, 30 iterations
CLIP_SIDE, CLIP_B, CLIP_POOL, CLIP_RANGE, CLIP_ITERS = 48, 4, 64, "8,12", 30
# the JAX CLI's losses on it, runs/clip_smoke/metrics-08172252.jsonl (the
# run directory is not copied to the card); the port draws its own streams,
# so the levels are compared: the mean of the port's losses at these
# iterations within CLIP_MEAN_RTOL of the JAX run's mean (1.9618)
CLIP_JAX_LOSSES = {0: 2.022671699523926, 5: 1.8997756242752075,
                   10: 1.8996251821517944, 15: 1.9043556451797485,
                   20: 2.0625782012939453, 25: 1.9815988540649414}
CLIP_MEAN_RTOL = 0.10
# the JAX run's initial parameters (its seed-0 draw from jax.random, written
# by tests/test_torch_clip_loss.py), given to the port's runs as
# --pretrained_checkpoint: in these 30 warm-up iterations the loss level is
# set by the initial draw through the overflow term (the port's own seed-0
# draw gave a mean of 2.1800 on an H100, 11% over the JAX run's), so the
# runs start where the JAX run started and differ by the fire draws only
CLIP_INIT = os.path.join(ASSETS, "clip_smoke_init")
# [clip-parity]: the port's towers and clip_loss on the card against the JAX
# package's numbers for the seeded inputs of clip_parity_inputs (computed on
# a CPU in float32 by tests/test_torch_clip_loss.py, shipped as assets):
# features to CLIP_FEAT_ATOL, the loss to CLIP_LOSS_RTOL of its value, its
# gradient to CLIP_GRAD_RTOL of max (TF32 off; the card sums in other
# orders)
CLIP_PARITY_SCALES = (1.0, 2.0)
CLIP_FEAT_ATOL, CLIP_LOSS_RTOL, CLIP_GRAD_RTOL = 1e-4, 1e-4, 1e-3
CLIP_ASSETS = ("text", "image", "loss", "grad")
# the kernels of the CLIP path on the cell engine (2.4, 2.5, 2.6, 2.8)
CLIP_KERNELS = ("sph_fwd_tab_kernel", "sph_bwd_tab_kernel",
                "sph_mask_tab_kernel", "sph_mlp_kernel")
# [optimizers]: each optimizer's OPT_UPDATES updates on the card against the
# same on the CPU in float64, params and state to OPT_RTOL of max (a float32
# reference on the CPU parted from the card by ~6e-06 of max on some hosts,
# at an entry where the card's value is float64's to within an ulp); then
# the train CLI with --optimizer lamb for OPT_CLI_ITERS iterations, a
# checkpoint, and --resume auto for OPT_RESUME more
OPT_UPDATES, OPT_RTOL, OPT_CLI_ITERS, OPT_RESUME = 3, 1e-6, 5, 2


def clip_parity_inputs():
    """[clip-parity]'s inputs, from numpy seeds: two images [2, 48, 48, 3] in
    [0, 1] and a state [2304, 16] in [-0.2, 1.2] (the overflow term
    active)."""
    images = np.random.default_rng(SEED).random(
        (2, CLIP_SIDE, CLIP_SIDE, 3), dtype=np.float32)
    A = np.random.default_rng(SEED + 1).uniform(
        -0.2, 1.2, (CLIP_SIDE * CLIP_SIDE, 16)).astype(np.float32)
    return images, A


def clip_parity_path(name: str) -> str:
    return os.path.join(ASSETS, f"clip_parity_{name}.npy")


def clip_parity_assets() -> dict:
    return {k: np.load(clip_parity_path(k)) for k in CLIP_ASSETS}


def clip_parity_errors(dev, ref: dict, enc=None) -> dict:
    """The port's random towers (``enc``: the image tower, drawn when not
    given) and clip_loss (scales CLIP_PARITY_SCALES) on ``dev`` against the
    JAX package's numbers ``ref``: the largest absolute error of the guide's
    text features and of the images' features, the loss's relative error and
    the gradient's error relative to its max."""
    from sph_nca_tpu_torch.training.clip_encoder import random_clip_encoder
    from sph_nca_tpu_torch.training.clip_text import get_text_features
    from sph_nca_tpu_torch.training.losses import CLIPLossConfig, clip_loss

    images, A = clip_parity_inputs()
    enc = enc or random_clip_encoder(0, device=dev)
    text = get_text_features(CLIP_GUIDE, device=dev)
    with torch.no_grad():
        image = enc(torch.from_numpy(images).to(dev))
    At = torch.from_numpy(A).to(dev).requires_grad_(True)
    cfg = CLIPLossConfig(image_size=CLIP_SIDE, scales=CLIP_PARITY_SCALES)
    loss = clip_loss(torch.zeros(A.shape[0], 2, device=dev), At, text, enc,
                     None, cfg)
    loss.backward()
    loss = float(loss.detach())
    grad = At.grad.cpu().numpy()

    def gap(t, want):
        return float(np.abs(t.cpu().numpy() - want).max())

    want_loss = float(ref["loss"])
    return {"text": gap(text, ref["text"]), "image": gap(image, ref["image"]),
            "loss_rel": abs(loss - want_loss) / abs(want_loss),
            "grad_rel": float(np.abs(grad - ref["grad"]).max()
                              / np.abs(ref["grad"]).max())}


def clip_parity_phase(dev, smi) -> None:
    """[clip-parity]: clip_parity_errors within the bars, and the image
    tower's times at the training path's shape (B = CLIP_B images of
    CLIP_SIDE x CLIP_SIDE): forward, and forward with backward to the
    images, by CUDA events."""
    from sph_nca_tpu_torch.training.clip_encoder import random_clip_encoder

    t0 = time.time()
    enc = random_clip_encoder(0, device=dev)
    errs = clip_parity_errors(dev, clip_parity_assets(), enc)
    imgs = torch.rand((CLIP_B, CLIP_SIDE, CLIP_SIDE, 3), device=dev)

    def fwd():
        with torch.no_grad():
            enc(imgs)

    def fwd_bwd():
        x = imgs.clone().requires_grad_(True)
        enc(x).sum().backward()

    fwd_ms, both_ms = cuda_ms(fwd, iters=20), cuda_ms(fwd_bwd, iters=20)
    gflop = CLIP_B * clip_tower_flop() / 1e9
    phase("clip-parity", t0, f"random towers and clip_loss (scales "
          f"{CLIP_PARITY_SCALES}) vs the JAX package's float32 CPU numbers: "
          f"text features max abs {errs['text']:.3e}, image features "
          f"{errs['image']:.3e} (limit {CLIP_FEAT_ATOL}), loss rel "
          f"{errs['loss_rel']:.3e} (limit {CLIP_LOSS_RTOL}), gradient "
          f"{errs['grad_rel']:.3e} of max (limit {CLIP_GRAD_RTOL}); image "
          f"tower at B={CLIP_B} ({gflop:.1f} GFLOP forward): forward "
          f"{fwd_ms:.3f} ms ({gflop / fwd_ms:.2f} TFLOP/s), forward + "
          f"backward {both_ms:.3f} ms | {smi}")
    if not (errs["text"] <= CLIP_FEAT_ATOL and errs["image"] <= CLIP_FEAT_ATOL
            and errs["loss_rel"] <= CLIP_LOSS_RTOL
            and errs["grad_rel"] <= CLIP_GRAD_RTOL):
        fail(f"the CLIP path departs from the JAX package's numbers: {errs}")


def clip_tower_flop() -> float:
    """Floating-point operations of one image through the image tower's
    products (patches, 12 blocks, projection; 2 per multiply-add)."""
    from sph_nca_tpu_torch.training import clip_encoder as CE

    t, w = (CE.IMAGE_RES // CE.PATCH) ** 2 + 1, CE.WIDTH
    block = t * (4 * w * w + 8 * w * w) + 2 * t * t * w
    return 2.0 * ((t - 1) * CE.PATCH * CE.PATCH * 3 * w + CE.LAYERS * block
                  + w * CE.EMBED)


def clip_train_argv(out_dir: str, engine: str, iters: int) -> list:
    """The train CLI at runs/clip_smoke's configuration on the card, from
    the JAX run's initial parameters."""
    return ["--device", "cuda", "--seed", str(SEED), "--loss",
            "clip_multiscale", "--clip_guide", CLIP_GUIDE, "--image_size",
            str(CLIP_SIDE), "--target_size", "64", "--h", str(TRAIN_H),
            "--batch_size", str(CLIP_B), "--pool_size", str(CLIP_POOL),
            "--steps_range", CLIP_RANGE, "--channels", "16", "--hidden",
            "256", "--log_every", "5", "--checkpoint_every", str(iters),
            "--save_resume", "false", "--training_iter", str(iters),
            "--pretrained_checkpoint", CLIP_INIT, "--engine", engine,
            "--output_dir", out_dir]


def clip_trainer(eng, x2, steps_increment: int = 0):
    """The port's Trainer at runs/clip_smoke's configuration on ``eng``
    (full 8-12-step depth from the first iteration unless a
    ``steps_increment`` is given), with its pool and its loss bundle."""
    from sph_nca_tpu_torch.models.nca import SPHNCAConfig
    from sph_nca_tpu_torch.training.clip_encoder import random_clip_encoder
    from sph_nca_tpu_torch.training.clip_text import get_text_features
    from sph_nca_tpu_torch.training.losses import CLIPLossConfig
    from sph_nca_tpu_torch.training.pool import DevicePool
    from sph_nca_tpu_torch.training.trainer import (
        TrainConfig,
        Trainer,
        make_clip_bundle,
    )

    dev = eng.device
    cfg = SPHNCAConfig(channels=16, hidden=256, fire_rate=0.5,
                       normalize_perception=1.0 / TRAIN_H)
    bundle = make_clip_bundle(get_text_features(CLIP_GUIDE, device=dev),
                              random_clip_encoder(0, device=dev),
                              CLIPLossConfig(image_size=CLIP_SIDE))
    lo, hi = (int(s) for s in CLIP_RANGE.split(","))
    trainer = Trainer(cfg, TrainConfig(
        batch_size=CLIP_B, pool_size=CLIP_POOL, steps_range=(lo, hi),
        steps_increment=steps_increment, seed=SEED), eng, x2, bundle,
        TRAIN_H)
    seed_A = plane_seed(x2, 16, gmin=(-1.0, -1.0), gsize=(2.0, 2.0),
                        radius=TRAIN_H)
    pool = DevicePool(x2.numpy(), seed_A.numpy(), CLIP_POOL,
                      rng=np.random.default_rng(SEED), device=dev)
    return trainer, pool, bundle


def clip_iteration_split(eng, x2) -> dict:
    """One full-depth CLIP iteration on ``eng`` (after a warm-up) under the
    profiler: wall and device ms and the device's busy share; and the loss
    terms alone on the same states (the ranking, the final and 4 aux
    states, the backward through the towers): their wall ms, which is the
    towers' share of the iteration."""
    from torch.profiler import ProfilerActivity, profile

    trainer, pool, bundle = clip_trainer(eng, x2)
    trainer.run_iteration(0, pool)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.time()
        trainer.run_iteration(1, pool)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t1)
    dev_ms = 1e-3 * sum(getattr(ev, "self_device_time_total",
                                getattr(ev, "self_cuda_time_total", 0))
                        for ev in prof.key_averages()
                        if ev.device_type != torch.autograd.DeviceType.CPU)
    _, A = pool.sample(CLIP_B)
    A = torch.as_tensor(A, device=eng.device)
    x = trainer.x
    gen = trainer.loss_generator

    def loss_terms():
        with torch.no_grad():
            bundle.per_sample(x, A, gen)
        As = A.clone().requires_grad_(True)
        total = sum(bundle.batch_total(x, As, gen) for _ in range(5))
        total.backward()

    loss_ms = cuda_ms(loss_terms, iters=5, warmup=1)
    return {"wall_ms": wall_ms, "dev_ms": dev_ms, "steps": trainer.last_steps,
            "loss_ms": loss_ms}


def clip_train_phase(dev, smi, out_root: str) -> tuple:
    """[clip-train]: the train CLI at runs/clip_smoke's configuration, from
    the JAX run's initial parameters (CLIP_INIT), for CLIP_ITERS iterations
    on the cell engine (float32 pair tables: kernels
    2.4 / 2.5 / 2.6 / 2.8) and on the default band engine (2.8): finite
    losses whose mean at iterations 0, 5, ..., 25 lies within CLIP_MEAN_RTOL
    of the JAX run's, launches as the drawn schedule implies, the checkpoint
    with meta.json (mode texture); ms an iteration, peak memory, one
    full-depth iteration's busy share and the towers' share; each kernel of
    the path against its plain version at the path's shapes. Returns
    ({path: launches}, {kernel: {path: max abs error}})."""
    from sph_nca_tpu_torch.io.checkpoint import load_checkpoint
    from sph_nca_tpu_torch.ops.bands import build_band_engine

    t0 = time.time()
    rng = np.random.default_rng(SEED + 5)
    x, x2 = plane_points(CLIP_SIDE)
    want_mean = float(np.mean(list(CLIP_JAX_LOSSES.values())))
    launches, lines, leads = {}, [], {}
    for engine in ("cells", "band"):
        if engine == "cells":
            eng = build_cell_engine(x, TRAIN_H, pair_tables="float32",
                                    device=dev)
            nbk = sum(1 for nb, _ in tab_stats(eng)["buckets"] if nb > 0)
            leads[f"clip-train {engine}"] = (CLIP_B, eng.num_cells,
                                             eng.slots_per_cell)
            tab = check_tab_kernels(eng, rng, dev, sizes=(1, CLIP_B))
        else:
            eng = build_band_engine(x.numpy(), TRAIN_H, table_dtype="float32",
                                    device=dev)
            nbk = 0
            leads[f"clip-train {engine}"] = (CLIP_B, eng.num_cells,
                                             eng.slots_per_cell)
        split = clip_iteration_split(eng, x2)
        del eng
        out_dir = os.path.join(out_root, engine)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        rc = cli_train.main(clip_train_argv(out_dir, engine, CLIP_ITERS))
        torch.cuda.synchronize()
        got = read_launches()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        if rc != 0:
            fail(f"the CLIP train CLI (--engine {engine}) returned {rc}")
        rows = metrics_rows(out_dir)
        if sorted(rows) != list(range(CLIP_ITERS)):
            fail(f"CLIP training ({engine}) wrote iterations {sorted(rows)}")
        losses = [rows[i]["loss"] for i in range(CLIP_ITERS)]
        steps = [rows[i]["steps"] for i in range(CLIP_ITERS)]
        mean = float(np.mean([losses[i] for i in CLIP_JAX_LOSSES]))
        want = expected_train_launches(steps, nbk, tables=True)
        if not all(np.isfinite(losses)):
            fail(f"CLIP training ({engine}) losses not finite: {losses}")
        if not abs(mean - want_mean) <= CLIP_MEAN_RTOL * want_mean:
            fail(f"CLIP training ({engine}): mean loss at "
                 f"{sorted(CLIP_JAX_LOSSES)} {mean:.4f}, the JAX run's "
                 f"{want_mean:.4f} (limit {CLIP_MEAN_RTOL} relative)")
        if got != want:
            fail(f"CLIP training ({engine}) launches {got}, expected {want}")
        (ck,) = glob.glob(os.path.join(out_dir, f"sphnca-*-{CLIP_ITERS:04d}"))
        meta = load_checkpoint(ck, device=dev)["meta"]
        if (meta["extra"]["mode"] != "texture" or meta["step"] != CLIP_ITERS
                or meta["extra"]["args"]["loss"] != "clip_multiscale"):
            fail(f"the CLIP checkpoint's meta.json: {meta}")
        launches[f"clip-train {engine}"] = got
        secs = [rows[i]["seconds"] for i in range(CLIP_ITERS)]
        print(f"  {engine}: losses "
              + " ".join(f"{l:.4f}" for l in losses), flush=True)
        lines.append(
            f"{engine}: mean loss at 0, 5, ..., 25 {mean:.4f} (JAX "
            f"{want_mean:.4f}), {losses[0]:.4f} -> {losses[-1]:.4f}; median "
            f"{1e3 * float(np.median(secs[CLIP_ITERS // 2:])):.1f} ms an "
            f"iteration over iterations {CLIP_ITERS // 2}-{CLIP_ITERS - 1} "
            f"({np.mean(steps[CLIP_ITERS // 2:]):.1f} steps), "
            f"{sum(secs):.1f} s in all, peak device memory {peak_gb:.3f} "
            f"GiB; one full-depth iteration ({split['steps']} steps) "
            f"{split['wall_ms']:.1f} ms wall, {split['dev_ms']:.1f} ms device "
            f"({100 * split['dev_ms'] / split['wall_ms']:.1f}% busy), its loss "
            f"terms (the towers) {split['loss_ms']:.1f} ms "
            f"({100 * split['loss_ms'] / split['wall_ms']:.1f}%); launches "
            f"{got}")
    mlp = mlp_shape_checks(dev, leads)
    errs = {name: {"clip-train cells": tab[name]} for name in
            ("sph_fwd_tab_kernel", "sph_bwd_tab_kernel", "sph_mask_tab_kernel")}
    errs["sph_mlp_kernel"] = {f"{label} {str(dtype)[6:]}": err
                              for (label, dtype), err in mlp.items()}
    phase("clip-train", t0, f"train CLI --loss clip_multiscale at "
          f"runs/clip_smoke's configuration ({CLIP_SIDE}x{CLIP_SIDE}, "
          f"B={CLIP_B}, pool {CLIP_POOL}, steps {CLIP_RANGE}, guide "
          f"{CLIP_GUIDE!r}, random towers, the JAX run's initial "
          f"parameters), {CLIP_ITERS} iterations; "
          + "; ".join(lines) + f"; 2.4-2.6 vs plain on its float32 tables "
          f"(B = 1 and {CLIP_B}) within {TAB_RTOL}, 2.8 at "
          + ", ".join(f"{k} {v}" for k, v in leads.items())
          + f" | {smi}")
    return launches, errs


def optimizers_phase(dev, smi) -> dict:
    """[optimizers]: each optimizer of training.optim OPT_UPDATES updates
    from the same params and seeded gradients (normalized, under the
    schedule) on the card and on the CPU in float64: params and every leaf
    of the optax state tree within OPT_RTOL of max; then the train CLI (band engine, MSE)
    with --optimizer lamb for OPT_CLI_ITERS iterations and a checkpoint in
    LAMB's optax layout, and --resume auto for OPT_RESUME more. Returns
    2.8's launches."""
    from sph_nca_tpu_torch.io.checkpoint import (
        load_checkpoint,
        optax_state_tree,
    )
    from sph_nca_tpu_torch.models.nca import (
        MLPParams,
        SPHNCAConfig,
        init_params,
    )
    from sph_nca_tpu_torch.training.optim import LAYOUTS, OPTIMIZERS
    from sph_nca_tpu_torch.training.trainer import (
        make_optimizer,
        normalize_grads_,
    )

    t0 = time.time()
    cfg = SPHNCAConfig(channels=16, hidden=256)
    p0 = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    grads = [[torch.from_numpy(np.random.default_rng(SEED + u).normal(
        size=tuple(p.shape)).astype(np.float32)) for p in p0]
        for u in range(OPT_UPDATES)]

    def run(name, device, dtype=torch.float32):
        params = [p.clone().to(device, dtype).requires_grad_(True)
                  for p in p0]
        opt, sched = make_optimizer(params, name=name, decay_steps=10)
        for g in grads:
            for p, gp in zip(params, g):
                p.grad = gp.to(device, dtype, copy=True)
            normalize_grads_(params)
            opt.step()
            sched.step()
        return params, optax_state_tree(opt, MLPParams(*params), True, name)

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}")
        else:
            yield path, np.asarray(tree)

    def arrays(params, tree):
        out = {f"param {k}": p.detach().cpu().numpy()
               for k, p in zip(MLPParams._fields, params)}
        out.update(leaves(tree))
        return out

    worst, repeat = {}, {}
    for name in OPTIMIZERS:
        got = arrays(*run(name, dev))
        again = arrays(*run(name, dev))
        want = arrays(*run(name, "cpu", torch.float64))
        if got.keys() != want.keys():
            fail(f"{name}: the card's optax tree {sorted(got)} is not the "
                 f"CPU's {sorted(want)}")
        repeat[name] = all(np.array_equal(got[k], again[k]) for k in got)
        gaps = {}
        for k, w in want.items():
            if w.dtype == np.int32:
                if not np.array_equal(got[k], w):
                    fail(f"{name}: count {k} {got[k]} != {w}")
                continue
            gaps[k] = float(np.abs(got[k] - w).max()
                            / max(np.abs(w).max(), 1e-30))
        leaf = max(gaps, key=gaps.get)
        worst[name] = gaps[leaf]
        if not worst[name] <= OPT_RTOL:
            d = np.abs(got[leaf] - want[leaf]).reshape(-1)
            j = int(d.argmax())
            fail(f"{name} on the card departs from the CPU's float64 by "
                 f"{worst[name]:.3e}"
                 f" of max (limit {OPT_RTOL}) at {leaf} [{j}]: "
                 f"{got[leaf].reshape(-1)[j]!r} vs {want[leaf].reshape(-1)[j]!r}"
                 f"; a second card run is bit-equal: {repeat[name]}")

    with tempfile.TemporaryDirectory() as out_dir:
        reset_launches()
        flags = ["--optimizer", "lamb", "--checkpoint_every",
                 str(OPT_CLI_ITERS), "--log_every", "1", "--engine", "band"]
        argv = ["--device", "cuda", "--seed", str(SEED), "--output_dir",
                out_dir] + flags
        rc = cli_train.main(argv + ["--training_iter", str(OPT_CLI_ITERS)])
        torch.cuda.synchronize()
        (ck,) = glob.glob(os.path.join(out_dir, "sphnca-*-*[0-9]"))
        tree = load_checkpoint(ck, device=dev)["opt_state"]
        rc2 = cli_train.main(argv + [
            "--training_iter", str(OPT_CLI_ITERS + OPT_RESUME), "--resume",
            "auto"])
        torch.cuda.synchronize()
        got = read_launches()
        rows = metrics_rows(out_dir)
    if rc != 0 or rc2 != 0:
        fail(f"train CLI --optimizer lamb returned {rc}, resumed {rc2}")
    inner = tree.get("1", {})
    if (set(tree) != {"0", "1"} or set(inner) != {
            str(i) for i in range(len(LAYOUTS["lamb"]))}
            or int(inner["0"]["count"]) != OPT_CLI_ITERS
            or int(inner["3"]["count"]) != OPT_CLI_ITERS):
        fail(f"the --optimizer lamb checkpoint is not LAMB's optax state: "
             f"{tree.keys()}, inner {inner.keys()}")
    losses = [rows[i]["loss"] for i in sorted(rows)]
    if (sorted(rows) != list(range(OPT_CLI_ITERS + OPT_RESUME))
            or not all(np.isfinite(losses))):
        fail(f"train CLI --optimizer lamb: iterations {sorted(rows)}, losses "
             f"{losses}")
    steps = [rows[i]["steps"] for i in sorted(rows)]
    want = expected_train_launches(steps, 0, tables=True)["sph_mlp_kernel"]
    if got != {**NO_LAUNCHES, "sph_mlp_kernel": want}:
        fail(f"train CLI --optimizer lamb launches {got}")
    phase("optimizers", t0, f"{OPT_UPDATES} updates of each optimizer on the "
          f"card vs the CPU in float64 (normalized gradients, the schedule), "
          f"params and "
          f"optax state within " + ", ".join(
              f"{n} {g:.2e}" for n, g in worst.items())
          + f" of max (limit {OPT_RTOL}), two card runs bit-equal for "
          f"{sum(repeat.values())} of {len(repeat)}; train CLI --optimizer "
          f"lamb (band "
          f"engine, MSE): {OPT_CLI_ITERS} iterations, a checkpoint in LAMB's "
          f"optax layout (count {OPT_CLI_ITERS}), --resume auto "
          f"{OPT_RESUME} more: losses "
          + " ".join(f"{l:.4f}" for l in losses) + f"; 2.8 {want} launches"
          f" | {smi}")
    return want


def check_png_frames(run_dir: str, side: int, n_states: int,
                     channels: int) -> str:
    """The test CLI's PNG frames of an image-mode run (``--export_every``
    1): one a state, ``{i:04d}.png``; the last one's signature and IHDR
    (side x side, 8 bits, RGBA or RGB). The card has no PIL: the header is
    read with struct."""
    names = sorted(f for f in os.listdir(run_dir) if f.endswith(".png"))
    if names != [f"{i:04d}.png" for i in range(n_states)]:
        fail(f"PNG frames {names[:3]}... ({len(names)}), expected "
             f"{n_states}")
    with open(os.path.join(run_dir, names[-1]), "rb") as f:
        head = f.read(26)
    w, h, depth, ctype = struct.unpack(">IIBB", head[16:26])
    kind = {6: "RGBA", 2: "RGB"}.get(ctype)
    if (head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR"
            or (w, h, depth) != (side, side, 8)
            or kind != {4: "RGBA", 3: "RGB"}[channels]):
        fail(f"PNG frame {names[-1]}: header {head!r}")
    return f"{len(names)} PNG frames {w}x{h} {kind}"


# ---- the graph engine: fixed-K neighbour lists, plain PyTorch ----------------

# the graph paths launch no kernel of the port: every wrapper's counter stays
# 0 through them. Their checks: the build's neighbour sets equal the native
# true pairs; float32 volumes and weights against a float64 build of the same
# lists, the ops against the dense oracle and the general ops, and the float32
# gradient in x against a float64 one, each within GRAPH_RTOL of max (float32
# sums in other orders; TF32 off); rollouts against the cell engine within
# ROLLOUT_ATOL (the states) or of max (GRAPH_GRAD_RTOL, a 4-step BPTT
# gradient); the rebuild without motion equals the static rollout within
# GRAPH_RTOL of max
GRAPH_RTOL = 1e-5
GRAPH_GRAD_RTOL = 1e-4
GRAPH_OPS_N, GRAPH_OPS_H = 2000, 0.15
GRAPH_TRAIN_ITERS, GRAPH_REBUILD_STEPS, GRAPH_GRAD_STEPS = 20, 16, 4


def graph_launches_zero(label: str) -> None:
    launches = read_launches()
    if launches != NO_LAUNCHES:
        fail(f"{label} launched kernels of the port: {launches}")


def plane_points(side: int, use_3d: bool = True):
    """The CLIs' particle plane: (x [N, 3] padded with z = 0, x2 [N, 2])."""
    x2 = grange((side, side), (-1.0, -1.0), (2.0, 2.0)).reshape(-1, 2)
    return (torch.nn.functional.pad(x2, (0, 1)) if use_3d else x2), x2


def graph_build_phase(dev, smi) -> dict:
    """[graph-build]: suggest_capacity and build_graph on the card for the
    gecko's grid (128x128, h = 0.1), the train CLI's (128x128 in 3D,
    h = 0.08) and a periodic 64x64 (h = 0.08, period 2): exact lists on the
    first build, each row's neighbour set equal to the native true pairs,
    volumes and weights within GRAPH_RTOL of max of a float64 build of the
    same lists (gv_sum against the largest |gv|: on a regular grid the sum
    cancels to ~0). Returns the graphs by label."""
    t0 = time.time()
    from sph_nca_tpu_torch.ops import hashgrid as HG

    gecko_h = load_weights_json(GECKO, device="cpu").h
    cases = {"gecko": (IMAGE, gecko_h, None),
             "train": (IMAGE, TRAIN_H, None),
             "periodic": (64, TRAIN_H, [2.0, 2.0, 2.0])}
    graphs, lines = {}, []
    for label, (side, h, period) in cases.items():
        x = plane_points(side)[0]
        dims = HG.default_dims(h)
        torch.cuda.synchronize()
        t1 = time.time()
        mpc, k = HG.suggest_capacity(x, h, dims, period=period)
        t2 = time.time()
        xd = x.to(dev)
        nl = HG.build_neighbor_list(xd, h, dims, max_per_cell=mpc, k=k,
                                    period=period)
        g = HG.graph_from_neighbor_list(xd, h, nl, period=period)
        torch.cuda.synchronize()
        t3 = time.time()
        dropped = int(nl.num_dropped)
        if dropped != 0:
            fail(f"graph build ({label}) dropped {dropped} neighbours")
        # each row's neighbour set against the native true pairs (which
        # take positions canonical to one period), as sorted (row,
        # neighbour) keys
        xc = x.numpy().astype(np.float64)
        if period is not None:
            xc = xc - np.floor(xc / period) * period
        pi, pj = native.true_pairs(xc, h, period)[:2]
        n = x.shape[0]
        want = np.sort(pi.astype(np.int64) * n + pj)
        idx, valid = g.idx.cpu().numpy(), g.valid.cpu().numpy()
        rows = np.nonzero(valid)[0].astype(np.int64)
        got = np.sort(rows * n + idx[valid])
        if not np.array_equal(got, want):
            fail(f"graph build ({label}): neighbour sets differ from the "
                 f"native true pairs ({got.size} against {want.size} pairs)")
        g64 = HG.graph_from_neighbor_list(xd.double(), h, nl, period=period)
        # gv_sum against the scale of its terms: on a regular grid it
        # cancels to ~0
        gaps = {name: float((getattr(g, name).double()
                             - getattr(g64, name)).abs().max()
                            / getattr(g64, scale).abs().max())
                for name, scale in (("v", "v"), ("wv", "wv"), ("gv", "gv"),
                                    ("gv_sum", "gv"))}
        if not max(gaps.values()) <= GRAPH_RTOL:
            fail(f"graph build ({label}) against float64: {gaps}")
        del g64
        graphs[label] = g
        lines.append(
            f"{label} N={n} h={h}{' periodic' if period else ''}: "
            f"max_per_cell={mpc} K={k}, {valid.sum(1).max()} neighbours at "
            f"most, {valid.sum() / n:.1f} a particle, {g.nbytes() / 1e6:.1f} "
            f"MB; capacity {t2 - t1:.3f} s (host), lists and weights "
            f"{t3 - t2:.3f} s (card); float64 gap "
            f"{max(gaps.values()):.3e} of max")
    for line in lines:
        print(f"  {line}", flush=True)
    phase("graph-build", t0, "graph engines built on the card: exact lists "
          f"equal to the native true pairs, weights within {GRAPH_RTOL} of "
          f"max of a float64 build | {smi}")
    return graphs


def graph_ops_phase(dev, smi) -> None:
    """[graph-ops]: on GRAPH_OPS_N random points on the card, the general
    neighbour ops against the dense oracle, the graph ops against the
    general ops, and the float32 gradient in x (and A) of a scalar of the
    general gradient and blur against a float64 autograd, within GRAPH_RTOL
    of max."""
    t0 = time.time()
    from sph_nca_tpu_torch.ops import dense as DN
    from sph_nca_tpu_torch.ops import hashgrid as HG
    from sph_nca_tpu_torch.ops import neighbor_ops as NO

    rng = np.random.default_rng(SEED + 5)
    x = rng.uniform(-1, 1, (GRAPH_OPS_N, 3)).astype(np.float32)
    x[:, 2] *= 0.1
    h, period = GRAPH_OPS_H, None
    dims = HG.default_dims(h)
    mpc, k = HG.suggest_capacity(x, h, dims)
    xd = torch.from_numpy(x).to(dev)
    nl = HG.build_neighbor_list(xd, h, dims, max_per_cell=mpc, k=k)
    g = HG.graph_from_neighbor_list(xd, h, nl)
    A = normal_cuda(rng, (GRAPH_OPS_N, 16), dev)
    V = normal_cuda(rng, (GRAPH_OPS_N, 16, 3), dev)
    R = normal_cuda(rng, (GRAPH_OPS_N, 16, 3), dev)
    gaps = {}

    def hold(name, got, want):
        gaps[name] = float((got.double() - want.double()).abs().max()
                           / want.double().abs().max())

    v = NO.volume(xd, h, nl)
    hold("volume vs dense", v, DN.volume(xd, h))
    for name, op, dop, inp in (("gradient", NO.gradient, DN.gradient, A),
                               ("divergence", NO.divergence, DN.divergence,
                                V),
                               ("blur", NO.blur, DN.blur, A)):
        hold(f"{name} vs dense", op(xd, v, inp, h, nl), dop(xd, v, inp, h))
    if not torch.equal(NO.count(xd, h, nl), DN.count(xd, h)):
        fail("graph ops: neighbour counts differ from the dense count")
    hold("graph_gradient vs general", NO.graph_gradient(g, A),
         NO.gradient(xd, g.v, A, h, nl))
    hold("graph_blur vs general", NO.graph_blur(g, A),
         NO.blur(xd, g.v, A, h, nl))
    hold("graph_divergence vs general", NO.graph_divergence(g, V),
         NO.divergence(xd, g.v, V, h, nl))
    grads = {}
    for dt in (torch.float32, torch.float64):
        xg = xd.to(dt).clone().requires_grad_(True)
        Ag = A.to(dt).clone().requires_grad_(True)
        vg = NO.volume(xg, h, nl)
        (torch.sum(NO.gradient(xg, vg, Ag, h, nl) * R.to(dt))
         + torch.sum(NO.blur(xg, vg, Ag, h, nl) * R[..., 0].to(dt))
         ).backward()
        grads[dt] = (xg.grad, Ag.grad)
    hold("d/dx vs float64", grads[torch.float32][0], grads[torch.float64][0])
    hold("d/dA vs float64", grads[torch.float32][1], grads[torch.float64][1])
    torch.cuda.synchronize()
    print("  " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()),
          flush=True)
    if not max(gaps.values()) <= GRAPH_RTOL:
        fail(f"graph ops out of tolerance: {gaps}")
    phase("graph-ops", t0, f"{GRAPH_OPS_N} points, h={h}, K={k}: general "
          f"ops == dense, graph ops == general ops, float32 gradients == "
          f"float64, within {GRAPH_RTOL} of max | {smi}")


def graph_inference_phase(dev, smi, alive_cells: float) -> dict:
    """[graph-inference]: the test CLI's image mode with --engine graph on
    the gecko (IMAGE x IMAGE, STEPS steps, fire_rate 0.5): no kernel
    launched, the gecko grows to within ALIVE_ATOL of the cell-engine CLI's
    alive share (same seed, another fire stream); ms per step of
    rollout_states on the CLI's graph; CHECK_STEPS steps at fire_rate 1.0
    against the cell engine's rollout through kernels 2.1 / 2.3 (ROLLOUT_ATOL
    of max)."""
    t0 = time.time()
    from sph_nca_tpu_torch.models.rollout import rollout_states
    from sph_nca_tpu_torch.ops import hashgrid as HG

    with tempfile.TemporaryDirectory() as out_dir:
        reset_launches()
        t1 = time.time()
        rc = cli_test.main([
            "--weights_json", GECKO, "--image_size", str(IMAGE), "--steps",
            str(STEPS), "--firerate", "0.5", "--seed", str(SEED),
            "--output_dir", out_dir, "--device", "cuda", "--engine",
            "graph"])
        torch.cuda.synchronize()
        cli_s = time.time() - t1
        graph_launches_zero("the graph test CLI")
        if rc != 0:
            fail(f"graph test CLI returned {rc}")
        (run,) = os.listdir(out_dir)
        with np.load(os.path.join(out_dir, run, "states.npz")) as z:
            states = z["states"]
        frames = check_png_frames(os.path.join(out_dir, run), IMAGE,
                                  STEPS + 1, 4)
    if (states.shape != (STEPS + 1, IMAGE * IMAGE, 16)
            or not np.isfinite(states).all()):
        fail(f"graph test CLI trajectory {states.shape}, finite "
             f"{np.isfinite(states).all()}")
    alive0 = float((states[0][:, 3] > 0.1).mean())
    alive = float((states[-1][:, 3] > 0.1).mean())
    if not (alive0 < alive < 0.5 and abs(alive - alive_cells) <= ALIVE_ATOL):
        fail(f"the graph gecko: alive {alive0} -> {alive}, cell engine "
             f"{alive_cells}")

    model = load_weights_json(GECKO, device=dev)
    h = model.h
    x, x2 = plane_points(IMAGE)
    dims = HG.default_dims(h)
    mpc, k = HG.suggest_capacity(x, h, dims)
    g = HG.build_graph(x.to(dev), h, dims, max_per_cell=mpc, k=k)
    A0 = plane_seed(x2, 16, gmin=(-1.0, -1.0), gsize=(2.0, 2.0),
                    radius=h).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        rollout_states(model.params, model.cfg, g, A0, gen, 4, h)  # warm-up
        torch.cuda.synchronize()
        t1 = time.time()
        rollout_states(model.params, model.cfg, g, A0, gen, STEPS, h)
        torch.cuda.synchronize()
        step_ms = (time.time() - t1) * 1e3 / STEPS
        cfg1 = dataclasses.replace(model.cfg, fire_rate=1.0)
        got = rollout_states(model.params, cfg1, g, A0, gen, CHECK_STEPS,
                             h)[-1]
        eng = build_cell_engine(x, h, device=dev)
        want = eng.gather_back(rollout_cells(
            model.params, cfg1, eng, eng.scatter(A0), gen, CHECK_STEPS, h))
    gap = float((got - want).abs().max() / want.abs().max())
    phase("graph-inference", t0, f"test CLI --engine graph, gecko {IMAGE}x"
          f"{IMAGE}, {STEPS} steps at fire_rate 0.5 in {cli_s:.2f} s, no "
          f"kernel launched: alive {alive0:.4f} -> {alive:.4f} (cell engine "
          f"{alive_cells:.4f}, limit {ALIVE_ATOL}), {frames}; rollout_states "
          f"{step_ms:.4f} ms a step (host clock around synchronize, K={g.k}, "
          f"{g.nbytes() / 1e6:.1f} MB); {CHECK_STEPS} steps at fire_rate 1.0 "
          f"against the cell engine (kernels 2.1 / 2.3): {gap:.3e} of max "
          f"(limit {ROLLOUT_ATOL}) | {smi}")
    if not gap <= ROLLOUT_ATOL:
        fail(f"graph rollout departs from the cell engine's by {gap:.3e}")
    return {"step_ms": step_ms, "alive": alive}


def graph_train_phase(dev, smi) -> dict:
    """[graph-train]: the train CLI with --engine graph at the JAX train
    CLI's defaults (128x128 in 3D, h = 0.08, batch 8, pool 1024, 32-48
    steps after the warm-up) for GRAPH_TRAIN_ITERS iterations (the loss
    falls; no kernel launched) and DEPTH_ITERS at full depth (ms an
    iteration, peak memory); then a GRAPH_GRAD_STEPS-step BPTT gradient at
    fire_rate 1.0 (the gecko from the seed, B = 8) against the cell engine's
    batched path on float32 tables (kernels 2.4-2.6, 2.8) within
    GRAPH_GRAD_RTOL of max (and, printed, against the graph in float64)."""
    t0 = time.time()
    from sph_nca_tpu_torch.models.rollout import rollout_batch
    from sph_nca_tpu_torch.ops import hashgrid as HG

    with tempfile.TemporaryDirectory() as out_dir:
        reset_launches()
        rows = run_train_cli(out_dir, ["--training_iter",
                                       str(GRAPH_TRAIN_ITERS)],
                             engine="graph")
        graph_launches_zero("the graph train CLI")
    losses = [r["loss"] for r in rows]
    if not (len(losses) == GRAPH_TRAIN_ITERS and np.isfinite(losses).all()
            and np.mean(losses[-5:]) < np.mean(losses[:5])):
        fail(f"graph train CLI losses {losses}")
    with tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.reset_peak_memory_stats()
        deep = run_train_cli(out_dir, ["--training_iter", str(DEPTH_ITERS),
                                       "--steps_increment", "0"],
                             engine="graph")
        peak = torch.cuda.max_memory_allocated()
    iter_ms = [1e3 * r["seconds"] for r in deep]

    # the gecko model from the train CLI's seed (radius h) on its grid:
    # few states near the alive threshold, so the two engines' float32
    # rounding flips no life mask (random dense states flip some in 4 steps)
    h = TRAIN_H
    x, x2 = plane_points(IMAGE)
    dims = HG.default_dims(h)
    mpc, k = HG.suggest_capacity(x, h, dims)
    g = HG.build_graph(x.to(dev), h, dims, max_per_cell=mpc, k=k)
    model = load_weights_json(GECKO, device=dev)
    cfg = dataclasses.replace(model.cfg, fire_rate=1.0)
    p0 = model.params
    A0 = plane_seed(x2, 16, gmin=(-1.0, -1.0), gsize=(2.0, 2.0),
                    radius=h).to(dev)
    A0 = A0.expand(TRAIN_B, -1, -1).contiguous()
    W = normal_cuda(np.random.default_rng(SEED + 6), tuple(A0.shape), dev)
    eng = build_cell_engine(x, h, pair_tables="float32", device=dev)
    grads = {}
    for label in ("graph", "graph float64", "cells"):
        dt = torch.float64 if label == "graph float64" else torch.float32
        p = type(p0)(*(t.to(dt).clone().requires_grad_(True) for t in p0))
        gen = torch.Generator(device=dev).manual_seed(SEED)
        if label.startswith("graph"):
            gl = g if dt == torch.float32 else HG.graph_from_neighbor_list(
                x.to(dev, dt), h, HG.NeighborList(g.idx, g.valid, None))
            final = rollout_batch(p, cfg, gl, A0.to(dt), gen,
                                  GRAPH_GRAD_STEPS, h).final
        else:
            final = batched_gather_back(eng, rollout_cells_batched(
                p, cfg, eng, batched_scatter(eng, A0), TRAIN_B, gen,
                GRAPH_GRAD_STEPS, h), TRAIN_B)
        torch.sum(final * W.to(dt)).backward()
        grads[label] = [t.grad.double() for t in p]
    if not all(float(b.abs().max()) > 0 for b in grads["cells"]):
        fail("graph-train: a parameter gradient of the check is 0")
    gaps = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(grads["graph"], grads["cells"])]
    gaps64 = [float((a - b).abs().max() / b.abs().max())
              for a, b in zip(grads["graph"], grads["graph float64"])]
    phase("graph-train", t0, f"train CLI --engine graph, {GRAPH_TRAIN_ITERS} "
          f"iterations: loss {np.mean(losses[:5]):.4f} -> "
          f"{np.mean(losses[-5:]):.4f} (mean of the first / last 5), no "
          f"kernel launched; {DEPTH_ITERS} full-depth iterations (steps "
          f"{[r['steps'] for r in deep]}): "
          + ", ".join(f"{ms:.1f}" for ms in iter_ms)
          + f" ms (host clock), peak memory {peak / 2**30:.2f} GiB; K={g.k}; "
          f"{GRAPH_GRAD_STEPS}-step BPTT gradient at fire_rate 1.0 (the "
          f"gecko from the seed, B={TRAIN_B}) against the cell engine's "
          f"batched path: "
          + ", ".join(f"{n} {v:.3e}" for n, v in zip(p0._fields, gaps))
          + f" of max (limit {GRAPH_GRAD_RTOL}); against the graph in "
          f"float64: " + ", ".join(f"{v:.3e}" for v in gaps64) + f" | {smi}")
    if not max(gaps) <= GRAPH_GRAD_RTOL:
        fail(f"graph BPTT gradient departs from the cell engine's: {gaps}")
    return {"iter_ms": iter_ms, "peak_bytes": peak}


def graph_surface_cli_phase(dev, smi) -> None:
    """[graph-surface-cli]: cli.test --surface --engine graph on the
    procedural mesh, SURF_N points, SURF_STEPS steps: stripes (the random
    seed, pre-diffused on a float32 band engine at radius 0.2) and gecko
    (radial seeds): the files, no kernel launched; then the engine-to-
    engine check: CHECK_STEPS steps at fire_rate 1.0 from each run's final
    state with the random seed's tangent field, rollout_mesh on the CLI's
    graphs and the cell engine's rollout_mesh_batched_dual (float32 tables,
    the table kernels, a float32 MLP), each within ROLLOUT_ATOL (states and
    tangents) of the same rollout on the graphs in float64; their distance
    to each other is printed (the texture model's steps amplify each
    engine's rounding: 1.02e-04 in 16 steps on an H100)."""
    t0 = time.time()
    from sph_nca_tpu_torch.models.surface import DIFFUSE_DIMS, rollout_mesh
    from sph_nca_tpu_torch.ops import hashgrid as HG

    runs = {"stripes-random": STRIPES, "gecko-radial": GECKO}
    every = 16
    finals, lines = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        obj = write_mesh_obj(os.path.join(tmp, "bumpy.obj"))
        for label, weights in runs.items():
            out_dir = os.path.join(tmp, label)
            reset_launches()
            t1 = time.time()
            rc = cli_test.main([
                "--weights_json", weights, "--surface", obj,
                "--surface_numpoints", str(SURF_N), "--steps",
                str(SURF_STEPS), "--export_every", str(every), "--seed",
                str(SEED), "--device", "cuda", "--output_dir", out_dir,
                "--engine", "graph"])
            torch.cuda.synchronize()
            secs = time.time() - t1
            graph_launches_zero(f"the graph surface CLI ({label})")
            if rc != 0:
                fail(f"graph surface CLI ({label}) returned {rc}")
            (run,) = os.listdir(out_dir)
            run = os.path.join(out_dir, run)
            with np.load(os.path.join(run, "states.npz")) as z:
                x, states = z["x"], z["states"]
            if (x.shape != (SURF_N, 3)
                    or states.shape != (SURF_STEPS + 1, SURF_N, 16)
                    or not np.isfinite(states).all()
                    or np.abs(x).max() > 1 + 1e-5):
                fail(f"graph surface CLI ({label}): shapes {x.shape} "
                     f"{states.shape}, non-finite states or points off the "
                     "normalized mesh")
            names = sorted(f for f in os.listdir(run) if f.endswith(".ply"))
            if names != [f"{i:04d}.ply"
                         for i in range(0, SURF_STEPS + 1, every)]:
                fail(f"graph surface CLI ({label}) PLY files {names}")
            for name in names:
                pts, rgba = load_ply_points(os.path.join(run, name))
                if not (np.array_equal(pts, x)
                        and rgba.shape == (SURF_N, 4)):
                    fail(f"graph surface CLI ({label}) {name}: wrong points")
            finals[label] = states[-1]
            live = [float((np.abs(states[k]).max(-1) > 0).mean())
                    for k in (0, SURF_STEPS)]
            lines.append(f"{label} {secs:.2f} s, {len(names)} PLY files, "
                         f"share of points not 0 at steps 0 and "
                         f"{SURF_STEPS}: {live[0]:.4f} {live[1]:.4f}")
        xs, nrm, _ = cli_test.surface_points(
            obj, 1.0, SURF_N, np.random.default_rng(SEED), dev)
    if not np.array_equal(xs, x):
        fail("graph surface CLI: the points differ from surface_points'")
    xt, nt = torch.from_numpy(xs).to(dev), torch.from_numpy(nrm).to(dev)
    with torch.no_grad():
        peng = build_cell_engine(xs, cli_test.SEED_RADIUS_RANDOM,
                                 pair_tables="float32", w6_only=True,
                                 device=dev)
        t_seed = surface_random_seed(
            xt, nt, 16, np.random.default_rng(SEED),
            torch.Generator(device=dev).manual_seed(SEED), peng,
            cli_test.PREDIFFUSE_PASSES)[1]
        del peng
        for label, weights in runs.items():
            model = load_weights_json(weights, device=dev)
            h = model.h
            cfg = dataclasses.replace(model.cfg, fire_rate=1.0,
                                      use_alpha=model.mode == "image")
            g = cli_test.graph_engine(xt, h, HG.default_dims(h), None,
                                      cfg.smoothing)
            gd = (g if abs(h - DIFFUSE_H) < 1e-9 else cli_test.graph_engine(
                xt, DIFFUSE_H, DIFFUSE_DIMS, None, cfg.smoothing))
            eng = build_cell_engine(xs, h, pair_tables="float32", device=dev)
            A = torch.from_numpy(finals[label]).to(dev)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            out = {"graph": rollout_mesh(model.params, cfg, g, gd, A, nt,
                                         t_seed, gen, CHECK_STEPS, h)[:2]}
            cA, cT = rollout_mesh_batched_dual(
                model.params, cfg, eng, eng, A[None], nt, t_seed[None], gen,
                CHECK_STEPS, h)
            out["cells"] = (cA[0], cT[0])
            # the reference: the same rollout on the graphs in float64
            def f64(e, r):
                return HG.graph_from_neighbor_list(
                    xt.double(), r, HG.NeighborList(e.idx, e.valid, None),
                    smoothing=cfg.smoothing)

            g64 = f64(g, h)
            gd64 = g64 if gd is g else f64(gd, DIFFUSE_H)
            ref = rollout_mesh(
                type(model.params)(*(t.double() for t in model.params)),
                cfg, g64, gd64, A.double(), nt.double(), t_seed.double(),
                gen, CHECK_STEPS, h)[:2]

            def dist(a, b):
                return max(float((a[0].double() - b[0]).abs().max()),
                           float((a[1].double() - b[1]).abs().max()))

            gaps = {k: dist(v, ref) for k, v in out.items()}
            pair = dist(out["graph"], [t.double() for t in out["cells"]])
            lines.append(f"{label}: K={g.k}, {CHECK_STEPS} steps from the "
                         f"final state, states and tangents against float64 "
                         f"graphs: graph {gaps['graph']:.3e}, cell engine "
                         f"{gaps['cells']:.3e}; graph against the cell "
                         f"engine {pair:.3e}")
            if not max(gaps.values()) <= ROLLOUT_ATOL:
                fail(f"graph surface rollout ({label}): {gaps} from the "
                     "float64 rollout")
            del g, gd, eng, g64, gd64
    for line in lines:
        print(f"  {line}", flush=True)
    phase("graph-surface-cli", t0, f"test CLI --surface --engine graph on "
          f"the procedural mesh, {SURF_N} points, {SURF_STEPS} steps, no "
          f"kernel launched; {CHECK_STEPS} steps at fire_rate 1.0 on the "
          f"graphs and on the cell engine, each within {ROLLOUT_ATOL} of "
          f"the float64 graphs' | {smi}")


def graph_rebuild_phase(dev, smi) -> None:
    """[graph-rebuild]: rollout_rebuild on the gecko's grid (IMAGE x IMAGE
    in 3D, GRAPH_REBUILD_STEPS steps at fire_rate 1.0): without motion it
    equals rollout_states on the static graph within GRAPH_RTOL of max; with
    the drift x + 0.01 sin(3 x reversed) (tests/test_rollout.py) it stays
    finite, every list exact at capacities sized for the drifted positions
    (the largest suggest_capacity over the trajectory)."""
    t0 = time.time()
    from sph_nca_tpu_torch.models.rollout import rollout_rebuild, rollout_states
    from sph_nca_tpu_torch.ops import hashgrid as HG

    model = load_weights_json(GECKO, device=dev)
    h = model.h
    cfg = dataclasses.replace(model.cfg, fire_rate=1.0)
    x, x2 = plane_points(IMAGE)
    xd = x.to(dev)
    A0 = plane_seed(x2, 16, gmin=(-1.0, -1.0), gsize=(2.0, 2.0),
                    radius=h).to(dev)
    dims = HG.default_dims(h)

    def drift(x, A, t):
        return x + 0.01 * torch.sin(3.0 * x.flip(-1))

    caps, xt = [], xd
    for t in range(GRAPH_REBUILD_STEPS + 1):
        caps.append(HG.suggest_capacity(xt, h, dims))
        xt = drift(xt, None, t)
    mpc, k = max(c[0] for c in caps), max(c[1] for c in caps)
    with torch.no_grad():
        gen = torch.Generator(device=dev).manual_seed(SEED)
        _, _, still, dropped0 = rollout_rebuild(
            model.params, cfg, xd, A0, gen, GRAPH_REBUILD_STEPS, h, dims,
            max_per_cell=mpc, k=k)
        g = HG.build_graph(xd, h, dims, max_per_cell=mpc, k=k)
        static = rollout_states(model.params, cfg, g, A0, gen,
                                GRAPH_REBUILD_STEPS, h)
        torch.cuda.synchronize()
        t1 = time.time()
        xf, Af, moved, dropped = rollout_rebuild(
            model.params, cfg, xd, A0, gen, GRAPH_REBUILD_STEPS, h, dims,
            max_per_cell=mpc, k=k, advect=drift)
        torch.cuda.synchronize()
        moved_ms = (time.time() - t1) * 1e3 / GRAPH_REBUILD_STEPS
    gap = float((still - static).abs().max() / static.abs().max())
    shift = float((xf - xd).norm(dim=-1).max())
    ok = (gap <= GRAPH_RTOL and bool(torch.isfinite(moved).all())
          and int(dropped0.abs().sum()) == 0 and int(dropped.abs().sum()) == 0)
    phase("graph-rebuild", t0, f"rollout_rebuild, gecko {IMAGE}x{IMAGE}, "
          f"{GRAPH_REBUILD_STEPS} steps at fire_rate 1.0, capacities "
          f"{mpc} / {k}: without motion vs rollout_states {gap:.3e} of max "
          f"(limit {GRAPH_RTOL}); drifting (largest shift {shift:.4f}): "
          f"finite {bool(torch.isfinite(moved).all())}, dropped per step "
          f"{dropped.tolist()}, {moved_ms:.2f} ms a step with its rebuild "
          f"(host clock) | {smi}")
    if not ok:
        fail("graph rebuild: static gap, non-finite states or dropped "
             "neighbours")


def graph_phases(dev, smi, alive_cells: float) -> dict:
    """The graph engine's phases in order; returns their numbers and
    seconds."""
    t0 = time.time()
    graph_build_phase(dev, smi)
    graph_ops_phase(dev, smi)
    out = {"inference": graph_inference_phase(dev, smi, alive_cells),
           "train": graph_train_phase(dev, smi)}
    graph_surface_cli_phase(dev, smi)
    graph_rebuild_phase(dev, smi)
    out["seconds"] = time.time() - t0
    phase("graph", t0, "the graph engine's phases together")
    return out


# ---- the sharded paths (sph_nca_tpu_torch/parallel) ----------------------------

PARALLEL_RANKS = 2  # ranks sharing the one card over gloo
PARALLEL_STEPS = 16
PARALLEL_GRAD_STEPS = 8
PARALLEL_CELL_GRAD_STEPS = 3
PARALLEL_TRAIN_STEPS = 40
PARALLEL_TRAIN_MESHES = (((2, 1), 2), ((1, 2), 1))  # (data, particle), iters
# the sharded BPTT gradient against the unsharded one, of max: the JAX
# package's sharded-vs-global bar (tests/test_band_shard.py)
PARALLEL_GRAD_RTOL = 1e-3
# the sharded cell paths' gradients against the same layout on one device
# (tests/test_parallel.py's bar)
PARALLEL_CELL_GRAD_RTOL = 1e-4
# the two far exchanges deliver the same rows to the same products
PARALLEL_MODES_RTOL = 1e-6
# the sharded train step against one process: the losses and Adam's
# moments within TRAIN_PARITY_RTOL of max; the parameters within
# TRAIN_PARAM_LR of a learning rate (Adam's update m / (sqrt(v) + eps)
# passes on the gradients' relative error, which the order of the sums sets
# at ~1e-7 absolute on normalized gradients); a parameter whose normalized
# gradient lies within ADAM_TIE of 0 at an iteration takes an update whose
# sign the order of the sums decides, and is counted instead
TRAIN_PARITY_RTOL = 1e-5
TRAIN_PARAM_LR = 1e-2
TRAIN_LR = 3e-3
ADAM_TIE = 1e-6


def _rank_dev(kind: str) -> torch.device:
    """A rank's device: the card ``run_ranks`` gave it, or the CPU when the
    plumbing is rehearsed there."""
    if kind == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(kind)


def parallel_inputs(dev) -> dict:
    """The sharded phases' engines, parameters and states, built on the
    host and handed to the ranks (each moves its shard to the card)."""
    from sph_nca_tpu_torch.models.nca import SPHNCAConfig, init_params
    from sph_nca_tpu_torch.ops.bands import build_band_engine
    from sph_nca_tpu_torch.utils.image import flat_color_target

    rng = np.random.default_rng(SEED + 17)
    gen = torch.Generator().manual_seed(SEED + 17)
    cfg = SPHNCAConfig(channels=16, hidden=256, fire_rate=1.0)
    xb = fibonacci_sphere(BENCH_N, BENCH_RADIUS)
    t1 = time.time()
    beng = build_band_engine(xb, bench_h(), table_dtype="bfloat16",
                             block_multiple=PARALLEL_RANKS, device="cpu")
    bench = {"eng": beng, "h": bench_h(), "cfg": cfg,
             "params": init_params(cfg, gen, device="cpu"),
             "A": band_states(rng, BATCH_B, BENCH_N, "cpu"),
             "build_s": time.time() - t1}

    model = load_weights_json(GECKO, device="cpu")
    gcfg = dataclasses.replace(model.cfg, fire_rate=1.0)
    x, x2 = plane_points(IMAGE)
    seed = plane_seed(x2, 16, gmin=(-1.0, -1.0), gsize=(2.0, 2.0),
                      radius=TRAIN_H)
    A_seed = seed.expand(TRAIN_B, -1, -1).clone()
    A_seed[..., 4:] += torch.from_numpy(rng.uniform(
        -0.1, 0.1, A_seed[..., 4:].shape).astype(np.float32))
    grad = {"eng": build_band_engine(x, TRAIN_H, table_dtype="float32",
                                     block_multiple=PARALLEL_RANKS,
                                     device="cpu"),
            "h": TRAIN_H, "cfg": gcfg, "params": model.params, "A": A_seed,
            "W": torch.from_numpy(rng.normal(size=tuple(A_seed.shape)).astype(
                np.float32))}

    stripes = load_weights_json(STRIPES, device="cpu")
    xs = fibonacci_sphere(SURF_N, SURF_RADIUS)
    nrm = torch.from_numpy(sphere_normals(xs))
    t0r = torch.from_numpy(rng.normal(size=(SURF_B, SURF_N, 3)).astype(
        np.float32))
    surface = {"eng": build_band_engine(xs, stripes.h, table_dtype="bfloat16",
                                        block_multiple=PARALLEL_RANKS,
                                        device="cpu"),
               "h": stripes.h,
               "cfg": dataclasses.replace(stripes.cfg, fire_rate=1.0),
               "params": stripes.params, "nrm": nrm,
               "t0": orthogonalize(nrm, normalize(t0r)),
               "A": torch.from_numpy(rng.uniform(
                   0.0, 1.0, (SURF_B, SURF_N, 16)).astype(np.float32))}

    gecko = load_weights_json(GECKO, device="cpu")
    A0 = plane_seed(x2, 16, gmin=(-1.0, -1.0), gsize=(2.0, 2.0),
                    radius=gecko.h)
    cells = {"x": x, "h": gecko.h,
             "cfg": dataclasses.replace(gecko.cfg, fire_rate=1.0),
             "params": gecko.params, "A": A0,
             "AB": A0.expand(BATCH_B, -1, -1).contiguous(),
             "W": torch.from_numpy(rng.normal(size=(x.shape[0], 16)).astype(
                 np.float32))}

    tcfg = SPHNCAConfig(channels=16, hidden=256, fire_rate=1.0,
                        normalize_perception=1.0 / TRAIN_H)
    steps = PARALLEL_TRAIN_STEPS
    train = {"x": x, "x2": x2, "h": TRAIN_H, "cfg": tcfg,
             "params": init_params(tcfg, gen, device="cpu"),
             "A": A_seed, "img": torch.from_numpy(flat_color_target(64)),
             "image_scale": 64 / IMAGE, "steps": steps,
             "collect": [0, steps // 4, steps // 2, steps]}
    return {"bench": bench, "grad": grad, "surface": surface, "cells": cells,
            "train": train, "device": dev.type}


def _sync_barrier():
    import torch.distributed as dist

    torch.cuda.synchronize()
    dist.barrier()


def _rank_band(b, mesh, dev) -> dict:
    """[parallel-band] on this rank: the perception in both far modes; a
    PARALLEL_STEPS-step rollout with a float32 MLP (held by the parent);
    the same with the bench's bfloat16 MLP, timed, its exchange counted,
    and 4 of its steps profiled."""
    from torch.profiler import ProfilerActivity, profile

    from sph_nca_tpu_torch.models.nca import MLPParams
    from sph_nca_tpu_torch.parallel import band_shard as BS
    from sph_nca_tpu_torch.parallel import comm
    from sph_nca_tpu_torch.parallel import mesh as MS

    t0 = time.time()
    out = {}
    locs = {}
    for halo in ("targeted", "allgather"):
        shards, st = BS.shard_band_engine(b["eng"], PARALLEL_RANKS, halo=halo)
        locs[halo] = (BS.place_shards(shards, mesh, dev), st, shards)
    X = MS.particle_slice(batched_scatter(b["eng"], b["A"]), mesh).to(dev)
    params = MLPParams(*(t.to(dev) for t in b["params"]))
    cfg, h = b["cfg"], b["h"]
    with torch.no_grad():
        pas = {halo: BS.perceive_band_sharded(loc, st, X, BATCH_B, True,
                                              out_dtype="bfloat16", mesh=mesh)
               for halo, (loc, st, _) in locs.items()}
        out["mode_gap"] = max(
            float((a.float() - c.float()).abs().max())
            / max(float(c.float().abs().max()), 1e-30)
            for a, c in zip(pas["targeted"], pas["allgather"]))
        loc, st, shards = locs["targeted"]
        reset_launches()
        fin = BS.rollout_band_sharded(params, cfg, loc, st, mesh, X, BATCH_B,
                                      SEED, PARALLEL_STEPS, h)
        torch.cuda.synchronize()
        out["launches"] = read_launches()
        out["final"] = MS.particle_gather(fin, mesh).cpu()

        def run(steps):
            return BS.rollout_band_sharded(params, cfg, loc, st, mesh, X,
                                           BATCH_B, SEED, steps, h,
                                           mlp_dtype="bfloat16")
        run(2)
        _sync_barrier()
        comm.reset_stats()
        t1 = time.time()
        bf = run(PARALLEL_STEPS)
        _sync_barrier()
        out["ms_step"] = (time.time() - t1) * 1e3 / PARALLEL_STEPS
        out["stats"] = comm.read_stats()
        out["finite"] = bool(torch.isfinite(bf).all())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.time()
            run(4)
            torch.cuda.synchronize()
            wall_us = (time.time() - t1) * 1e6
        dev_us = sum(getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0))
                     for ev in prof.key_averages()
                     if ev.device_type != torch.autograd.DeviceType.CPU)
        out["busy"] = dev_us / wall_us
    out["comm"] = BS.comm_bytes_per_pass(shards, st, BATCH_B * 16, 2)
    out["seconds"] = time.time() - t0
    return out


def _rank_band_grad(g, mesh, dev) -> dict:
    """[parallel-band-grad] on this rank: a PARALLEL_GRAD_STEPS-step BPTT
    through rollout_band_sharded (each step recomputed in the backward);
    the parameters' gradient summed over the ranks."""
    from sph_nca_tpu_torch.models.nca import MLPParams
    from sph_nca_tpu_torch.parallel import band_shard as BS
    from sph_nca_tpu_torch.parallel import comm
    from sph_nca_tpu_torch.parallel import mesh as MS

    t0 = time.time()
    shards, st = BS.shard_band_engine(g["eng"], PARALLEL_RANKS)
    loc = BS.place_shards(shards, mesh, dev)
    X = MS.particle_slice(batched_scatter(g["eng"], g["A"]), mesh).to(dev)
    W = MS.particle_slice(batched_scatter(g["eng"], g["W"]), mesh).to(dev)
    p = MLPParams(*(t.to(dev).clone().requires_grad_(True) for t in g["params"]))
    reset_launches()
    fin = BS.rollout_band_sharded(p, g["cfg"], loc, st, mesh, X, TRAIN_B,
                                  SEED, PARALLEL_GRAD_STEPS, g["h"])
    torch.sum(fin * W).backward()
    torch.cuda.synchronize()
    return {"launches": read_launches(),
            "grads": [comm.all_reduce_(t.grad.clone()).cpu() for t in p],
            "seconds": time.time() - t0}


def _rank_surface(s, mesh, dev) -> dict:
    """[parallel-surface] on this rank: rollout_mesh_band_sharded,
    PARALLEL_STEPS steps, float32 MLP."""
    from sph_nca_tpu_torch.models.nca import MLPParams
    from sph_nca_tpu_torch.parallel import band_shard as BS
    from sph_nca_tpu_torch.parallel import mesh as MS

    t0 = time.time()
    eng = s["eng"]
    shards, st = BS.shard_band_engine(eng, PARALLEL_RANKS)
    loc = BS.place_shards(shards, mesh, dev)
    rows = eng.num_cells * eng.slots_per_cell

    def local(t):
        return MS.particle_slice(t, mesh).to(dev)

    reset_launches()
    with torch.no_grad():
        fS, ftd = BS.rollout_mesh_band_sharded(
            MLPParams(*(t.to(dev) for t in s["params"])), s["cfg"], loc, st,
            mesh, local(batched_scatter(eng, s["A"])),
            local(eng.scatter(s["nrm"])),
            local(batched_scatter(eng, s["t0"]).reshape(rows, SURF_B, 3)),
            SURF_B, SEED, PARALLEL_STEPS, s["h"])
        torch.cuda.synchronize()
    return {"launches": read_launches(),
            "final": MS.particle_gather(fS, mesh).cpu(),
            "td": torch.stack([MS.particle_gather(t, mesh) for t in ftd],
                              -1).cpu(),
            "seconds": time.time() - t0}


def _cell_grads(params, cfg, eng, S0, W, h):
    """(final, the parameters' gradient of sum(final * W)) of a
    PARALLEL_CELL_GRAD_STEPS-step rollout_cells."""
    from sph_nca_tpu_torch.models.nca import MLPParams

    p = MLPParams(*(t.detach().clone().requires_grad_(True) for t in params))
    fin = rollout_cells(p, cfg, eng, S0, torch.Generator(S0.device),
                        PARALLEL_CELL_GRAD_STEPS, h)
    torch.sum(fin * W).backward()
    return fin.detach(), [t.grad for t in p]


def _rank_cells(c, mesh, dev) -> dict:
    """[parallel-cells] on this rank: the gecko on engines built with
    n_shards=2, each rank running the kernels on its blocks: the recompute
    engine (2.1-2.3) PARALLEL_STEPS steps (at fire_rate 1, and at 0.5 from
    a seeded generator) and a 3-step gradient, float32
    tables (2.4-2.6) a 3-step gradient, the batched bfloat16 tables (2.4 /
    2.6 / 2.8) at B = BATCH_B, PARALLEL_STEPS steps; launches per path."""
    from sph_nca_tpu_torch.models.nca import MLPParams
    from sph_nca_tpu_torch.parallel import comm
    from sph_nca_tpu_torch.parallel import mesh as MS

    t0 = time.time()
    x, h, cfg = c["x"], c["h"], c["cfg"]
    params = MLPParams(*(t.to(dev) for t in c["params"]))
    out = {}

    def gather(t):
        return MS.particle_gather(t, mesh, dim=-3).cpu()

    for label, tables in (("recompute", None), ("tables", "float32")):
        eng = build_cell_engine(x, h, n_shards=PARALLEL_RANKS,
                                pair_tables=tables, device=dev)
        sh = MS.shard_cell_engine(eng, mesh)
        S0 = MS.particle_slice(eng.scatter(c["A"].to(dev)), mesh)
        W = MS.particle_slice(eng.scatter(c["W"].to(dev)), mesh)
        res = {}
        reset_launches()
        if tables is None:
            with torch.no_grad():
                res["final"] = gather(rollout_cells(
                    params, cfg, sh, S0, torch.Generator(dev),
                    PARALLEL_STEPS, h))
            torch.cuda.synchronize()
            res["launches"] = read_launches()
            with torch.no_grad():
                res["fire_half"] = gather(rollout_cells(
                    params, cfg, sh, S0, torch.Generator(dev).manual_seed(
                        SEED), PARALLEL_STEPS, h, fire_rate=0.5))
            reset_launches()
        fin, grads = _cell_grads(params, cfg, sh, S0, W, h)
        torch.cuda.synchronize()
        res["grad_launches"] = read_launches()
        res["grad_final"] = gather(fin)
        res["grads"] = [comm.all_reduce_(g.clone()).cpu() for g in grads]
        out[label] = res
        del eng, sh
    eng = build_cell_engine(x, h, n_shards=PARALLEL_RANKS,
                            pair_tables="bfloat16", device=dev)
    sh = MS.shard_cell_engine(eng, mesh)
    SB = MS.particle_slice(batched_scatter(eng, c["AB"].to(dev)), mesh)
    reset_launches()
    with torch.no_grad():
        fin = rollout_cells_batched(params, cfg, sh, SB, BATCH_B,
                                    torch.Generator(dev), PARALLEL_STEPS, h)
        torch.cuda.synchronize()
    out["batched"] = {"launches": read_launches(), "final": gather(fin)}
    out["seconds"] = time.time() - t0
    return out


def _train_objective(t, dev):
    from sph_nca_tpu_torch.training.losses import MSELossConfig

    return t["img"].to(dev), MSELossConfig(
        gmin=(-1.0, -1.0), gsize=(2.0, 2.0), image_scale=t["image_scale"])


def _train_graph(t, dev):
    from sph_nca_tpu_torch.ops import hashgrid as HG

    dims = HG.default_dims(t["h"])
    mpc, k = HG.suggest_capacity(t["x"], t["h"], dims)
    return HG.build_graph(t["x"].to(dev), t["h"], dims, max_per_cell=mpc,
                          k=k)


def _rank_train(t, dev) -> dict:
    """[parallel-train] on this rank: make_sharded_train_step on the graph
    engine at the train CLI's defaults, on each mesh of
    PARALLEL_TRAIN_MESHES; per mesh and iteration the loss, this rank's
    parameters and Adam state after it."""
    from sph_nca_tpu_torch.models.nca import MLPParams
    from sph_nca_tpu_torch.parallel import mesh as MS
    from sph_nca_tpu_torch.parallel.shard import (
        make_sharded_train_step,
        mse_loss_piece,
    )
    from sph_nca_tpu_torch.training.trainer import make_optimizer

    t0 = time.time()
    graph = _train_graph(t, dev)
    img, loss_cfg = _train_objective(t, dev)
    out = []
    for (nd, npart), iters in PARALLEL_TRAIN_MESHES:
        mesh = MS.make_mesh(data=nd, particle=npart, backend="gloo")
        p = MLPParams(*(q.requires_grad_(True) for q in MS.replicate(
            MLPParams(*(q.to(dev) for q in t["params"])), mesh)))
        opt, sched = make_optimizer(list(p), TRAIN_LR)
        x2 = MS.particle_slice(t["x2"].to(dev), mesh)
        piece = mse_loss_piece(img, loss_cfg, x2, TRAIN_B,
                               t["x2"].shape[0])
        step = make_sharded_train_step(t["cfg"], opt, piece, t["h"], mesh,
                                       t["steps"], scheduler=sched)
        A = MS.shard_batch(t["A"].to(dev), mesh)
        g = MS.shard_graph(graph, mesh)
        snaps, ms = [], 0.0
        for i in range(iters):
            t1 = time.time()
            loss = step.fn(p, g, A, SEED, i, t["steps"], t["collect"])[0]
            torch.cuda.synchronize()
            ms += (time.time() - t1) * 1e3
            snaps.append({"losses": [loss],
                          "params": [q.detach().cpu().clone() for q in p],
                          "state": [{k: v.cpu().clone()
                                     for k, v in opt.state[q].items()}
                                    for q in p]})
        out.append({"iters": snaps, "ms_iter": ms / iters})
    return {"meshes": out, "seconds": time.time() - t0}


def parallel_rank(inp) -> dict:
    """One of PARALLEL_RANKS ranks sharing the card over gloo: every
    sharded phase's part on this rank."""
    from sph_nca_tpu_torch.parallel import mesh as MS

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = _rank_dev(inp["device"])
    mesh = MS.make_mesh(data=1, particle=PARALLEL_RANKS, backend="gloo")
    return {"band": _rank_band(inp["bench"], mesh, dev),
            "grad": _rank_band_grad(inp["grad"], mesh, dev),
            "surface": _rank_surface(inp["surface"], mesh, dev),
            "cells": _rank_cells(inp["cells"], mesh, dev),
            "train": _rank_train(inp["train"], dev)}


def nccl_rank(b, kind: str) -> dict:
    """[parallel-nccl] on this rank: the [parallel-band] check rollout over
    NCCL, one rank a card."""
    import torch.distributed as dist

    from sph_nca_tpu_torch.models.nca import MLPParams
    from sph_nca_tpu_torch.parallel import band_shard as BS
    from sph_nca_tpu_torch.parallel import comm
    from sph_nca_tpu_torch.parallel import mesh as MS

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = _rank_dev(kind)
    k = dist.get_world_size()
    mesh = MS.make_mesh(data=1, particle=k)
    shards, st = BS.shard_band_engine(b["eng"], k)
    loc = BS.place_shards(shards, mesh, dev)
    X = MS.particle_slice(batched_scatter(b["eng"], b["A"]), mesh).to(dev)
    params = MLPParams(*(t.to(dev) for t in b["params"]))
    with torch.no_grad():
        BS.rollout_band_sharded(params, b["cfg"], loc, st, mesh, X, BATCH_B,
                                SEED, 2, b["h"])  # warm-up
        torch.cuda.synchronize()
        dist.barrier()
        comm.reset_stats()
        reset_launches()
        t1 = time.time()
        fin = BS.rollout_band_sharded(params, b["cfg"], loc, st, mesh, X,
                                      BATCH_B, SEED, PARALLEL_STEPS, b["h"])
        torch.cuda.synchronize()
    return {"ranks": k, "device": str(dev),
            "ms_step": (time.time() - t1) * 1e3 / PARALLEL_STEPS,
            "launches": read_launches(), "stats": comm.read_stats(),
            "final": MS.particle_gather(fin, mesh).cpu()}


def _gap(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def parallel_references(dev, inp) -> dict:
    """The unsharded twins on the card, in this process, before the ranks
    start: the bench rollout (float32 MLP held; bfloat16 MLP timed), the
    band BPTT gradient, the surface rollout, the cell paths (the n_shards=1
    engine, and the n_shards=2 engine on one device), the train step on one
    process."""
    from sph_nca_tpu_torch.models.nca import MLPParams

    def on(params):
        return MLPParams(*(t.to(dev) for t in params))

    ref = {}
    b = inp["bench"]
    beng = b["eng"].to(dev)
    SB = batched_scatter(beng, b["A"].to(dev))
    with torch.no_grad():
        ref["band"] = rollout_cells_batched(
            on(b["params"]), b["cfg"], beng, SB, BATCH_B,
            torch.Generator(dev), PARALLEL_STEPS, b["h"])

        def run(steps):
            return rollout_cells_batched(
                on(b["params"]), b["cfg"], beng, SB, BATCH_B,
                torch.Generator(dev), steps, b["h"], mlp_dtype="bfloat16")
        run(2)
        torch.cuda.synchronize()
        t1 = time.time()
        run(PARALLEL_STEPS)
        torch.cuda.synchronize()
        ref["band_ms_step"] = (time.time() - t1) * 1e3 / PARALLEL_STEPS
    del beng, SB

    g = inp["grad"]
    geng = g["eng"].to(dev)
    p = MLPParams(*(t.to(dev).clone().requires_grad_(True) for t in g["params"]))
    fin = rollout_cells_batched(p, g["cfg"], geng,
                                batched_scatter(geng, g["A"].to(dev)),
                                TRAIN_B, torch.Generator(dev),
                                PARALLEL_GRAD_STEPS, g["h"])
    torch.sum(fin * batched_scatter(geng, g["W"].to(dev))).backward()
    ref["grad"] = [t.grad.cpu() for t in p]
    del geng, fin

    s = inp["surface"]
    seng = s["eng"].to(dev)
    with torch.no_grad():
        ref["surface"] = [t.cpu() for t in rollout_mesh_batched(
            on(s["params"]), s["cfg"], seng, s["A"].to(dev),
            s["nrm"].to(dev), s["t0"].to(dev), torch.Generator(dev),
            PARALLEL_STEPS, s["h"])]
    del seng

    c = inp["cells"]
    cref = {}
    for k in (1, PARALLEL_RANKS):
        for tables in (None, "float32", "bfloat16"):
            eng = build_cell_engine(c["x"], c["h"], n_shards=k,
                                    pair_tables=tables, device=dev)
            S0 = eng.scatter(c["A"].to(dev))
            with torch.no_grad():
                if tables is None:
                    cref[k, "final"] = eng.gather_back(rollout_cells(
                        on(c["params"]), c["cfg"], eng, S0,
                        torch.Generator(dev), PARALLEL_STEPS, c["h"]))
                if tables is None and k == PARALLEL_RANKS:
                    cref[k, "fire_half"] = eng.gather_back(rollout_cells(
                        on(c["params"]), c["cfg"], eng, S0,
                        torch.Generator(dev).manual_seed(SEED),
                        PARALLEL_STEPS, c["h"], fire_rate=0.5))
                if tables == "bfloat16":
                    cref[k, "batched"] = batched_gather_back(
                        eng, rollout_cells_batched(
                            on(c["params"]), c["cfg"], eng,
                            batched_scatter(eng, c["AB"].to(dev)), BATCH_B,
                            torch.Generator(dev), PARALLEL_STEPS, c["h"]),
                        BATCH_B)
            if k == PARALLEL_RANKS and tables != "bfloat16":
                fin, grads = _cell_grads(on(c["params"]), c["cfg"], eng, S0,
                                         eng.scatter(c["W"].to(dev)), c["h"])
                cref[k, tables, "grads"] = [q.cpu() for q in grads]
                cref[k, tables, "grad_final"] = eng.gather_back(fin)
            cref[k, tables, "eng"] = eng
    ref["cells"] = cref

    torch.cuda.empty_cache()
    return ref


def reference_train_step(t, dev, graph, start, i: int) -> dict:
    """One single-process training iteration (``training.trainer``'s update
    on the whole batch) from ``start``: None for the initial parameters, or
    a rank's snapshot after iteration i - 1 (its parameters, Adam's state;
    the schedule at position i), so every sharded step is held against the
    single-process step from the same inputs."""
    from sph_nca_tpu_torch.models.nca import MLPParams
    from sph_nca_tpu_torch.models.rollout import rollout_batch
    from sph_nca_tpu_torch.training.trainer import (
        make_mse_bundle,
        make_optimizer,
        normalize_grads_,
        set_schedule_position,
    )

    src = t["params"] if start is None else start["params"]
    p = MLPParams(*(q.to(dev).clone().requires_grad_(True) for q in src))
    opt, sched = make_optimizer(list(p), TRAIN_LR)
    if start is not None:
        for q, st in zip(p, start["state"]):
            opt.state[q] = {k: v.clone() if k == "step" else v.to(dev).clone()
                            for k, v in st.items()}
        set_schedule_position(sched, i)
    img, loss_cfg = _train_objective(t, dev)
    bundle = make_mse_bundle(img, loss_cfg)
    x2 = t["x2"].to(dev)
    o = rollout_batch(p, t["cfg"], graph, t["A"].to(dev),
                      torch.Generator(dev), t["steps"], t["h"],
                      n_steps=t["steps"], collect_steps=t["collect"])
    total = bundle.batch_total(x2, o.final)
    for j in range(len(t["collect"])):
        total = total + 0.1 * bundle.batch_total(x2, o.collected[:, j])
    opt.zero_grad(set_to_none=True)
    total.backward()
    normalize_grads_(p)
    grads = [q.grad.detach().cpu().clone() for q in p]
    opt.step()
    sched.step()
    return {"losses": [total.item()], "grads": [grads],
            "params": [q.detach().cpu() for q in p],
            "state": [{k: v.cpu() for k, v in opt.state[q].items()}
                      for q in p]}


def _train_gaps(got, want):
    """(the loss gap and the largest moment gap, relative to max; the
    largest parameter gap outside the Adam ties, in learning rates; the
    count of tie parameters) of one mesh."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                   want["losses"]))
    moment = max(_gap(sa[k], sb[k]) for sa, sb in zip(got["state"],
                                                      want["state"])
                 for k in ("exp_avg", "exp_avg_sq"))
    param, ties = 0.0, 0
    for i, (a, b) in enumerate(zip(got["params"], want["params"])):
        tie = torch.stack([g[i].abs() <= ADAM_TIE
                           for g in want["grads"]]).any(0)
        ties += int(tie.sum())
        diff = torch.where(tie, torch.zeros_like(a), a - b)
        param = max(param, float(diff.abs().max()) / TRAIN_LR)
    return loss, moment, param, ties


def parallel_phases(dev, smi) -> dict:
    """The sharded paths (``sph_nca_tpu_torch/parallel``) on the card:
    PARALLEL_RANKS ranks share it over gloo (the exchanges staged through
    pinned host buffers) in one spawn that serves [parallel-band],
    [parallel-band-grad], [parallel-surface], [parallel-cells] and
    [parallel-train]; then [parallel-nccl], one rank a card over NCCL. The
    kernels and the native library are built before (the build phase), so
    no rank builds. Each phase holds its ranks' result against the
    unsharded twin on the card. Returns the kernels' launches a rank by
    path, and each path's gap from its twin (relative to max, or absolute
    on states of |A| <~ 1 where the phase line says so)."""
    from sph_nca_tpu_torch.parallel.comm import run_ranks

    t0 = time.time()
    inp = parallel_inputs(dev)
    ref = parallel_references(dev, inp)
    phase("parallel-inputs", t0, f"engines built on the host (the bench "
          f"sphere in {inp['bench']['build_s']:.2f} s), the unsharded twins "
          f"on the card | {smi}")
    t0 = time.time()
    res = run_ranks(parallel_rank, PARALLEL_RANKS, inp, device=dev.type,
                    backend="gloo", timeout=600)
    spawn_s = time.time() - t0
    launches, gaps_by_path = {}, {}

    # [parallel-band]
    r = [x["band"] for x in res]
    gap = max(_gap(x["final"], ref["band"]) for x in r)
    modes = max(x["mode_gap"] for x in r)
    acc, st = r[0]["comm"], r[0]["stats"]
    ms = max(x["ms_step"] for x in r)
    launches["parallel-band"] = r[0]["launches"]
    gaps_by_path["parallel-band"] = gap
    phase("parallel-band", t0, f"bench configuration (N={BENCH_N}, "
          f"B={BATCH_B}, bfloat16 tables), {PARALLEL_RANKS} ranks on one card "
          f"over gloo, {PARALLEL_STEPS} steps at fire_rate 1.0: float32 MLP "
          f"against the unsharded band rollout {gap:.3e} of max (limit "
          f"{ROLLOUT_ATOL}); targeted vs allgather perception {modes:.3e} "
          f"(limit {PARALLEL_MODES_RTOL}); bfloat16 MLP {ms:.3f} ms a "
          f"sharded step (slower rank, host clock) vs "
          f"{ref['band_ms_step']:.3f} unsharded; per pass "
          f"{acc['ppermute_bytes']} B ppermuted + {acc['allgather_bytes']} B "
          f"far rows ({acc['mode']}, export fraction "
          f"{acc['export_fraction']:.3f}, full state "
          f"{acc['full_state_bytes']} B); a rank sent "
          f"{st['sent_bytes'] / PARALLEL_STEPS:.0f} B and staged "
          f"{st['staged_bytes'] / PARALLEL_STEPS:.0f} B a step in "
          f"{st['collectives'] / PARALLEL_STEPS:.1f} exchanges; device busy "
          + " + ".join(f"{100 * x['busy']:.1f}%" for x in r)
          + f" (the ranks, 4 profiled steps); launches a rank "
          f"{launches['parallel-band']}; {r[0]['seconds']:.1f} s in the "
          f"ranks | {smi}")
    if not (gap <= ROLLOUT_ATOL and modes <= PARALLEL_MODES_RTOL
            and all(x["finite"] for x in r)):
        fail(f"parallel-band: {gap} against unsharded, {modes} between the "
             "far modes, or non-finite bfloat16 states")
    if launches["parallel-band"] != {**NO_LAUNCHES, "sph_mlp_kernel":
                                     PARALLEL_STEPS}:
        fail(f"parallel-band launches {launches['parallel-band']}")

    # [parallel-band-grad]
    r = [x["grad"] for x in res]
    gaps = [max(_gap(x["grads"][i], want) for x in r)
            for i, want in enumerate(ref["grad"])]
    launches["parallel-band-grad"] = r[0]["launches"]
    gaps_by_path["parallel-band-grad"] = max(gaps)
    phase("parallel-band-grad", t0, f"the train CLI's defaults (N="
          f"{IMAGE * IMAGE}, h={TRAIN_H}, float32 tables, B={TRAIN_B}), "
          f"{PARALLEL_GRAD_STEPS}-step BPTT through rollout_band_sharded at "
          f"fire_rate 1.0: the parameters' gradient summed over the ranks "
          f"against the unsharded one, "
          + ", ".join(f"{v:.3e}" for v in gaps)
          + f" of max (limit {PARALLEL_GRAD_RTOL}); launches a rank "
          f"{launches['parallel-band-grad']}; {r[0]['seconds']:.1f} s | {smi}")
    if not max(gaps) <= PARALLEL_GRAD_RTOL:
        fail(f"parallel-band-grad: {gaps}")

    # [parallel-surface]
    r = [x["surface"] for x in res]
    s = inp["surface"]
    seng = s["eng"]
    got_A = [batched_gather_back(seng, x["final"], SURF_B) for x in r]
    got_t = [batched_gather_back(seng, x["td"].reshape(
        seng.num_cells, seng.slots_per_cell, SURF_B * 3), SURF_B) for x in r]
    ref_A, ref_t = ref["surface"]
    gap_A = max(_gap(a, ref_A) for a in got_A)
    gap_t = max(float((t_ - ref_t).abs().max()) for t_ in got_t)
    launches["parallel-surface"] = r[0]["launches"]
    gaps_by_path["parallel-surface"] = gap_A
    phase("parallel-surface", t0, f"stripes on the {SURF_N}-point sphere "
          f"(bfloat16 band tables, B={SURF_B}, float32 MLP), "
          f"{PARALLEL_STEPS} steps of rollout_mesh_band_sharded at fire_rate "
          f"1.0 against rollout_mesh_batched: states {gap_A:.3e} of max "
          f"(limit {ROLLOUT_ATOL}), unit tangents {gap_t:.3e} (limit "
          f"{ROLLOUT_ATOL}); launches a rank {launches['parallel-surface']}; "
          f"{r[0]['seconds']:.1f} s | {smi}")
    if not (gap_A <= ROLLOUT_ATOL and gap_t <= ROLLOUT_ATOL):
        fail(f"parallel-surface: states {gap_A}, tangents {gap_t}")

    # [parallel-cells]
    r = [x["cells"] for x in res]
    cref = ref["cells"]
    k = PARALLEL_RANKS
    e2 = cref[k, None, "eng"]
    one = float((cref[k, "final"] - cref[1, "final"]).abs().max())
    rec = max(float((e2.gather_back(x["recompute"]["final"].to(dev))
                     - cref[1, "final"]).abs().max()) for x in r)
    # the ranks draw the whole engine's fire mask from the caller's
    # generator and keep their cells: at fire_rate 0.5 too the ranks' rollout
    # is the same engine's on one device
    half = max(float((e2.gather_back(x["recompute"]["fire_half"].to(dev))
                      - cref[k, "fire_half"]).abs().max()) for x in r)
    grad_gaps = {label: max(_gap(a, b) for x in r
                            for a, b in zip(x[label]["grads"],
                                            cref[k, tables, "grads"]))
                 for label, tables in (("recompute", None),
                                       ("tables", "float32"))}
    eb = cref[k, "bfloat16", "eng"]
    bat = max(float((batched_gather_back(eb, x["batched"]["final"].to(dev),
                                         BATCH_B)
                     - cref[1, "batched"]).abs().max()) for x in r)
    for label, key in (("recompute", "launches"),
                       ("recompute grad", "grad_launches"),
                       ("tables grad", "grad_launches")):
        launches[f"parallel-cells {label}"] = r[0][label.split()[0]][key]
    launches["parallel-cells batched"] = r[0]["batched"]["launches"]
    gaps_by_path.update({"parallel-cells recompute": max(rec, half),
                         "parallel-cells recompute grad":
                             grad_gaps["recompute"],
                         "parallel-cells tables grad": grad_gaps["tables"],
                         "parallel-cells batched": bat})
    phase("parallel-cells", t0, f"the gecko {IMAGE}x{IMAGE} on engines built "
          f"with n_shards={k}: shards={k} on one device (2.1-2.3) against "
          f"n_shards=1, {PARALLEL_STEPS} steps {one:.3e}; {k} ranks over gloo "
          f"(recompute) against n_shards=1 {rec:.3e}, at fire_rate 0.5 from "
          f"one seeded generator against the same engine on one device "
          f"{half:.3e} (limit {ROLLOUT_ATOL}); "
          f"{PARALLEL_CELL_GRAD_STEPS}-step gradients against the same layout "
          f"on one device: recompute {grad_gaps['recompute']:.3e}, float32 "
          f"tables {grad_gaps['tables']:.3e} of max (limit "
          f"{PARALLEL_CELL_GRAD_RTOL}); batched B={BATCH_B} bfloat16 tables "
          f"{bat:.3e} (limit {ROLLOUT_ATOL}); launches a rank: "
          + "; ".join(f"{p_} {({n: v for n, v in c_.items() if v})}"
                      for p_, c_ in launches.items()
                      if p_.startswith("parallel-cells"))
          + f"; {r[0]['seconds']:.1f} s | {smi}")
    if not (one <= ROLLOUT_ATOL and rec <= ROLLOUT_ATOL
            and half <= ROLLOUT_ATOL and bat <= ROLLOUT_ATOL
            and max(grad_gaps.values()) <= PARALLEL_CELL_GRAD_RTOL):
        fail(f"parallel-cells: {one}, {rec}, {half}, {grad_gaps}, {bat}")
    for name in ("sph_fwd_kernel", "sph_mask_kernel"):
        if not launches["parallel-cells recompute"][name]:
            fail(f"parallel-cells launched no {name}")
    for name, path in (("sph_bwd_kernel", "recompute grad"),
                       ("sph_fwd_tab_kernel", "tables grad"),
                       ("sph_bwd_tab_kernel", "tables grad"),
                       ("sph_mask_tab_kernel", "tables grad"),
                       ("sph_fwd_tab_kernel", "batched"),
                       ("sph_mask_tab_kernel", "batched"),
                       ("sph_mlp_kernel", "batched")):
        if not launches[f"parallel-cells {path}"][name]:
            fail(f"parallel-cells {path} launched no {name}")

    # [parallel-train]: each sharded iteration against the single-process
    # iteration from the same parameters and Adam state
    lines, worst, worst_lr = [], 0.0, 0.0
    graph = _train_graph(inp["train"], dev)
    for m, ((nd, npart), iters) in enumerate(PARALLEL_TRAIN_MESHES):
        snaps = [x["train"]["meshes"][m]["iters"] for x in res]
        gs = []
        for i in range(iters):
            want = reference_train_step(inp["train"], dev, graph,
                                        snaps[0][i - 1] if i else None, i)
            gs += [_train_gaps(sn[i], want) for sn in snaps]
        same = all(torch.equal(a, b) for sn in snaps[1:]
                   for a, b in zip(sn[-1]["params"], snaps[0][-1]["params"]))
        loss, moment, param, ties = (max(g[i] for g in gs) for i in range(4))
        worst = max(worst, loss, moment)
        worst_lr = max(worst_lr, param)
        lines.append(f"data {nd} x particle {npart}, {iters} iterations "
                     f"({res[0]['train']['meshes'][m]['ms_iter']:.0f} ms "
                     f"each): losses {loss:.3e}, Adam moments {moment:.3e} "
                     f"of max, parameters {param:.3e} learning rates apart "
                     f"outside {ties} Adam ties, replicas bit-equal {same}")
        if not same:
            fail(f"parallel-train: the replicas' parameters differ ({nd} x "
                 f"{npart})")
    phase("parallel-train", t0, f"make_sharded_train_step on the graph "
          f"engine at the train CLI's defaults ({IMAGE}x{IMAGE}, h={TRAIN_H}, "
          f"B={TRAIN_B}, {PARALLEL_TRAIN_STEPS}-step rollouts, Adam 3e-3, "
          f"fire_rate 1.0), each iteration against the single-process "
          f"iteration from the same parameters and Adam state: "
          + "; ".join(lines)
          + f" (limits {TRAIN_PARITY_RTOL} of max, {TRAIN_PARAM_LR} learning "
          f"rates); {res[0]['train']['seconds']:.1f} s | {smi}")
    if not (worst <= TRAIN_PARITY_RTOL and worst_lr <= TRAIN_PARAM_LR):
        fail(f"parallel-train: {worst} of max, {worst_lr} learning rates "
             "from one process")
    phase("parallel-ranks", t0, f"{PARALLEL_RANKS} ranks over gloo on one "
          f"card: {spawn_s:.1f} s for the spawn and the five phases | {smi}")

    # [parallel-nccl]
    t0 = time.time()
    k = min(torch.cuda.device_count(), 4)
    nres = run_ranks(nccl_rank, k, inp["bench"], dev.type, device=dev.type,
                     backend="nccl", timeout=300)
    gap = max(_gap(x["final"], ref["band"]) for x in nres)
    launches["parallel-nccl"] = nres[0]["launches"]
    gaps_by_path["parallel-nccl"] = gap
    phase("parallel-nccl", t0, f"the [parallel-band] check rollout over NCCL "
          f"on {nres[0]['ranks']} rank(s), one a card "
          f"({', '.join(x['device'] for x in nres)}): {gap:.3e} of max "
          f"against the unsharded rollout (limit {ROLLOUT_ATOL}), "
          f"{nres[0]['ms_step']:.3f} ms a step (float32 MLP), a rank sent "
          f"{nres[0]['stats']['sent_bytes']} B, staged "
          f"{nres[0]['stats']['staged_bytes']} B | {smi}")
    if not gap <= ROLLOUT_ATOL:
        fail(f"parallel-nccl: {gap} against the unsharded rollout")
    return launches, gaps_by_path


# ---- the fixed-order backward: the detector and the exact resume ------------

# [determinism] runs one iteration of each training path in a child process
# under torch.use_deterministic_algorithms(True, warn_only=True), with
# cuBLAS's workspace fixed in the child's environment (it must be set before
# cuBLAS starts): every op that lacks a deterministic implementation on the
# card warns, and the child reports them. The mode is a detector only: the
# port never turns it on. [texture-resume] then holds the two straight runs
# and the resumed one bit-equal, or, where the detector named an op, to
# RESUME_RTOL, naming the op.
DETERMINISM_FLAG = "--determinism-check"
DETERMINISM_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
DETERMINISM_TIMEOUT = 600


def determinism_child() -> int:
    """The child of [determinism]: one iteration of the band engine's MSE
    training at the train CLI's defaults, of OT training at
    runs/ot_gabor_dotted's configuration and of graph-engine training,
    under the deterministic mode; prints the ops that warned as one JSON
    line."""
    import warnings

    _build.load_library()
    native.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    found = {}
    with tempfile.TemporaryDirectory() as root:
        common = ["--device", "cuda", "--seed", str(SEED), "--training_iter",
                  "1", "--checkpoint_every", "100000"]
        runs = {
            "band MSE (train CLI defaults)": common + [
                "--engine", "band", "--output_dir",
                os.path.join(root, "band")],
            "OT (runs/ot_gabor_dotted)": texture_train_argv(
                os.path.join(root, "ot"), 1),
            "graph MSE (train CLI defaults)": common + [
                "--engine", "graph", "--output_dir",
                os.path.join(root, "graph")],
        }
        for label, argv in runs.items():
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                rc = cli_train.main(argv)
                torch.cuda.synchronize()
            ops = sorted({str(w.message).split(" does not have")[0]
                          for w in caught
                          if "deterministic implementation" in str(w.message)})
            found[label] = {"rc": rc, "ops": ops}
    print(json.dumps({"determinism": found}), flush=True)
    return 0


def determinism_phase(smi) -> list:
    """[determinism]: the child's report; returns the ops it named."""
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), DETERMINISM_FLAG],
        cwd=ROOT, env={**os.environ, **DETERMINISM_ENV}, capture_output=True,
        text=True, timeout=DETERMINISM_TIMEOUT)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith('{"determinism"')]
    if proc.returncode != 0 or not lines:
        fail(f"the determinism check exited {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    found = json.loads(lines[-1])["determinism"]
    bad = {k: r["rc"] for k, r in found.items() if r["rc"] != 0}
    if bad:
        fail(f"the determinism check's train CLIs returned {bad}")
    ops = sorted({op for r in found.values() for op in r["ops"]})
    phase("determinism", t0, "one iteration of each training path under "
          "torch.use_deterministic_algorithms(True, warn_only=True), "
          f"CUBLAS_WORKSPACE_CONFIG={DETERMINISM_ENV['CUBLAS_WORKSPACE_CONFIG']}"
          ": ops without a deterministic implementation: "
          + "; ".join(f"{label}: {r['ops'] or 'none'}"
                      for label, r in found.items()) + f" | {smi}")
    return ops


# ---- the demo server (sph_nca_tpu_torch/demo) --------------------------------

# [demo-parity]: the server's states on the card against the port's numpy
# engine (the independent oracle, sph_nca_tpu_torch/demo/engine.py) at size
# 32, fire_rate 1.0 (the two draw fire masks from other streams), 8 steps,
# within the numpy engine test's bar (np.allclose, rtol 1e-3 / atol 1e-4);
# [demo-serve]: the server in a thread at --size 64 and 256 with the shipped
# gecko, real HTTP requests.
DEMO_PARITY_SIZE, DEMO_PARITY_STEPS = 32, 8
DEMO_RTOL, DEMO_ATOL = 1e-3, 1e-4
DEMO_SIZES = (64, 256)
DEMO_FRAMES = 32
DEMO_RECORD_STEPS, DEMO_RECORD_FRAMES = 24, 4


def demo_args(path: str, size: int, pattern="square", jitter=0.0):
    return argparse.Namespace(weights_json=path, size=size, pattern=pattern,
                              jitter=jitter, spatial_jitter=False,
                              color_mode="rgba", device="cuda")


def demo_weights_at_fire_rate(src: str, out_dir: str, fire_rate: float) -> str:
    """A copy of a shipped weights JSON with ``fire_rate`` in its config."""
    with open(src) as f:
        data = json.load(f)
    data["config"]["fire_rate"] = fire_rate
    path = os.path.join(out_dir, os.path.basename(src))
    with open(path, "w") as f:
        json.dump(data, f)
    return path


def demo_numpy_engine(path: str, state):
    """The port's numpy engine on the server's points, built as the JAX
    package's server builds its own (weights, h, rule, period, smoothing
    from the JSON)."""
    from sph_nca_tpu_torch.demo.engine import NumpyEngine

    with open(path) as f:
        data = json.load(f)
    cfg = data["config"]
    layers = sorted(data["layers"], key=lambda l: l["index"])
    weights = {"w1": np.asarray(layers[0]["weight"], np.float32).T,
               "b1": np.asarray(layers[0]["bias"], np.float32),
               "w2": np.asarray(layers[1]["weight"], np.float32).T,
               "b2": np.asarray(layers[1]["bias"], np.float32)}
    h = float(cfg.get("h", 0.08))
    image = cfg.get("mode", "image") == "image"
    return NumpyEngine(
        state.x, weights, h=h, fire_rate=float(cfg["fire_rate"]),
        update_rule=cfg.get("update_rule", "gated"),
        channels=int(cfg["input_features"]) // 3, use_alpha=image,
        normalize_perception=1.0 / h,
        period=None if image else np.asarray([2.0, 2.0], np.float32),
        smoothing=cfg.get("smoothing", "poly6"))


def demo_parity_phase(dev, smi) -> tuple:
    """[demo-parity]: square, hex with jitter 0.3 and the texture model,
    DEMO_PARITY_STEPS steps each, the server against the numpy engine; then
    kernel 2.8 against its plain version at the demo's row shapes (B = 1,
    the band engine's blocks at sizes 32 and 256). Returns (2.8's launches,
    its errors by (shape, dtype))."""
    from sph_nca_tpu_torch.demo import server as DS

    t0 = time.time()
    cases = (("square", GECKO, "square", 0.0), ("hex jitter 0.3", GECKO,
                                                "hex", 0.3),
             ("texture", STRIPES, "square", 0.0))
    lines, launches, leads = [], 0, {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, src, pattern, jitter in cases:
            sub = os.path.join(tmp, label.replace(" ", "-"))
            os.makedirs(sub)
            path = demo_weights_at_fire_rate(src, sub, 1.0)
            state = DS.DemoState(demo_args(path, DEMO_PARITY_SIZE, pattern,
                                           jitter))
            oracle = demo_numpy_engine(path, state)
            A = state.A
            reset_launches()
            for _ in range(DEMO_PARITY_STEPS):
                state.step()
                A = oracle.step(A)
            torch.cuda.synchronize()
            counts = read_launches()
            got = state.A
            err = float(np.abs(got - A).max())
            ok = bool(np.allclose(got, A, rtol=DEMO_RTOL, atol=DEMO_ATOL))
            want = {**NO_LAUNCHES, "sph_mlp_kernel": DEMO_PARITY_STEPS}
            lines.append(f"{label} ({state.mode}, N={state.x.shape[0]}): "
                         f"max abs {err:.3e}, alive share "
                         f"{float((A[:, 3] > 0.1).mean()):.3f}")
            print(f"  {lines[-1]}", flush=True)
            if not ok or counts != want:
                fail(f"demo-parity {label}: the server parts from the numpy "
                     f"engine by {err} (rtol {DEMO_RTOL}, atol {DEMO_ATOL}) "
                     f"or launched {counts}, expected {want}")
            launches += counts["sph_mlp_kernel"]
            leads[f"demo-{DEMO_PARITY_SIZE}"] = (1, state.engine.num_cells,
                                                 state.engine.slots_per_cell)
    n = max(DEMO_SIZES) ** 2
    leads[f"demo-{max(DEMO_SIZES)}"] = (1, -(-n // 64), 64)
    errs = mlp_shape_checks(dev, leads)
    phase("demo-parity", t0, f"demo server (band engine, float32 tables, "
          f"B = 1) at size {DEMO_PARITY_SIZE}, fire_rate 1.0, "
          f"{DEMO_PARITY_STEPS} steps, against the port's numpy engine "
          f"within rtol {DEMO_RTOL} / atol {DEMO_ATOL}: " + "; ".join(lines)
          + f"; kernel 2.8 == mlp_ref at {leads} | {smi}")
    return launches, errs


def _http(url: str, body=None) -> bytes:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read()


def _frame_meta(body: bytes):
    mlen = struct.unpack("<I", body[:4])[0]
    return json.loads(body[4:4 + mlen]), len(body) - 4 - mlen


def demo_serve_size(dev, size: int) -> dict:
    """The server in a thread at ``size`` with the shipped gecko, driven by
    real HTTP requests; returns its numbers."""
    from http.server import ThreadingHTTPServer

    from sph_nca_tpu_torch.demo import server as DS

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.time()
    state = DS.DemoState(demo_args(GECKO, size))
    first_build = time.time() - t1
    srv = ThreadingHTTPServer(("127.0.0.1", 0), DS.make_handler(state))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    out = {"size": size, "lead": (1, state.engine.num_cells,
                                  state.engine.slots_per_cell)}
    try:
        info = json.loads(_http(base + "/info"))
        out["n"] = info["n_particles"]
        builds = [("gecko square", first_build, info["build_seconds"],
                   info["table_bytes"])]
        mass0 = float(np.clip(state.A[:, 3], 0.0, 1.0).sum())
        reset_launches()
        ms = []
        for i in range(DEMO_FRAMES):
            t2 = time.perf_counter()
            body = _http(base + "/frame")
            ms.append(1e3 * (time.perf_counter() - t2))
            meta, npx = _frame_meta(body)
            if meta != {"size": size, "step": i + 1} or npx != size * size * 4:
                fail(f"demo-serve {size}: frame {i} meta {meta}, {npx} bytes")
        counts = read_launches()
        want = {**NO_LAUNCHES, "sph_mlp_kernel": DEMO_FRAMES}
        if counts != want:
            fail(f"demo-serve {size}: {DEMO_FRAMES} frames launched {counts}, "
                 f"expected {want}")
        mass1 = float(np.clip(state.A[:, 3], 0.0, 1.0).sum())
        if not mass1 > mass0:
            fail(f"demo-serve {size}: the gecko did not grow (alpha mass "
                 f"{mass0} -> {mass1})")
        _http(base + "/brush", {"x": 0.0, "y": 0.0, "kind": "damage",
                                "radius": 0.3})
        hit = np.sum(state.x ** 2, -1) < 0.09
        if not np.all(state.A[hit] == 0.0):
            fail(f"demo-serve {size}: the damage brush left state")
        out["step_ms"] = cuda_ms(state.step, 20, 3)
        for label, cfg in (("hex jitter 0.3", {"pattern": "hex",
                                                "jitter": 0.3}),
                           ("stripes", {"weights": "stripes"})):
            t2 = time.time()
            _http(base + "/config", cfg)
            wall = time.time() - t2
            info = json.loads(_http(base + "/info"))
            meta, npx = _frame_meta(_http(base + "/frame"))
            if meta != {"size": size, "step": 1} or npx != size * size * 4:
                fail(f"demo-serve {size} after /config {cfg}: {meta}")
            builds.append((label, wall, info["build_seconds"],
                           info["table_bytes"]))
        _http(base + "/reset")
        if state.step_count != 0:
            fail(f"demo-serve {size}: /reset left step {state.step_count}")
        torch.cuda.synchronize()
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    out.update(frame_median=float(np.median(ms)),
               frame_p90=float(np.percentile(ms, 90)), builds=builds,
               launches_per_frame=counts["sph_mlp_kernel"] / DEMO_FRAMES,
               mass=(mass0, mass1), launches=counts["sph_mlp_kernel"])
    return out


def demo_serve_phase(dev, smi) -> dict:
    """[demo-serve] at each of DEMO_SIZES, then the --record run; 2.8's time
    at the largest size's rows beside its bound and the library chain."""
    from sph_nca_tpu_torch.demo import server as DS

    t0 = time.time()
    runs = [demo_serve_size(dev, size) for size in DEMO_SIZES]
    for r in runs:
        print(f"  size {r['size']} (N={r['n']}): /frame {r['frame_median']:.2f} "
              f"ms median, {r['frame_p90']:.2f} ms p90 over {DEMO_FRAMES} "
              f"requests; one step {r['step_ms']:.4f} ms (CUDA events, 20 "
              f"steps); kernel 2.8 {r['launches_per_frame']:.0f} launch a "
              f"frame; alpha mass {r['mass'][0]:.1f} -> {r['mass'][1]:.1f}; "
              "builds (wall s, build s, table bytes): "
              + ", ".join(f"{label} {wall:.2f} / {secs:.2f} / {nbytes}"
                          for label, wall, secs, nbytes in r["builds"])
              + f"; peak {r['peak_gib']:.3f} GiB", flush=True)
    # the headless --record mode through the CLI
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "strip.png")
        reset_launches()
        DS.main(["--weights_json", GECKO, "--size", str(DEMO_SIZES[0]),
                 "--record", path, "--record_steps", str(DEMO_RECORD_STEPS),
                 "--record_frames", str(DEMO_RECORD_FRAMES), "--device",
                 "cuda"])
        torch.cuda.synchronize()
        rec = read_launches()["sph_mlp_kernel"]
        with open(path, "rb") as f:
            head = f.read(24)
    wh = struct.unpack(">II", head[16:24])
    if (head[:8] != b"\x89PNG\r\n\x1a\n"
            or wh != (DEMO_RECORD_FRAMES * DEMO_SIZES[0], DEMO_SIZES[0])
            or rec != DEMO_RECORD_STEPS):
        fail(f"demo --record: PNG {head[:8]} {wh}, 2.8 launches {rec}")
    big = runs[-1]
    t = mlp_times(dev, big["lead"], torch.float32, events=True)
    print(f"  {mlp_times_line('demo-' + str(big['size']), big['lead'], torch.float32, t)} "
          "(CUDA events)", flush=True)
    phase("demo-serve", t0, "the demo server in a thread, gecko.json, "
          + "; ".join(f"size {r['size']}: /frame {r['frame_median']:.2f} ms "
                      f"median / {r['frame_p90']:.2f} ms p90, step "
                      f"{r['step_ms']:.4f} ms, rebuilds "
                      + ", ".join(f"{b[2]:.2f} s" for b in r["builds"])
                      + f", peak {r['peak_gib']:.3f} GiB" for r in runs)
          + f"; --record {DEMO_RECORD_FRAMES} frames x {DEMO_RECORD_STEPS} "
          f"steps -> a {wh[0]}x{wh[1]} PNG | {smi}")
    return {"launches": {**{f"demo-serve {r['size']}": r["launches"]
                            for r in runs}, "demo --record": rec},
            "times": {"shapes": f"demo-{big['size']} (gecko, square) "
                                f"{big['lead']} float32 inputs",
                      **{k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}}}


# [api]: the port as a library user reaches it, through the subpackages'
# public names only. The golden recipe on the card is held against its
# plain CPU run over all API_STEPS steps: on the H100 the gap grew smoothly
# from 6.4e-07 of max after 16 steps to 2.9e-05 after 128, with no life mask
# flipping at the 0.1 threshold, so the whole rollout is not chaotic at ulp
# level. The gap at API_GAP_STEPS and the alive shares are printed.
API_SIDE, API_STEPS = 64, 128
API_GAP_STEPS = (CHECK_STEPS, 32, 64, API_STEPS)
API_HOLD_STEPS = API_STEPS
API_WARMUP, API_TIMED, API_TRACE = 2, 10, 4


def api_recipe(device, steps: int):
    """The verify skill's golden recipe through the public names: the face
    model's checkpoint (assets/gecko_full_8000), an API_SIDE x API_SIDE
    grid, ``ops.build_graph``, ``utils.plane_seed``,
    ``models.rollout_states`` at fire_rate 1. Returns (states [steps + 1,
    N, C] on the CPU, K)."""
    from sph_nca_tpu_torch import io, models, ops, utils

    ck = io.load_checkpoint(FACE_CHECKPOINT, device=device)
    h, cfg = ck["h"], ck["model_cfg"]
    x = utils.grange((API_SIDE, API_SIDE), [-1.0, -1.0],
                     [2.0, 2.0]).reshape(-1, 2)
    dims = ops.default_dims(h)
    mpc, k = ops.suggest_capacity(x, h, dims)
    x = x.to(device)
    g = ops.build_graph(x, h, dims, max_per_cell=mpc, k=k)
    A0 = utils.plane_seed(x, cfg.channels, gmin=(-1.0, -1.0),
                          gsize=(2.0, 2.0), radius=h)
    gen = torch.Generator(device=device).manual_seed(SEED)
    with torch.no_grad():
        states = models.rollout_states(ck["params"], cfg, g, A0, gen, steps,
                                       h, fire_rate=1.0)
    return states.cpu(), g.k


def api_phase(dev, smi) -> dict:
    """[api]: (1) the golden recipe on the card against its plain CPU run;
    (2) ``utils.profiling.StepTimer`` around single steps of
    ``models.surface.rollout_mesh_batched`` on ``ops.build_band_engine``'s
    engine at the bench shape (bfloat16 tables and MLP: 2.8's fused variant
    once a step), mean ms and particle-steps/s, no bar; (3) ``utils.profiling.
    trace`` around API_TRACE more steps: the Chrome trace exists, parses and
    holds a CUDA kernel event. Returns the fused variant's launches and the
    numbers."""
    from sph_nca_tpu_torch import models, ops, utils

    t0 = time.time()
    reset_launches()
    t1 = time.time()
    card, k = api_recipe(dev, API_STEPS)
    card_s = time.time() - t1
    graph_launches_zero("the golden recipe")
    t1 = time.time()
    cpu, _ = api_recipe("cpu", API_STEPS)
    cpu_s = time.time() - t1
    if card.shape != (API_STEPS + 1, API_SIDE * API_SIDE, 16) or not bool(
            torch.isfinite(card).all()):
        fail(f"the golden recipe: states {tuple(card.shape)}, finite "
             f"{bool(torch.isfinite(card).all())}")
    gaps = {s: float((card[s] - cpu[s]).abs().max() / cpu[s].abs().max())
            for s in API_GAP_STEPS}
    alive = {label: (float((st[0][:, 3] > 0.1).float().mean()),
                     float((st[-1][:, 3] > 0.1).float().mean()))
             for label, st in (("card", card), ("cpu", cpu))}
    print(f"  golden recipe, {API_SIDE}x{API_SIDE}, K={k}: card vs CPU, "
          f"rel to max, after "
          + ", ".join(f"{s} steps {g:.3e}" for s, g in gaps.items())
          + f"; alive {alive['card'][0]:.4f} -> {alive['card'][1]:.4f} "
          f"(CPU {alive['cpu'][1]:.4f}); {card_s:.2f} s on the card, "
          f"{cpu_s:.2f} s on the CPU", flush=True)
    if not gaps[API_HOLD_STEPS] <= ROLLOUT_ATOL:
        fail(f"the golden recipe on the card parts from its CPU run by "
             f"{gaps[API_HOLD_STEPS]:.3e} of max after {API_HOLD_STEPS} "
             f"steps (limit {ROLLOUT_ATOL})")
    if not (alive["card"][0] < alive["card"][1]
            and abs(alive["card"][1] - alive["cpu"][1]) <= ALIVE_ATOL):
        fail(f"the golden recipe's alive shares {alive}")

    h = bench_h()
    x = fibonacci_sphere(BENCH_N, BENCH_RADIUS)
    t1 = time.time()
    eng = ops.build_band_engine(x, h, table_dtype="bfloat16", device=dev)
    torch.cuda.synchronize()
    build_s = time.time() - t1
    cfg = models.SPHNCAConfig(normalize_perception=1.0 / h)
    params = models.init_params(cfg, torch.Generator().manual_seed(SEED),
                                device=dev)
    nrm = torch.from_numpy(sphere_normals(x)).to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    A = torch.rand(BENCH_B, BENCH_N, cfg.channels, generator=g, device=dev)
    T = models.orthogonalize(nrm, models.normalize(torch.randn(
        BENCH_B, BENCH_N, 3, generator=g, device=dev)))
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def step(A, T):
        return models.surface.rollout_mesh_batched(
            params, cfg, eng, A, nrm, T, gen, 1, h, mlp_dtype="bfloat16")

    timer = utils.profiling.StepTimer(num_particles=BENCH_B * BENCH_N,
                                      warmup=API_WARMUP)
    reset_launches()
    with torch.no_grad(), tempfile.TemporaryDirectory() as logdir:
        for _ in range(API_WARMUP + API_TIMED):
            with timer:
                A, T = step(A, T)
        with utils.profiling.trace(logdir) as d:
            for _ in range(API_TRACE):
                A, T = step(A, T)
        traces = glob.glob(os.path.join(d, "trace-*.json"))
        if len(traces) != 1:
            fail(f"trace wrote {traces} into its directory")
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
    launches = read_launches()
    n_steps = API_WARMUP + API_TIMED + API_TRACE
    if launches != {**NO_LAUNCHES, FUSED: n_steps}:
        fail(f"[api] steps launched {launches}, expected {n_steps} of "
             "sph_mlp_kernel's fused variant only")
    if not (bool(torch.isfinite(A).all()) and bool(torch.isfinite(T).all())):
        fail("[api] steps: non-finite states or tangents")
    kern = [e for e in events if e.get("cat") == "kernel"]
    if not kern:
        fail(f"the trace holds no CUDA kernel event ({len(events)} events)")
    mlp_traced = sum("sph_mlp_kernel" in e.get("name", "") for e in kern)
    s = timer.summary()
    phase("api", t0, f"through `from sph_nca_tpu_torch import io, models, "
          f"ops, utils`: the golden recipe on the card within "
          f"{gaps[API_HOLD_STEPS]:.3e} of max of its CPU run after "
          f"{API_HOLD_STEPS} steps (limit {ROLLOUT_ATOL}), {API_STEPS}-step "
          f"alive shares within {ALIVE_ATOL}; StepTimer at the bench shape "
          f"({BENCH_N} points, B={BENCH_B}, band engine built in "
          f"{build_s:.2f} s, bfloat16 tables and MLP, one "
          f"rollout_mesh_batched step an interval, synchronized, "
          f"{s['steps']} intervals, {API_WARMUP} skipped): "
          f"{s['mean_ms']:.4f} ms a step, "
          f"{s['particle_steps_per_sec']:.4e} particle-steps/s; trace of "
          f"{API_TRACE} steps: {len(events)} events, {len(kern)} CUDA "
          f"kernel events, sph_mlp_kernel among them: {mlp_traced} "
          f"(launched {API_TRACE}); launches {launches} | {smi}")
    return {"launches": launches[FUSED],
            "shapes": f"bench sphere N={BENCH_N} bfloat16 tables B={BENCH_B}",
            "step_ms": s["mean_ms"],
            "particle_steps_per_sec": s["particle_steps_per_sec"],
            "trace_kernel_events": len(kern),
            "trace_mlp_events": mlp_traced,
            "recipe_gap": {str(k): v for k, v in gaps.items()}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if DETERMINISM_FLAG in sys.argv[1:]:
        return determinism_child()
    dev = torch.device("cuda", 0)

    # ---- device -------------------------------------------------------
    t0 = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    phase("device", t0, f"{kind} | nvidia-smi: {smi} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda} | TF32 off")

    # ---- build --------------------------------------------------------
    t0 = time.time()
    lib_path = _build.build(verbose=True)
    _build.load_library()
    t1 = time.time()
    native_path = native.build()
    native.load_library()
    native_s = time.time() - t1
    phase("build", t0, f"nvcc {' '.join(_build.NVCC_FLAGS)} -> "
          f"{os.path.relpath(lib_path, ROOT)}; "
          f"{' '.join(native.build_command(native_path))} (relative: "
          f"{os.path.relpath(native_path, ROOT)}) in {native_s:.2f} s")

    # ---- kernels vs plain at the inference path's shapes --------------
    t0 = time.time()
    model = load_weights_json(GECKO, device=dev)
    h = model.h
    gmin, gsize = (-1.0, -1.0), (2.0, 2.0)
    x2 = grange((IMAGE, IMAGE), gmin, gsize).reshape(-1, 2)
    x = torch.nn.functional.pad(x2, (0, 1))  # 3D, as the CLIs run it
    eng = build_cell_engine(x, h, device=dev)
    nb1, w1 = eng.blk_xs.shape[0], eng.blk_xw.shape[2]
    nb2, w2 = eng.blk2_xs.shape[0], eng.blk2_xw.shape[2]
    if nb1 == 0 or nb2 == 0:
        fail(f"expected two non-empty buckets, got nb1={nb1} nb2={nb2}")
    shapes = (f"C={eng.num_cells} M={eng.slots_per_cell} "
              f"bucket1 nb={nb1} W={w1}, bucket2 nb={nb2} W={w2}")
    scal = PK.scal_vec(eng)
    rng = np.random.default_rng(SEED)
    S = torch.from_numpy(rng.normal(
        size=(eng.num_cells, eng.slots_per_cell, model.cfg.channels)
    ).astype(np.float32)).to(dev)
    errs = {name: 0.0 for name in KERNELS}  # inference shapes
    errs.update(check_recompute(eng, S))
    const_field(eng, dev)
    phase("kernels", t0, f"kernel == plain within gA {GA_RTOL} and sm "
          f"{SM_RTOL} of max, a constant field cancels, at {shapes}")

    # ---- the inference path, through its CLI --------------------------
    t0 = time.time()
    with tempfile.TemporaryDirectory() as out_dir:
        reset_launches()
        rc = cli_test.main([
            "--weights_json", GECKO, "--image_size", str(IMAGE),
            "--steps", str(STEPS), "--firerate", "0.5", "--seed", str(SEED),
            "--output_dir", out_dir, "--device", "cuda", "--engine", "cells",
        ])
        torch.cuda.synchronize()
        infer_launches = read_launches()
        if rc != 0:
            fail(f"CLI returned {rc}")
        (run,) = os.listdir(out_dir)
        with np.load(os.path.join(out_dir, run, "states.npz")) as z:
            states = z["states"]
        frames = check_png_frames(os.path.join(out_dir, run), IMAGE,
                                  STEPS + 1, 4)
    want = 2 * STEPS  # two buckets a step
    if infer_launches != {**NO_LAUNCHES, "sph_fwd_kernel": want,
                          "sph_mask_kernel": want}:
        fail(f"launch counts {infer_launches}, expected {want} for the "
             "forward and mask kernels (2 buckets x 128 steps), 0 adjoint")
    if states.shape != (STEPS + 1, IMAGE * IMAGE, model.cfg.channels):
        fail(f"trajectory shape {states.shape}")
    finite = bool(np.isfinite(states).all())
    alive0 = float((states[0][:, 3] > 0.1).mean())
    alive = float((states[-1][:, 3] > 0.1).mean())
    if not finite:
        fail("non-finite states in the rollout")
    if not alive0 < alive < 0.5:
        fail(f"the gecko did not grow: alive fraction {alive0} -> {alive}")
    phase("rollout", t0, f"CLI {STEPS} steps at fire_rate 0.5, "
          f"{IMAGE * IMAGE} particles: launches {infer_launches}, "
          f"finite={finite}, alive fraction {alive0:.4f} -> {alive:.4f}; "
          f"{frames}")

    t0 = time.time()
    cfg1 = dataclasses.replace(model.cfg, fire_rate=1.0)
    A0 = plane_seed(x2, model.cfg.channels, gmin=gmin, gsize=gsize,
                    radius=h).to(dev)
    S0 = eng.scatter(A0)
    finals = {}
    with torch.no_grad():
        for use_kernels in (True, False):
            gen = torch.Generator(device=dev).manual_seed(SEED)
            finals[use_kernels] = eng.gather_back(rollout_cells(
                model.params, cfg1, eng, S0, gen, CHECK_STEPS, h,
                fire_rate=1.0, use_kernels=use_kernels))
    diff = float((finals[True] - finals[False]).abs().max())
    phase("rollout-check", t0, f"{CHECK_STEPS} steps at fire_rate 1.0, "
          f"kernels vs plain versions: max state difference {diff:.3e} "
          f"(limit {ROLLOUT_ATOL})")
    if not diff <= ROLLOUT_ATOL:
        fail(f"kernel rollout departs from the plain rollout by {diff}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step_ms = {}
    with torch.no_grad():
        for use_kernels in (True, False):
            rollout_cells(model.params, model.cfg, eng, S0, gen, 4, h,
                          use_kernels=use_kernels)  # warm-up
            torch.cuda.synchronize()
            t1 = time.time()
            rollout_cells(model.params, model.cfg, eng, S0, gen, STEPS, h,
                          use_kernels=use_kernels)
            torch.cuda.synchronize()
            step_ms[use_kernels] = (time.time() - t1) * 1e3 / STEPS

    # ---- the batched-lane path at inference ----------------------------
    batched_launches = batched_phases(dev, model, x, h, A0, alive)

    # ---- adjoint and batch axis at the training shapes ----------------
    t0 = time.time()
    teng = build_cell_engine(x, TRAIN_H, device=dev)
    tnb1, tnb2 = teng.blk_xs.shape[0], teng.blk2_xs.shape[0]
    if tnb1 == 0 or tnb2 == 0:
        fail(f"expected two non-empty buckets, got nb1={tnb1} nb2={tnb2}")
    tshapes = (f"B={TRAIN_B} C={teng.num_cells} bucket1 nb={tnb1} "
               f"W={teng.blk_xw.shape[2]}, bucket2 nb={tnb2} "
               f"W={teng.blk2_xw.shape[2]}")
    tscal = PK.scal_vec(teng)
    c_t, m_t = teng.xs.shape[:2]
    terrs = {name: 0.0 for name in KERNELS}  # training shapes
    SB = torch.from_numpy(rng.normal(size=(TRAIN_B, c_t, m_t, 16)).astype(
        np.float32)).to(dev)
    GB = torch.from_numpy(rng.normal(size=(TRAIN_B, c_t, m_t, 48)).astype(
        np.float32)).to(dev)
    for bucket in (1, 2):
        real = real_rows(teng, bucket)
        args = bwd_args(teng, GB, bucket)
        dk = PK.bwd_bucket(tscal, *args)
        dp = PK.bwd_bucket_plain(tscal, *args)
        torch.cuda.synchronize()
        da_abs, da_rel = rel_err(dk, dp, real)
        pad_zero = bool((dk[:, ~real] == 0).all())
        terrs["sph_bwd_kernel"] = max(terrs["sph_bwd_kernel"], da_abs)
        xs_b, ab, xw_b, vw_b, wc = bucket_args(teng, SB, bucket)
        ga_k, sm_k = PK.fwd_bucket(tscal, xs_b, ab, xw_b, vw_b, SB, wc,
                                   use_alpha=True)
        ga_p, sm_p = PK.fwd_bucket_plain(tscal, xs_b, ab, xw_b, vw_b, SB, wc,
                                         use_alpha=True)
        mk = PK.mask_bucket(tscal, xs_b, xw_b, vw_b, SB, wc, use_alpha=True)
        mp = PK.mask_bucket_plain(tscal, xs_b, xw_b, vw_b, SB, wc,
                                  use_alpha=True)
        torch.cuda.synchronize()
        ga_abs, ga_rel = rel_err(ga_k, ga_p, real)
        sm_abs, sm_rel = rel_err(sm_k, sm_p, real)
        mk_abs, mk_rel = rel_err(mk, mp, real)
        terrs["sph_fwd_kernel"] = max(terrs["sph_fwd_kernel"], ga_abs,
                                      sm_abs)
        terrs["sph_mask_kernel"] = max(terrs["sph_mask_kernel"], mk_abs)
        same = True
        for b in range(TRAIN_B):
            ga1, sm1 = PK.fwd_bucket(tscal, xs_b, ab[b], xw_b, vw_b, SB[b],
                                     wc, use_alpha=True)
            mk1 = PK.mask_bucket(tscal, xs_b, xw_b, vw_b, SB[b], wc,
                                 use_alpha=True)
            same &= bool(torch.equal(ga1, ga_k[b]) and torch.equal(sm1, sm_k[b])
                         and torch.equal(mk1, mk[b]))
        print(f"  bucket {bucket}: bwd dA max abs {da_abs:.3e} (rel to max "
              f"{da_rel:.3e}), pad rows 0: {pad_zero}; B={TRAIN_B} fwd gA "
              f"rel {ga_rel:.3e}, sm rel {sm_rel:.3e}, mask rel "
              f"{mk_rel:.3e}; B={TRAIN_B} launch == {TRAIN_B} B=1 launches: "
              f"{same}", flush=True)
        if not (da_rel <= DA_RTOL and pad_zero):
            fail(f"sph_bwd_kernel vs plain: {da_rel:.3e} > {DA_RTOL} of max "
                 f"|dA| or nonzero pad rows (bucket {bucket})")
        if not (ga_rel <= GA_RTOL and sm_rel <= SM_RTOL
                and mk_rel <= SM_RTOL and same):
            fail(f"batched forward/mask kernels out of tolerance or unequal "
                 f"to per-sample launches (bucket {bucket})")
    const_field(teng, dev)
    phase("adjoint", t0, f"sph_bwd_kernel == plain within {DA_RTOL} of max "
          f"|dA|; batched kernels == plain and == per-sample; a constant "
          f"field cancels, at {tshapes}")

    # ---- the perception's gradient through the kernels ----------------
    t0 = time.time()
    R = torch.from_numpy(rng.normal(size=(TRAIN_B, c_t, m_t, 48)).astype(
        np.float32)).to(dev)
    R[:, teng.vs == 0] = 0.0  # training puts no cotangent on pad rows
    grads = {}
    for use_kernels in (True, False):
        Sg = SB.clone().requires_grad_(True)
        if use_kernels:
            ga, _ = PK.perceive_cells_dmajor(teng, Sg)
        else:
            ga, _ = PK.fused_perception(teng, Sg, d_major=True,
                                        use_kernels=False)
        (ga * R).sum().backward()
        grads[use_kernels] = Sg.grad
    torch.cuda.synchronize()
    real = teng.vs > 0
    g_abs = float((grads[True] - grads[False]).abs()[:, real].max())
    g_rel = g_abs / float(grads[False].abs()[:, real].max())
    phase("grad", t0, f"autograd through the kernels (forward + adjoint) vs "
          f"autograd through the plain forward: max abs {g_abs:.3e}, rel to "
          f"max {g_rel:.3e} (limit {DA_RTOL})")
    if not g_rel <= DA_RTOL:
        fail(f"kernel gradient departs from plain autograd: {g_rel:.3e}")
    del SB, GB, R, grads, Sg, ga

    # ---- the update-MLP kernel at the training and batched gecko shapes --
    mlp_shapes = {"train": (TRAIN_B, c_t, m_t),
                  "gecko": (BATCH_B, eng.num_cells, eng.slots_per_cell)}
    mlp_errs = mlp_phases(dev, mlp_shapes)

    # ---- the training path, through its CLI ---------------------------
    t0 = time.time()
    with tempfile.TemporaryDirectory() as out_dir:
        reset_launches()
        rows = run_train_cli(out_dir, ["--training_iter", str(TRAIN_ITERS)])
        train_launches = read_launches()
        (weights,) = glob.glob(os.path.join(out_dir, "sphnca-*.json"))
        rc = cli_test.main(["--weights_json", weights, "--image_size",
                            str(IMAGE), "--steps", "8", "--device", "cuda",
                            "--output_dir", out_dir, "--engine", "cells"])
        if rc != 0:
            fail(f"the trained weights did not run in the test CLI ({rc})")
        (run,) = glob.glob(os.path.join(out_dir, "sphnca-test-*"))
        with np.load(os.path.join(run, "states.npz")) as z:
            trained_states = z["states"]
    losses = [r["loss"] for r in rows]
    steps = [r["steps"] for r in rows]
    want = expected_train_launches(steps, 2, tables=True)
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    iter_ms = [1e3 * r["seconds"] for r in rows]
    print(f"  losses {' '.join(f'{l:.4f}' for l in losses)}", flush=True)
    print(f"  rollout lengths {steps}", flush=True)
    print(f"  launches expected {want}, measured {train_launches}",
          flush=True)
    phase("train", t0, f"train CLI {TRAIN_ITERS} iterations (float32 pair "
          f"tables, the batched-lane rollout, a device pool) at {tshapes}: "
          f"loss {first:.4f} (mean of first 5) -> {last:.4f} (last 5), "
          f"median {np.median(iter_ms):.1f} ms/iteration over "
          f"{sum(steps)} steps; trained weights ran 8 steps in the test CLI "
          f"(finite: {bool(np.isfinite(trained_states).all())})")
    if len(rows) != TRAIN_ITERS or not all(np.isfinite(losses)):
        fail(f"training losses not finite or missing: {losses}")
    if not last < first:
        fail(f"the training loss did not fall: {first} -> {last}")
    if train_launches != want:
        fail(f"training launch counts {train_launches}, expected {want}")
    if not np.isfinite(trained_states).all():
        fail("the trained model's rollout is not finite")

    # ---- full-depth BPTT, with and without the recompute -------------
    t0 = time.time()
    depth, peak_gb = {}, {}
    for remat in (cell_step.REMAT, not cell_step.REMAT):
        cell_step.REMAT = remat
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        with tempfile.TemporaryDirectory() as out_dir:
            drows = run_train_cli(out_dir, ["--training_iter",
                                            str(DEPTH_ITERS),
                                            "--steps_increment", "0"])
        peak_gb[remat] = torch.cuda.max_memory_allocated(dev) / 2**30
        depth[remat] = [(r["steps"], 1e3 * r["seconds"], r["loss"])
                        for r in drows]
        if not all(np.isfinite(r[2]) for r in depth[remat]):
            fail(f"full-depth losses not finite (remat={remat}): "
                 f"{depth[remat]}")
    cell_step.REMAT = not cell_step.REMAT  # back to the module's value
    if [r[2] for r in depth[True]] != [r[2] for r in depth[False]]:
        print("  note: the losses with and without the recompute differ: "
              f"{depth[True]} vs {depth[False]}", flush=True)
    phase("train-depth", t0, "batched path (train CLI): " + "; ".join(
        f"remat={remat}: full-depth iterations (steps, ms, loss) "
        + ", ".join(f"({n}, {ms:.1f}, {l:.4f})" for n, ms, l in depth[remat])
        + f", {depth[remat][-1][1] / depth[remat][-1][0]:.2f} ms per BPTT "
        f"step in the last, peak device memory {peak_gb[remat]:.3f} GiB "
        "(max_memory_allocated, the 1.07 GB device pool included)"
        for remat in (True, False)) + f" | {smi}")

    # the recompute path: the Trainer on the engine without tables (kernels
    # 2.1-2.3), full depth, each step recomputed in the backward
    t0 = time.time()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    trainer, pool = make_trainer(teng, x2)
    reset_launches()
    rdepth = []
    for i in range(DEPTH_ITERS):
        t1 = time.time()
        loss = trainer.run_iteration(i, pool)
        torch.cuda.synchronize()
        rdepth.append((trainer.last_steps, (time.time() - t1) * 1e3, loss))
    recompute_launches = read_launches()
    rpeak = torch.cuda.max_memory_allocated(dev) / 2**30
    rwant = expected_train_launches([n for n, _, _ in rdepth], 2,
                                    tables=False)
    phase("train-recompute", t0, "Trainer on the engine without tables, "
          "full-depth iterations (steps, ms, loss) "
          + ", ".join(f"({n}, {ms:.1f}, {l:.4f})" for n, ms, l in rdepth)
          + f", {rdepth[-1][1] / rdepth[-1][0]:.2f} ms per BPTT step in the "
          f"last, peak device memory {rpeak:.3f} GiB (a 16-state host pool); "
          f"launches {recompute_launches}")
    if not all(np.isfinite(r[2]) for r in rdepth):
        fail(f"recompute-path losses not finite: {rdepth}")
    if recompute_launches != rwant:
        fail(f"recompute-path launch counts {recompute_launches}, expected "
             f"{rwant}")
    del trainer, pool

    # ---- the two training paths in turns -----------------------------
    t0 = time.time()
    turns = train_turns(teng, x, x2, dev)
    phase("train-turns", t0, "full-depth Trainer iterations in turns "
          "(batched path on float32 tables, recompute path, recompute, "
          "batched, ...): ms per BPTT step " + "; ".join(
              f"{label} {' '.join(f'{v:.3f}' for v in vals)} (median "
              f"{np.median(vals):.3f})" for label, vals in turns.items())
          + f" | {smi}")

    # ---- the surface path and its table kernels ---------------------
    rows_tab, scene = surface_phases(dev, rng, smi)

    # ---- times -------------------------------------------------------
    t0 = time.time()
    SB = torch.from_numpy(rng.normal(size=(TRAIN_B, c_t, m_t, 16)).astype(
        np.float32)).to(dev)
    GB = torch.from_numpy(rng.normal(size=(TRAIN_B, c_t, m_t, 48)).astype(
        np.float32)).to(dev)
    targs = [bucket_args(teng, SB, b) for b in (1, 2)]
    bargs = [bwd_args(teng, GB, b) for b in (1, 2)]
    iargs = [bucket_args(eng, S, b) for b in (1, 2)]

    def fwd(fn, sc, args, state):
        return lambda: [fn(sc, xs_b, ab, xw_b, vw_b, state, wc,
                           use_alpha=True)
                        for xs_b, ab, xw_b, vw_b, wc in args]

    def mask(fn, sc, args, state):
        return lambda: [fn(sc, xs_b, xw_b, vw_b, state, wc, use_alpha=True)
                        for xs_b, _, xw_b, vw_b, wc in args]

    def bwd(fn):
        return lambda: [fn(tscal, *a) for a in bargs]

    calls = {
        "sph_fwd_kernel": (fwd(PK.fwd_bucket, tscal, targs, SB),
                           fwd(PK.fwd_bucket_plain, tscal, targs, SB)),
        "sph_mask_kernel": (mask(PK.mask_bucket, tscal, targs, SB),
                            mask(PK.mask_bucket_plain, tscal, targs, SB)),
        "sph_bwd_kernel": (bwd(PK.bwd_bucket), bwd(PK.bwd_bucket_plain)),
    }
    infer_calls = {
        "sph_fwd_kernel": (fwd(PK.fwd_bucket, scal, iargs, S),
                           fwd(PK.fwd_bucket_plain, scal, iargs, S)),
        "sph_mask_kernel": (mask(PK.mask_bucket, scal, iargs, S),
                            mask(PK.mask_bucket_plain, scal, iargs, S)),
    }
    need = work(teng, TRAIN_B)
    ineed = work(eng, 1)
    rows = []
    rc_ms = {}  # the recompute kernels' training-shape times, for the
    # comparison with the table kernels on the same engine below
    for name, replaces in (
        ("sph_fwd_kernel", "sph_nca_tpu/ops/pallas/pair_kernel.py:79"),
        ("sph_mask_kernel", "sph_nca_tpu/ops/pallas/pair_kernel.py:625"),
        ("sph_bwd_kernel", "sph_nca_tpu/ops/pallas/pair_kernel.py:437"),
    ):
        kern, plain = calls[name]
        ms, plain_ms = device_ms(kern, name), device_ms(plain)
        event_ms = cuda_ms(kern)
        nbytes, ops = need[name]
        bound_ms, bound_by = bound(nbytes, ops)
        route = ""
        if name in need["route"]:
            # the fp32 count on the CUDA cores stays on the text line
            core_ms, core_by = bound_ms, bound_by
            _, core, tc = need["route"][name]
            bound_ms, bound_by = route_bound(*need["route"][name])
            rc_ms[name, "train"] = ms
            route = (f" on its route ({core / 1e9:.3f} G operations on the "
                     f"CUDA cores, {3 * tc / 1e9:.3f} G TF32 products on "
                     f"the tensor cores; {core_ms:.4f} ms by {core_by} "
                     f"counting all {ops / 1e9:.3f} G as fp32 on the CUDA "
                     f"cores; first design, recorded: "
                     f"{RC_RECORDED_MS[name, 'train']:.4f} ms)")
        elif (name, "train") in RC_RECORDED_MS:
            route = (f" (first design, recorded: "
                     f"{RC_RECORDED_MS[name, 'train']:.4f} ms)")
        print(f"  {name} at the training shapes (B={TRAIN_B}, both buckets):"
              f" {ms:.4f} ms device time ({event_ms:.4f} ms by CUDA events "
              f"around the wrapper calls), plain {plain_ms:.4f} ms device "
              f"time, bound {bound_ms:.4f} ms by {bound_by}{route} "
              f"({nbytes / 1e6:.2f} MB; {need['pairs']} pairs, "
              f"{need['pairs_in_support']} within h)", flush=True)
        # the recompute kernels' training path is the Trainer on the engine
        # without tables (train-recompute phase)
        train = {"shapes": f"train {IMAGE}x{IMAGE} h={TRAIN_H} B={TRAIN_B} "
                           "recompute",
                 "launches": recompute_launches[name],
                 "max_abs_err": terrs[name], "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by}
        row = {"name": name, "route": "cuda",
               "source": "sph_nca_tpu_torch/csrc/pair_kernels.cu",
               "replaces": replaces, "library_ms": None}
        if name in infer_calls:
            # the inference path's numbers head the row, as in PR 4's line;
            # the training path's go in "train"
            ik, ip = infer_calls[name]
            i_ms, i_plain = device_ms(ik, name), device_ms(ip)
            inbytes, iops = ineed[name]
            i_bound, i_by = bound(inbytes, iops)
            iroute = ""
            if name in ineed["route"]:
                _, icore, itc = ineed["route"][name]
                iroute = (f" on its route ({icore / 1e9:.3f} G CUDA-core "
                          f"operations, {3 * itc / 1e9:.3f} G TF32 products; "
                          f"{i_bound:.4f} ms by {i_by} counting all "
                          f"{iops / 1e9:.3f} G as fp32; first design, "
                          f"recorded: "
                          f"{RC_RECORDED_MS[name, 'inference']:.4f} ms)")
                i_bound, i_by = route_bound(*ineed["route"][name])
            elif (name, "inference") in RC_RECORDED_MS:
                iroute = (f" (first design, recorded: "
                          f"{RC_RECORDED_MS[name, 'inference']:.4f} ms)")
            print(f"  {name} at the gecko inference shapes (B=1): {i_ms:.4f}"
                  f" ms device time ({cuda_ms(ik):.4f} ms by CUDA events), "
                  f"plain {i_plain:.4f} ms, bound {i_bound:.4f} ms by {i_by}"
                  f"{iroute} ({inbytes / 1e6:.2f} MB; {ineed['pairs']} "
                  f"pairs, {ineed['pairs_in_support']} within h)",
                  flush=True)
            row.update({"shapes": f"gecko inference {IMAGE}x{IMAGE} h={h} "
                                  f"B=1",
                        "launches": infer_launches[name],
                        "max_abs_err": errs[name], "ms": i_ms,
                        "plain_ms": i_plain, "bound_ms": i_bound,
                        "bound_by": i_by, "train": train})
        else:  # the adjoint runs on the training path only
            row.update(train)
        rows.append(row)
    # the table kernels on the training path: B = 8, float32 tables of the
    # train CLI's engine, use_alpha on; beside one torch.bmm per bucket with
    # the batch's right-hand side (the one-read-per-batch yardstick)
    tteng = build_cell_engine(x, TRAIN_H, pair_tables="float32", device=dev)
    ttab_errs = check_tab_kernels(tteng, rng, dev)
    SBt = normal_cuda(rng, (TRAIN_B, c_t, m_t, 16), dev)
    GBt = normal_cuda(rng, (TRAIN_B, c_t, m_t, 48), dev)
    Xt = normal_cuda(rng, (TRAIN_B, c_t, m_t, 4), dev)
    tk = tab_calls(tteng, SBt, GBt, Xt, plain=False, use_alpha=True)
    tp = tab_calls(tteng, SBt, GBt, Xt, plain=True, use_alpha=True)
    tneed = work_tab(tteng, TRAIN_B, use_alpha=True)
    tlib = {"sph_fwd_tab_kernel": [], "sph_mask_tab_kernel": []}
    for *_, md, w6 in tab_buckets(tteng):
        nb, w = w6.shape[0], w6.shape[2]
        tlib["sph_fwd_tab_kernel"].append(
            (md, normal_cuda(rng, (nb, w, TRAIN_B * 16), dev)))
        tlib["sph_mask_tab_kernel"].append(
            (w6, normal_cuda(rng, (nb, w, TRAIN_B), dev)))
    tlib["sph_bwd_tab_kernel"] = tlib["sph_fwd_tab_kernel"]
    tst = tab_stats(tteng)
    print(f"  training engine with float32 tables: blocks x W "
          + " + ".join(f"{nb} x {w}" for nb, w in tst["buckets"])
          + f", {tst['pairs']} pairs, {tst['within_h']} within h, tables "
          f"{tst['bytes'] / 1e6:.1f} MB", flush=True)
    train_tab = {}
    for name in ("sph_fwd_tab_kernel", "sph_bwd_tab_kernel",
                 "sph_mask_tab_kernel"):
        ms, plain_ms = device_ms(tk[name], name), device_ms(tp[name])
        lib_ms = device_ms(lambda args=tlib[name]: [
            torch.bmm(a, b) for a, b in args])
        nbytes, ops = tneed[name]
        bound_ms, bound_by = bound(nbytes, ops)
        before = (f" (first design, recorded: {TAB_RECORDED_MS[name]:.4f} "
                  f"ms)" if name in TAB_RECORDED_MS else "")
        print(f"  {name} at the training shapes (float32 tables, B="
              f"{TRAIN_B}, both buckets): {ms:.4f} ms device time{before}, "
              f"plain {plain_ms:.4f} ms, torch.bmm with the batch's "
              f"right-hand side {lib_ms:.4f} ms, bound {bound_ms:.4f} ms by "
              f"{bound_by} ({100 * bound_ms / ms:.1f}% of it; "
              f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G operations)",
              flush=True)
        train_tab[name] = {
            "shapes": f"train {IMAGE}x{IMAGE} h={TRAIN_H} float32 tables "
                      f"B={TRAIN_B}",
            "launches": train_launches[name],
            "launches_path": "train",
            "max_abs_err": ttab_errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}
    # the recompute kernels beside the table kernels on the same positions
    # (this engine with float32 tables): the same function, without the
    # table read
    for rc_name, tab_name in (("sph_fwd_kernel", "sph_fwd_tab_kernel"),
                              ("sph_bwd_kernel", "sph_bwd_tab_kernel")):
        print(f"  {rc_name} at the training shapes (B={TRAIN_B}): "
              f"{rc_ms[rc_name, 'train']:.4f} ms device time, {tab_name} on "
              f"the same engine with float32 tables "
              f"{train_tab[tab_name]['ms']:.4f} ms (bound "
              f"{train_tab[tab_name]['bound_ms']:.4f} ms, the table read); "
              f"the first design of {rc_name}, recorded: "
              f"{RC_RECORDED_MS[rc_name, 'train']:.4f} ms", flush=True)
    del tteng, SBt, GBt, Xt, tk, tp, tlib

    # the forward table kernel at the batched gecko's shapes (bfloat16
    # tables, B = 8, use_alpha on), beside one torch.bmm of the f32 tables
    # per bucket with the batch's right-hand side
    geng = build_cell_engine(x, h, pair_tables="bfloat16", device=dev)
    c_g, m_g, _ = geng.xs.shape
    SBg = normal_cuda(rng, (BATCH_B, c_g, m_g, 16), dev)
    GBg = normal_cuda(rng, (BATCH_B, c_g, m_g, 48), dev)
    gk = tab_calls(geng, SBg, GBg, None, plain=False, use_alpha=True)
    gp = tab_calls(geng, SBg, GBg, None, plain=True, use_alpha=True)
    name = "sph_fwd_tab_kernel"
    g_err = g_rel = 0.0
    for kk, pp in zip(gk[name](), gp[name]()):
        for k, q in zip(kk, pp):
            err = float((k - q).abs().max())
            g_err = max(g_err, err)
            g_rel = max(g_rel, err / max(float(q.abs().max()), 1e-30))
    if not g_rel <= TAB_RTOL:
        fail(f"{name} vs plain at the batched gecko's shapes: {g_rel:.3e} > "
             f"{TAB_RTOL} of max")
    g_ms, g_plain = device_ms(gk[name], name), device_ms(gp[name])
    glib = [(md.float(), normal_cuda(rng, (md.shape[0], md.shape[2],
                                           BATCH_B * 16), dev))
            for *_, md, _ in tab_buckets(geng)]
    g_lib = device_ms(lambda: [torch.bmm(a, b) for a, b in glib])
    g_bound, g_by = bound(*work_tab(geng, BATCH_B, use_alpha=True)[name])
    print(f"  {name} at the batched gecko's shapes (bfloat16 tables, B="
          f"{BATCH_B}, both buckets): {g_ms:.4f} ms device time, plain "
          f"{g_plain:.4f} ms, torch.bmm {g_lib:.4f} ms, bound {g_bound:.4f} "
          f"ms by {g_by}, max abs {g_err:.3e} from plain", flush=True)
    train_tab[name]["batched"] = {
        "shapes": f"gecko {IMAGE}x{IMAGE} h={h} bfloat16 tables B={BATCH_B}",
        "launches": batched_launches[name], "launches_path": "batched",
        "max_abs_err": g_err, "ms": g_ms, "plain_ms": g_plain,
        "bound_ms": g_bound, "bound_by": g_by, "library_ms": g_lib}
    del geng, SBg, GBg, gk, gp, glib

    # the update-MLP kernel at the training shapes (float32) and at the
    # batched gecko's (bfloat16 inputs), gated, hid 256; beside the library
    # chain addmm -> relu -> addmm on [n, 48]: in float32 with TF32 off, or
    # on bfloat16 inputs with float32 sums and outputs and H rounded to
    # bfloat16 between the two (the function the kernel computes)
    mlp_rows = {}
    for label, lead, dtype, launches in (
            ("train", mlp_shapes["train"], torch.float32,
             train_launches["sph_mlp_kernel"]),
            ("gecko", mlp_shapes["gecko"], torch.bfloat16,
             batched_launches["sph_mlp_kernel"])):
        t = mlp_times(dev, lead, dtype)
        print(f"  {mlp_times_line(label, lead, dtype, t)}", flush=True)
        mlp_rows[label] = {
            "shapes": f"{label} {tuple(lead)} {str(dtype)[6:]} inputs",
            "launches": launches,
            "launches_path": "train" if label == "train" else "batched",
            "max_abs_err": mlp_errs[(label, dtype)],
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}}
    mlp_row = {"name": "sph_mlp_kernel", "route": "cuda",
               "source": "sph_nca_tpu_torch/csrc/mlp_kernel.cu",
               "replaces": "sph_nca_tpu/ops/pallas/mlp_kernel.py:48",
               **mlp_rows["train"], "inference": mlp_rows["gecko"]}

    # rows 2.4-2.6 head with the training path's numbers; the surface path's
    # go under "surface"
    for i, row in enumerate(rows_tab):
        if row["name"] in train_tab:
            surface = {k: v for k, v in row.items()
                       if k not in ("name", "route", "source", "replaces")}
            rows_tab[i] = {k: row[k] for k in ("name", "route", "source",
                                               "replaces")}
            rows_tab[i].update(train_tab[row["name"]], surface=surface)

    phase("times", t0, f"inference rollout step {step_ms[True]:.4f} ms with "
          f"the kernels, {step_ms[False]:.4f} ms with the plain versions "
          f"({STEPS} steps, fire_rate 0.5, host clock around synchronize, "
          f"timed after the inference phases); kernel times: device time "
          f"from torch.profiler kernel records, median of 3 profiles of 20 "
          f"calls, L2-warm | {smi}")

    if "--profile" in sys.argv[1:]:
        t0 = time.time()
        profile_steps(model, eng, S0, h)
        phase("profile", t0, "torch.profiler, 16 inference steps at "
              "fire_rate 0.5")
        for label, train_eng in (
                ("pair tables", build_cell_engine(
                    x, TRAIN_H, pair_tables="float32", device=dev)),
                ("recompute", teng)):
            t0 = time.time()
            profile_train(train_eng, x2)
            phase("profile-train", t0, "torch.profiler, one full-depth "
                  f"training iteration ({label})")

    # ---- the batched surface rollout, the CLI's surface mode, the bench --
    # (after the times phase: once these phases' profiles have run, every
    # later profile of 20 calls was seen to lose 4-5 of its 40 records)
    sb_launches = surface_batched_phases(dev, smi, *scene)
    del scene
    cli_launches, cli_errs = surface_cli_phase(dev, smi)
    bench, cell_pps = surface_bench_phase(dev, rng, smi)

    # ---- the band engine: both CLIs' default, the trainer, the bench ------
    bengines = band_build_phase(dev, smi)
    band_mlp_errs, band_mlp_times = band_mlp_phase(dev, smi, bengines)
    fused = band_fused_phase(dev, rng, smi, bengines["bench"])
    band = {"band-train": band_train_phase(dev, smi, bengines["train"], x2),
            "band-inference": band_inference_phase(dev, smi, model, x)}
    fused["launches"]["band-bench"] = band_bench_phase(
        dev, rng, smi, bengines["bench"], cell_pps)
    band["band-surface-cli"] = band_surface_cli_phase(dev, smi)
    del bengines

    # ---- the texture slice: OT training, checkpoints, the test / eval CLIs
    with tempfile.TemporaryDirectory() as tex_dir:
        ck, tex_train = texture_train_phase(dev, smi,
                                            os.path.join(tex_dir, "band"))
        texture = {"texture-train": {"sph_mlp_kernel": tex_train},
                   "texture-cells": texture_cells_phase(
                       dev, smi, os.path.join(tex_dir, "cells"))}
        cli_counts, final = texture_cli_phase(dev, smi, ck)
        texture.update({f"texture-cli {label}": c
                        for label, c in cli_counts.items()})
        tex_errs = texture_kernels_phase(dev, smi, ck, final)
    texture_resume_phase(dev, smi, determinism_phase(smi))
    texture["texture-eval"] = {"sph_mlp_kernel": texture_eval_phase(dev, smi)}
    texture["eval"] = {"sph_mlp_kernel": eval_phase(dev, smi)}
    if "--profile" in sys.argv[1:]:
        texture_profile_phase(dev, smi)

    # ---- the CLIP slice: text-guided training, the optimizers --------------
    clip_parity_phase(dev, smi)
    with tempfile.TemporaryDirectory() as clip_dir:
        clip_launches, clip_errs = clip_train_phase(dev, smi, clip_dir)
    clip_launches["optimizers lamb"] = {
        **NO_LAUNCHES, "sph_mlp_kernel": optimizers_phase(dev, smi)}

    # ---- the graph engine: the oracle tier, no kernel of the port ---------
    graph_phases(dev, smi, alive)

    # ---- the sharded paths: ranks sharing the card, then NCCL ---------------
    par_launches, par_gaps = parallel_phases(dev, smi)

    # ---- the demo server on the card ---------------------------------------
    demo_parity_launches, demo_errs = demo_parity_phase(dev, smi)
    demo = demo_serve_phase(dev, smi)

    # ---- the public API: the golden recipe, StepTimer, trace ---------------
    api = api_phase(dev, smi)

    kernels = rows + rows_tab + [mlp_row]
    # the texture paths' launches, by path
    for row in kernels:
        counts = {path: c[row["name"]] for path, c in texture.items()
                  if c.get(row["name"], 0)}
        if counts:
            row["texture"] = {"launches": counts,
                              "launches_path": ", ".join(counts),
                              "max_abs_err": tex_errs.get(row["name"], {})}
    missing = [row["name"] for row in kernels if "texture" not in row
               and row["name"] != "sph_bwd_kernel"]
    if missing:
        fail(f"the texture paths launched no {missing}")
    # the batched surface paths: launches of the batched rollout and of each
    # surface CLI run, and the bench shape's numbers
    for row in kernels:
        name = row["name"]
        if name in bench:
            row["surface_batched"] = {
                "shapes": f"surface stripes sphere N={SURF_N} bfloat16 "
                          f"tables B={SURF_B}",
                **sb_launches[name], "launches_path": "surface-batched"}
            row["surface_cli"] = {
                "shapes": f"test CLI --surface {SURF_N} points B=1",
                "launches": {label: c[name]
                             for label, c in cli_launches.items()},
                "launches_path": "surface-cli",
                "max_abs_err": cli_errs[name]}
            row["bench"] = bench[name]
        if name == "sph_mlp_kernel":
            # the fused variant: its own launches (the bench rollouts, the
            # [api] steps, its check), its check and times
            fused["launches"]["api"] = api.pop("launches")
            fused["launches_path"] = ", ".join(fused["launches"])
            row["fused"] = fused
            row["api"] = api
            # the demo server steps the band engine: 2.8 is its kernel
            row["demo"] = {
                "launches": {"demo-parity": demo_parity_launches,
                             **demo["launches"]},
                "launches_path": "demo-parity, demo-serve, demo --record",
                "times": demo["times"],
                "max_abs_err": {f"{label} {str(dtype)[6:]}": err
                                for (label, dtype), err in demo_errs.items()}}
            # the band paths run no pair-table kernel: 2.8 is their kernel
            row["band"] = {"launches": band, "times": band_mlp_times,
                           "launches_path": ", ".join(band),
                           "max_abs_err": {
                               f"{label} {str(dtype)[6:]}": err
                               for (label, dtype), err
                               in band_mlp_errs.items()}}
    # the CLIP paths' launches and errors, by path
    for row in kernels:
        counts = {path: c[row["name"]] for path, c in clip_launches.items()
                  if c.get(row["name"], 0)}
        if counts:
            row["clip"] = {"launches": counts,
                           "launches_path": ", ".join(counts),
                           "max_abs_err": clip_errs.get(row["name"], {})}
    missing = [name for name in CLIP_KERNELS
               if not clip_launches["clip-train cells"][name]]
    if missing:
        fail(f"the CLIP cell-engine run launched no {missing}")
    # the sharded paths' launches a rank and their gaps from the unsharded
    # twins, by path
    for row in kernels:
        counts = {path: c[row["name"]] for path, c in par_launches.items()
                  if c.get(row["name"], 0)}
        if counts:
            row["parallel"] = {"launches": counts,
                               "launches_path": ", ".join(counts),
                               "max_abs_err": {path: par_gaps[path]
                                               for path in counts}}
    missing = [row["name"] for row in kernels if "parallel" not in row
               and row["name"] != "sph_blur_tab_kernel"]
    if missing:
        fail(f"the sharded paths launched no {missing}")
    if len(kernels) != 8:
        fail(f"the kernels line has {len(kernels)} rows, expected 8")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

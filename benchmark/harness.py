"""One run of one cell: set-up, the measured window, the traced window, and
the comparison with the plain reference that decides ``correct``.

A cell (``workloads/<cell>.json``) names a configuration
(``configs/<config>.json``: the model, the geometry, the precision) and a
traffic mix (``traffic/<traffic>.json``: the engine, the batch, the unit of
work). The traffic's ``kind`` picks one of two general drivers: ``rollout``
(back-to-back batched surface rollouts, a closed loop: each rollout is read
back before the next starts) or ``train`` (back-to-back training
iterations). Nothing here names a cell.

Inputs come from the seed: ``subseed(seed, tag, ...)`` gives every stream
its own seed, so the same seed gives the same inputs and weights.
"""

from __future__ import annotations

import copy
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import arithmetic as AR
from benchmark import trace as TR
from benchmark.reference import geometry as GEO
from benchmark.reference import nca as REF
from benchmark.reference.sph import Operators

HERE = Path(__file__).resolve().parent
# the tangent diffusion's blurred mass under which tangents are not
# compared (the division by it amplifies rounding there)
MASS_FLOOR = 0.1
# how far rounding moves a blurred life value: the pair weights rounded to
# the table precision (bfloat16: 2^-8 of each) move a blur of at most 1 by
# under 4e-3
BLUR_ROUNDING = 4e-3


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def cell_spec(cell: str, overrides: dict | None = None) -> dict:
    """The cell's workload, configuration and traffic files, merged into
    one dict (``overrides`` replaces keys: tests run a cell at a small
    size)."""
    wl = load_json("workloads", cell)
    spec = {**load_json("configs", wl["config"]),
            **load_json("traffic", wl["traffic"]), **wl, "cell": cell}
    spec.update(overrides or {})
    return spec


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed for the stream ``tags`` of run ``seed``."""
    words = [seed % (1 << 64)] + [
        int.from_bytes(str(t).encode(), "little") % (1 << 64) for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def log(text: str) -> None:
    print(f"benchmark: {text}", file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def make_weights(spec: dict, seed: int, device) -> REF.Weights:
    """The update MLP's weights at the configuration's widths, uniform in
    +-1/sqrt(fan_in) as torch.nn.Linear draws them, made on the device in
    one draw."""
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "weights"))
    fin, hid, out = spec["mlp_inputs"], spec["hidden"], spec["mlp_outputs"]
    shapes = [((fin, hid), fin), ((hid,), fin), ((hid, out), hid),
              ((out,), hid)]
    u = torch.rand(sum(math.prod(s) for s, _ in shapes), generator=gen,
                   device=device)
    out, off = [], 0
    for shape, fan_in in shapes:
        n = math.prod(shape)
        bound = 1.0 / math.sqrt(fan_in)
        out.append((u[off:off + n] * (2 * bound) - bound).reshape(shape))
        off += n
    return REF.Weights(*out)


def geometry(spec: dict):
    """(positions [N, 3] float32 numpy, normals or None, h, plane xy or
    None) of the configuration."""
    if spec["geometry"] == "fibonacci_sphere":
        x = GEO.fibonacci_sphere(spec["points"], spec["radius"])
        h = GEO.h_for_neighbours(spec["points"], spec["radius"],
                                 spec["neighbours"])
        return x, GEO.sphere_normals(x), h, None
    if spec["geometry"] == "plane_grid":
        x2 = GEO.plane_grid(spec["side"])
        x = torch.nn.functional.pad(x2, (0, 1)).numpy()
        return x, None, float(spec["h"]), x2
    raise ValueError(f"unknown geometry {spec['geometry']!r}")


def build_engine(spec: dict, x: np.ndarray, h: float, device):
    """The program's band engine, as its CLIs build it. (The cell engine
    draws its fire masks in a slot order the reference does not rebuild
    yet, so no cell runs it.)"""
    from sph_nca_tpu_torch.ops.bands import build_band_engine

    if spec["engine"] != "band":
        raise ValueError(f"no check for the {spec['engine']!r} engine")
    return build_band_engine(x, h, table_dtype=spec["precision"],
                             device=device)


def model_config(spec: dict, h: float):
    """The program's model configuration as the configuration file states
    it; ValueError where the program has no option for what it states."""
    from sph_nca_tpu_torch.models import nca

    if spec["alive_threshold"] != nca.ALIVE_THRESHOLD:
        raise ValueError("the program's life threshold is fixed at "
                         f"{nca.ALIVE_THRESHOLD}")
    cfg = nca.SPHNCAConfig(channels=spec["channels"], hidden=spec["hidden"],
                           fire_rate=spec["fire_rate"],
                           update_rule=spec["update_rule"],
                           normalize_perception=1.0 / h,
                           smoothing=spec["smoothing"])
    if (cfg.in_features, cfg.out_features) != (spec["mlp_inputs"],
                                               spec["mlp_outputs"]):
        raise ValueError("the MLP's widths do not fit the update rule")
    return cfg


def perception_scale(h: float) -> float:
    """h k with k = 1 / h, rounded as the program rounds it."""
    return h * (1.0 / h)


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| / |want| over the whole tensor (float32 norms)."""
    got, want = got.float(), want.float()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-30))


def norm_gap(got, want, keep):
    """Worst leaf of |(|got|) - (|want|)| / max(|want|, median leaf
    |want|), over the leaves ``keep`` marks."""
    gn = [float(torch.linalg.vector_norm(g.float())) for g in got]
    wn = [float(torch.linalg.vector_norm(w.float())) for w in want]
    med = float(np.median([w for w, k in zip(wn, keep) if k]))
    return max(abs(g - w) / max(w, med, 1e-30)
               for g, w, k in zip(gn, wn, keep) if k)


def unexplained_flips(ops, A, flip, living, seen, threshold):
    """[B, N]: the particles whose life the program decides apart from the
    reference although rounding cannot explain it. A particle lives where
    its blurred life before (``pre``) and after the update (``post``) both
    pass the threshold. The program's ``pre`` reads the same states as the
    reference's, so it may differ by ``BLUR_ROUNDING``; its ``post`` blurs
    the updated alpha lanes, which differ by up to the widest alpha gap of
    the particles both sides keep, so every neighbour whose alpha lies that
    near the threshold may have its life decided apart too, and moves
    ``post`` by its weight in the blur."""
    both = (~flip) & living
    gap = float((A[..., 3] - seen["alpha"]).abs()[both].max()) \
        if bool(both.any()) else 0.0
    # the alpha lanes are tested rounded to the table precision: a lane a
    # rounding step from the threshold may cross it too
    step = threshold * 2.0 ** -7
    near = ((seen["alpha"] - threshold).abs() <= gap + step).float()[
        ..., None]
    doubt = ops.blur(near)[..., 0] + BLUR_ROUNDING
    explained = (((seen["pre"] - threshold).abs() <= BLUR_ROUNDING)
                 | ((seen["post"] - threshold).abs() <= doubt))
    return flip & ~explained


class RolloutDriver:
    """Back-to-back batched surface rollouts of one mesh
    (``models.surface.rollout_mesh_batched``)."""

    def __init__(self, spec: dict, seed: int, device, substitute=None):
        self.spec, self.seed, self.device = spec, seed, device
        # called once the program is built, before any of its work runs: a
        # control or a fault puts itself in the program's place there
        self.substitute = substitute
        self.b, self.steps = spec["batch"], spec["steps"]

    def setup(self) -> None:
        from sph_nca_tpu_torch.models.surface import rollout_mesh_batched

        spec, dev = self.spec, self.device
        self.x, nrm, self.h, _ = geometry(spec)
        self.n = torch.from_numpy(nrm).to(dev)
        t0 = time.perf_counter()
        self.eng = build_engine(spec, self.x, self.h, dev)
        sync(dev)
        self.build_s = time.perf_counter() - t0
        self.cfg = model_config(spec, self.h)
        self.rule = REF.rule_of(spec, perception_scale(self.h))
        self.weights = make_weights(spec, self.seed, dev)
        self.mlp_dtype = "bfloat16" if spec["precision"] == "bfloat16" \
            else None
        self.rollout_fn = rollout_mesh_batched
        self.kept = {}
        self.pick = np.random.default_rng(subseed(self.seed, "sample"))
        if self.substitute is not None:
            self.substitute(self)
        t1 = time.perf_counter()
        with torch.no_grad():
            self._rollout(-1, 2)  # every shape a step uses
        sync(dev)
        log(f"warm-up rollout {time.perf_counter() - t1:.3f} s")

    def inputs(self, k: int):
        """Rollout k's initial states [B, N, 16] (uniform) and unit
        tangents [B, N, 3] (normal draws projected off the normals)."""
        gen = torch.Generator(device=self.device).manual_seed(
            subseed(self.seed, "inputs", k))
        npts = self.x.shape[0]
        A0 = torch.rand(self.b, npts, self.spec["channels"], generator=gen,
                        device=self.device)
        t = torch.randn(self.b, npts, 3, generator=gen, device=self.device)
        t = t - self.n * torch.sum(self.n * t, dim=-1, keepdim=True)
        return A0, t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)

    def fire_seed(self, k: int) -> int:
        return subseed(self.seed, "fire", k)

    def _rollout(self, k: int, steps: int):
        from sph_nca_tpu_torch.models.nca import MLPParams

        A0, T0 = self.inputs(k)
        gen = torch.Generator(device=self.device).manual_seed(
            self.fire_seed(k))
        return self.rollout_fn(MLPParams(*self.weights), self.cfg, self.eng,
                               A0, self.n, T0, gen, steps, self.h,
                               mlp_dtype=self.mlp_dtype)

    def unit(self, k: int) -> int:
        """Rollout k, read back; keeps the first and one uniform pick of
        the rest (reservoir) for the check. Returns its particle-steps."""
        with torch.no_grad():
            out = self._rollout(k, self.steps)
        sync(self.device)
        if k == 0 or self.pick.random() < 1.0 / k:
            self.kept[0 if k == 0 else "pick"] = (k, out)
        return self.b * self.x.shape[0] * self.steps

    def traced_units(self) -> int:
        return 1

    def release(self) -> None:
        del self.eng

    def program_states(self) -> None:
        """Each kept rollout's states around two of its steps, the program's
        own: the first (from the inputs) and the last (the answer). The
        program runs the same entry for t - 1 and t steps from the same
        inputs and fire seed, so its first t - 1 steps are the answer's."""
        self.steps_checked = []
        for k, (A, T) in sorted(self.kept.values(), key=lambda e: e[0]):
            for t in sorted({1, self.steps}):
                with torch.no_grad():
                    before = (self.inputs(k) if t == 1
                              else self._rollout(k, t - 1))
                    after = (A, T) if t == self.steps \
                        else self._rollout(k, t)
                self.steps_checked.append((k, t, before, after))
        self.kept.clear()

    def check(self):
        """One reference step from each of the program's states that
        ``program_states`` kept, with the program's fire draws of that
        step; the numbers are the worst over them of: the share of
        particles whose life the two sides decide apart where rounding
        cannot explain it (``unexplained_flips``), and the relative gaps of
        the states (where both sides keep the particle alive or both kill
        it) and of the tangents (where the blurred mass is ``MASS_FLOOR``
        or more)."""
        spec = self.spec
        ops = Operators(torch.from_numpy(self.x).to(self.device), self.h,
                        spec["precision"])
        rank, shape = GEO.band_ranks(self.x, self.h)
        state = tangent = every = flips = unexplained = 0.0
        alive = []
        for k, t, (Ap, Tp), (A, T) in self.steps_checked:
            draws = REF.FireDraws(self.fire_seed(k), rank, shape, self.b,
                                  self.device)
            for _ in range(t - 1):
                draws.next()
            seen = {}
            with torch.no_grad():
                Ar, Tr = REF.surface_step(ops, self.weights, Ap.float(),
                                          Tp.float(), self.n, draws.next(),
                                          self.rule, seen)
                # a particle whose life mask the two sides decide apart (a
                # thresholded blur a rounding away from the threshold) is 0
                # on one side: left out of the state gap, and counted
                living = Ar.abs().amax(-1) > 0
                flip = (A.abs().amax(-1) > 0) != living
                alive.append(float(living.float().mean()))
                lost = unexplained_flips(ops, A, flip, living, seen,
                                         self.rule.alive)
                same = ~flip[..., None]
                # t2 = blur(m t) / blur(m) turns rounding into noise where
                # the blurred mass m is small: tangents are compared where
                # it is MASS_FLOOR or more
                mass = ops.blur(torch.clamp(Ar[..., 3:4], 0.0, 1.0)) \
                    >= MASS_FLOOR
            state = max(state, rel_gap(A * same, Ar * same))
            tangent = max(tangent, rel_gap(T * mass, Tr * mass))
            every = max(every, rel_gap(T, Tr))
            flips = max(flips, float(flip.float().mean()))
            unexplained = max(unexplained, float(lost.float().mean()))
        log(f"not compared: the tangent gap over every particle {every!r}; "
            f"the reference's living share {alive!r}; every life flip "
            f"{flips!r}")
        self.pairs = ops.pairs
        return {"state_gap": state, "tangent_gap": tangent,
                "unexplained_flips": unexplained}


def adam_state(trainer):
    """([(first, second moment)] by leaf, update count) of the trainer's
    Adam (zeros and 0 before its first update)."""
    state = trainer.optimizer.state
    moments = [(state[p]["exp_avg"].detach().clone(),
                state[p]["exp_avg_sq"].detach().clone()) if p in state
               else (torch.zeros_like(p), torch.zeros_like(p))
               for p in trainer.params]
    first = state.get(trainer.params[0], {})
    return moments, int(first["step"]) if "step" in first else 0


class TrainDriver:
    """Back-to-back full-depth training iterations
    (``training.trainer.Trainer.run_iteration`` on a ``DevicePool``)."""

    def __init__(self, spec: dict, seed: int, device, substitute=None):
        self.spec, self.seed, self.device = spec, seed, device
        # called once the program is built, before any of its work runs: a
        # control or a fault puts itself in the program's place there
        self.substitute = substitute
        self.b = spec["batch"]

    def trainer_seed(self) -> int:
        """The trainer's own seed (its depth, aux-state and fire draws):
        the traffic's, the same in every run, so every run draws the same
        depths."""
        return subseed(self.spec["trainer_seed"], "trainer")

    def pool_draws(self) -> int:
        return subseed(self.seed, "pool draws")

    def target(self) -> torch.Tensor:
        """The flat-colour target image [size, size, 4]."""
        img = torch.zeros(self.spec["target_size"], self.spec["target_size"],
                          4, device=self.device)
        img[...] = torch.tensor(self.spec["target_rgba"], device=self.device)
        return img

    def pool_states(self) -> torch.Tensor:
        """The pool's states [pool, N, C], uniform, distinct rows."""
        gen = torch.Generator(device=self.device).manual_seed(
            subseed(self.seed, "pool"))
        return torch.rand(self.spec["pool_size"], self.x2.shape[0],
                          self.spec["channels"], generator=gen,
                          device=self.device)

    def setup(self) -> None:
        from sph_nca_tpu_torch.models import cell_step
        from sph_nca_tpu_torch.models.nca import MLPParams
        from sph_nca_tpu_torch.training.losses import MSELossConfig
        from sph_nca_tpu_torch.training.pool import DevicePool
        from sph_nca_tpu_torch.training.trainer import (
            TrainConfig,
            Trainer,
            make_mse_bundle,
        )

        spec, dev = self.spec, self.device
        if spec["remat"] != cell_step.REMAT:
            raise ValueError(f"the program's recompute is {cell_step.REMAT}")
        if not spec["device_pool"]:
            raise ValueError("the driver keeps the pool on the device")
        self.x, _, self.h, self.x2 = geometry(spec)
        self.rule = REF.rule_of(spec, perception_scale(self.h))
        t0 = time.perf_counter()
        self.eng = build_engine(spec, self.x, self.h, dev)
        sync(dev)
        self.build_s = time.perf_counter() - t0
        self.weights = make_weights(spec, self.seed, dev)
        self.seed_state = GEO.radial_seed(self.x2, spec["channels"], self.h)
        loss = make_mse_bundle(self.target(), MSELossConfig(
            gmin=(-1.0, -1.0), gsize=(2.0, 2.0),
            image_scale=spec["image_scale"],
            overflow_weight=spec["overflow_weight"], use_alpha=True))
        tc = TrainConfig(batch_size=self.b, pool_size=spec["pool_size"],
                         steps_range=tuple(spec["steps_range"]),
                         steps_increment=spec["steps_increment"],
                         lr=spec["lr"], lr_end_factor=spec["lr_end_factor"],
                         lr_decay_steps=spec["lr_decay_steps"],
                         normalize_grads=spec["normalize_grads"],
                         aux_states=spec["aux_states"],
                         aux_weight=spec["aux_weight"],
                         optimizer=spec["optimizer"],
                         seed=self.trainer_seed())
        self.trainer = Trainer(model_config(spec, self.h), tc, self.eng,
                               self.x2, loss, self.h,
                               params=MLPParams(*self.weights))
        self.pool = DevicePool(
            self.x2.numpy(), self.seed_state.numpy(), spec["pool_size"],
            rng=np.random.default_rng(self.pool_draws()),
            device=dev)
        self.pool.A = self.pool_states()
        sync(dev)
        log(f"trainer and pool built {time.perf_counter() - t0:.3f} s after "
            "the engine's build began")
        if self.substitute is not None:
            self.substitute(self)
        # the first iterations are the set-up's warm-up and the check's
        # steps: the losses, the first one's raw gradients and final
        # states, and the parameters before and after
        tr = self.trainer
        self.before = [p.detach().clone() for p in tr.params]
        self.losses = []
        # the pool rows the first iteration draws, and writes its final
        # states back to
        self.rows = torch.as_tensor(np.random.default_rng(
            self.pool_draws()).permutation(spec["pool_size"])[:self.b],
            device=dev)
        for i in range(spec["checked_iterations"]):
            t0 = time.perf_counter()
            if i == 0:
                self.first = self._recorded(0)
                self.losses.append(self.first["loss"])
            else:
                self.losses.append(tr.run_iteration(i, self.pool))
            log(f"set-up iteration {i}: {tr.last_steps} steps, loss "
                f"{self.losses[-1]!r}, {time.perf_counter() - t0:.3f} s")
            if i == 0:
                self.first_finals = self.pool.A[self.rows].clone()
        self.after = [p.detach().clone() for p in tr.params]
        self.i = spec["checked_iterations"]
        self.depths = []
        self.kept = None
        self.pick = np.random.default_rng(subseed(self.seed, "sample"))
        sync(dev)

    def _recorded(self, i: int) -> dict:
        """Iteration ``i``, with what the reference needs to follow it from
        the program's own state and what it is compared with: the
        parameters, Adam's state and the draws' states before it, the pool
        rows and the batch it drew, its raw gradients (as the backward hands
        them to the leaves, before any normalization), the final states it
        wrote back with their rows, and its loss."""
        tr, pool = self.trainer, self.pool
        rec = {"params": [p.detach().clone() for p in tr.params],
               "adam": adam_state(tr),
               "np": copy.deepcopy(tr.np_rng.bit_generator.state),
               "fire": tr.generator.get_state(),
               "grads": [None] * len(tr.params)}
        sample, update = pool.sample, pool.update

        def recorded_sample(*a, **k):
            del pool.sample
            idx, A0 = sample(*a, **k)
            rec["idx"] = torch.as_tensor(idx).cpu().clone()
            rec["A0"] = torch.as_tensor(A0).clone()
            return idx, A0

        def recorded_update(idx, A):
            del pool.update
            rec["rows"] = torch.as_tensor(idx).cpu().clone()
            rec["final"] = A.detach().clone()
            return update(idx, A)

        def keep(i):
            def hook(g):
                rec["grads"][i] = g.detach().clone()
            return hook
        pool.sample, pool.update = recorded_sample, recorded_update
        hooks = [p.register_hook(keep(k)) for k, p in enumerate(tr.params)]
        try:
            rec["loss"] = tr.run_iteration(i, pool)
        finally:
            for h in hooks:
                h.remove()
            pool.__dict__.pop("sample", None)
            pool.__dict__.pop("update", None)
        rec["steps"] = tr.last_steps
        return rec

    def unit(self, k: int) -> int:
        # one iteration of the window, drawn uniformly (reservoir), is
        # recorded for the check
        if k == 0 or self.pick.random() < 1.0 / (k + 1):
            self.kept = self._recorded(self.i)
            self.kept["unit"] = k
        else:
            self.trainer.run_iteration(self.i, self.pool)
        self.i += 1
        self.depths.append(self.trainer.last_steps)
        return self.b * self.x2.shape[0] * self.trainer.last_steps

    def traced_units(self) -> int:
        return 2

    def release(self) -> None:
        del self.trainer, self.pool, self.eng

    def _reference(self, ops, weights, pool):
        rank, shape = GEO.band_ranks(self.x, self.h)
        return REF.PlaneTrainer(
            ops, weights, self.x2.to(self.device), self.target(), pool,
            self.seed_state.to(self.device), self.spec,
            pool_seed=self.pool_draws(), train_seed=self.trainer_seed(),
            rank=rank, shape=shape, batch=self.b, rule=self.rule,
            device=self.device)

    @staticmethod
    def _kept(grads):
        """The leaves whose reference gradient is a thousandth of the
        median leaf's or more."""
        raw = [float(torch.linalg.vector_norm(g)) for g in grads]
        return [r >= 1e-3 * float(np.median(raw)) for r in raw]

    @staticmethod
    def state_gaps(got, want):
        """Each sample's relative final-state gap, over the particles whose
        life mask both sides decide alike, and the share of the others."""
        flip = (got.abs().amax(-1) > 0) != (want.abs().amax(-1) > 0)
        same = ~flip[..., None]
        return ([rel_gap(a * s, r * s) for a, r, s in zip(got, want, same)],
                float(flip.float().mean()))

    def check(self):
        """The reference's first iterations from the same weights, pool,
        draws' seeds and target, and the recorded window iteration from the
        program's own state before it. Compared: the median over the
        samples of the final states' gap of the first and of the window
        iteration; the norm of the parameters' change over the first
        iterations, by the worst leaf; the norms of the window iteration's
        raw gradients, by the worst leaf. Leaves whose reference gradient
        is under a thousandth of the median leaf's are left out of the
        norms. Logged, not compared: the losses, and the first iteration's
        raw gradients (from uniform states under random weights its rollout
        overflows and its life masks flip, so they swing by more than the
        control moves them)."""
        spec, dev = self.spec, self.device
        ops = Operators(torch.from_numpy(self.x).to(dev), self.h,
                        spec["precision"])
        ref = self._reference(ops, self.weights, self.pool_states())
        losses, finals = [], None
        for _ in self.losses:
            losses.append(ref.iteration())
            if finals is None:
                finals = ref.pool[self.rows].clone()
        per_sample, flips = self.state_gaps(self.first_finals, finals)
        log(f"not compared: the first iteration's per-sample state gaps, "
            f"largest {max(per_sample)!r}; life flips {flips!r}; the losses "
            f"{self.losses!r} against the reference's {losses!r}, the "
            "first's gap " + repr(abs(self.losses[0] - losses[0])
                                  / max(abs(losses[0]), 1e-30)))
        keep = self._kept(ref.first_raw_grads)
        change = [a - b for a, b in zip(self.after, self.before)]
        ref_change = [a.detach() - b for a, b in zip(ref.params,
                                                     ref.initial)]
        first_grads = norm_gap(self.first["grads"], ref.first_raw_grads,
                               keep)
        # the window's recorded iteration, from the program's state
        w = self.kept
        again = self._reference(ops, REF.Weights(*w["params"]), None)
        again.resume(w["adam"], w["np"], w["fire"])
        loss, final, order = again.iterate(w["A0"].to(dev))
        # the reference's final states in the order of the pool rows the
        # program wrote
        at = {int(r): k for k, r in enumerate(w["idx"][order.cpu()])}
        final = final[[at[int(r)] for r in w["rows"]]]
        window_states, window_flips = self.state_gaps(w["final"], final)
        window_grads = norm_gap(w["grads"], again.raw_grads,
                                self._kept(again.raw_grads))
        log(f"window iteration {w['unit']} ({w['steps']} steps): not "
            f"compared: its loss {w['loss']!r} against the reference's "
            f"{loss!r}, the gap {abs(w['loss'] - loss) / abs(loss)!r}; its "
            f"life flips {window_flips!r}; the first iteration's raw "
            f"gradients' norm gap {first_grads!r}")
        self.pairs = ops.pairs
        return {
            "first_state_gap": float(np.median(per_sample)),
            "change_gap": norm_gap(change, ref_change, keep),
            "window_state_gap": float(np.median(window_states)),
            "window_grad_gap": window_grads,
        }


DRIVERS = {"rollout": RolloutDriver, "train": TrainDriver}


def window(driver, seconds: float, min_units: int = 1):
    """Units back to back until ``seconds`` have passed (and at least
    ``min_units`` ran); the window closes when the last unit is read back.
    (units, work, seconds)."""
    sync(driver.device)
    t0 = time.perf_counter()
    units = work = 0
    ends = []
    while units < min_units or ends[-1] - t0 < seconds:
        work += driver.unit(units)
        units += 1
        ends.append(time.perf_counter())
    sync(driver.device)
    driver.next_unit = units
    secs = time.perf_counter() - t0
    log("units' seconds " + " ".join(
        f"{b - a:.4f}" for a, b in zip([t0] + ends[:-1], ends)))
    if getattr(driver, "depths", None):
        log(f"units' depths {driver.depths}")
    return units, work, secs


def device_window(driver, seconds: float, min_units: int = 1):
    """``window`` under a profiler that records the device's activity
    alone (no host operators): (units, work, seconds, the seconds in which
    an operation ran on the device; None off a card)."""
    if torch.device(driver.device).type != "cuda":
        return (*window(driver, seconds, min_units), None)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        units, work, secs = window(driver, seconds, min_units)
    t0 = time.perf_counter()
    busy = TR.device_busy_s(prof)
    log(f"device busy {busy:.6f} s of the window's {secs:.3f} s, read in "
        f"{time.perf_counter() - t0:.3f} s")
    return units, work, secs, busy


def load_readers() -> dict:
    """Every per-layer reader in ``metrics/``, by file name."""
    readers = {}
    for path in sorted((HERE / "metrics").glob("*.py")):
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{path.stem.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        readers[path.stem] = mod
    return readers


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None,
             overrides: dict | None = None, substitute=None,
             min_units: int = 1) -> dict:
    """One run; returns the result's fields (the contract's last line less
    its device's name) and the compared numbers with their limits."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = cell_spec(cell, overrides)
    torch.backends.cuda.matmul.allow_tf32 = spec["tf32"]
    torch.backends.cudnn.allow_tf32 = spec["tf32"]
    driver = DRIVERS[spec["kind"]](spec, seed, device, substitute)
    t0 = time.perf_counter()
    driver.setup()
    sync(device)
    # the set-up's objects leave the collector's generations, so that a
    # collection in the window does not walk them
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s (before the driver {t0 - t_start:.3f} s, "
        f"the engine's build {driver.build_s:.3f} s)")
    # a cell timed by the device's trace runs its window under the
    # profiler, except in a traced run, whose window times the host
    by_device = spec.get("timed_by") == "device_trace" and not trace
    if by_device:
        units, work, secs, busy = device_window(driver, seconds, min_units)
    else:
        units, work, secs = window(driver, seconds, min_units)
    log(f"window {secs:.3f} s, {units} units, {work / secs:.6e} "
        "particle-steps/s")
    metrics = {}
    record = None
    if trace:
        t0 = time.perf_counter()
        record = TR.traced_window(driver)
        log(f"traced window {record['window_s']:.3f} s, reduced in "
            f"{time.perf_counter() - t0 - record['window_s']:.3f} s")
        record.update(untraced_rate=work / secs, engine_build_s=driver.build_s,
                      precision=spec["precision"], batch=driver.b,
                      points=driver.x.shape[0], kind=spec["kind"],
                      widths=AR.widths(spec),
                      surface=spec["kind"] == "rollout")
    elif by_device:
        if busy is not None:
            # the device's milliseconds a step of the whole batch
            steps = work / (driver.b * driver.x.shape[0])
            metrics[spec["metric"]] = {"value": 1e3 * busy / steps,
                                       "unit": "ms"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        metrics[spec["metric"]] = {"value": work / secs,
                                   "unit": "particle-steps/s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    t0 = time.perf_counter()
    if hasattr(driver, "program_states"):
        driver.program_states()
    driver.release()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    numbers = driver.check()
    sync(device)
    log(f"check: the program's states {t1 - t0:.3f} s, the reference "
        f"{time.perf_counter() - t1:.3f} s")
    limits = spec["limits"]
    log(f"pairs within h, self pairs included: {driver.pairs}")
    if record is not None:
        record["pairs"] = driver.pairs
        for name, mod in load_readers().items():
            value = mod.read(record)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
    bad = [k for k, v in numbers.items() if not v <= limits[k]]
    out = {"correct": units > 0 and not bad, "attempted": units,
           "failed": len(bad), "metrics": metrics,
           "device": {"peak": peak}, "checks": {
               k: {"value": v, "limit": limits[k]}
               for k, v in numbers.items()}}
    if record is not None:
        out["device"].update(busy_s=record["busy_s"],
                             window_s=record["window_s"])
        out["breakdown"] = record["breakdown"]
        out["tracing_overhead"] = 1.0 - record["traced_rate"] / (work / secs)
    gc.unfreeze()
    return out

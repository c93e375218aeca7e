"""Checkpoints with full training resume (counterpart of
``sph_nca_tpu/io/checkpoint.py``), in the JAX package's layout, so each
package reads the other's:

  checkpoint.msgpack  {params: {w1, b1, w2, b2}, opt_state?}, flax's msgpack
                      encoding (written and read by ``io/msgpack.py``)
  meta.json           model and train configs, h, step, loss, extra (the
                      CLI's args and the model's mode)
  seed.npz            the seed geometry x and state A (optional)
  resume.npz + resume_rng.json   the resume sidecar: the pool's states and
                      the random streams' states

``opt_state`` is optax's state of the JAX trainer's chain, as
``flax.serialization.to_state_dict`` flattens it: with gradient
normalization ``{"0": {}, "1": inner}``, without it ``{"0": inner}``, where
``inner`` holds one entry per transform of the optimizer's chain
(``training/optim.LAYOUTS``), e.g. Adam's ``{"0": {count, mu, nu}, "1":
{count}}`` and LAMB's ``{"0": {count, mu, nu}, "1": {}, "2": {}, "3":
{count}}``; counts are int32 scalars, and mu, nu and sum_of_squares hold
{w1, b1, w2, b2} in float32. ``optax_state_tree`` / ``load_optax_state``
map it onto the port's optimizers: ``torch.optim.Adam``'s exp_avg,
exp_avg_sq and step for Adam (the update formulas agree: the same eps
outside the square root, the same bias correction), the optax rules' own
state for the others (``training/optim.py``); every count in the tree is
the number of updates, which also puts the schedule at its position. A tree
of another optimizer's layout raises.

The port's sidecar holds the pool, the numpy streams' states (the trainer's
and the pool's) and the trainer's ``torch.Generator`` states, and says it is
the port's. A sidecar of the JAX package holds a JAX key instead, which the
port cannot continue: ``load_resume_state`` marks it, and the train CLI then
resumes softly (params, optimizer state and step restored; a fresh pool
and streams).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models.nca import MLPParams, SPHNCAConfig
from ..training.optim import LAYOUTS, OPTIMIZERS, SCHEDULE
from . import msgpack

PARAM_NAMES = MLPParams._fields  # ('w1', 'b1', 'w2', 'b2')
PORT_SIDECAR = "sph_nca_tpu_torch"


def _host(t) -> np.ndarray:
    if torch.is_tensor(t):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def save_checkpoint(
    path: str,
    *,
    params: MLPParams,
    model_cfg: SPHNCAConfig,
    h: float,
    step: int,
    loss: float = float("nan"),
    opt_state: Optional[dict] = None,
    train_cfg: Any = None,
    seed_x=None,
    seed_A=None,
    extra_meta: Optional[Dict[str, Any]] = None,
) -> None:
    """Write a checkpoint directory. ``opt_state`` is an optax-layout tree
    (``Trainer.opt_state_tree()``)."""
    os.makedirs(path, exist_ok=True)
    state = {"params": {k: _host(v).astype(np.float32)
                        for k, v in params._asdict().items()}}
    if opt_state is not None:
        state["opt_state"] = opt_state
    with open(os.path.join(path, "checkpoint.msgpack"), "wb") as f:
        f.write(msgpack.packb(state))

    meta = {
        "model_cfg": dataclasses.asdict(model_cfg),
        "h": float(h),
        "step": int(step),
        "loss": float(loss),
        "has_opt_state": opt_state is not None,
    }
    if train_cfg is not None:
        meta["train_cfg"] = (dataclasses.asdict(train_cfg)
                             if dataclasses.is_dataclass(train_cfg)
                             else dict(train_cfg))
    if extra_meta:
        meta["extra"] = extra_meta
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)

    if seed_x is not None:
        np.savez(os.path.join(path, "seed.npz"), x=_host(seed_x),
                 A=_host(seed_A) if seed_A is not None else np.zeros(0))


def load_checkpoint(path: str, device="cuda") -> Dict[str, Any]:
    """Read a checkpoint of either package -> {params (on ``device``),
    model_cfg, h, step, loss, meta, opt_state? (the raw optax tree),
    seed_x?, seed_A?}. Metas written before ``smoothing`` existed give
    poly6; a meta key the config does not know raises."""
    dev = resolve_device(device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(path, "checkpoint.msgpack"), "rb") as f:
        state = msgpack.unpackb(f.read())

    model_cfg = SPHNCAConfig(**meta["model_cfg"])
    raw = state["params"]
    if set(raw) != set(PARAM_NAMES):
        raise ValueError(f"checkpoint params {sorted(raw)} are not "
                         f"{sorted(PARAM_NAMES)}")
    params = MLPParams(*(torch.tensor(np.asarray(raw[k], np.float32),
                                      device=dev) for k in PARAM_NAMES))
    want = {"w1": (model_cfg.in_features, model_cfg.hidden),
            "b1": (model_cfg.hidden,),
            "w2": (model_cfg.hidden, model_cfg.out_features),
            "b2": (model_cfg.out_features,)}
    for k, t in zip(PARAM_NAMES, params):
        if tuple(t.shape) != want[k]:
            raise ValueError(f"checkpoint {k} has shape {tuple(t.shape)}, "
                             f"the model config needs {want[k]}")
    out: Dict[str, Any] = {"params": params, "model_cfg": model_cfg,
                           "h": meta["h"], "step": meta["step"],
                           "loss": meta["loss"], "meta": meta}
    if "opt_state" in state:
        out["opt_state"] = state["opt_state"]
    seed_path = os.path.join(path, "seed.npz")
    if os.path.exists(seed_path):
        with np.load(seed_path) as seed:
            out["seed_x"] = seed["x"]
            out["seed_A"] = seed["A"] if seed["A"].size else None
    return out


# ---- the optimizers' state in optax's layout --------------------------------


def _is_adam(optimizer) -> bool:
    return isinstance(optimizer, torch.optim.Adam)


def _count(optimizer, params: MLPParams) -> int:
    if not _is_adam(optimizer):
        return optimizer.count
    st = optimizer.state.get(params[0], {})
    return int(float(st["step"])) if st else 0


def _moment(optimizer, p: torch.Tensor, field: str) -> np.ndarray:
    if not _is_adam(optimizer):
        return _host(optimizer.moments(p)[field]).astype(np.float32)
    st = optimizer.state.get(p, {})
    if not st:  # before the first update
        return np.zeros(tuple(p.shape), np.float32)
    key = {"mu": "exp_avg", "nu": "exp_avg_sq"}[field]
    return _host(st[key]).astype(np.float32)


def optax_state_tree(optimizer, params: MLPParams, normalize_grads: bool,
                     name: str = "adam") -> dict:
    """The state of ``optimizer`` (``training.optim.OPTIMIZERS[name]``) for
    ``params`` as the JAX trainer's optax state tree. Before the first
    update: the initial moments, count 0."""
    count = np.asarray(_count(optimizer, params), np.int32)
    inner = {}
    for i, entry in enumerate(LAYOUTS[name]):
        if entry == SCHEDULE:
            inner[str(i)] = {"count": count.copy()}
            continue
        inner[str(i)] = {
            f: count.copy() if f == "count" else {
                k: _moment(optimizer, p, f)
                for k, p in zip(PARAM_NAMES, params)}
            for f in entry}
    return {"0": {}, "1": inner} if normalize_grads else {"0": inner}


def load_optax_state(optimizer, params: MLPParams, tree: dict,
                     name: str = "adam") -> int:
    """Load an optax state tree of optimizer ``name`` (either chain layout)
    into ``optimizer`` for ``params``; returns its update count. Raises on
    another optimizer's layout, on counts that differ and on moments whose
    shapes differ from the params'."""
    label = OPTIMIZERS[name].__name__
    if set(tree) == {"0", "1"} and tree["0"] == {}:
        inner = tree["1"]
    elif set(tree) == {"0"}:
        inner = tree["0"]
    else:
        raise ValueError(f"opt_state keys {sorted(tree)} are not an optax "
                         f"{label} chain")
    layout = LAYOUTS[name]
    if not isinstance(inner, dict) or set(inner) != {
            str(i) for i in range(len(layout))}:
        raise ValueError(f"opt_state is not an optax {label} state: "
                         f"{len(layout)} transforms expected")
    counts, moments = [], {}
    for i, entry in enumerate(layout):
        st = inner[str(i)]
        want = {"count"} if entry == SCHEDULE else set(entry)
        if not isinstance(st, dict) or set(st) != want:
            raise ValueError(f"opt_state entry {i} is not optax {label}'s "
                             f"{sorted(want)}")
        for f in want:
            if f == "count":
                counts.append(int(np.asarray(st[f])))
            elif not isinstance(st[f], dict) or set(st[f]) != set(
                    PARAM_NAMES):
                raise ValueError(f"opt_state {f} is not keyed by "
                                 f"{PARAM_NAMES}")
            else:
                moments[f] = st[f]
    if len(set(counts)) != 1:
        raise ValueError(f"opt_state counts differ: {counts}")
    count = counts[0]
    for k, p in zip(PARAM_NAMES, params):
        arrays = {f: np.asarray(m[k], np.float32) for f, m in moments.items()}
        if any(a.shape != tuple(p.shape) for a in arrays.values()):
            raise ValueError(f"opt_state {k} moments "
                             f"{[a.shape for a in arrays.values()]} do not "
                             f"match the param {tuple(p.shape)}")
        state = {f: torch.tensor(a, device=p.device)
                 for f, a in arrays.items()}
        if _is_adam(optimizer):
            state = {"step": torch.tensor(float(count), dtype=torch.float32),
                     "exp_avg": state["mu"], "exp_avg_sq": state["nu"]}
        optimizer.state[p] = state
    if not _is_adam(optimizer):
        optimizer.count = count
    return count


# ---- the resume sidecar ------------------------------------------------------


def save_resume_state(path: str, *, pool_A, np_rng_state: Dict[str, Any],
                      pool_rng_state: Dict[str, Any],
                      torch_rng: Dict[str, torch.Tensor]) -> None:
    """Write the port's sidecar: the pool [P, N, C], the trainer's and the
    pool's numpy stream states, the trainer's generator states."""
    np.savez(os.path.join(path, "resume.npz"), pool_A=_host(pool_A),
             **{f"torch_rng_{k}": _host(v) for k, v in torch_rng.items()})
    with open(os.path.join(path, "resume_rng.json"), "w") as f:
        json.dump({"np_rng": np_rng_state, "pool_rng": pool_rng_state,
                   "format": PORT_SIDECAR}, f)


def load_resume_state(path: str) -> Dict[str, Any]:
    """-> {pool_A, np_rng, pool_rng, port, torch_rng?, key_data?}: ``port``
    is False for a JAX package's sidecar, which carries ``key_data`` (a JAX
    key) in place of ``torch_rng``."""
    with np.load(os.path.join(path, "resume.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    with open(os.path.join(path, "resume_rng.json")) as f:
        rng = json.load(f)
    out = {"pool_A": arrays["pool_A"], "np_rng": rng["np_rng"],
           "pool_rng": rng["pool_rng"],
           "port": rng.get("format") == PORT_SIDECAR}
    if out["port"]:
        out["torch_rng"] = {k[len("torch_rng_"):]: torch.from_numpy(v)
                            for k, v in arrays.items()
                            if k.startswith("torch_rng_")}
    elif "key_data" in arrays:
        out["key_data"] = arrays["key_data"]
    return out


def has_resume_state(path: str) -> bool:
    return os.path.exists(os.path.join(path, "resume.npz"))


def find_latest_resumable(output_dir: str) -> Optional[str]:
    """The highest-step checkpoint directory under ``output_dir`` that has a
    resume sidecar, or None."""
    best, best_step = None, -1
    if not os.path.isdir(output_dir):
        return None
    for name in os.listdir(output_dir):
        p = os.path.join(output_dir, name)
        if not (os.path.isdir(p) and has_resume_state(p)):
            continue
        try:
            with open(os.path.join(p, "meta.json")) as f:
                step = int(json.load(f)["step"])
        except (OSError, KeyError, ValueError):
            continue
        if step > best_step:
            best, best_step = p, step
    return best

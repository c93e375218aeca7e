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
normalization ``{"0": {}, "1": {"0": {count, mu, nu}, "1": {count}}}``,
without it ``{"0": {"0": {count, mu, nu}, "1": {count}}}``; mu and nu hold
{w1, b1, w2, b2}. ``adam_to_optax`` / ``adam_from_optax`` map it onto
``torch.optim.Adam``: mu is ``exp_avg``, nu ``exp_avg_sq`` and count
``step`` (and the schedule's position); the update formulas agree (the same
eps outside the square root, the same bias correction).

The port's sidecar holds the pool, the numpy streams' states (the trainer's
and the pool's) and the trainer's ``torch.Generator`` states, and says it is
the port's. A sidecar of the JAX package holds a JAX key instead, which the
port cannot continue: ``load_resume_state`` marks it, and the train CLI then
resumes softly (params, Adam state and step restored; a fresh pool and
streams).
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


# ---- Adam's state in optax's layout -----------------------------------------


def adam_to_optax(optimizer: torch.optim.Adam, params: MLPParams,
                  normalize_grads: bool) -> dict:
    """``torch.optim.Adam``'s state for ``params`` as the JAX trainer's optax
    state tree. Before the first update: zero moments, count 0."""
    mu, nu, count = {}, {}, 0
    for k, p in zip(PARAM_NAMES, params):
        st = optimizer.state.get(p, {})
        if st:
            mu[k] = _host(st["exp_avg"]).astype(np.float32)
            nu[k] = _host(st["exp_avg_sq"]).astype(np.float32)
            count = int(float(st["step"]))
        else:
            mu[k] = np.zeros(tuple(p.shape), np.float32)
            nu[k] = np.zeros(tuple(p.shape), np.float32)
    c = np.asarray(count, np.int32)
    adam = {"0": {"count": c, "mu": mu, "nu": nu}, "1": {"count": c.copy()}}
    return {"0": {}, "1": adam} if normalize_grads else {"0": adam}


def adam_from_optax(optimizer: torch.optim.Adam, params: MLPParams,
                    tree: dict) -> int:
    """Load an optax Adam state tree (either chain layout) into
    ``optimizer`` for ``params``; returns its update count. Raises on
    another layout or on moments whose shapes differ from the params'."""
    if set(tree) == {"0", "1"} and tree["0"] == {}:
        adam = tree["1"]
    elif set(tree) == {"0"}:
        adam = tree["0"]
    else:
        raise ValueError(f"opt_state keys {sorted(tree)} are not an optax "
                         "Adam chain")
    try:
        moments = adam["0"]
        count = int(np.asarray(moments["count"]))
        mu, nu = moments["mu"], moments["nu"]
    except (KeyError, TypeError) as e:
        raise ValueError(f"opt_state is not an optax Adam state: {e!r}")
    sched_count = int(np.asarray(adam["1"]["count"]))
    if sched_count != count:
        raise ValueError(f"opt_state counts differ: Adam {count}, schedule "
                         f"{sched_count}")
    for k, p in zip(PARAM_NAMES, params):
        m, v = np.asarray(mu[k], np.float32), np.asarray(nu[k], np.float32)
        if m.shape != tuple(p.shape) or v.shape != tuple(p.shape):
            raise ValueError(f"opt_state {k} moments {m.shape} / {v.shape} "
                             f"do not match the param {tuple(p.shape)}")
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.tensor(m, device=p.device),
            "exp_avg_sq": torch.tensor(v, device=p.device),
        }
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

"""Port parity: the msgpack codec, checkpoints read and written across the
two packages, Adam's state in optax's layout, and resume through the train
CLI.

- The codec decodes every checkpoint under runs/ to the tree
  ``flax.serialization.msgpack_restore`` gives and encodes that tree back to
  the same bytes; flax decodes what the port writes.
- Checkpoints: each package reads the other's params, config, h and step;
  Adam's moments and count map onto ``torch.optim.Adam`` (exp_avg,
  exp_avg_sq, step; ``io.checkpoint.optax_state_tree`` /
  ``load_optax_state`` of Adam) and back onto optax's state, with gradient
  normalization in the chain and without. One more update from a carried
  state agrees between the packages to 1e-6 of the largest |p| (float32
  updates in other orders).
- Resume within the port is exact on the CPU: 6 iterations straight and
  3 + a checkpoint + ``--resume auto`` + 3 give bit-equal losses and
  parameters. A JAX package's sidecar gives the soft resume.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import ml_dtypes
import optax
import pytest
import torch
from flax import serialization

from sph_nca_tpu.io import checkpoint as JC
from sph_nca_tpu.models import SPHNCAConfig as JaxConfig
from sph_nca_tpu.models import init_params as jax_init
from sph_nca_tpu.training.trainer import make_optimizer as jax_optimizer
from sph_nca_tpu_torch.cli import train as cli_train
from sph_nca_tpu_torch.io import checkpoint as TC
from sph_nca_tpu_torch.io import msgpack as M
from sph_nca_tpu_torch.io.convert import params_from_jax_numpy
from sph_nca_tpu_torch.models.nca import MLPParams, SPHNCAConfig
from sph_nca_tpu_torch.training.trainer import (
    TrainConfig,
    make_optimizer,
    normalize_grads_,
    set_schedule_position,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_CHECKPOINTS = sorted(
    os.path.relpath(os.path.dirname(p), ROOT) for p in
    glob.glob(os.path.join(ROOT, "runs", "**", "checkpoint.msgpack"),
              recursive=True))
ASSETS = os.path.join(ROOT, "sph_nca_tpu_torch", "assets")
UPDATE_RTOL = 1e-6
LR, DECAY = 3e-3, 10


def _same_tree(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _same_tree(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


def test_run_checkpoints_are_found():
    assert len(RUN_CHECKPOINTS) >= 40
    assert "runs/gecko_full/sphnca-08162133-8000" in RUN_CHECKPOINTS


@pytest.mark.parametrize("path", RUN_CHECKPOINTS)
def test_run_checkpoint_reads_as_in_jax(path):
    """Every checkpoint of the JAX package's runs: the codec's tree and
    bytes equal flax's; the port's ``load_checkpoint`` gives the JAX
    loader's params, config (poly6 for the metas written before
    ``smoothing``), h and step, and its Adam state loads."""
    full = os.path.join(ROOT, path)
    with open(os.path.join(full, "checkpoint.msgpack"), "rb") as f:
        raw = f.read()
    want_tree = serialization.msgpack_restore(raw)
    _same_tree(M.unpackb(raw), want_tree)
    assert M.packb(want_tree) == raw
    got, want = TC.load_checkpoint(full, device="cpu"), JC.load_checkpoint(full)
    for g, w in zip(got["params"], want["params"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert dataclasses.asdict(got["model_cfg"]) == dataclasses.asdict(
        want["model_cfg"])
    assert (got["h"], got["step"]) == (want["h"], want["step"])
    params = [p.clone().requires_grad_(True) for p in got["params"]]
    opt, sched = make_optimizer(params)
    assert TC.load_optax_state(opt, MLPParams(*params),
                                got["opt_state"]) == got["step"]


def test_codec_round_trips_through_flax():
    tree = {"ints": [0, 127, 128, 255, 256, 65536, 2**33, -1, -32, -33, -129,
                     -40000, -2**40],
            "floats": [0.5, -1e300], "flags": [True, False, None],
            "text": ["", "a" * 31, "b" * 32, "c" * 300], "bin": b"\x00" * 70,
            "a": np.arange(12, dtype=np.int64).reshape(3, 4),
            "f16": np.linspace(0, 1, 5, dtype=np.float16),
            "empty": np.zeros((0, 3), np.float32),
            "bf16": np.array([1.5, -2.0, 3.25], ml_dtypes.bfloat16),
            "big": {str(i): i for i in range(20)}}
    flax_bytes = serialization.msgpack_serialize(tree)
    decoded = M.unpackb(flax_bytes)
    bf16 = decoded.pop("bf16")
    assert bf16.dtype == torch.bfloat16
    assert bf16.float().tolist() == [1.5, -2.0, 3.25]
    want = dict(tree)
    want.pop("bf16")
    _same_tree(decoded, want)
    # the port's encoding: flax decodes it to the same tree, bfloat16 too
    mine = M.packb({**decoded, "bf16": bf16})
    assert mine == flax_bytes
    back = serialization.msgpack_restore(mine)
    assert back["bf16"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(back["bf16"], tree["bf16"])
    _same_tree({k: v for k, v in back.items() if k != "bf16"}, want)


def test_codec_refuses_what_it_does_not_know():
    with pytest.raises(M.MsgpackError, match="ext type 9"):
        M.unpackb(b"\xd4\x09\x00")
    # flax's numpy scalars and complex numbers (ext types 3 and 2)
    for value in (np.float32(2.5), 1 - 2j):
        with pytest.raises(M.MsgpackError, match="ext type"):
            M.unpackb(serialization.msgpack_serialize({"x": value}))
        with pytest.raises(M.MsgpackError, match="cannot encode"):
            M.packb({"x": value})
    with pytest.raises(M.MsgpackError, match="0xc1"):
        M.unpackb(b"\xc1")
    with pytest.raises(M.MsgpackError, match="truncated"):
        M.unpackb(b"\x92\x01")
    with pytest.raises(M.MsgpackError, match="after the object"):
        M.unpackb(b"\x01\x02")
    with pytest.raises(M.MsgpackError, match="cannot encode"):
        M.packb({"x": object()})
    with pytest.raises(M.MsgpackError, match="cannot encode"):
        M.packb([{1, 2}])


def _cfg_pair():
    kw = dict(channels=4, hidden=8, use_alpha=False,
              normalize_perception=2.0)
    return JaxConfig(**kw), SPHNCAConfig(**kw)


def _grads(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _port_updates(params, grads_list, normalize):
    opt, sched = make_optimizer(list(params), LR, decay_steps=DECAY)
    for grads in grads_list:
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        if normalize:
            normalize_grads_(params)
        opt.step()
        sched.step()
    return opt, sched


def _jax_updates(jp, grads_list, normalize):
    tx = jax_optimizer(LR, decay_steps=DECAY, grad_norm=normalize)
    state = tx.init(jp)
    for grads in grads_list:
        g = type(jp)(*(jnp.asarray(a) for a in grads))
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
    return tx, state, jp


def _adam_of(state, normalize):
    return state[1][0] if normalize else state[0][0]


@pytest.mark.parametrize("normalize", [True, False])
def test_port_checkpoint_reads_in_jax(tmp_path, normalize):
    jcfg, cfg = _cfg_pair()
    jp = jax_init(jax.random.key(0), jcfg)
    params = [p.clone().requires_grad_(True) for p in
              params_from_jax_numpy(*(np.asarray(a) for a in jp),
                                    device="cpu")]
    shapes = [tuple(p.shape) for p in params]
    opt, _ = _port_updates(params, [_grads(shapes, s) for s in range(3)],
                           normalize)
    tree = TC.optax_state_tree(opt, MLPParams(*params), normalize)
    path = str(tmp_path / "ck")
    TC.save_checkpoint(path, params=MLPParams(*params), model_cfg=cfg, h=0.3,
                       step=3, loss=0.25, opt_state=tree,
                       train_cfg=TrainConfig(normalize_grads=normalize),
                       seed_x=np.zeros((5, 2), np.float32),
                       extra_meta={"mode": "texture"})
    ck = JC.load_checkpoint(path)
    for g, w in zip(params, ck["params"]):
        np.testing.assert_array_equal(np.asarray(w), g.detach().numpy())
    assert ck["model_cfg"] == jcfg
    assert (ck["h"], ck["step"], ck["loss"]) == (0.3, 3, 0.25)
    assert ck["meta"]["extra"]["mode"] == "texture"
    assert ck["meta"]["train_cfg"]["normalize_grads"] is normalize
    assert ck["seed_A"] is None and ck["seed_x"].shape == (5, 2)
    tx = jax_optimizer(LR, decay_steps=DECAY, grad_norm=normalize)
    adam = _adam_of(JC.restore_opt_state(tx.init(ck["params"]),
                                         ck["opt_state"]), normalize)
    assert int(adam.count) == 3
    for k, p in zip(MLPParams._fields, params):
        st = opt.state[p]
        np.testing.assert_array_equal(np.asarray(getattr(adam.mu, k)),
                                      st["exp_avg"].numpy())
        np.testing.assert_array_equal(np.asarray(getattr(adam.nu, k)),
                                      st["exp_avg_sq"].numpy())


@pytest.mark.parametrize("normalize", [True, False])
def test_jax_checkpoint_reads_in_port(tmp_path, normalize):
    """A JAX checkpoint after 3 updates: the port's Adam gets its moments,
    count and schedule position, and a fourth update from there agrees
    with the JAX optimizer's."""
    jcfg, cfg = _cfg_pair()
    jp0 = jax_init(jax.random.key(1), jcfg)
    shapes = [a.shape for a in jp0]
    tx, state, jp = _jax_updates(jp0, [_grads(shapes, s) for s in range(3)],
                                 normalize)
    path = str(tmp_path / "ck")
    JC.save_checkpoint(path, params=jp, model_cfg=jcfg, h=0.2, step=3,
                       opt_state=state, extra_meta={"mode": "image"})
    ck = TC.load_checkpoint(path, device="cpu")
    assert ck["model_cfg"] == cfg and (ck["h"], ck["step"]) == (0.2, 3)
    params = [p.clone().requires_grad_(True) for p in ck["params"]]
    opt, sched = make_optimizer(params, LR, decay_steps=DECAY)
    count = TC.load_optax_state(opt, MLPParams(*params), ck["opt_state"])
    set_schedule_position(sched, count)
    adam = _adam_of(state, normalize)
    for k, p in zip(MLPParams._fields, params):
        st = opt.state[p]
        assert float(st["step"]) == 3.0
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      np.asarray(getattr(adam.mu, k)))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      np.asarray(getattr(adam.nu, k)))
    want_lr = float(optax.linear_schedule(LR, LR * 0.1, DECAY)(3))
    np.testing.assert_allclose(opt.param_groups[0]["lr"], want_lr, rtol=1e-6)
    # a fourth update in both
    g4 = _grads(shapes, 9)
    _, _, jp4 = _jax_updates_from(tx, state, jp, g4)
    for p, g in zip(params, g4):
        p.grad = torch.from_numpy(g.copy())
    if normalize:
        normalize_grads_(params)
    opt.step()
    for p, w in zip(params, jp4):
        w = np.asarray(w)
        gap = np.abs(p.detach().numpy() - w).max() / np.abs(w).max()
        assert gap <= UPDATE_RTOL


def _jax_updates_from(tx, state, jp, grads):
    g = type(jp)(*(jnp.asarray(a) for a in grads))
    updates, state = tx.update(g, state, jp)
    return tx, state, optax.apply_updates(jp, updates)


def test_checkpoint_refuses_mismatched_arrays(tmp_path):
    jcfg, cfg = _cfg_pair()
    jp = jax_init(jax.random.key(2), jcfg)
    path = str(tmp_path / "ck")
    JC.save_checkpoint(path, params=jp, model_cfg=jcfg, h=0.2, step=0)
    meta = json.load(open(os.path.join(path, "meta.json")))
    meta["model_cfg"]["hidden"] = 16
    json.dump(meta, open(os.path.join(path, "meta.json"), "w"))
    with pytest.raises(ValueError, match="w1 has shape"):
        TC.load_checkpoint(path, device="cpu")
    params = [torch.zeros(s, requires_grad=True) for s in
              ((12, 8), (8,), (8, 9), (9,))]
    opt, _ = make_optimizer(params)
    tree = TC.optax_state_tree(opt, MLPParams(*params), True)
    tree["1"]["0"]["mu"]["w1"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="moments"):
        TC.load_optax_state(opt, MLPParams(*params), tree)
    with pytest.raises(ValueError, match="not an optax Adam chain"):
        TC.load_optax_state(opt, MLPParams(*params), {"2": {}})


def test_assets_are_the_run_checkpoints():
    for asset, run in (("ot_gabor_dotted_800",
                        "runs/ot_gabor_dotted/sphnca-08181219-0800"),
                       ("gecko_full_8000",
                        "runs/gecko_full/sphnca-08162133-8000")):
        for name in ("meta.json", "checkpoint.msgpack"):
            with open(os.path.join(ASSETS, asset, name), "rb") as a, \
                    open(os.path.join(ROOT, run, name), "rb") as r:
                assert a.read() == r.read(), (asset, name)


def test_find_latest_resumable(tmp_path):
    assert TC.find_latest_resumable(str(tmp_path / "none")) is None
    for step, sidecar in ((2, True), (5, True), (9, False)):
        d = tmp_path / f"ck{step}"
        d.mkdir()
        (d / "meta.json").write_text(json.dumps({"step": step}))
        if sidecar:
            (d / "resume.npz").write_bytes(b"")
    (tmp_path / "broken").mkdir()
    (tmp_path / "broken" / "resume.npz").write_bytes(b"")
    assert TC.find_latest_resumable(str(tmp_path)) == str(tmp_path / "ck5")


# ---- resume through the train CLI ---------------------------------------------


@pytest.fixture
def one_thread():
    """The CLI runs below on one intra-op thread: the suite runs several
    worker processes at once, and torch's thread pools oversubscribed the
    cores (a 7 s test took minutes); one thread costs ~15% alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TEXTURE_ARGV = [
    "--device", "cpu", "--loss", "ot", "--wrap", "true", "--use_alpha",
    "false", "--initial_feature", "random", "--img",
    os.path.join(ASSETS, "dotted_synth_64.npy"), "--image_size", "36",
    "--h", "0.15", "--batch_size", "2", "--pool_size", "4", "--steps_range",
    "2,4", "--steps_increment", "1", "--hidden", "16", "--log_every", "100",
    "--checkpoint_every", "3"]


def _metrics(out):
    rows = []
    for path in sorted(glob.glob(str(out / "metrics-*.jsonl"))):
        with open(path) as f:
            rows += [json.loads(line) for line in f]
    return [(r["iter"], r["loss"], r["steps"]) for r in rows]


def _final_params(out, step):
    (ck,) = glob.glob(str(out / f"sphnca-*-{step:04d}"))
    return TC.load_checkpoint(ck, device="cpu")


def test_resume_is_exact(tmp_path, one_thread):
    """At image side 36 the finest Gabor set has 1296 rows, so the OT loss
    subsamples it: the loss generator's state is part of what resumes."""
    a, b = tmp_path / "straight", tmp_path / "resumed"
    assert cli_train.main(TEXTURE_ARGV + ["--training_iter", "6",
                                          "--output_dir", str(a)]) == 0
    assert cli_train.main(TEXTURE_ARGV + ["--training_iter", "3",
                                          "--output_dir", str(b)]) == 0
    assert cli_train.main(TEXTURE_ARGV + ["--training_iter", "6", "--resume",
                                          "auto", "--output_dir",
                                          str(b)]) == 0
    want, got = _metrics(a), _metrics(b)
    assert [r[0] for r in got] == list(range(6)) and got == want
    ca, cb = _final_params(a, 6), _final_params(b, 6)
    for g, w in zip(cb["params"], ca["params"]):
        assert torch.equal(g, w)
    _same_tree(cb["opt_state"], ca["opt_state"])
    # one sidecar is kept: the latest checkpoint's
    (sidecar,) = glob.glob(str(b / "*" / "resume.npz"))
    assert os.path.dirname(sidecar).endswith("-0006")
    assert ca["meta"]["extra"]["mode"] == "texture"
    assert os.path.exists(str(glob.glob(str(a / "sphnca-*-0006"))[0])
                          + ".json")


def test_resume_from_jax_sidecar_is_soft(tmp_path, capsys, one_thread):
    """A checkpoint whose sidecar holds a JAX key: params, Adam state and
    step come back; the pool and streams start afresh, and the CLI says so."""
    out = tmp_path / "run"
    assert cli_train.main(TEXTURE_ARGV + ["--training_iter", "3",
                                          "--output_dir", str(out)]) == 0
    (ck,) = glob.glob(str(out / "sphnca-*-0003"))
    port_sidecar = TC.load_resume_state(ck)
    assert port_sidecar["port"] and set(port_sidecar["torch_rng"]) == {
        "fire", "loss"}
    JC.save_resume_state(ck, pool_A=port_sidecar["pool_A"],
                         key_data=np.asarray(jax.random.key_data(
                             jax.random.key(0))),
                         np_rng_state=port_sidecar["np_rng"],
                         pool_rng_state=port_sidecar["pool_rng"])
    jax_sidecar = TC.load_resume_state(ck)
    assert not jax_sidecar["port"] and "key_data" in jax_sidecar
    capsys.readouterr()
    assert cli_train.main(TEXTURE_ARGV + ["--training_iter", "4", "--resume",
                                          "auto", "--output_dir",
                                          str(out)]) == 0
    text = capsys.readouterr().out
    assert "JAX package's" in text and "soft resume" in text
    rows = _metrics(out)
    assert [r[0] for r in rows] == [0, 1, 2, 3]
    # the soft resume keeps the checkpoint's sidecar
    assert os.path.exists(os.path.join(ck, "resume.npz"))

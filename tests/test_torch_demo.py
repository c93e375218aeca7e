"""The port's demo server (sph_nca_tpu_torch/demo) against the JAX package's
on the CPU.

Both servers load the same weights JSON, written by the JAX package's
``save_weights_json`` with fire_rate 1.0 in its config: the two draw fire
masks from different streams, so they agree only when every particle fires.
The JAX server steps its numpy engine, the port's server the band engine
(float32 tables); after 4 steps the states agree within rtol 1e-3 / atol
1e-4 (the bar of tests/test_demo_engine.py) and the frames' bytes within one
level. Sizes stay at 12-16 (at most 256 particles): the numpy engine loops
in Python. Texture cases use h = 0.25, where 2 / h is whole, so the numpy
engine's modulo grid tiles the period.
"""

import json
import struct
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import jax
import pytest
import torch

from sph_nca_tpu.demo import engine as JE
from sph_nca_tpu.demo import server as JS
from sph_nca_tpu.io import save_weights_json
from sph_nca_tpu.models import SPHNCAConfig, init_params
from sph_nca_tpu_torch.demo import engine as TE
from sph_nca_tpu_torch.demo import server as TS

STATE_RTOL, STATE_ATOL = 1e-3, 1e-4
FRAME_LEVELS = 1
STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one intra-op thread: the tier-1 run's workers share the
    cores, and torch's own pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_weights(path, seed, h, mode, channels=8, hidden=16):
    """Random weights whose gated update pushes alpha up (a positive bias
    on its delta and on the update's multiplier), so the alive region lives
    and spreads instead of dying out."""
    cfg = SPHNCAConfig(channels=channels, hidden=hidden, fire_rate=1.0,
                       normalize_perception=1.0 / h)
    params = init_params(jax.random.key(seed), cfg)
    b2 = params.b2.at[channels + 3].set(2.0).at[-1].set(1.0)
    save_weights_json(str(path), params._replace(b2=b2), cfg, h=h, mode=mode)
    return str(path)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Three weights files in one directory: two image models (the second
    the /config target) and a texture model."""
    d = tmp_path_factory.mktemp("weights")
    return {"image": _write_weights(d / "a.json", 0, 0.3, "image"),
            "other": _write_weights(d / "b.json", 1, 0.3, "image"),
            "texture": _write_weights(d / "tex.json", 2, 0.25, "texture")}


def _args(wpath, size=12, jitter=0.0, pattern="square",
          spatial_jitter=False, color_mode="rgba", device=None):
    class Args:
        pass

    a = Args()
    a.weights_json, a.size, a.jitter = wpath, size, jitter
    a.pattern, a.spatial_jitter, a.color_mode = pattern, spatial_jitter, \
        color_mode
    if device is not None:
        a.device = device
    return a


def _pair(wpath, **kw):
    return JS.DemoState(_args(wpath, **kw)), TS.DemoState(
        _args(wpath, device="cpu", **kw))


def _hold_states(j, t):
    np.testing.assert_allclose(t.A, j.A, rtol=STATE_RTOL, atol=STATE_ATOL)


def _hold_frames(j, t):
    a = np.frombuffer(j.frame(), np.uint8).astype(np.int16)
    b = np.frombuffer(t.frame(), np.uint8).astype(np.int16)
    assert a.shape == b.shape == (j.size * j.size * 4,)
    assert int(np.abs(a - b).max()) <= FRAME_LEVELS


CASES = {
    "square": dict(kind="image", size=12),
    "hex": dict(kind="image", size=14, pattern="hex"),
    "jitter": dict(kind="image", size=12, jitter=0.3),
    "spatial_jitter": dict(kind="image", size=14, pattern="hex", jitter=0.4,
                           spatial_jitter=True),
    "texture": dict(kind="texture", size=12, jitter=0.3,
                    spatial_jitter=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_states_and_frames_match_jax(weights, case):
    kw = dict(CASES[case])
    j, t = _pair(weights[kw.pop("kind")], **kw)
    np.testing.assert_array_equal(t.x, j.x)
    assert t.mode == j.mode and t.size == j.size
    _hold_states(j, t)
    for _ in range(STEPS):
        j.step()
        t.step()
    assert t.step_count == j.step_count == STEPS
    assert (j.A[:, 3] > 0.1).mean() > 0.05  # the model lives
    _hold_states(j, t)
    _hold_frames(j, t)
    for s in (j, t):
        s.reconfigure(color_mode="activity")
    _hold_frames(j, t)


@pytest.mark.parametrize("kind", ["damage", "seed"])
def test_brushes_match_jax(weights, kind):
    j, t = _pair(weights["image"], size=14, pattern="hex", jitter=0.2)
    for s in (j, t):
        s.step()
        s.brush(0.1, -0.2, 0.5, kind)
    _hold_states(j, t)
    for s in (j, t):
        s.step()
        s.step()
    _hold_states(j, t)
    _hold_frames(j, t)


def test_reset_and_config_match_jax(weights):
    j, t = _pair(weights["image"], size=12)
    for s in (j, t):
        s.step()
        s.reset()
        assert s.step_count == 0
    _hold_states(j, t)
    for s in (j, t):
        s.reconfigure(pattern="hex", weights="b", size=16, jitter=0.3)
    assert t.current == j.current
    assert t.x.shape == j.x.shape
    for s in (j, t):
        s.step()
        s.step()
    _hold_states(j, t)
    _hold_frames(j, t)
    engine = t.engine
    t.reconfigure(color_mode="activity")  # render-only: no rebuild
    assert t.engine is engine
    with pytest.raises(ValueError, match="color_mode"):
        t.reconfigure(color_mode="nope")
    with pytest.raises(ValueError, match="unknown weights"):
        t.reconfigure(weights="nope")
    assert t.engine is engine and t.current["weights"] == "b"


def test_numpy_engine_copy_steps_bit_equal(weights):
    """The port's copy of the numpy engine steps exactly as the JAX
    package's, at fire_rate 0.5 too (both seed default_rng(0))."""
    x = TS.demo_points(12, "hex", 0.3, True)
    data = json.load(open(weights["image"]))
    layers = sorted(data["layers"], key=lambda l: l["index"])
    w = {"w1": np.asarray(layers[0]["weight"], np.float32).T,
         "b1": np.asarray(layers[0]["bias"], np.float32),
         "w2": np.asarray(layers[1]["weight"], np.float32).T,
         "b2": np.asarray(layers[1]["bias"], np.float32)}
    kw = dict(h=0.3, fire_rate=0.5, channels=8, normalize_perception=1 / 0.3)
    je, te = JE.NumpyEngine(x, w, **kw), TE.NumpyEngine(x, w, **kw)
    A = TS.demo_seed(x, 8, 0.3, "image")
    a, b = A.copy(), A.copy()
    for _ in range(3):
        a, b = je.step(a), te.step(b)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(je.rgba(a), te.rgba(b))


# ---- HTTP, as tests/test_demo_server.py drives the JAX server ---------------


@pytest.fixture
def server(weights):
    state = TS.DemoState(_args(weights["image"], device="cpu"))
    srv = ThreadingHTTPServer(("127.0.0.1", 0), TS.make_handler(state))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", state
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


def _frame(body):
    mlen = struct.unpack("<I", body[:4])[0]
    return json.loads(body[4:4 + mlen]), np.frombuffer(body[4 + mlen:],
                                                       np.uint8)


def test_http_frame_index_info_brush_reset(server):
    base, state = server
    meta, px = _frame(_get(base + "/frame"))
    assert meta == {"size": 12, "step": 1}
    assert px.shape == (12 * 12 * 4,)
    assert bytes(px) == state.frame()  # the same renderer
    assert _frame(_get(base + "/frame"))[0]["step"] == 2
    assert "<canvas" in _get(base + "/").decode()
    info = json.loads(_get(base + "/info"))
    assert info["current"]["size"] == 12
    assert info["weights"] == ["a", "b", "tex"]
    assert info["n_particles"] == 144 and info["device"] == "cpu"
    assert info["table_bytes"] > 0 and info["build_seconds"] >= 0
    _post(base + "/brush", {"x": 0.0, "y": 0.0, "kind": "damage",
                            "radius": 5.0})
    assert np.all(state.A == 0.0)  # radius 5 wipes the whole domain
    _get(base + "/reset")
    assert state.step_count == 0 and not np.allclose(state.A, 0.0)


def test_http_config_and_refusals(server):
    base, state = server
    _post(base + "/config", {"size": 16, "pattern": "hex", "jitter": 0.3})
    info = json.loads(_get(base + "/info"))
    assert info["current"]["pattern"] == "hex"
    assert info["n_particles"] == state.x.shape[0] != 144
    meta, px = _frame(_get(base + "/frame"))
    assert meta == {"size": 16, "step": 1} and px.shape == (16 * 16 * 4,)
    for bad in ({"weights": "nope"}, {"color_mode": "nope"}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/config", bad)
        assert e.value.code == 400
    assert json.loads(_get(base + "/info"))["current"] == info["current"]


def test_record_writes_a_png_strip(weights, tmp_path):
    state = TS.DemoState(_args(weights["texture"], device="cpu"))
    out = tmp_path / "strip.png"
    TS.record(state, str(out), steps=4, frames=3)
    raw = out.read_bytes()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n" and raw[12:16] == b"IHDR"
    assert struct.unpack(">II", raw[16:24]) == (3 * 12, 12)
    assert state.step_count == 4

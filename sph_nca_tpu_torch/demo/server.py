"""Interactive SPH-NCA demo server on the card (stdlib HTTP).

Counterpart of ``sph_nca_tpu/demo/server.py``: loads a weights JSON, steps
the model, streams RGBA frames to a canvas page (``static/index.html``) and
applies click-to-damage / click-to-seed brushes. The JAX package's server
steps its numpy engine; this one steps the port's band engine on the card:

  * each build makes a float32 ``build_band_engine`` over the demo's 2-D
    points (square or hexagonal lattice, uniform or spatially growing
    jitter; periodic with period 2 in texture mode) with the smoothing the
    JSON names;
  * the state stays on the card in the engine's rank layout between
    requests: scattered once at ``reset``, gathered back only to render a
    frame or to apply a brush;
  * a ``/frame`` request is one step of the batched band step at B = 1
    (``models.cell_step.rollout_cells_batched``, the test CLI's ``--engine
    band`` path; its update MLP is kernel 2.8), the fire draws from one
    device ``torch.Generator`` seeded with 0 at each build (as the numpy
    engine seeds its rng) and not at ``reset``;
  * a frame's RGBA values are read back, clipped and converted to bytes on
    the host, and hexagonal lattices are splatted there too (numpy's
    last-write-wins indexing, so the bytes equal the JAX server's for equal
    states);
  * ``/config`` builds the new engine outside the lock, then swaps the
    engine and the state under it: a request never steps a half-built
    engine, and a failed build leaves the running one as it was.

Every touch of the state or the engine goes under one lock: the HTTP
server's handler threads all call into CUDA. Without a card the server
raises unless ``--device cpu`` is given; it never steps the numpy engine
in the card's place.

Run:
    python -m sph_nca_tpu_torch.demo.server \\
        --weights_json sph_nca_tpu/demo/web/weights/gecko.json --size 256
then open http://localhost:8000/. Headless, a PNG strip of evenly spaced
frames (``--record strip.png``; ``--record_steps``, ``--record_frames``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .. import resolve_device
from ..io.weights_json import load_weights_json
from ..models.cell_step import rollout_cells_batched
from ..ops.bands import build_band_engine

STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "static")

SIZE_RANGE = (16, 256)
SETTINGS = ("weights", "size", "pattern", "jitter", "spatial_jitter",
            "color_mode")


def demo_points(size: int, pattern: str, jitter: float,
                spatial_jitter: bool) -> np.ndarray:
    """The demo's particle positions [N, 2] float32 (the JAX server's
    patterns, from the reference's inference worker): a square lattice of
    size x size, or hexagonal rows at spacing * sqrt(3) / 2 with odd rows
    offset by half a spacing and one point short; uniform jitter of
    ``jitter`` spacings drawn from default_rng(0), growing across the domain
    with ``spatial_jitter``."""
    spacing = 2.0 / size
    if pattern == "hex":
        vs = spacing * np.sqrt(3.0) / 2.0
        ny = int(np.ceil(2.0 / vs))
        pts = []
        for j in range(ny):
            row_off = spacing / 2.0 if j % 2 else 0.0
            nx = size - 1 if j % 2 else size
            xs = -1.0 + row_off + (np.arange(nx) + 0.5) * spacing
            ys = np.full(nx, -1.0 + (j + 0.5) * vs)
            pts.append(np.stack([xs, ys], -1))
        x = np.concatenate(pts).astype(np.float32)
        x = x[(x[:, 1] >= -1.0) & (x[:, 1] <= 1.0)]
    else:
        lin = (np.arange(size) + 0.5) / size * 2.0 - 1.0
        gx, gy = np.meshgrid(lin, lin, indexing="ij")
        x = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    if jitter > 0:
        rng = np.random.default_rng(0)
        noise = rng.uniform(-jitter, jitter, x.shape)
        if spatial_jitter:
            fac = 0.5 * ((x[:, 0] + 1.0) / 2.0 + (x[:, 1] + 1.0) / 2.0)
            noise = noise * fac[:, None]
        x = x + noise.astype(np.float32) * spacing
    return x


def demo_seed(x: np.ndarray, channels: int, h: float,
              mode: str) -> np.ndarray:
    """The demo's initial state [N, C] float32: in image mode
    clip(1 - d^2 / h^2, 0, 1)^3 on every channel around the origin; in
    texture mode uniform noise from default_rng(0)."""
    n = x.shape[0]
    if mode == "image":
        A = np.zeros((n, channels), np.float32)
        d2 = np.sum(x**2, -1)
        w = np.clip(1.0 - d2 / h**2, 0, 1) ** 3
        A += w[:, None]
        return A
    return np.random.default_rng(0).random((n, channels), dtype=np.float32)


@dataclasses.dataclass
class Built:
    """One build of the demo's engine and its constants."""

    settings: dict
    x: np.ndarray  # [N, 2] float32 positions (host)
    engine: object  # BandEngine on the device
    params: tuple
    cfg: object
    h: float
    mode: str
    size: int
    seconds: float  # host seconds of the build (engine and model)
    table_bytes: int


class DemoState:
    """The simulation loop state shared with the HTTP handlers."""

    def __init__(self, args):
        self.device = resolve_device(getattr(args, "device", "cuda"))
        self.lock = threading.Lock()
        # available weight files: the given file, or every *.json next to
        # it (the reference UI's weights selector)
        wpath = args.weights_json
        wdir = os.path.dirname(os.path.abspath(wpath))
        self.weights_files = {
            os.path.splitext(f)[0]: os.path.join(wdir, f)
            for f in sorted(os.listdir(wdir))
            if f.endswith(".json")
        }
        self.current = dict(
            weights=os.path.splitext(os.path.basename(wpath))[0],
            size=args.size,
            pattern=getattr(args, "pattern", "square"),
            jitter=args.jitter,
            spatial_jitter=bool(getattr(args, "spatial_jitter", False)),
            color_mode=getattr(args, "color_mode", "rgba"),
        )
        self._install(self._build(self.current))

    # -- building and swapping ---------------------------------------------

    def _build(self, settings: dict) -> Built:
        """A new engine for ``settings`` (outside the lock)."""
        path = self.weights_files.get(settings["weights"])
        if path is None:
            raise ValueError(f"unknown weights {settings['weights']!r}")
        t0 = time.time()
        model = load_weights_json(path, device=self.device)
        mode = model.mode
        cfg = dataclasses.replace(model.cfg, use_alpha=mode == "image")
        size = int(settings["size"])
        x = demo_points(size, settings["pattern"], float(settings["jitter"]),
                        bool(settings["spatial_jitter"]))
        eng = build_band_engine(
            x, model.h, period=None if mode == "image" else [2.0, 2.0],
            table_dtype="float32", smoothing=cfg.smoothing,
            device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return Built(settings=dict(settings), x=x, engine=eng,
                     params=model.params, cfg=cfg, h=model.h, mode=mode,
                     size=size, seconds=time.time() - t0,
                     table_bytes=sum(eng.table_bytes()))

    def _install(self, b: Built) -> None:
        """Swap in a build: its engine, a generator seeded with 0 and the
        seed state."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        S = self._scatter(b, demo_seed(b.x, b.cfg.channels, b.h, b.mode))
        with self.lock:
            self.built, self.gen, self.S = b, gen, S
            self.current = dict(b.settings)
            self.step_count = 0

    def _scatter(self, b: Built, A: np.ndarray) -> torch.Tensor:
        """Host state [N, C] -> the engine's rank layout on the device."""
        return b.engine.scatter(torch.from_numpy(A).to(self.device))

    def reconfigure(self, **kw):
        """Rebuild the engine with changed settings (the reference UI's
        weights / resolution / pattern / noise selectors); ``color_mode``
        alone changes only the rendering."""
        with self.lock:
            new = dict(self.current)
        for k, v in kw.items():
            if k in SETTINGS and v is not None:
                if k == "size":
                    v = max(SIZE_RANGE[0], min(SIZE_RANGE[1], int(v)))
                if k == "jitter":
                    v = max(0.0, min(1.0, float(v)))
                if k == "color_mode" and v not in ("rgba", "activity"):
                    raise ValueError(f"unknown color_mode {v!r}")
                new[k] = v
        if set(kw) == {"color_mode"}:
            with self.lock:
                self.current["color_mode"] = new["color_mode"]
            return
        self._install(self._build(new))

    # -- the loop ----------------------------------------------------------

    @property
    def mode(self) -> str:
        return self.built.mode

    @property
    def size(self) -> int:
        return self.built.size

    @property
    def x(self) -> np.ndarray:
        return self.built.x

    @property
    def engine(self):
        return self.built.engine

    @property
    def A(self) -> np.ndarray:
        """The state [N, C] in particle order, on the host."""
        with self.lock:
            return self.built.engine.gather_back(self.S).cpu().numpy()

    def reset(self):
        with self.lock:
            b = self.built
            self.S = self._scatter(b, demo_seed(b.x, b.cfg.channels, b.h,
                                                b.mode))
            self.step_count = 0

    def step(self):
        with self.lock, torch.no_grad():
            b = self.built
            self.S = rollout_cells_batched(b.params, b.cfg, b.engine, self.S,
                                           1, self.gen, 1, b.h)
            self.step_count += 1

    def frame(self) -> bytes:
        with self.lock, torch.no_grad():
            b = self.built
            A = b.engine.gather_back(self.S)
            act = A[:, 3:4] if b.cfg.use_alpha else torch.ones_like(A[:, :1])
            rgba = torch.cat([A[:, :3], act], -1).cpu().numpy()
            color_mode = self.current.get("color_mode")
        rgba = np.clip(rgba, 0.0, 1.0)
        if color_mode == "activity":
            # grayscale of the activity channel (reference main.js:593)
            act = rgba[:, 3:4] if b.mode == "image" else \
                np.ones_like(rgba[:, :1])
            rgba = np.concatenate(
                [act, act, act, np.ones_like(act)], axis=-1
            )
        if rgba.shape[0] == b.size * b.size:
            img = rgba.reshape(b.size, b.size, 4)
        else:
            # non-square lattices (hex): splat points onto the canvas, the
            # last point of a pixel winning
            ij = np.clip(
                ((b.x + 1.0) / 2.0 * b.size).astype(np.int64),
                0, b.size - 1,
            )
            img = np.zeros((b.size, b.size, 4), np.float32)
            img[ij[:, 0], ij[:, 1]] = rgba
        if b.mode != "image":
            img[..., 3] = 1.0
        return (img * 255).astype(np.uint8).tobytes()

    def brush(self, cx: float, cy: float, radius: float, kind: str):
        """Click interaction (reference inference-worker.js:318-336): zero
        the state within ``radius`` ("damage") or add a cubic bump
        ("seed"), on the host state gathered back, then scattered again."""
        with self.lock:
            b = self.built
            d2 = np.sum((b.x - np.asarray([cx, cy], np.float32)) ** 2, -1)
            mask = d2 < radius * radius
            A = b.engine.gather_back(self.S).cpu().numpy()
            if kind == "damage":
                A[mask] = 0.0
            else:  # seed
                w = np.clip(1.0 - d2[mask] / radius**2, 0, 1) ** 3
                A[mask] += w[:, None]
            self.S = self._scatter(b, A)

    def info(self) -> dict:
        with self.lock:
            return {
                "current": dict(self.current),
                "mode": self.built.mode,
                "n_particles": int(self.built.x.shape[0]),
                "weights": sorted(self.weights_files),
                "device": str(self.device),
                "build_seconds": self.built.seconds,
                "table_bytes": self.built.table_bytes,
            }


def make_handler(state: DemoState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                with open(os.path.join(STATIC_DIR, "index.html"), "rb") as f:
                    self._send(200, f.read(), "text/html")
            elif self.path.startswith("/frame"):
                state.step()
                meta = json.dumps(
                    {"size": state.size, "step": state.step_count}
                ).encode()
                body = (
                    len(meta).to_bytes(4, "little") + meta + state.frame()
                )
                self._send(200, body, "application/octet-stream")
            elif self.path.startswith("/reset"):
                state.reset()
                self._send(200, b"{}")
            elif self.path.startswith("/info"):
                self._send(200, json.dumps(state.info()).encode())
            else:
                self._send(404, b"{}")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n)) if n else {}
            if self.path.startswith("/brush"):
                state.brush(
                    float(req["x"]), float(req["y"]),
                    float(req.get("radius", 0.15)),
                    req.get("kind", "damage"),
                )
                self._send(200, b"{}")
            elif self.path.startswith("/config"):
                try:
                    state.reconfigure(**req)
                    self._send(200, b"{}")
                except (ValueError, KeyError) as e:
                    self._send(400, json.dumps(
                        {"error": str(e)}).encode())
            else:
                self._send(404, b"{}")

    return Handler


def record(state: DemoState, path: str, steps: int, frames: int) -> None:
    """Headless recording: step the engine and write a horizontal PNG strip
    of evenly spaced frames, rendered by the same ``frame()`` the canvas
    page streams."""
    from ..utils.image import save_frame_png

    at = set(
        int(round(i * steps / max(1, frames - 1)))
        for i in range(frames)
    )
    panels = []

    def grab():
        raw = np.frombuffer(state.frame(), np.uint8)
        panels.append(
            raw.reshape(state.size, state.size, 4).astype(np.float32)
            / 255.0
        )

    if 0 in at:
        grab()
    for t in range(1, steps + 1):
        state.step()
        if t in at:
            grab()
    strip = np.concatenate(panels, axis=1)
    save_frame_png(path, strip)
    print(f"recorded {len(panels)} frames x {steps} steps -> {path}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--weights_json", required=True)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--jitter", type=float, default=0.0)
    p.add_argument(
        "--pattern", choices=["square", "hex"], default="square",
        help="point lattice (reference pointPattern square/hexagonal)",
    )
    p.add_argument(
        "--spatial_jitter", action="store_true",
        help="jitter amplitude grows across the domain "
             "(reference spatiallyVaryingNoise)",
    )
    p.add_argument("--port", type=int, default=8000)
    p.add_argument(
        "--color_mode", choices=["rgba", "activity"], default="rgba",
        help="render mode (reference main.js colorMode)",
    )
    p.add_argument(
        "--record", type=str, default="",
        help="headless mode: run --record_steps steps and write a PNG "
             "strip of --record_frames evenly-spaced frames to this "
             "path, then exit (no browser needed)",
    )
    p.add_argument("--record_steps", type=int, default=96)
    p.add_argument("--record_frames", type=int, default=6)
    p.add_argument("--device", default="cuda",
                   help="torch device to step on ('cpu' runs the plain "
                        "PyTorch path)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = DemoState(args)
    if args.record:
        record(state, args.record, args.record_steps, args.record_frames)
        return
    server = ThreadingHTTPServer(("127.0.0.1", args.port), make_handler(state))
    print(f"demo at http://127.0.0.1:{args.port}/ ({state.mode} mode, "
          f"{state.size}x{state.size}, {device})")
    server.serve_forever()


if __name__ == "__main__":
    main()

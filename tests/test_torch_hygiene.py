"""Rules of the port that no parity test sees:

* nothing in sph_nca_tpu_torch/ or chip_smoke.py imports JAX, flax, the
  msgpack package or the JAX package (the GPU machine has none of them);
* the kernels are built with plain nvcc, never through
  torch.utils.cpp_extension or against torch/extension.h;
* entry points run on the card unless asked for the CPU, and raise when no
  card is present instead of falling back.
"""

import ast
import os
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "sph_nca_tpu_torch"
GECKO = ROOT / "sph_nca_tpu" / "demo" / "web" / "weights" / "gecko.json"


def _port_files():
    # the card-side tests run where there is no JAX, too, and the sharded
    # tests' ranks import their helper module without it
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
        ROOT / "tests" / "torch_parallel_ranks.py"]
    assert len(files) > 10
    return files


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_imports_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax", "msgpack",
                           "ml_dtypes", "sph_nca_tpu"), (
            f"{path.relative_to(ROOT)} imports {mod}")


def test_port_imports_pil_only_inside_functions():
    """The card's machine has no PIL: only reading an image file needs it."""
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in tree.body:
            names = []
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            assert not any(n.split(".")[0] == "PIL" for n in names), path


def test_kernels_built_without_torch_headers():
    sources = list(PORT.rglob("*.py")) + list(PORT.rglob("*.cu")) + [
        ROOT / "chip_smoke.py"]
    for path in sources:
        text = path.read_text()
        assert "cpp_extension" not in text, path
        assert "torch/extension.h" not in text, path


SUBPACKAGES = ("ops", "models", "training", "utils", "io", "parallel",
               "native", "demo", "cli")

# A fresh interpreter with no card imports one subpackage while every way of
# starting a compiler or loading a library raises.
_IMPORT_CHILD = """
import ctypes, importlib, subprocess, sys
import torch
torch.cuda.is_available = lambda: False
def refuse(*a, **k):
    raise AssertionError(f"started at import: {a[:1]!r}")
subprocess.Popen = subprocess.run = ctypes.CDLL = refuse
mod = importlib.import_module("sph_nca_tpu_torch." + sys.argv[1])
assert not {"jax", "sph_nca_tpu"} & set(sys.modules), sys.argv[1]
print("imported", mod.__name__, len(getattr(mod, "__all__", ())))
"""


def test_port_package_imports_without_card(no_card):
    import subprocess
    import sys

    import sph_nca_tpu_torch.cli.test  # noqa: F401
    import sph_nca_tpu_torch.models.cell_step  # noqa: F401
    import sph_nca_tpu_torch.ops._build  # noqa: F401
    import sph_nca_tpu_torch.ops.pair_kernel  # noqa: F401

    # every subpackage, each in a fresh process: import order must not
    # matter (io and training import each other's modules), and no kernel
    # or host-library build starts at import
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", _IMPORT_CHILD, name], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in SUBPACKAGES}
    for name, proc in procs.items():
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, out
        assert f"imported sph_nca_tpu_torch.{name}" in out
    import sph_nca_tpu_torch

    # the root imports ops, as the JAX package's root does
    assert sph_nca_tpu_torch.ops.__name__ == "sph_nca_tpu_torch.ops"


def test_batched_path_modules_import_without_card():
    """The batched-lane path's modules import no JAX and need no card."""
    import sph_nca_tpu_torch.ops.batched  # noqa: F401
    import sph_nca_tpu_torch.ops.mlp_kernel  # noqa: F401
    import sph_nca_tpu_torch.training.pool  # noqa: F401
    import sph_nca_tpu_torch.training.trainer  # noqa: F401

    names = {p.name for p in _port_files()}
    assert {"batched.py", "mlp_kernel.py", "pool.py"} <= names
    assert (PORT / "csrc" / "mlp_kernel.cu").exists()


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_card(no_card, tmp_path):
    from sph_nca_tpu_torch import resolve_device
    from sph_nca_tpu_torch.cli import test as cli_test
    from sph_nca_tpu_torch.io.convert import params_from_jax_numpy
    from sph_nca_tpu_torch.io.weights_json import load_weights_json
    from sph_nca_tpu_torch.ops.cells import build_cell_engine

    x = torch.rand(64, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_cell_engine(x, 0.25)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_weights_json(str(GECKO))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax_numpy(*(torch.zeros(s).numpy() for s in
                                ((48, 8), (8,), (8, 33), (33,))))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_test.main(["--weights_json", str(GECKO),
                       "--output_dir", str(tmp_path)])
    assert os.listdir(tmp_path) == []
    # asked for the CPU, they run
    assert resolve_device("cpu") == torch.device("cpu")
    assert build_cell_engine(x, 0.25, device="cpu").device.type == "cpu"


def test_train_entry_point_raises_without_card(no_card, tmp_path):
    from sph_nca_tpu_torch.cli import train as cli_train
    from sph_nca_tpu_torch.models.nca import SPHNCAConfig, init_params

    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(["--output_dir", str(tmp_path)])
    assert os.listdir(tmp_path) == []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(SPHNCAConfig(), torch.Generator())


def test_device_pool_raises_without_card(no_card):
    from sph_nca_tpu_torch.training.pool import DevicePool

    x = torch.rand(16, 2).numpy()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePool(x, x, 4)
    assert DevicePool(x, x, 4, device="cpu").A.device.type == "cpu"


def test_every_launcher_has_a_c_signature():
    """ctypes passes an undeclared argument as a 32-bit int, which cuts a
    pointer: every extern "C" launcher of csrc/ has its argtypes declared."""
    import re

    launchers = set()
    for src in (PORT / "csrc").glob("*.cu"):
        launchers |= set(re.findall(r'extern "C" int (\w+)\(',
                                    src.read_text()))
    assert {"sph_mlp_launch", "sph_mlp_fused_launch"} <= launchers
    assert len(launchers) == 9
    build = (PORT / "ops" / "_build.py").read_text()
    for name in launchers:
        assert f"lib.{name}.argtypes" in build, name
        assert f"lib.{name}.restype" in build, name


def test_build_is_keyed_by_source_hash():
    from sph_nca_tpu_torch.ops import _build

    path = _build.library_path()
    assert path.parent == PORT / "_build"
    assert path.name.startswith("libsph_nca_kernels_") and path.suffix == ".so"
    assert path == _build.library_path()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_non_poly6_models_are_refused(tmp_path):
    """The cell engine's pair kernels hard-wire the poly6 / spiky pair math:
    a Wendland model makes the test CLI exit on --engine cells before it
    builds anything, and build_cell_engine refuses other kernels, as the JAX
    package does, naming the band and graph engines' builders."""
    import json

    from sph_nca_tpu_torch.cli import test as cli_test
    from sph_nca_tpu_torch.ops.cells import build_cell_engine

    data = json.loads(GECKO.read_text())
    data["config"]["smoothing"] = "wendlandC2"
    weights = tmp_path / "gecko-wendland.json"
    weights.write_text(json.dumps(data))
    out = tmp_path / "out"
    out.mkdir()
    with pytest.raises(SystemExit, match="poly6"):
        cli_test.main(["--weights_json", str(weights), "--output_dir",
                       str(out), "--device", "cpu", "--image_size", "8",
                       "--steps", "1", "--engine", "cells"])
    assert os.listdir(out) == []
    x = torch.rand(64, 2)
    with pytest.raises(NotImplementedError, match="poly6/spiky only") as e:
        build_cell_engine(x, 0.25, smoothing="wendlandC2", device="cpu")
    # the message points to the ported engines that run other kernels
    assert "build_band_engine" in str(e.value)
    assert "build_graph" in str(e.value)
    with pytest.raises(NotImplementedError, match="poly6/spiky only"):
        build_cell_engine(x, 0.25, gradient_kernel="wendlandC2",
                          device="cpu")
    with pytest.raises(ValueError, match="pair_tables"):
        build_cell_engine(x, 0.25, pair_tables="float16", device="cpu")


def test_texture_entry_points_raise_without_card(no_card, tmp_path):
    """The eval CLI, checkpoint loading and the test CLI's --checkpoint run
    on the card by default, and raise when there is none."""
    from sph_nca_tpu_torch.cli import eval as cli_eval
    from sph_nca_tpu_torch.cli import test as cli_test
    from sph_nca_tpu_torch.io.checkpoint import load_checkpoint

    ck = str(PORT / "assets" / "gecko_full_8000")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(ck)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_eval.main(["--checkpoint", ck])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_test.main(["--checkpoint", ck, "--output_dir", str(tmp_path)])
    assert os.listdir(tmp_path) == []
    assert load_checkpoint(ck, device="cpu")["params"].w1.device.type == \
        "cpu"
    # the texture and CLIP losses' factories likewise, called without device
    from sph_nca_tpu_torch.training import clip_encoder, clip_text, features

    missing = str(tmp_path / "no-such-weights.npz")
    factories = [
        lambda: features.load_vgg19_features(missing),
        lambda: features.random_vgg19_features(0),
        lambda: features.gabor_texture_features(),
        lambda: features.get_texture_features(),
        lambda: clip_encoder.load_clip_encoder(missing),
        lambda: clip_encoder.random_clip_encoder(0),
        lambda: clip_encoder.get_clip_encoder(),
        lambda: clip_text.load_text_encoder(missing),
        lambda: clip_text.random_text_encoder(1),
        lambda: clip_text.get_text_features("a gecko"),
    ]
    for make in factories:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert features.gabor_texture_features(device="cpu").even.device.type \
        == "cpu"


def test_graph_entry_points_raise_without_card(no_card, tmp_path):
    """--engine graph runs on the card by default in both CLIs and raises
    without one; the graph build follows its positions' device."""
    from sph_nca_tpu_torch.cli import test as cli_test
    from sph_nca_tpu_torch.cli import train as cli_train
    from sph_nca_tpu_torch.ops.hashgrid import build_graph

    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_test.main(["--weights_json", str(GECKO), "--engine", "graph",
                       "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(["--engine", "graph", "--output_dir", str(tmp_path)])
    assert os.listdir(tmp_path) == []
    g = build_graph(torch.rand(64, 2), 0.3, 7, max_per_cell=16, k=16)
    assert g.idx.device.type == "cpu"


def test_no_jax_check_covers_the_parallel_package():
    parallel = {p.relative_to(PORT).as_posix() for p in _port_files()
                if p.is_relative_to(PORT / "parallel")}
    assert {"parallel/__init__.py", "parallel/mesh.py", "parallel/comm.py",
            "parallel/band_shard.py", "parallel/cell_shard.py",
            "parallel/shard.py", "parallel/dryrun.py"} <= parallel


def _raises(node) -> bool:
    return any(isinstance(n, ast.Raise) for n in ast.walk(node))


def test_comm_has_no_fallback_handler():
    """Every ``except`` in parallel/comm.py re-raises: a failed collective,
    rank or build never goes on over another backend or device."""
    tree = ast.parse((PORT / "parallel" / "comm.py").read_text())
    handlers = [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    assert handlers, "run_ranks reports its ranks' failures"
    for h in handlers:
        assert _raises(h), f"comm.py:{h.lineno} swallows an exception"
    # and nothing there picks a backend or device after a failure
    text = (PORT / "parallel" / "comm.py").read_text()
    assert "fallback" not in text.lower()


def test_demo_server_raises_without_card(no_card, tmp_path):
    """The demo server steps the card by default: without one it raises,
    in its CLI (headless --record too) and in DemoState, and never steps
    the numpy engine in the card's place."""
    from sph_nca_tpu_torch.demo import server

    strip = tmp_path / "strip.png"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.main(["--weights_json", str(GECKO), "--record", str(strip),
                     "--size", "16"])
    assert not strip.exists()

    class Args:
        weights_json, size, jitter = str(GECKO), 16, 0.0

    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.DemoState(Args())
    text = (PORT / "demo" / "server.py").read_text()
    assert "NumpyEngine" not in text


def test_demo_static_page_is_the_ports_own():
    """The page the port's server sends lies in the port's package (and is
    packaged with it), not in the JAX package's."""
    from sph_nca_tpu_torch.demo import server

    static = Path(server.STATIC_DIR).resolve()
    assert static == (PORT / "demo" / "static").resolve()
    page = static / "index.html"
    assert "<canvas" in page.read_text()
    assert "demo/static/*.html" in (ROOT / "pyproject.toml").read_text()
    names = {p.relative_to(PORT).as_posix() for p in _port_files()
             if p.is_relative_to(PORT)}
    assert {"demo/__init__.py", "demo/engine.py", "demo/server.py"} <= names


def test_native_entry_points_raise_when_the_library_cannot_load(
        monkeypatch, tmp_path):
    """With a source g++ cannot compile, fps and cell_hash raise with the
    compiler's message (the JAX package's return None), and available()
    reports False without hiding that error from them."""
    import numpy as np

    from sph_nca_tpu_torch import native

    bad = tmp_path / "sphgrid.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    native.load_library.cache_clear()
    try:
        x = np.zeros((4, 2), np.float32)
        assert native.available() is False
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.fps(x, 2)
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.cell_hash(x, 0.5, 4)
        assert not list((tmp_path / "_build").glob("*.so"))
    finally:
        native.load_library.cache_clear()


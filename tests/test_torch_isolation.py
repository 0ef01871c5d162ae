"""The port stands alone: no module of ``repro_torch``, not
``chip_smoke.py``, no script of ``tools/`` and no port example
(``examples/*_torch.py``) imports JAX, the JAX package or ``ml_dtypes``, and its
entry points (``api.build``, ``models.build_model``, ``launch.serve``)
target the card unless the caller asks for the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.configs import get_smoke
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import build_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("*.py"))
            + sorted((ROOT / "examples").glob("*_torch.py")))


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_with_jax_and_repro_blocked():
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('jax', 'jaxlib', 'repro', 'ml_dtypes'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'jax' not in [m for m in sys.modules if sys.modules[m]]\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stderr
    # 45 modules: the paper path's, the wire's, the rwkv6 serving path's
    # (nn, models, configs, launch.serve, kernels.rwkv6_chunk) and the
    # zamba2 one's (nn.attention, nn.moe, kernels.ssd_chunk,
    # configs.zamba2_7b)
    assert int(out.stdout.split()[-1]) >= 45


@pytest.mark.parametrize("module", ["nn/attention.py", "nn/moe.py",
                                    "kernels/ssd_chunk.py",
                                    "configs/zamba2_7b.py"])
def test_zamba2_modules_are_checked(module):
    """The zamba2 serving path's new modules are among the files held to
    import no JAX and no ``repro``."""
    path = PORT / module
    assert path in _port_files()
    assert not set(_imported_roots(path)) & set(FORBIDDEN)


@pytest.mark.parametrize("module", ["kernels/smooth_clip.py",
                                    "kernels/block_topk.py"])
def test_clip_and_block_topk_modules_are_checked(module):
    """The launchers of the last four kernels (``sumsq``, ``scale``,
    ``scale_noise``, ``block_topk``) are among the files held to import no
    JAX and no ``repro``."""
    path = PORT / module
    assert path in _port_files()
    assert not set(_imported_roots(path)) & set(FORBIDDEN)


def _logreg_loss(params, batch):
    f, l = batch
    logits = f @ params["w"] + params["b"]
    return torch.mean(torch.log1p(torch.exp(-(2 * l - 1) * logits)))


def test_build_targets_cuda_unless_asked():
    algo = api.build(api.ExperimentSpec(), _logreg_loss)
    assert algo.device == torch.device("cuda")
    params = {"w": np.zeros(123, np.float32), "b": np.float32(0.0)}
    if torch.cuda.is_available():
        assert algo.init(params).x["w"].is_cuda
        return
    # no card here: the first tensor op raises instead of running on the CPU
    with pytest.raises((RuntimeError, AssertionError)):
        algo.init(params)
    cpu = api.build(api.ExperimentSpec(), _logreg_loss, device="cpu")
    assert cpu.init(params).x["w"].device.type == "cpu"


def test_kernel_backend_on_cpu_tensors_launches_nothing():
    """The comm round's 'kernel' backend on CPU tensors runs the kernels'
    plain versions over the flat planes and counts no launch."""
    ops.reset_launches()
    algo = api.build(api.ExperimentSpec(comm_backend="kernel"), _logreg_loss,
                     device="cpu")
    state = algo.init({"w": torch.zeros(123), "b": torch.zeros(())})
    batch = (torch.ones(10, 4, 123), torch.ones(10, 4))
    algo.step(state, batch, None)
    assert set(ops.LAUNCHES.values()) == {0}


def test_serve_targets_cuda_unless_asked(monkeypatch):
    """``launch.serve`` loads the model on cuda unless ``--device cpu`` is
    given; without a card it raises instead of moving to the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            serve.main(["--smoke", "--gen", "1"])
    seen = []

    class Stop(Exception):
        pass

    def fake_load(arch, smoke, device, seed):
        seen.append(torch.device(device))
        raise Stop

    monkeypatch.setattr(serve, "device_line", lambda device: "card")
    monkeypatch.setattr(serve, "load", fake_load)
    for argv in (["--smoke"], ["--smoke", "--device", "cpu"]):
        with pytest.raises(Stop):
            serve.main(argv)
    assert seen == [torch.device("cuda"), torch.device("cpu")]


def test_build_model_targets_cuda_unless_asked():
    cfg = get_smoke("rwkv6-7b")
    bundle = build_model(cfg)
    if torch.cuda.is_available():
        assert bundle.init_cache(1)["S"].is_cuda
        return
    with pytest.raises((RuntimeError, AssertionError)):
        bundle.init_cache(1)
    assert build_model(cfg, device="cpu").init_cache(1)["S"].device.type == \
        "cpu"


def test_hybrid_bundle_targets_cuda_unless_asked():
    cfg = get_smoke("zamba2-7b")
    bundle = build_model(cfg)
    if torch.cuda.is_available():
        assert bundle.init_cache(1, 8)["attn"]["k"].is_cuda
        return
    with pytest.raises((RuntimeError, AssertionError)):
        bundle.init_cache(1, 8)
    cache = build_model(cfg, device="cpu").init_cache(1, 8)
    assert {t.device.type for part in cache.values()
            for t in part.values()} == {"cpu"}


@pytest.mark.parametrize("path", [PORT / "launch" / "mesh.py",
                                  PORT / "core" / "agents.py",
                                  ROOT / "tests" / "torch_dist_worker.py"],
                         ids=["launch/mesh.py", "core/agents.py",
                              "tests/torch_dist_worker.py"])
def test_agents_as_processes_modules_are_checked(path):
    """The process group module and the rank programs of the process tests
    (imported by name in every spawned rank) import no JAX, no ``repro``
    and no test file."""
    roots = set(_imported_roots(path))
    assert not roots & set(FORBIDDEN)
    assert not any(r.startswith("test_") for r in roots)
    if path.parent == PORT / "launch":
        assert path in _port_files()


def _launch_imports(path):
    """The ``launch`` modules ``path`` imports, relatively or by name."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if (node.level == 2 and mod.split(".")[0] == "launch") or \
                    mod.startswith("repro_torch.launch"):
                yield mod
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.startswith("repro_torch.launch"):
                    yield alias.name


@pytest.mark.parametrize(
    "path", sorted((PORT / "core").glob("*.py"))
    + sorted((PORT / "data").glob("*.py")),
    ids=lambda p: str(p.relative_to(PORT)))
def test_core_and_data_do_not_import_the_launch_layer(path):
    """The algorithms and the data sources sit below the launch layer (the
    process group, the round loop, the drivers): an agent group reaches
    them as an argument, its row arithmetic lives in ``core/agents``."""
    assert not list(_launch_imports(path))


def test_a_spawned_rank_imports_no_jax():
    """A rank of ``spawn_agents`` running the tests' worker module: neither
    JAX nor the reference is among its modules."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "from repro_torch.launch import mesh\n"
        "import torch_dist_worker as W\n"
        "print(mesh.spawn_agents(W.loaded_roots, 2, device='cpu',"
        " threads=1, timeout_s=120))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}, timeout=180)
    assert out.returncode == 0, out.stderr
    assert "[[], []]" in out.stdout, out.stdout

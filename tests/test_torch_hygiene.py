"""The port stands alone: no JAX, nothing of the JAX package, no library
kernel standing in for a hand-written one, and no silent CPU fallback."""
import ast
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch import compat
from repro_torch.core import coordinator, devicetree, interface, pools
from repro_torch.kernels import _build, stream

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(ROOT, "src", "repro_torch")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files
                if f.endswith((".py", ".cu", ".cuh"))]
    return sorted(out)


def test_every_module_imports_without_jax_or_the_jax_package():
    mods = _modules()
    assert {"repro_torch.core.workloads", "repro_torch.kernels.stream",
            "repro_torch.core.exec.assemble", "repro_torch.core.exec.plan",
            "repro_torch.core.exec.dispatch", "repro_torch.core.characterize",
            "repro_torch.core.placement",
            "repro_torch.kernels.compute_probe",
            "repro_torch.core.exec.program", "repro_torch.core.exec.fence",
            "repro_torch.core.exec.resilience",
            "repro_torch.core.exec.journal",
            "repro_torch.kernels.contention",
            "repro_torch.kernels.flash_attention",
            "repro_torch.configs", "repro_torch.configs.base",
            "repro_torch.configs.qwen2_1_5b"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.') "
        "or k == 'triton')\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("clean")


FORBIDDEN = {
    "imports jax": re.compile(r"^\s*(import|from)\s+jax\b", re.M),
    "imports the JAX package": re.compile(
        r"^\s*(import\s+repro(\s|\.|$)|from\s+repro(\.|\s))", re.M),
    "library attention": re.compile(r"scaled_dot_product_attention"),
    "torch.compile": re.compile(r"torch\.compile"),
    "TPU figure": re.compile(r"v5e|197e12|VMEM 128 MiB|TPU_V5E"),
}


# chip_smoke.py times one library call beside the flash kernel as its
# yardstick (library_ms); the name may stand in that one function and
# nowhere else, and never in the package
YARDSTICK = "library_attention_ms"


def _yardstick_lines(path):
    """The lines of chip_smoke.py's yardstick function, else none."""
    if os.path.basename(path) != "chip_smoke.py":
        return set()
    tree = ast.parse(open(path, encoding="utf-8").read())
    return {n for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)
            and f.name == YARDSTICK
            for n in range(f.lineno, f.end_lineno + 1)}


def _text(path, what):
    lines = open(path, encoding="utf-8").read().splitlines()
    if what == "library attention":
        skip = _yardstick_lines(path)
        lines = [ln for i, ln in enumerate(lines, 1) if i not in skip]
    return "\n".join(lines)


@pytest.mark.parametrize("what", sorted(FORBIDDEN))
def test_sources_hold_nothing_forbidden(what):
    hits = [os.path.relpath(p, ROOT) for p in _sources()
            if FORBIDDEN[what].search(_text(p, what))]
    assert not hits, f"{what}: {hits}"


def test_library_attention_only_in_the_yardstick():
    """The one exception to the library-attention rule: chip_smoke.py's
    yardstick function, which times the call and hands back a time."""
    path = os.path.join(ROOT, "chip_smoke.py")
    lines = open(path, encoding="utf-8").read().splitlines()
    where = [i for i, ln in enumerate(lines, 1)
             if FORBIDDEN["library attention"].search(ln)]
    inside = _yardstick_lines(path)
    assert where and set(where) <= inside
    tree = ast.parse("\n".join(lines))
    def calls(node):
        return {id(n) for n in ast.walk(node) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == YARDSTICK}
    # its result is only ever the value of a "library_ms" key
    as_library_ms = set()
    for d in ast.walk(tree):
        if isinstance(d, ast.Dict):
            for k, v in zip(d.keys, d.values):
                if getattr(k, "value", None) == "library_ms":
                    as_library_ms |= calls(v)
    assert calls(tree) and calls(tree) == as_library_ms


def test_kernel_sources_are_in_the_package():
    names = sorted(os.listdir(os.path.join(PKG, "kernels", "csrc")))
    assert names == ["chase.cu", "compute_probe.cu", "contention.cu",
                     "flash_attention.cu", "flash_attention_tc.cu",
                     "roles.cuh", "stream.cu"]
    assert sorted(f"{n}.cu" for n in _build.SOURCES) == \
        [n for n in names if n.endswith(".cu")]
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    gitignore = open(os.path.join(ROOT, ".gitignore")).read().split()
    assert {"build/", "__pycache__/", ".hypothesis/", "*.so"} <= \
        set(gitignore)
    assert _build.build_dir().parts[-2:] == ("build", "repro_torch")


def _skip_if_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the raise cannot be shown")


@pytest.mark.parametrize("entry", [
    lambda: compat.resolve_device("cuda"),
    lambda: devicetree.detect_platform(),
    lambda: pools.PoolManager(devicetree.H100_SXM),
    lambda: coordinator.CoreCoordinator(),
    lambda: coordinator.CoreCoordinator(backend="simulate"),
    lambda: interface.MemscopeInterface(),
    lambda: interface.main(["--pools"]),
    lambda: stream.write_hbm(128, block_rows=128),
])
def test_asking_for_the_card_without_one_raises(entry):
    _skip_if_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_auto_backend_is_cuda_never_simulate():
    c = coordinator.CoreCoordinator(
        pools.PoolManager(devicetree.H100_SXM, "cpu"), backend="auto")
    assert c.backend == "cuda" and c.device.type == "cpu"
    with pytest.raises(ValueError):
        coordinator.CoreCoordinator(
            pools.PoolManager(devicetree.H100_SXM, "cpu"), backend="tpu")
    with pytest.raises(ValueError):
        compat.resolve_device("mps")


def test_building_without_nvcc_raises_with_the_reason(tmp_path, monkeypatch):
    if compat.nvcc_available():
        pytest.skip("nvcc is installed here")
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    with pytest.raises(_build.KernelBuildError, match="no nvcc"):
        _build.compile_source("stream")
    assert not list(tmp_path.iterdir())


def test_where_a_tensor_runs():
    assert not _build.launches_kernel(torch.zeros(4))
    with pytest.raises(TypeError):
        _build.launches_kernel(torch.zeros(4, device="meta"))

"""Builds ``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` and loads them with ctypes.

A source is compiled at first use into a shared library with a plain C
interface (seconds per file; no PyTorch headers), named after a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags so that an
edited source is rebuilt.  The
libraries go to ``build/repro_torch/`` beside ``src/`` (git-ignored).
A build that fails raises with ``nvcc``'s output; nothing here falls
back to another implementation.
Importing this module needs neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import sys
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

from repro_torch import compat

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("stream", "chase", "compute_probe", "contention",
           "flash_attention", "flash_attention_tc", "flash_attention_bwd",
           "flash_attention_bwd_tc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# shared memory one block can use on an H100 SM (227 KB of the SM's 256 KB)
SMEM_PER_BLOCK_BYTES = 232_448

_libs: Dict[str, ctypes.CDLL] = {}
_bound: Dict[tuple, "ctypes._CFuncPtr"] = {}
_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def build_dir() -> Path:
    # <root>/src/repro_torch/kernels/_build.py -> <root>/build/repro_torch
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _library_path(name: str) -> Path:
    # the headers every source may include count too: an edited role body
    # rebuilds every library that holds it
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{tag}.so"


def _report_path(name: str) -> Path:
    return _library_path(name).with_suffix(".ptxas.txt")


def compile_source(name: str, *, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    ptxas' report (registers, spills a kernel) is kept beside the library,
    where :func:`ptxas_report` reads it; ``verbose`` echoes it to stderr."""
    out, report = _library_path(name), _report_path(name)
    if out.exists() and report.exists():
        return out
    nvcc = compat.nvcc_path()
    if nvcc is None:
        raise KernelBuildError(
            f"cannot build {name}.cu: no nvcc on PATH, under $CUDA_HOME or "
            "under /usr/local/cuda")
    out.parent.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a concurrent process never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(prefix=f".{name}-", suffix=".so",
                               dir=out.parent)
    os.close(fd)
    cmd: List[str] = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
                      str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        if verbose:
            sys.stderr.write(proc.stderr)    # ptxas' register and smem report
        report.write_text(proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


_ENTRY_RE = re.compile(r"Compiling entry function '([^']+)'")
_FRAME_RE = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads")
_REGS_RE = re.compile(r"Used (\d+) registers")


def parse_ptxas(text: str) -> Dict[str, Dict[str, int]]:
    """ptxas' ``-v`` report as {kernel (mangled): {registers, stack_bytes,
    spill_stores, spill_loads}}, each line read under the entry function
    being compiled before it."""
    out: Dict[str, Dict[str, int]] = {}
    cur: Optional[str] = None
    for line in text.splitlines():
        m = _ENTRY_RE.search(line)
        if m:
            cur = m.group(1)
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = _FRAME_RE.search(line)
        if m:
            out[cur].update(stack_bytes=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = _REGS_RE.search(line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """Registers and spills of every kernel of ``csrc/<name>.cu``, from the
    report its build left beside its library."""
    compile_source(name)
    return parse_ptxas(_report_path(name).read_text())


def build_all(names: Iterable[str] = SOURCES, *,
              verbose: bool = False) -> Dict[str, Path]:
    """Compile every source, one ``nvcc`` each, all started together."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        futures = {n: ex.submit(compile_source, n, verbose=verbose)
                   for n in names}
        return {n: f.result() for n, f in futures.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_source(name)))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def bind(name: str, fn: str, argtypes: Sequence,
         restype=ctypes.c_int) -> "ctypes._CFuncPtr":
    """A C entry point with its argument types declared (an undeclared
    pointer would be passed as a 32-bit int and cut)."""
    f = _bound.get((name, fn))
    if f is None:
        f = getattr(library(name), fn)
        f.argtypes = list(argtypes)
        f.restype = restype
        _bound[(name, fn)] = f
    return f


def check_launch(name: str, fn: str, code: int) -> None:
    if code != 0:
        msg = library(name).repro_error_string(code).decode()
        raise KernelLaunchError(f"{fn}: CUDA error {code}: {msg}")


def current_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# -- where a tensor's kernel runs ---------------------------------------------


def launches_kernel(t: torch.Tensor) -> bool:
    """True when the wrapper given ``t`` must launch its CUDA kernel:
    for a CUDA tensor, or for a pinned host tensor when a card is present
    (the kernel reads it over PCIe through the same pointer).  False for
    an ordinary CPU tensor, which takes the plain version.  Anything else
    raises: there is no silent third path."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise TypeError(f"unsupported tensor device {t.device}")
    return compat.cuda_available() and t.is_pinned()


def compute_device(t: torch.Tensor) -> torch.device:
    """The card a kernel over ``t`` runs on (``t`` is CUDA or pinned)."""
    if t.is_cuda:
        return t.device
    return torch.device("cuda", torch.cuda.current_device())


def check_buffer(t: torch.Tensor, *, dtypes, what: str,
                 members: bool = False) -> None:
    """Raise on what the kernels do not take: they index (rows, 128)
    contiguous buffers in 16-byte units.  With ``members`` a
    (g, rows, 128) stack is taken too: each member's rows contiguous, the
    members 16-byte aligned and possibly apart (a view of a larger
    stack)."""
    if not (t.dim() == 2 or (members and t.dim() == 3)) or t.shape[-1] != 128:
        want = "(rows, 128) or (g, rows, 128)" if members else "(rows, 128)"
        raise ValueError(f"{what}: want shape {want}, got {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: want dtype in {dtypes}, got {t.dtype}")
    if t.dim() == 3:
        if (t.stride(2) != 1 or t.stride(1) != 128
                or (t.stride(0) * t.element_size()) % 16):
            raise ValueError(f"{what}: each member's rows must be "
                             "contiguous and 16-byte aligned")
    elif not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
    if t.numel() < 1:
        raise ValueError(f"{what}: need at least one row")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: data pointer must be 16-byte aligned")


def member_layout(t: torch.Tensor) -> tuple:
    """``(members, rows, member stride in elements)`` of a buffer that
    :func:`check_buffer` took: a (rows, 128) buffer is one member."""
    if t.dim() == 2:
        return 1, t.shape[0], t.numel()
    return t.shape[0], t.shape[1], t.stride(0)


def empty_like_placed(t: torch.Tensor, shape: Optional[tuple] = None,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """An uninitialised tensor of ``t``'s dtype (or ``dtype``) in the same
    memory as ``t``: on its card, or pinned host memory for a pinned
    ``t``."""
    shape = tuple(t.shape) if shape is None else shape
    dtype = t.dtype if dtype is None else dtype
    if t.is_cuda:
        return torch.empty(shape, dtype=dtype, device=t.device)
    return torch.empty(shape, dtype=dtype, pin_memory=t.is_pinned())

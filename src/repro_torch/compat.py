"""Availability probes and the one place a device request is resolved.

Nothing here falls back: :func:`resolve_device` raises when the caller
asks for the card and there is none, and :func:`kernels_supported` raises
with the build's or the launch's error instead of answering False.  Only
``device="cpu"`` selects the CPU, where the kernel wrappers take their
plain PyTorch versions.
"""
from __future__ import annotations

import functools
import os
import shutil
from typing import Optional, Union

import torch

_CUDA_HOME_DEFAULT = "/usr/local/cuda"


def cuda_available() -> bool:
    return torch.cuda.is_available()


def nvcc_path() -> Optional[str]:
    """The ``nvcc`` that builds the kernels, or None when none is installed."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or _CUDA_HOME_DEFAULT
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.access(cand, os.X_OK) else None


def nvcc_available() -> bool:
    return nvcc_path() is not None


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises if it asks for a
    card this process does not have."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda":
        if not cuda_available():
            raise RuntimeError(
                "device='cuda' requested but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=None)
def kernels_supported(device: Union[str, torch.device] = "cuda") -> bool:
    """Do the hand-written kernels build and run on ``device``'s card?

    The port of ``repro/compat.py:pallas_supported``: builds the contention
    library and launches its ``probe_add_one`` kernel (``x + 1`` on an
    (8, 128) float32 block), checked exactly.  True when it ran and agreed;
    a failed build or launch RAISES with ``nvcc``'s or the launch's error,
    and a wrong result raises too: the caller never falls back to the
    plain versions on the card.  Asked about the CPU it raises (there is
    nothing to probe there).  Cached per device, as the reference caches."""
    from repro_torch.kernels import contention

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("kernels_supported probes a card; the CPU runs the "
                         "plain versions")
    x = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(8, 128)
    out = contention.probe_add_one(x)
    torch.cuda.synchronize(dev)
    if not torch.equal(out, x + 1.0):
        raise RuntimeError("probe_add_one ran but x + 1 came back wrong: "
                           "the card's kernels cannot be trusted")
    return True


def device_clock_source(device: Union[str, torch.device] = "cuda") -> str:
    """Where the contention ladder's in-launch stamps come from:
    ``"device"`` on the card (``%globaltimer``, read by the engines inside
    the kernel), ``"host"`` on the CPU (the plain version stamps with
    ``time.perf_counter_ns``).  The JAX package's counterpart answers
    ``"callback"`` or ``"none"``; this port always has a clock."""
    return "device" if resolve_device(device).type == "cuda" else "host"

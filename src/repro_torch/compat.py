"""Availability probes and the one place a device request is resolved.

Nothing here falls back: :func:`resolve_device` raises when the caller
asks for the card and there is none.  Only ``device="cpu"`` selects the
CPU, where the kernel wrappers take their plain PyTorch versions.
"""
from __future__ import annotations

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

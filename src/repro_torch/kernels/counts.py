"""Launch counters: how often each wrapper launched its CUDA kernel, and
how often it took the plain PyTorch version instead.

A wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel and
nowhere else, and one to ``PLAIN[name]`` where a CPU tensor made it take
the plain version.  A run that must show it went through the kernels sets
both to zero before (``reset``) and reads them after (``snapshot``).
"""
from __future__ import annotations

from typing import Dict, Tuple

KERNELS = ("read_hbm", "write_hbm", "write_hbm_seeded", "rmw_hbm",
           "copy_hbm", "read_vmem", "write_vmem", "chase_vmem", "chase_hbm")

LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
PLAIN: Dict[str, int] = {k: 0 for k in KERNELS}


def reset() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN[k] = 0


def snapshot() -> Tuple[Dict[str, int], Dict[str, int]]:
    return dict(LAUNCHES), dict(PLAIN)

"""Launch counters: how often each wrapper launched its CUDA kernel, and
how often it took the plain PyTorch version instead.

A wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel and
nowhere else, and one to ``PLAIN[name]`` where a CPU tensor made it take
the plain version.  A run that must show it went through the kernels sets
both to zero before (``reset``) and reads them after (``snapshot``).
``INSTANCES`` splits the launches of a kernel built in more than one
design by the design that ran (``"<kernel>:<instance>"``); ``reset`` zeroes
it too.
"""
from __future__ import annotations

from typing import Dict, Tuple

KERNELS = ("read_hbm", "write_hbm", "write_hbm_seeded", "rmw_hbm",
           "copy_hbm", "read_vmem", "write_vmem", "chase_vmem", "chase_hbm",
           "mxu_probe", "contention_ladder", "probe_add_one", "triad_hbm",
           "flash_attention", "flash_attention_bwd")

LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
PLAIN: Dict[str, int] = {k: 0 for k in KERNELS}
INSTANCES: Dict[str, int] = {"flash_attention:wgmma_bf16": 0,
                             "flash_attention:fma_f32": 0,
                             "flash_attention_bwd:wgmma_bf16": 0,
                             "flash_attention_bwd:fma_bf16": 0,
                             "flash_attention_bwd:fma_f32": 0}


def reset() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN[k] = 0
    for k in INSTANCES:
        INSTANCES[k] = 0


def snapshot() -> Tuple[Dict[str, int], Dict[str, int]]:
    return dict(LAUNCHES), dict(PLAIN)

"""Compute busy loop — the paper's "memory-idle" activity (letter ``i``).

MEMSCOPE keeps non-stressor cores *memory-idle* with a CPU-bound busy
loop so they contribute zero memory traffic while still being online.
The card's counterpart, in ``csrc/compute_probe.cu``: one CTA computes a
chain of dependent (128, 128) float32 products on an operand it holds in
shared memory.  After the one load of the operand the kernel touches no
device memory until it stores the result: it keeps one SM busy and
leaves the memory idle.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, counts, ref

N = 128

_VP, _I = ctypes.c_void_p, ctypes.c_int


def mxu_probe(a: torch.Tensor, *, iters: int = 64) -> torch.Tensor:
    """a: (128, 128) float32.  Returns a^(iters+1) to float32 accuracy.

    Replaces ``repro/kernels/compute_probe.py:mxu_probe``.  Bound by
    operations: ``iters * 2 * 128**3`` float32 operations, dependent
    from one product to the next.  Design: one CTA on one SM, each
    product as 3xTF32 on ``mma.sync`` (hi*hi + hi*lo + lo*hi), ``a`` and
    the running product in shared memory (see the note in the CUDA
    source).  For a CPU tensor the plain version,
    :func:`repro_torch.kernels.ref.mxu_probe_ref`."""
    if tuple(a.shape) != (N, N) or a.dtype != torch.float32:
        raise ValueError(f"mxu_probe: want a ({N}, {N}) float32 operand, got "
                         f"{tuple(a.shape)} {a.dtype}")
    if not a.is_contiguous():
        raise ValueError("mxu_probe: operand must be contiguous")
    if iters < 0:
        raise ValueError("mxu_probe: iters must be >= 0")
    if not _build.launches_kernel(a):
        counts.PLAIN["mxu_probe"] += 1
        return ref.mxu_probe_ref(a, iters)
    dev = _build.compute_device(a)
    out = torch.empty((N, N), dtype=torch.float32, device=dev)
    fn = _build.bind("compute_probe", "repro_mxu_probe", (_VP, _VP, _I, _VP))
    code = fn(a.data_ptr(), out.data_ptr(), iters, _build.current_stream(dev))
    _build.check_launch("compute_probe", "mxu_probe", code)
    counts.LAUNCHES["mxu_probe"] += 1
    return out

"""Data-dependent pointer-chase latency kernels (the paper's l / m).

MEMSCOPE measures round-trip latency by ensuring exactly one outstanding
memory transaction: the next address is only known once the previous load
returns.  The buffer is initialised as a single permutation *cycle*
(Sattolo's algorithm — the equivalent of the paper's Appendix-A
swap-based shuffle: full coverage, no repeats, unprefetchable).

The wrappers of ``csrc/chase.cu``:

* ``chase_vmem`` (strategy ``l``) — the whole block stages the chain into
  the shared memory of one SM, then one thread performs truly dependent
  loads there (``idx = buf[idx]``).  Measures on-chip load-to-use latency.
* ``chase_hbm``  (strategy ``m``) — the chain stays where the tensor
  lives (device memory, or pinned host memory read over PCIe); one thread
  issues one ``ld.global.cg`` per hop, which bypasses L1, so each hop is
  served by the L2 or, for a buffer past the L2's 50 MB, by the memory
  behind it.  One outstanding transaction by construction.

A hop reads the 4-byte successor of a 512-byte line (one 32-byte
sector), where the TPU kernel it replaces moves the whole line.

Line layout: (n_lines, 128) int32 — one 512-byte row per "line";
element [i, 0] holds the successor of line i.  Both chases also take a
(g, n_lines, 128) stack of g chains (the port of the reference's
``jax.vmap`` over a leading member axis): one launch chases member 0's
chain, then member 1's, ..., and returns the g final indices.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build, counts, ref

LANE = 128
SMEM_CHAIN_BYTES = _build.SMEM_PER_BLOCK_BYTES

_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


# ---------------------------------------------------------------------------
# Chain initialisation (the paper's Fig. 16, steps 1-3)
# ---------------------------------------------------------------------------


def make_chain(n_lines: int, seed: int = 0) -> np.ndarray:
    """Sattolo cyclic permutation: following next[i] from 0 visits every
    line exactly once before returning to 0."""
    rng = np.random.default_rng(seed)
    # every j in one call: the generator draws them in the order of the
    # reference's scalar loop, bit for bit, and the swaps stay sequential,
    # over Python ints; the scalar draws were most of the loop's time
    js = rng.integers(0, np.arange(n_lines - 1, 0, -1)).tolist()
    p = list(range(n_lines))
    for i, j in zip(range(n_lines - 1, 0, -1), js):
        p[i], p[j] = p[j], p[i]
    return np.asarray(p, dtype=np.int32)


def chain_buffer(n_lines: int, seed: int = 0) -> np.ndarray:
    """(n_lines, 128) int32 buffer with the successor in lane 0."""
    buf = np.zeros((n_lines, LANE), np.int32)
    buf[:, 0] = make_chain(n_lines, seed)
    return buf


def make_strided_chain(n_lines: int, stride: int) -> np.ndarray:
    """Deterministic strided cycle: next[i] = (i + stride') mod n with
    stride' the smallest value >= stride coprime to n, so the walk still
    visits every line exactly once.  Unlike the Sattolo shuffle the hop
    distance is CONSTANT — the strided-chase traffic shape: predictable
    distance, no spatial locality beyond the stride."""
    if n_lines == 1:
        return np.zeros(1, np.int32)
    s = max(1, stride) % n_lines or 1
    while math.gcd(s, n_lines) != 1:
        s += 1
        if s >= n_lines:
            s = 1
            break
    return ((np.arange(n_lines) + s) % n_lines).astype(np.int32)


def strided_chain_buffer(n_lines: int, stride: int) -> np.ndarray:
    """(n_lines, 128) int32 strided-cycle buffer (successor in lane 0)."""
    buf = np.zeros((n_lines, LANE), np.int32)
    buf[:, 0] = make_strided_chain(n_lines, stride)
    return buf


# ---------------------------------------------------------------------------
# The chases
# ---------------------------------------------------------------------------


def work(name: str, buf: torch.Tensor, n_steps: int) -> counts.Work:
    """The counted work of a chase over ``buf``'s members: no operation;
    ``chase_vmem`` stages each chain into shared memory once (its lines'
    bytes), ``chase_hbm`` loads one 32-byte sector a hop.  A chase is
    bound by the latency of one load, which neither count sees."""
    g, rows, _ = _build.member_layout(buf)
    if name == "chase_vmem":
        return counts.Work(0, g * rows * LANE * 4)
    return counts.Work(0, g * n_steps * counts.SECTOR_BYTES)


def _chase(name: str, buf: torch.Tensor, n_steps: int) -> torch.Tensor:
    _build.check_buffer(buf, dtypes=(torch.int32,), what=name, members=True)
    if n_steps < 0:
        raise ValueError(f"{name}: n_steps must be >= 0")
    w = work(name, buf, n_steps)
    if not _build.launches_kernel(buf):
        with counts.plain(name, w):
            if buf.dim() == 3:
                return torch.tensor(ref.chase_members_ref(buf, n_steps),
                                    dtype=torch.int32)
            return torch.tensor(ref.chase_ref(buf, n_steps),
                                dtype=torch.int32)
    dev = _build.compute_device(buf)
    g, rows, stride = _build.member_layout(buf)
    out = torch.empty(g, dtype=torch.int32, device=dev)
    stream = _build.current_stream(dev)
    if name == "chase_vmem":
        fn = _build.bind("chase", "repro_chase_vmem",
                         (_VP, _LL, _I, _I, _I, _VP, _VP))
        code = fn(buf.data_ptr(), stride, g, rows, n_steps, out.data_ptr(),
                  stream)
    else:
        fn = _build.bind("chase", "repro_chase_hbm",
                         (_VP, _LL, _I, _I, _VP, _VP))
        code = fn(buf.data_ptr(), stride, g, n_steps, out.data_ptr(), stream)
    _build.check_launch("chase", name, code)
    counts.launched(name, w)
    return out.reshape(buf.shape[:-2])


def chase_vmem(buf: torch.Tensor, *, n_steps: int) -> torch.Tensor:
    """buf: (n_lines, 128) int32 that fits the shared memory of one SM.
    Returns the final index (data-dependent on every intermediate load).

    Replaces ``repro/kernels/chase.py:chase_vmem``.  Bound by latency,
    not by bytes or operations: ``n_steps`` dependent shared-memory
    loads, one at a time.  Design (D): stage with the whole block, chase
    with one thread, store the final index.  The entries must lie in
    [0, n_lines): the kernel does not check them."""
    if buf.dim() in (2, 3) and buf.shape[-2] * LANE * 4 > SMEM_CHAIN_BYTES:
        raise ValueError(
            f"chase_vmem: a chain of {buf.shape[-2]} lines "
            f"({buf.shape[-2] * LANE * 4} B) does not fit the "
            f"{SMEM_CHAIN_BYTES} B of shared memory of one SM")
    return _chase("chase_vmem", buf, n_steps)


def chase_hbm(buf: torch.Tensor, *, n_steps: int) -> torch.Tensor:
    """buf: (n_lines, 128) int32 staying in its own memory; exactly one
    outstanding load at any time.

    Replaces ``repro/kernels/chase.py:chase_hbm``.  Bound by latency:
    ``n_steps`` dependent loads that bypass L1.  Design (D): one thread,
    ``n_steps`` a run-time argument, final index stored.  The entries
    must lie in [0, n_lines): the kernel does not check them."""
    return _chase("chase_hbm", buf, n_steps)

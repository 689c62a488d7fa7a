"""Workload Library — registry of micro-benchmark activities (Table I).

Each workload is keyed by its access-strategy letter and binds a memory
pool + buffer size to a runnable activity.  Workloads carry:

* a **buffer initialiser** (the paper's configurable init: sequential
  ints for bandwidth sanity-checking, a Sattolo chain for latency);
* an **executable** (a hand-written CUDA kernel on the card, its plain
  PyTorch version on ``device="cpu"``) used by the ``cuda`` backend;
* the **queueing-class parameters** (strategy letter, traffic multiplier,
  MLP) consumed by the ``simulate`` backend.

The cacheable strategies (r/w/l) run the on-chip kernels when the buffer
fits the shared memory of one SM and the streaming / global-memory
kernels otherwise; past that, whether a cacheable buffer is served by
the L2 or by the memory behind it is set by the hardware — which is
exactly how the paper's Fig. 5 buffer-size sweeps behave.

Every buffer lives in its pool's memory: the stream sources and
destinations and the chase chains are the pool's allocation itself.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from repro_torch.core.devicetree import (L2_BYTES, SMEM_PER_SM_BYTES,
                                         MemoryNode)
from repro_torch.core.pools import Allocation, MemoryPool, PoolError
from repro_torch.kernels import ops

LANE = 128
LINE_BYTES = LANE * 4          # one (1,128) f32 row = 512 B "line"
# the two residency thresholds (PERF.md "Residency thresholds")
SMEM_RESIDENT_BYTES = SMEM_PER_SM_BYTES   # executable choice: the buffer
                                          # fits the shared memory of one SM
CACHE_RESIDENT_BYTES = L2_BYTES           # modeling choice: it fits the L2


@dataclass
class WorkloadResult:
    strategy: str
    pool: str
    buffer_bytes: int
    iters: int
    bytes_moved: int           # useful bytes touched (all iters)
    elapsed_ns: float          # device time (cuda) / wall time (cpu)
    transactions: int          # dependent loads for latency workloads
    # True when an on-chip kernel ran on the card: its few microseconds of
    # work are outweighed by the launch, so ``elapsed_ns`` (and the rate or
    # latency derived from it) is the host's launch cost, not the memory's
    launch_bound: bool = False

    @property
    def bandwidth_gbps(self) -> float:
        if self.elapsed_ns <= 0:
            return 0.0
        return self.bytes_moved / self.elapsed_ns

    @property
    def latency_ns(self) -> float:
        if self.transactions <= 0:
            return 0.0
        return self.elapsed_ns / self.transactions


@dataclass
class Workload:
    """A bound activity: strategy letter + pool + buffer."""
    strategy: str
    pool: MemoryPool
    buffer_bytes: int
    description: str
    run_fn: Callable[[int], WorkloadResult]
    alloc: Optional[Allocation] = None
    is_memory_bound: bool = True

    def run(self, iters: int = 500) -> WorkloadResult:
        return self.run_fn(iters)

    def release(self) -> None:
        if self.alloc is not None:
            self.pool.free(self.alloc)
            self.alloc = None

    @property
    def node(self) -> MemoryNode:
        return self.pool.node


# ---------------------------------------------------------------------------
# Buffer initialisers (paper: "Configurable Buffer Initialization")
# ---------------------------------------------------------------------------


def bw_buffer_init(shape, dtype):
    """Sequential integers — lets experiments sanity-check corruption."""
    n = 1
    for s in shape:
        n *= int(s)
    return torch.arange(n, dtype=torch.float32).reshape(shape).to(dtype)


def latency_buffer_init(n_lines: int, seed: int = 0):
    return torch.from_numpy(ops.chain_buffer(n_lines, seed))


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., Workload]] = {}


def register_strategy(letter: str):
    def deco(fn):
        _REGISTRY[letter] = fn
        return fn
    return deco


def strategies() -> Dict[str, str]:
    return {k: (v.__doc__ or "").strip().splitlines()[0]
            for k, v in sorted(_REGISTRY.items())}


def make_workload(strategy: str, pool: MemoryPool, buffer_bytes: int,
                  **kw) -> Workload:
    if strategy not in _REGISTRY:
        raise KeyError(
            f"unknown access strategy {strategy!r}; have "
            f"{sorted(_REGISTRY)}")
    return _REGISTRY[strategy](pool, buffer_bytes, **kw)


def resolve_strategy(strategy: str, shape=None) -> str:
    """The strategy letter a (strategy, TrafficShape) pair actually
    executes as: mixed shapes run the ``b`` mixed-stream workload,
    strided shapes the ``t`` strided chase, everything else the plain
    strategy.  The single source of truth for this mapping, so every
    backend executes the same kernel class for a given spec."""
    kind = getattr(shape, "kind", "steady") if shape is not None \
        else "steady"
    return {"mixed": "b", "strided": "t"}.get(kind, strategy)


def make_shaped_workload(strategy: str, pool: MemoryPool, buffer_bytes: int,
                         shape=None, **kw) -> Workload:
    """Bind a (strategy, TrafficShape) pair to an executable workload.

    Steady shapes resolve to the plain strategy; mixed ratios map onto
    the ``b`` mixed-stream workload, strided shapes onto the ``t``
    strided chase, and bursty shapes wrap the base workload with
    duty-cycled accounting (the off phase is pure idle, so the
    time-averaged bandwidth scales by the duty cycle)."""
    if shape is None or getattr(shape, "is_steady", True):
        return make_workload(strategy, pool, buffer_bytes, **kw)
    if shape.kind == "mixed":
        return make_workload("b", pool, buffer_bytes,
                             read_fraction=shape.read_fraction, **kw)
    if shape.kind == "strided":
        return make_workload("t", pool, buffer_bytes,
                             stride=shape.stride, **kw)
    if shape.kind == "burst":
        wl = make_workload(strategy, pool, buffer_bytes, **kw)
        return _duty_cycled(wl, shape.duty_cycle)
    raise KeyError(f"unknown traffic shape kind {shape.kind!r}")


def _duty_cycled(wl: Workload, duty: float) -> Workload:
    base_run = wl.run_fn

    def run(iters):
        res = base_run(iters)
        idle_ns = res.elapsed_ns * (1.0 - duty) / duty
        return dataclasses.replace(res, elapsed_ns=res.elapsed_ns + idle_ns)

    wl.run_fn = run
    wl.description = f"{wl.description} (duty={duty:g})"
    return wl


def _rows(buffer_bytes: int) -> int:
    rows = max(1, buffer_bytes // LINE_BYTES)
    # keep divisible by the largest block we use
    block = 512 if rows >= 512 else rows
    return (rows // block) * block or rows


def rows_for(buffer_bytes: int) -> int:
    """Public spelling of the buffer->line-rows mapping every backend
    shares (block-aligned row count for a byte budget)."""
    return _rows(buffer_bytes)


def _timed(fn, *args, iters: int, on: torch.device, **kw) -> float:
    """Median-of-3 time for `iters` back-to-back calls, ns per call.

    On the card: a ``torch.cuda.Event`` pair around each sample and one
    synchronise per sample, so the time is the device's and includes the
    gaps between launches.  On the CPU: the host's clock.  ``on`` is
    the device the work runs on (every other keyword goes to ``fn``)."""
    samples = []
    if on.type == "cuda":
        fn(*args, **kw)                              # build + warm
        torch.cuda.synchronize(on)
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args, **kw)
            stop.record()
            stop.synchronize()
            samples.append(start.elapsed_time(stop) * 1e6 / iters)
    else:
        fn(*args, **kw)
        for _ in range(3):
            t0 = time.perf_counter_ns()
            for _ in range(iters):
                fn(*args, **kw)
            samples.append((time.perf_counter_ns() - t0) / iters)
    return float(statistics.median(samples))


def _fits_vmem(buffer_bytes: int) -> bool:
    """Executable-kernel residency choice: the buffer fits the shared
    memory of one SM."""
    return buffer_bytes < SMEM_RESIDENT_BYTES


def models_as_vmem(buffer_bytes: int) -> bool:
    """Modeling-side 'fits the cache' rule (the Fig. 5 sweep knee), for a
    platform tree without a transparent cache node."""
    return buffer_bytes < CACHE_RESIDENT_BYTES


def _launch_bound(pool: MemoryPool) -> bool:
    """Whether an on-chip kernel timed on ``pool``'s device measures the
    launch rather than the walk (see ``WorkloadResult.launch_bound``)."""
    return pool.device.type == "cuda"


def _source(pool: MemoryPool, alloc: Allocation, rows: int) -> torch.Tensor:
    """The stream's source buffer: the pool's allocation, or for an
    on-chip pool (a residency grant holds no tensor) a staging buffer on
    the pool's device."""
    if alloc.array is not None:
        return alloc.array
    return pool.place(bw_buffer_init((rows, LANE), torch.float32))


# ---- bandwidth strategies ---------------------------------------------------


@register_strategy("r")
def _mk_r(pool, buffer_bytes, **kw):
    """sequential reads (cacheable) — read bandwidth"""
    rows = _rows(buffer_bytes)
    alloc = pool.alloc((rows, LANE), torch.float32, init=bw_buffer_init,
                       tag="bw:r")
    x = _source(pool, alloc, rows)
    vmem = _fits_vmem(buffer_bytes) or pool.node.kind == "vmem"

    def run(iters):
        if vmem:
            t = _timed(ops.vmem_read, x, repeats=8, iters=iters,
                       on=pool.device) / 8
        else:
            t = _timed(ops.stream_read, x, block_rows=min(512, rows),
                       iters=iters, on=pool.device)
        return WorkloadResult("r", pool.node.name, buffer_bytes, iters,
                              rows * LINE_BYTES * iters, t * iters, 0,
                              launch_bound=vmem and _launch_bound(pool))

    return Workload("r", pool, buffer_bytes,
                    "sequential cacheable read", run, alloc)


@register_strategy("w")
def _mk_w(pool, buffer_bytes, **kw):
    """sequential writes (cacheable, write-allocate) — write bandwidth"""
    rows = _rows(buffer_bytes)
    alloc = pool.alloc((rows, LANE), torch.float32, tag="bw:w")
    vmem = _fits_vmem(buffer_bytes) or pool.node.kind == "vmem"

    def run(iters):
        if vmem:
            t = _timed(ops.vmem_write, rows=rows, repeats=8,
                       device=pool.device, out=alloc.array,
                       iters=iters, on=pool.device) / 8
        else:
            t = _timed(ops.stream_write, rows=rows,
                       block_rows=min(512, rows), device=pool.device,
                       out=alloc.array, iters=iters, on=pool.device)
        return WorkloadResult("w", pool.node.name, buffer_bytes, iters,
                              rows * LINE_BYTES * iters, t * iters, 0,
                              launch_bound=vmem and _launch_bound(pool))

    return Workload("w", pool, buffer_bytes,
                    "sequential cacheable write", run, alloc)


@register_strategy("s")
def _mk_s(pool, buffer_bytes, **kw):
    """non-cacheable sequential read (always streams from the module)"""
    rows = _rows(buffer_bytes)
    alloc = pool.alloc((rows, LANE), torch.float32, init=bw_buffer_init,
                       tag="bw:s")
    x = _source(pool, alloc, rows)

    def run(iters):
        t = _timed(ops.stream_read, x, block_rows=min(512, rows),
                   iters=iters, on=pool.device)
        return WorkloadResult("s", pool.node.name, buffer_bytes, iters,
                              rows * LINE_BYTES * iters, t * iters, 0)

    return Workload("s", pool, buffer_bytes, "non-cacheable read", run,
                    alloc)


@register_strategy("x")
def _mk_x(pool, buffer_bytes, **kw):
    """non-cacheable write (write-allocate: line read+written)"""
    rows = _rows(buffer_bytes)
    alloc = pool.alloc((rows, LANE), torch.float32, init=bw_buffer_init,
                       tag="bw:x")
    x = _source(pool, alloc, rows)

    def run(iters):
        t = _timed(ops.stream_rmw, x, block_rows=min(512, rows),
                   iters=iters, on=pool.device)
        return WorkloadResult("x", pool.node.name, buffer_bytes, iters,
                              2 * rows * LINE_BYTES * iters, t * iters, 0)

    return Workload("x", pool, buffer_bytes,
                    "non-cacheable write (allocate)", run, alloc)


@register_strategy("y")
def _mk_y(pool, buffer_bytes, **kw):
    """write-streaming (no write-allocate — the dc zva analog)"""
    rows = _rows(buffer_bytes)
    alloc = pool.alloc((rows, LANE), torch.float32, tag="bw:y")

    def run(iters):
        t = _timed(ops.stream_write, rows=rows, block_rows=min(512, rows),
                   device=pool.device, out=alloc.array, iters=iters,
                   on=pool.device)
        return WorkloadResult("y", pool.node.name, buffer_bytes, iters,
                              rows * LINE_BYTES * iters, t * iters, 0)

    return Workload("y", pool, buffer_bytes, "write-streaming", run, alloc)


@register_strategy("c")
def _mk_c(pool, buffer_bytes, **kw):
    """copy stream (read every line, write it elsewhere) — STREAM copy"""
    rows = _rows(buffer_bytes)
    alloc = pool.alloc((rows, LANE), torch.float32, init=bw_buffer_init,
                       tag="bw:c")
    x = _source(pool, alloc, rows)

    def run(iters):
        t = _timed(ops.stream_copy, x, block_rows=min(512, rows),
                   iters=iters, on=pool.device)
        return WorkloadResult("c", pool.node.name, buffer_bytes, iters,
                              2 * rows * LINE_BYTES * iters, t * iters, 0)

    return Workload("c", pool, buffer_bytes, "copy stream", run, alloc)


@register_strategy("b")
def _mk_mixed(pool, buffer_bytes, *, read_fraction: float = 0.5, **kw):
    """mixed read/write blocks at a configurable r:w ratio"""
    rows = _rows(buffer_bytes)
    alloc = pool.alloc((rows, LANE), torch.float32, init=bw_buffer_init,
                       tag="bw:b")
    x = _source(pool, alloc, rows)
    rf = max(0.0, min(1.0, read_fraction))
    # the write half stores ``1.0 + seed``: the seeded store stream, whose
    # value depends on an operand in the pool's memory, is the form that a
    # fenced multi-engine region needs, and the one measured here too
    seed = pool.place(torch.zeros((1, 1), dtype=torch.float32))

    def run(iters):
        t = _timed(ops.stream_mixed, x, read_fraction=rf,
                   block_rows=min(512, rows), seed=seed, iters=iters,
                   on=pool.device)
        return WorkloadResult("b", pool.node.name, buffer_bytes, iters,
                              rows * LINE_BYTES * iters, t * iters, 0)

    return Workload("b", pool, buffer_bytes,
                    f"mixed r/w stream (rf={rf:g})", run, alloc)


# ---- latency strategies -----------------------------------------------------


def _chase_workload(letter: str, description: str, pool, buffer_bytes,
                    make_chain, fn) -> Workload:
    """A chase over the (rows, 128) int32 chain ``make_chain(rows)``,
    which is allocated in ``pool`` (an on-chip pool's residency grant
    holds no tensor: the chain is then staged from the pool's device)."""
    rows = _rows(buffer_bytes)
    chain = make_chain(rows)
    alloc = pool.alloc((rows, LANE), torch.int32,
                       init=lambda shape, dtype: chain, tag=f"lat:{letter}")
    buf = alloc.array if alloc.array is not None else pool.place(chain)

    def run(iters):
        steps = rows                      # one full cycle per iteration
        t = _timed(fn, buf, n_steps=steps, iters=max(1, iters // 10),
                   on=pool.device)
        return WorkloadResult(letter, pool.node.name, buffer_bytes,
                              iters, rows * LINE_BYTES, t,
                              transactions=steps,
                              launch_bound=(fn is ops.chase_vmem
                                            and _launch_bound(pool)))

    return Workload(letter, pool, buffer_bytes, description, run, alloc)


@register_strategy("t")
def _mk_strided(pool, buffer_bytes, *, stride: int = 8, **kw):
    """strided pointer chase (constant hop distance, non-cacheable)"""
    return _chase_workload(
        "t", f"strided pointer-chase (x{stride})", pool, buffer_bytes,
        lambda rows: torch.from_numpy(ops.strided_chain_buffer(rows, stride)),
        ops.chase_hbm)


@register_strategy("l")
def _mk_l(pool, buffer_bytes, *, seed: int = 0, **kw):
    """data-dependent pointer chase (cacheable) — latency"""
    vmem = _fits_vmem(buffer_bytes) or pool.node.kind == "vmem"
    if vmem and _rows(buffer_bytes) * LINE_BYTES > SMEM_RESIDENT_BYTES:
        # an on-chip pool forces residency; a stream is tiled over SMs,
        # a chase is one thread on one SM and cannot be
        raise PoolError(
            f"pool {pool.node.name}: a {buffer_bytes}B chase chain cannot "
            f"be held in the {SMEM_RESIDENT_BYTES}B shared memory of one SM")
    return _chase_workload(
        "l", "pointer-chase latency", pool, buffer_bytes,
        lambda rows: latency_buffer_init(rows, seed),
        ops.chase_vmem if vmem else ops.chase_hbm)


@register_strategy("m")
def _mk_m(pool, buffer_bytes, *, seed: int = 0, **kw):
    """non-cacheable pointer chase — module latency"""
    return _chase_workload(
        "m", "non-cacheable pointer-chase", pool, buffer_bytes,
        lambda rows: latency_buffer_init(rows, seed), ops.chase_hbm)


# ---- memory-idle -------------------------------------------------------------


@register_strategy("i")
def _mk_idle(pool, buffer_bytes, **kw):
    """memory-idle compute busy loop (zero memory traffic)"""

    def run(iters):
        raise NotImplementedError(
            "strategy 'i' as a main activity needs the mxu_probe kernel, "
            "which is not ported yet (ROADMAP.md queue 2, K5c); as a "
            "stressor it is modeled")

    return Workload("i", pool, 0, "memory-idle busy loop", run, None,
                    is_memory_bound=False)

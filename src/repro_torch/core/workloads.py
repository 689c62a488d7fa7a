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

Timing on the card (:func:`_timed`) brackets back-to-back calls with
device events.  The on-chip kernels do a few microseconds of work a call,
less than the host needs to launch one, so on the card they are timed by
the slope between two work counts (:func:`_slope_timed`): the per-walk
or per-hop time of the memory, not the launch.  On the CPU the plain
versions are timed as the reference times its kernels.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
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
    # True when an on-chip kernel ran on the card and its slope timing
    # failed (the longer run not positive over, or not twice, the
    # shorter): ``elapsed_ns`` (and the rate or latency derived from it)
    # is then the time per call, launch included, not the memory's
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


# The hold in front of a timed sample on the card: twice the host's cost
# of enqueueing the sample's calls, at most 50 ms.
HOLD_PER_CALL = 2
HOLD_CAP_NS = 50_000_000


def _timed(fn, *args, iters: int, on: torch.device, **kw) -> float:
    """Time of one of `iters` back-to-back calls, ns: the least of 3
    samples on the card, their median on the CPU.

    On the card: a ``torch.cuda.Event`` pair around each sample and one
    synchronise per sample, so the time is the device's.  A wrapper call
    costs the host about as much as a short kernel costs the card (58 us
    against 91 us for a 256 MiB read on an H100 80GB HBM3 at 700 W, as
    ``chip_smoke.py`` measures them), so each
    sample starts behind a hold of the stream (``HOLD_PER_CALL`` times
    the host's cost of the `iters` calls, at most ``HOLD_CAP_NS``): the
    host has enqueued the calls before the card reaches the first, and
    they run back to back.  A host stall longer than the hold can still
    only add idle time, so the least sample is the one it disturbed
    least.  On the CPU: the host's clock and the reference's median.
    ``on`` is the device the work runs on (every other keyword goes to
    ``fn``)."""
    samples = []
    if on.type == "cuda":
        fn(*args, **kw)                              # build + warm
        torch.cuda.synchronize(on)
        t0 = time.perf_counter_ns()
        fn(*args, **kw)
        hold_ns = min(HOLD_CAP_NS,
                      HOLD_PER_CALL * (time.perf_counter_ns() - t0) * iters)
        torch.cuda.synchronize(on)
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            ops.hold_stream(hold_ns, on)
            start.record()
            for _ in range(iters):
                fn(*args, **kw)
            stop.record()
            stop.synchronize()
            samples.append(start.elapsed_time(stop) * 1e6 / iters)
        return float(min(samples))
    fn(*args, **kw)
    for _ in range(3):
        t0 = time.perf_counter_ns()
        for _ in range(iters):
            fn(*args, **kw)
        samples.append((time.perf_counter_ns() - t0) / iters)
    return float(statistics.median(samples))


# Work counts of the on-chip slope: walks of the tile (read_vmem,
# write_vmem) and full cycles of the chain (chase_vmem, at least
# ``HOP_FLOOR`` hops).  The shorter run must itself outlast the host's cost
# of one wrapper call (13-65 us measured on an H100), or both runs time the
# host; the longer is eight times the shorter.
WALK_COUNTS = (256, 2048)
HOP_FLOOR = 8192


def _slope_timed(fn, *args, work: str, counts: Tuple[int, int], iters: int,
                 on: torch.device, **kw) -> Tuple[float, bool]:
    """ns per unit of the keyword ``work`` (a walk, a hop) of one call of
    ``fn``, by the slope between the work counts ``counts``, and whether
    the slope failed.  It fails when it is not positive or the longer run
    did not take twice the shorter; the time per unit of the shorter run,
    launch included, is returned then."""
    lo, hi = counts
    t_lo = _timed(fn, *args, iters=iters, on=on, **{work: lo}, **kw)
    t_hi = _timed(fn, *args, iters=iters, on=on, **{work: hi}, **kw)
    slope = (t_hi - t_lo) / (hi - lo)
    if slope > 0 and t_hi >= 2.0 * t_lo:
        return slope, False
    return t_lo / lo, True


def _walk_time(fn, *args, iters: int, on: torch.device,
               **kw) -> Tuple[float, bool]:
    """ns per walk of an on-chip kernel (``repeats`` walks a call), and
    whether it is launch-bound.  On the card by the slope; on the CPU as
    the reference times it, 8 walks a call."""
    if on.type == "cuda":
        return _slope_timed(fn, *args, work="repeats", counts=WALK_COUNTS,
                            iters=iters, on=on, **kw)
    return _timed(fn, *args, repeats=8, iters=iters, on=on, **kw) / 8, False


def _chase_time(fn, buf: torch.Tensor, rows: int, iters: int,
                on: torch.device) -> Tuple[float, bool]:
    """ns for one call of the chase ``fn`` over ``rows`` hops (one full
    cycle of each chain in ``buf``), and whether it is launch-bound.  The
    on-chip chase on the card is timed by the slope over whole cycles
    (a chain that is one full cycle ends at 0 again after any number of
    them); every other chase as the reference times it."""
    calls = max(1, iters // 10)
    if on.type == "cuda" and fn is ops.chase_vmem:
        k = -(-HOP_FLOOR // rows)
        per_hop, lb = _slope_timed(fn, buf, work="n_steps",
                                   counts=(k * rows, 8 * k * rows),
                                   iters=calls, on=on)
        return per_hop * rows, lb
    return _timed(fn, buf, n_steps=rows, iters=calls, on=on), False


def _fits_vmem(buffer_bytes: int) -> bool:
    """Executable-kernel residency choice: the buffer fits the shared
    memory of one SM."""
    return buffer_bytes < SMEM_RESIDENT_BYTES


def models_as_vmem(buffer_bytes: int) -> bool:
    """Modeling-side 'fits the cache' rule (the Fig. 5 sweep knee), for a
    platform tree without a transparent cache node."""
    return buffer_bytes < CACHE_RESIDENT_BYTES


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
        launch_bound = False
        if vmem:
            t, launch_bound = _walk_time(ops.vmem_read, x, iters=iters,
                                         on=pool.device)
        else:
            t = _timed(ops.stream_read, x, block_rows=min(512, rows),
                       iters=iters, on=pool.device)
        return WorkloadResult("r", pool.node.name, buffer_bytes, iters,
                              rows * LINE_BYTES * iters, t * iters, 0,
                              launch_bound=launch_bound)

    return Workload("r", pool, buffer_bytes,
                    "sequential cacheable read", run, alloc)


@register_strategy("w")
def _mk_w(pool, buffer_bytes, **kw):
    """sequential writes (cacheable, write-allocate) — write bandwidth"""
    rows = _rows(buffer_bytes)
    alloc = pool.alloc((rows, LANE), torch.float32, tag="bw:w")
    vmem = _fits_vmem(buffer_bytes) or pool.node.kind == "vmem"

    def run(iters):
        launch_bound = False
        if vmem:
            t, launch_bound = _walk_time(ops.vmem_write, rows=rows,
                                         device=pool.device, out=alloc.array,
                                         iters=iters, on=pool.device)
        else:
            t = _timed(ops.stream_write, rows=rows,
                       block_rows=min(512, rows), device=pool.device,
                       out=alloc.array, iters=iters, on=pool.device)
        return WorkloadResult("w", pool.node.name, buffer_bytes, iters,
                              rows * LINE_BYTES * iters, t * iters, 0,
                              launch_bound=launch_bound)

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
        # one full cycle of `rows` hops per iteration
        t, launch_bound = _chase_time(fn, buf, rows, iters, pool.device)
        return WorkloadResult(letter, pool.node.name, buffer_bytes,
                              iters, rows * LINE_BYTES, t,
                              transactions=rows, launch_bound=launch_bound)

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
    a = torch.eye(LANE, dtype=torch.float32, device=pool.device) * 0.99

    def run(iters):
        t = _timed(lambda aa: ops.mxu_probe(aa, iters=64), a, iters=iters,
                   on=pool.device)
        return WorkloadResult("i", pool.node.name, 0, iters, 0, t * iters,
                              0)

    return Workload("i", pool, 0, "memory-idle busy loop", run, None,
                    is_memory_bound=False)


# ---------------------------------------------------------------------------
# Batched group measurement (the matrix runner's fast path)
# ---------------------------------------------------------------------------

# observer strategies whose measured pass runs over a stacked
# (g, rows, 128) input, so G same-shape scenarios collapse into ONE
# launch over a leading member axis (read-like paths; chases keep
# per-member Sattolo chains) — write-like paths and the deterministic
# strided chase ('t', whose members are bit-identical) carry no distinct
# batched input, so their group measures once and shares the result.
_VMAP_READS = ("r", "s", "c", "x", "b")
_VMAP_CHASES = ("l", "m")


# batched measurement stacks member buffers into one tensor; cap the
# stack so a big group cannot out-allocate the device (the naive path
# only ever holds ONE member buffer)
_BATCH_BYTES_CAP = 1 << 30


def measure_group(strategy: str, pool: MemoryPool, buffer_bytes: int,
                  n_members: int, iters: int, *, shape=None,
                  seeds: Optional[list] = None,
                  member_pools: Optional[list] = None) -> Tuple[list, int]:
    """Measure ``n_members`` same-signature observers with one launch
    over the stacked member buffers (chases keep per-member chains, so
    different seeds stay distinct).

    ``member_pools`` (optional, len ``n_members``) supports
    *heterogeneous* groups: observers from different pools whose
    placement lands in the same physical memory (the caller groups by
    :meth:`MemoryPool.effective_memory_kind`, so this never stacks
    buffers that would really live in different memories).  Each
    member's result is labeled with its own pool name.

    Returns ``(results, n_dispatches)``.  Normally one dispatch covers
    the whole group; groups whose stacked footprint would exceed the
    batch byte cap or the pool's free space split into chunks (the
    naive path only ever holds ONE member buffer, so the batched path
    must not out-allocate it unboundedly), each chunk one dispatch.
    The group's time is split evenly: the streams spread every member
    over the whole card, so each member is credited the aggregate rate
    of the pass; the on-chip reads and the chases run their members
    back to back, so each member is credited its own walk or chase."""
    strat = resolve_strategy(strategy, shape)
    if strat not in _VMAP_READS + _VMAP_CHASES:
        # write-like path stacks no buffers: one measurement serves
        # the whole group regardless of member size
        chunk = n_members
    else:
        member_bytes = _rows(buffer_bytes) * LINE_BYTES
        budget = min(_BATCH_BYTES_CAP, max(pool.available, member_bytes))
        chunk = max(1, min(n_members, budget // member_bytes))
    results: list = []
    dispatches = 0
    for start in range(0, n_members, chunk):
        g = min(chunk, n_members - start)
        results.extend(_measure_chunk(
            strategy, pool, buffer_bytes, g, iters, shape=shape,
            seeds=(seeds[start:start + g] if seeds is not None
                   else list(range(start, start + g))),
            pool_names=([p.node.name for p in
                         member_pools[start:start + g]]
                        if member_pools is not None else None)))
        dispatches += 1
    return results, dispatches


def _measure_chunk(strategy: str, pool: MemoryPool, buffer_bytes: int,
                   n_members: int, iters: int, *, shape=None,
                   seeds: Optional[list] = None,
                   pool_names: Optional[list] = None) -> list:
    rows = _rows(buffer_bytes)
    g = n_members
    names = pool_names or [pool.node.name] * g
    vmem = _fits_vmem(buffer_bytes) or pool.node.kind == "vmem"
    blk = min(512, rows)
    strat = resolve_strategy(strategy, shape)

    duty = shape.duty_cycle if (shape is not None
                                and shape.kind == "burst") else 1.0

    if strat in _VMAP_CHASES:
        seeds = seeds or list(range(g))
        on_chip = strat == "l" and vmem
        if on_chip and rows * LINE_BYTES > SMEM_RESIDENT_BYTES:
            raise PoolError(
                f"pool {pool.node.name}: a {buffer_bytes}B chase chain "
                f"cannot be held in the {SMEM_RESIDENT_BYTES}B shared "
                "memory of one SM")
        bufs = pool.place(torch.from_numpy(
            np.stack([ops.chain_buffer(rows, s) for s in seeds])))
        fn = ops.chase_vmem if on_chip else ops.chase_hbm
        # the g chains run back to back in the one launch, so /g is the
        # time of one member's chase
        t, launch_bound = _chase_time(fn, bufs, rows, iters, pool.device)
        per = (t / g) / duty
        return [WorkloadResult(strat, name, buffer_bytes, iters,
                               rows * LINE_BYTES, per, transactions=rows,
                               launch_bound=launch_bound)
                for name in names]

    if strat in _VMAP_READS:
        x = pool.place(bw_buffer_init((g, rows, LANE), torch.float32))
        useful = rows * LINE_BYTES
        launch_bound = False
        if strat == "b":
            rf = (shape.read_fraction
                  if shape is not None and shape.kind == "mixed" else 0.5)
            # seeded, as the single-observer ``b`` workload is
            seed = pool.place(torch.zeros((1, 1), dtype=torch.float32))
            t = _timed(ops.stream_mixed, x, read_fraction=rf,
                       block_rows=blk, seed=seed, iters=iters,
                       on=pool.device)
        elif strat == "c":
            t = _timed(ops.stream_copy, x, block_rows=blk, iters=iters,
                       on=pool.device)
            useful = 2 * rows * LINE_BYTES
        elif strat == "x":
            t = _timed(ops.stream_rmw, x, block_rows=blk, iters=iters,
                       on=pool.device)
            useful = 2 * rows * LINE_BYTES
        elif vmem and strat == "r":
            # per walk of every member's tile, members back to back
            t, launch_bound = _walk_time(ops.vmem_read, x, iters=iters,
                                         on=pool.device)
        else:
            t = _timed(ops.stream_read, x, block_rows=blk, iters=iters,
                       on=pool.device)
        per = (t / g) / duty
        return [WorkloadResult(strat, name, buffer_bytes, iters,
                               useful * iters, per * iters, 0,
                               launch_bound=launch_bound)
                for name in names]

    # write-like paths (w/y/t/i...): no batched input — one
    # measurement, shared by every identical member (relabeled with
    # each member's own pool for heterogeneous groups).
    wl = make_shaped_workload(strategy, pool, buffer_bytes, shape)
    try:
        res = wl.run(iters)
    finally:
        wl.release()
    return [res if name == res.pool else dataclasses.replace(res, pool=name)
            for name in names]

"""dispatch — stage 3 of the spmd execution pipeline.

Owns everything between a built program and its numbers: the
coordinator-level program/operand LRU (:class:`ProgramCache`), the
host-synchronous launch itself, the fence check of every launch, and the
(waves, subsets, rungs, samples) clock decode mapping each stacked
ladder's stamp pairs back to per-rung elapsed medians — line for line the
JAX package's decode, on the same (n_eng, steps, 2) ``[s, ns]`` layout.

:class:`DispatchStats` is the accounting ``run_matrix`` returns and
CurveDB records, every field counted where the JAX package counts it.
``aot_compiles`` stays 0: one kernel is built once by ``nvcc``, and no
program is compiled on its own.
"""
from __future__ import annotations

import functools
import hashlib
import os
import time as _time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core.exec.plan import PlannedDispatch
from repro_torch.core.exec.program import (build_ladder_entry, build_program,
                                           ladder_operand_rows, operand_bytes)


def _fault_site(key: Tuple) -> str:
    """Stable fault-injection site id for a program cache key.  The
    key's repr is deterministic (frozen dataclasses and primitives
    only), so the same dispatch gets the same site in every process —
    which is what makes a seeded fault schedule byte-reproducible."""
    return hashlib.sha256(repr(key).encode()).hexdigest()[:16]


@dataclass
class DispatchStats:
    """Execution accounting for the matrix runner: the batched runner's
    claim ("fewer dispatches than the per-point loop") and the spmd
    backend's claim ("one fused SPMD dispatch per ladder rung") are
    checked against these numbers in the tests."""
    n_scenarios: int = 0            # ScenarioSpecs in the matrix
    n_ladders: int = 0              # (spec, observer, buffer) ladders
    measure_dispatches: int = 0     # timed executable measurement passes
    model_evals: int = 0            # queueing-network solves
    spmd_rungs: int = 0             # ladder rungs executed on the mesh
    # host-blocking spmd program executions: the sweep-batched path
    # does ONE per same-signature ladder GROUP (~ one per distinct
    # program signature per sweep) — width-packed or not: a packed
    # dispatch running P ladders side by side still counts ONE — the
    # fused ladder path one per ladder, the legacy path 4 per RUNG
    # (warm + 3 timed)
    host_sync_dispatches: int = 0
    # compiled spmd programs (+ placed operands) reused from the
    # coordinator-level LRU cache — across rungs, ladders, AND
    # back-to-back run_matrix calls on one coordinator
    program_cache_hits: int = 0
    # sweep-level megabatching: distinct role-program signatures this
    # run stacked ladders under (0 on the non-batched paths)
    spmd_groups: int = 0
    # spmd programs actually built this run (cache misses: a step
    # table and placed operands), and how many of those were compiled
    # ahead of time (none: the ladder is one kernel, built by nvcc)
    programs_built: int = 0
    aot_compiles: int = 0
    # engine-subset width-packing: ladders that ran side by side on a
    # disjoint engine subset of a packed dispatch, and the widest
    # subset used (0 when nothing packed this run)
    packed_ladders: int = 0
    subset_width: int = 0
    # the resilience layer: faults consumed from the
    # injector, failed attempts retried, ladders that finished BELOW
    # their planned dispatch level, ladders that fell all the way to
    # the modeled floor, quality-gate re-measurements (each one is an
    # extra honest host_sync_dispatch) + rungs still noisy after them,
    # and ladders restored from a sweep journal instead of re-executed
    faults_injected: int = 0
    retried_dispatches: int = 0
    degraded_ladders: int = 0
    modeled_floor_ladders: int = 0
    noisy_remeasures: int = 0
    noisy_rungs: int = 0
    resumed_ladders: int = 0

    def resilience_clean(self) -> bool:
        """True while no fault, retry, degradation or re-measurement
        has perturbed the dispatch accounting — the strict
        one-sync-per-group equalities only hold then."""
        return not (self.faults_injected or self.retried_dispatches
                    or self.degraded_ladders or self.noisy_remeasures)


class ProgramMemoryError(RuntimeError):
    """A program's operands do not fit its memory even with the cache
    emptied: raised before anything is allocated."""


class ProgramCache:
    """LRU over built spmd programs + their placed operands, keyed by
    program signature, bounded twice: at most ``cap`` entries, and on
    the card by the bytes of their operands.  :meth:`reserve` runs
    BEFORE a program is built: it evicts least recently used entries of
    the same memory until the new operands fit in ``capacity(place)``
    bytes (``None``: no byte bound, as for CPU tensors), so the peak is
    never an old program beside a new one that does not fit with it.
    Eviction drops the evicted entry's operand tensors at once (on the
    card they go back to the allocator) — dropping only the dict entry
    would leave them alive for as long as anything else referred to it."""

    def __init__(self, cap: int,
                 capacity: Optional[Callable[[str, int], Optional[int]]]
                 = None):
        assert cap >= 1, cap
        self.cap = cap
        self.capacity = capacity
        self.entries: "OrderedDict[Tuple, Any]" = OrderedDict()

    def get(self, key: Tuple, stats: Optional[DispatchStats] = None):
        entry = self.entries.get(key)
        if entry is not None:
            self.entries.move_to_end(key)
            if stats is not None:
                stats.program_cache_hits += 1
        return entry

    def resident(self, place: str) -> int:
        """Operand bytes the cache holds in ``place``."""
        return sum(e.nbytes for e in self.entries.values()
                   if e.place == place)

    def _evict_oldest(self, place: Optional[str] = None) -> bool:
        for k, e in self.entries.items():
            if place is None or e.place == place:
                del self.entries[k]
                e.drop_operands()
                return True
        return False

    def reserve(self, place: str, nbytes: int) -> None:
        """Make room for a program of ``nbytes`` operand bytes in
        ``place`` before it is built; raise :class:`ProgramMemoryError`
        when it cannot fit even alone."""
        while len(self.entries) >= self.cap:
            self._evict_oldest()
        if self.capacity is None:
            return
        held = self.resident(place)
        cap_bytes = self.capacity(place, held)
        if cap_bytes is None:
            return
        while held + nbytes > cap_bytes and self._evict_oldest(place):
            held = self.resident(place)
        if held + nbytes > cap_bytes:
            raise ProgramMemoryError(
                f"spmd program operands of {nbytes} bytes do not fit "
                f"{place} memory ({cap_bytes} bytes usable)")

    def put(self, key: Tuple, entry) -> None:
        self.entries[key] = entry
        self.entries.move_to_end(key)
        while len(self.entries) > self.cap:
            self._evict_oldest()


def operand_capacity(device: torch.device, place: str,
                     held: int) -> Optional[int]:
    """Bytes the cache may hold in ``place``, given the ``held`` bytes
    it holds there now.  On the card: what it holds, plus what the card
    has free (the driver's free memory and the allocator's reserved but
    unused blocks, where evicted operands go), less a margin for the
    launch's own tensors and the rest of the process.  Pinned host
    memory: half the host's physical memory (the pinned allocator keeps
    what is freed, so the host's free pages say nothing).  CPU tensors:
    no bound."""
    if place == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        unused = (torch.cuda.memory_reserved(device)
                  - torch.cuda.memory_allocated(device))
        return held + free + unused - max(1 << 30, total // 32)
    if place == "pinned_host":
        return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") // 2
    return None


class Dispatcher:
    """Stage 3: run planned dispatches.  Holds the program LRU and the
    per-coordinator dispatch knobs (sample count, the device, the CTAs
    an engine); the coordinator facade delegates here."""

    def __init__(self, cache_cap: int, samples: int, *, device,
                 ctas_per_engine: int, faults=None):
        assert samples >= 1, samples
        self.device = torch.device(device)
        # a partial over the device, not a closure over self: no cycle
        # keeps a dropped dispatcher's operands alive until a collection
        self.cache = ProgramCache(
            cache_cap, functools.partial(operand_capacity, self.device))
        self.samples = samples
        self.ctas_per_engine = ctas_per_engine
        # where the fused path's stamps come from: "device" (the kernel's
        # %globaltimer) or "host" (the plain version on the CPU)
        self.clock_source = compat.device_clock_source(self.device)
        # the fault-injection seam (exec.resilience.FaultInjector or
        # None): consulted at the compile / dispatch / decode sites of
        # both dispatch paths.  Deterministic — draws are pure hashes
        # of (seed, site, phase, attempt) — and duck-typed, so this
        # module never imports the resilience layer
        self.faults = faults

    def _fault(self, site: str, phase: str, stats: DispatchStats):
        """Consult the fault-injection seam.  Raising phases
        ("compile"/"dispatch") raise the injector's fault; the
        "decode" phase returns the fault kind so the caller can
        corrupt the decoded timings instead (a corrupted-timing fault
        must produce bad VALUES — detection is the resilience layer's
        validator, not an exception)."""
        if self.faults is None:
            return None
        kind = self.faults.check(site, phase)
        if kind is not None:
            stats.faults_injected += 1
            if phase != "decode":
                raise self.faults.error(kind, site)
        return kind

    def _placement(self, kind: Optional[str], rows_max: int,
                   n_eng: int) -> Tuple[str, int]:
        """Where a program's operands will live, and their bytes."""
        place = ("pinned_host" if kind == "pinned_host"
                 else self.device.type)
        return place, operand_bytes(n_eng, rows_max)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the fused/batched/packed path ---------------------------------

    def run_planned(self, planned: PlannedDispatch, n_eng: int,
                    activity: str, mode: str, stats: DispatchStats,
                    ) -> Tuple[np.ndarray, np.ndarray, bool, bool]:
        """Execute one planned dispatch: build (or fetch) its program,
        run it with ONE launch the host waits for, verify the launch's
        fence, and decode each stacked ladder's in-launch stamp pairs.
        Returns ``(med, spread, fenced, aot)`` with ``med``/``spread``
        of shape (group, n_scen) nanoseconds."""
        key = planned.cache_key(mode, n_eng, activity, self.samples)
        site = _fault_site(key)
        entry = self.cache.get(key, stats)
        if entry is None:
            self._fault(site, "compile", stats)
            self.cache.reserve(*self._placement(
                planned.kind, ladder_operand_rows(planned, n_eng), n_eng))
            entry = build_ladder_entry(planned, n_eng, self.samples, stats,
                                       device=self.device,
                                       ctas_per_engine=self.ctas_per_engine)
            self.cache.put(key, entry)
        self._fault(site, "dispatch", stats)
        out = entry.launch().to_cpu()       # the one host sync
        stats.host_sync_dispatches += 1
        stats.measure_dispatches += 1
        stats.spmd_rungs += planned.group * planned.n_scen
        if planned.packed:
            stats.packed_ladders += planned.group
            stats.subset_width = max(stats.subset_width,
                                     planned.subset_width)
        fenced = entry.is_fenced(out)
        # each subset's LEADER engine is its observer: its [s, ns]
        # stamp pairs bracket each step's barrier pair, stop stamp taken
        # after the subset's stop barrier (i.e. when its SLOWEST engine
        # finished — paper invariant 3).  Ladder g ran in wave g//P on
        # subset g%P; the trailing spare subsets of a ragged last wave
        # executed but are not decoded.
        t0s = out.t0s.numpy()
        t1s = out.t1s.numpy()
        k, s = planned.n_scen, self.samples
        med = np.zeros((planned.group, k))
        spread = np.zeros((planned.group, k), np.int64)
        for g in range(planned.group):
            wave, subset = planned.member_slot(g)
            lead = subset * planned.subset_width
            t0 = t0s[lead].reshape(planned.waves, k, s, 2)[wave]
            t1 = t1s[lead].reshape(planned.waves, k, s, 2)[wave]
            d = ((t1[..., 0].astype(np.int64) - t0[..., 0])
                 * 1_000_000_000 + (t1[..., 1] - t0[..., 1]))
            med[g] = np.median(d, axis=1)
            spread[g] = d.max(axis=1) - d.min(axis=1)
        if self._fault(site, "decode", stats):
            med = -np.abs(med)      # corrupted timings: non-positive
        return med, spread, fenced, entry.aot

    # -- the host-timed per-rung path ------------------------------------

    def run_rung(self, roles, n_eng: int, activity: str,
                 kind: Optional[str], stats: DispatchStats,
                 ) -> Tuple[float, bool, int, bool]:
        """One rung, one launch of a one-step table: 1 warm launch + the
        timed ``samples``, each timed on the host by ``perf_counter_ns``
        around the launch and a synchronize (median; the returned int is
        the spread of the samples, the bool the fence verified from
        every timed launch's stamps).  Costs 1 + ``samples`` host syncs
        per rung and includes the host's launch cost; the fused ladder
        path replaces both and this path is kept for comparison and as
        the resilience layer's per-rung floor."""
        roles = tuple(roles)
        # the kind joins the cache key: identical role programs from
        # differently-placed pools must not share operands
        key = ("rung", n_eng, activity, kind, roles)
        site = _fault_site(key)
        entry = self.cache.get(key, stats)
        if entry is None:
            self._fault(site, "compile", stats)
            rows_max = max(r[2] for r in roles)
            self.cache.reserve(*self._placement(kind, rows_max, n_eng))
            entry = build_program(
                [roles], n_eng, kind=kind, samples=1, subsets=None,
                op_roles=roles, rows_max=rows_max,
                device=self.device, ctas_per_engine=self.ctas_per_engine,
                stats=stats)
            self.cache.put(key, entry)
        self._fault(site, "dispatch", stats)
        entry.launch().to_cpu()                 # warm
        samples, fenced = [], entry.fenced
        for _ in range(self.samples):
            t0 = _time.perf_counter_ns()
            out = entry.launch()
            self._sync()
            samples.append(_time.perf_counter_ns() - t0)
            fenced = fenced and entry.is_fenced(out.to_cpu())
        stats.host_sync_dispatches += 1 + self.samples
        stats.measure_dispatches += 1
        stats.spmd_rungs += 1
        elapsed = float(np.median(samples))
        if self._fault(site, "decode", stats):
            elapsed = -abs(elapsed)     # corrupted timing: non-positive
        return elapsed, fenced, int(max(samples) - min(samples)), entry.aot

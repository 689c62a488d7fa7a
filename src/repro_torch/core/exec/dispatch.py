"""dispatch — the execution accounting of the matrix runner.

Only :class:`DispatchStats` is ported so far: the measured observer pass
of ``run_matrix`` (backends ``simulate`` and ``cuda``) fills its
``n_scenarios``, ``n_ladders``, ``measure_dispatches`` and
``model_evals``.  Every other field belongs to the executable
multi-engine contention path (the JAX package's ``spmd`` backend, its
program cache, ahead-of-time compiles, width-packing and resilience
layer); they are kept, at 0, so that the accounting and the CurveDB
``meta`` it is written into have the same fields in both packages.
``Dispatcher`` and ``ProgramCache`` come with that path.
"""
from __future__ import annotations

from dataclasses import dataclass


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
    # spmd programs actually traced + compiled this run (cache
    # misses), and how many of those were compiled ahead of time —
    # together with host_sync_dispatches the dispatch-vs-compile
    # attribution
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

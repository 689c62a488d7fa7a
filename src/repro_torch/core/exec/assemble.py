"""assemble — stage 4 of the spmd execution pipeline.

Folds the measured pass, the executed rungs and the model back into
user-facing structures: per-rung :class:`ScenarioResult`s, per-ladder
:class:`ScenarioRun`s with their ``execution`` provenance dict (backend,
executed-vs-modeled rungs, whether the uncontended observer was
measured, coupling, the activity that ran, and on ``spmd`` the fence
state, timing source and width-packing slot), and the
:class:`MatrixResult` that ``run_matrix`` returns.  The observer
measurement stamping (:func:`observer_result`) lives here too: it is the
boundary where raw elapsed nanoseconds become WorkloadResults.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.exec.dispatch import DispatchStats
from repro_torch.core.exec.plan import effective_duty
from repro_torch.core.exec.program import _SPMD_CHASES, _SPMD_STREAM_2X
from repro_torch.core.scenarios import ObserverSpec, ScenarioSpec
from repro_torch.core.workloads import (LINE_BYTES, WorkloadResult,
                                        resolve_strategy,
                                        rows_for as _wl_rows)


@dataclass
class ScenarioResult:
    n_stressors: int
    main: WorkloadResult
    modeled_bw_gbps: float = 0.0
    modeled_lat_ns: float = 0.0
    stress_bw_gbps: float = 0.0
    # where this rung's curve value comes from: "modeled" (queueing
    # network; `main` is at most an uncontended measurement) or
    # "executed" (`main` IS the observer measured under n_stressors
    # live stress engines — the spmd backend)
    source: str = "modeled"


@dataclass
class ScenarioRun:
    """One (scenario, observer, buffer) ladder."""
    spec: ScenarioSpec
    buffer_bytes: int
    key: str
    observer: Optional[ObserverSpec] = None   # which observer this curve is
    scenarios: List[ScenarioResult] = field(default_factory=list)
    # executed-vs-modeled provenance, persisted into CurveDB v2:
    # {"backend", "executed_rungs", "modeled_rungs", ...}
    execution: Dict[str, Any] = field(default_factory=dict)

    def bandwidth_curve(self) -> List[Tuple[int, float]]:
        return [(s.n_stressors,
                 s.main.bandwidth_gbps if s.source == "executed"
                 else (s.modeled_bw_gbps or s.main.bandwidth_gbps))
                for s in self.scenarios]

    def latency_curve(self) -> List[Tuple[int, float]]:
        return [(s.n_stressors,
                 s.main.latency_ns if s.source == "executed"
                 else (s.modeled_lat_ns or s.main.latency_ns))
                for s in self.scenarios]


@dataclass
class MatrixResult:
    runs: List[ScenarioRun] = field(default_factory=list)
    stats: DispatchStats = field(default_factory=DispatchStats)


def observer_result(obs: ObserverSpec, buf: int, iters: int,
                    elapsed: float) -> WorkloadResult:
    """Stamp one executed rung's observer measurement.  Uses the
    RESOLVED strategy letter, like the batched group measurement does:
    the executed role for a mixed 'r' observer is the 'b' stream, and
    provenance must say so."""
    obs_rows = _wl_rows(buf)
    strat = resolve_strategy(obs.strategy, obs.shape)
    n_active = max(1, int(round(iters * effective_duty(obs.shape))))
    if strat in _SPMD_CHASES:
        # elapsed spans n_active full traversals: bytes and
        # transactions both scale with it (latency = elapsed/tx)
        return WorkloadResult(strat, obs.pool, buf, iters,
                              obs_rows * LINE_BYTES * n_active,
                              elapsed,
                              transactions=obs_rows * n_active)
    mult = 2 if strat in _SPMD_STREAM_2X else 1
    return WorkloadResult(strat, obs.pool, buf, iters,
                          mult * obs_rows * LINE_BYTES * n_active,
                          elapsed, 0)


def assemble_runs(triples, *, backend: str, activity: str,
                  stats: DispatchStats, depth_fn, model_fn,
                  measured: Dict[int, WorkloadResult],
                  executed: Optional[Dict[Tuple[int, int],
                                          WorkloadResult]] = None,
                  fenced_by_triple: Optional[Dict[int, bool]] = None,
                  timing_by_triple: Optional[Dict[int, Dict[str, Any]]]
                  = None,
                  n_engines: Optional[int] = None,
                  operand_kinds_fn=None) -> List[ScenarioRun]:
    """(per-triple measurements, per-rung executions, fence + timing
    provenance) -> the per-ladder ScenarioRuns ``run_matrix`` returns.
    ``depth_fn(spec)`` gives the ladder depth, ``model_fn(spec, obs, buf,
    k)`` the queueing-network rung prediction (counted into
    ``stats.model_evals`` here), and — on the spmd backend —
    ``operand_kinds_fn(spec, obs)`` the sorted operand memory kinds for
    the provenance dict."""
    executed = executed or {}
    fenced_by_triple = fenced_by_triple or {}
    timing_by_triple = timing_by_triple or {}
    runs: List[ScenarioRun] = []
    for i, (spec, obs, buf) in enumerate(triples):
        n_scen = depth_fn(spec)
        scenarios = []
        exec_rungs = []
        for k in range(n_scen):
            bw, lat, sbw = model_fn(spec, obs, buf, k)
            stats.model_evals += 1
            ex = executed.get((i, k))
            main_res = ex if ex is not None else (
                measured.get(i) or WorkloadResult(
                    obs.strategy, obs.pool, buf, spec.iters, 0, 0.0, 0))
            if ex is not None:
                exec_rungs.append(k)
            scenarios.append(ScenarioResult(
                n_stressors=k, main=main_res, modeled_bw_gbps=bw,
                modeled_lat_ns=lat, stress_bw_gbps=sbw,
                source="executed" if ex is not None else "modeled"))
        execution = {
            "backend": backend,
            "executed_rungs": exec_rungs,
            "modeled_rungs": [k for k in range(n_scen)
                              if k not in exec_rungs],
            "measured_uncontended": i in measured,
            # whether this curve's siblings were part of its measured
            # region / queueing network (effective coupling: a
            # single-observer spec couples nothing)
            "coupled": bool(spec.coupled and len(spec.observers) > 1),
            # what ran: "cuda" (the hand-written kernels), "plain" (their
            # plain versions, device="cpu"), "none" (modeled only)
            "activity": activity,
        }
        if backend == "spmd":
            execution["n_engines"] = n_engines
            # the VERIFIED fence state of this ladder's launches (the
            # kernel's stamps and barrier layout)
            execution["fenced"] = fenced_by_triple.get(i, False)
            # how the executed rungs were timed: "device" (in-launch
            # %globaltimer stamps), "host" (the plain version's
            # perf_counter stamps, or the per-rung host clock), plus the
            # per-rung sample spreads, the host-synchronous dispatch
            # count this ladder cost, and its width-packing slot
            # (packed / subset_width / subset_index)
            execution.update(timing_by_triple.get(i, {}))
            if operand_kinds_fn is not None:
                execution["operand_memory_kinds"] = \
                    operand_kinds_fn(spec, obs)
        runs.append(ScenarioRun(spec=spec, buffer_bytes=buf,
                                key=spec.key_for(obs, buf),
                                observer=obs,
                                scenarios=scenarios,
                                execution=execution))
    return runs

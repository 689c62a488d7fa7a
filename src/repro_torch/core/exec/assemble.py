"""assemble — folds the measured pass and the model back into results.

Per-rung :class:`ScenarioResult`s, per-ladder :class:`ScenarioRun`s with
their ``execution`` provenance dict (backend, executed-vs-modeled rungs,
whether the uncontended observer was measured, coupling, the activity
that ran), and the :class:`MatrixResult` that ``run_matrix`` returns.
The executed rungs of the multi-engine contention path, and the
observer stamping it needs, come with that path.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.exec.dispatch import DispatchStats
from repro_torch.core.scenarios import ObserverSpec, ScenarioSpec
from repro_torch.core.workloads import WorkloadResult


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
    # live stress engines)
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


def assemble_runs(triples, *, backend: str, activity: str,
                  stats: DispatchStats, depth_fn, model_fn,
                  measured: Dict[int, WorkloadResult]) -> List[ScenarioRun]:
    """(per-triple measurements) -> the per-ladder ScenarioRuns
    ``run_matrix`` returns.  ``depth_fn(spec)`` gives the ladder depth,
    ``model_fn(spec, obs, buf, k)`` the queueing-network rung
    prediction (counted into ``stats.model_evals`` here)."""
    runs: List[ScenarioRun] = []
    for i, (spec, obs, buf) in enumerate(triples):
        n_scen = depth_fn(spec)
        scenarios = []
        for k in range(n_scen):
            bw, lat, sbw = model_fn(spec, obs, buf, k)
            stats.model_evals += 1
            main_res = measured.get(i) or WorkloadResult(
                obs.strategy, obs.pool, buf, spec.iters, 0, 0.0, 0)
            scenarios.append(ScenarioResult(
                n_stressors=k, main=main_res, modeled_bw_gbps=bw,
                modeled_lat_ns=lat, stress_bw_gbps=sbw, source="modeled"))
        execution = {
            "backend": backend,
            "executed_rungs": [],
            "modeled_rungs": list(range(n_scen)),
            "measured_uncontended": i in measured,
            # whether this curve's siblings were part of its
            # queueing network (effective coupling: a single-observer
            # spec couples nothing)
            "coupled": bool(spec.coupled and len(spec.observers) > 1),
            # what ran the measured pass: "cuda" (the hand-written
            # kernels), "plain" (their plain versions, device="cpu"),
            # "none" (modeled only)
            "activity": activity,
        }
        runs.append(ScenarioRun(spec=spec, buffer_bytes=buf,
                                key=spec.key_for(obs, buf),
                                observer=obs,
                                scenarios=scenarios,
                                execution=execution))
    return runs

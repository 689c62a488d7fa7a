"""assemble — the user-facing result of one ladder rung.

The place its counterpart has in the JAX package (``core/exec/assemble``),
where the per-ladder ``ScenarioRun`` and the ``MatrixResult`` will join it
with the matrix runner.
"""
from __future__ import annotations

from dataclasses import dataclass

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

"""Core Coordinator — scenario ladders, one measured observer.

Mirrors the paper's §III-D: an *Experiment Instantiator* validates the
configuration and binds workloads; the observed activity is measured
alone on the card and every contended rung of the ladder comes from the
queueing-network model (:mod:`repro_torch.core.simulate`).

Backends:

``simulate``  nothing executes; every rung is modeled.
``cuda``      the observed activity's hand-written CUDA kernel really
              runs (its plain PyTorch version on ``device="cpu"``);
              contended rungs come from the model.  The counterpart of
              the JAX package's ``tpu`` / ``interpret`` backends.
``auto``      is ``cuda``.  It never resolves to ``simulate``: asked
              for the card where there is none, the coordinator raises.

The scenario-matrix runner and the executable multi-engine contention
path (observer + live stressor engines inside one launch) are not ported
yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.compat import resolve_device
from repro_torch.core import simulate as sim
from repro_torch.core.devicetree import Platform, detect_platform
from repro_torch.core.exec.assemble import ScenarioResult
from repro_torch.core.pools import MemoryPool, PoolManager
from repro_torch.core.scenarios import StressorSpec, TrafficShape
from repro_torch.core.workloads import (_REGISTRY, WorkloadResult,
                                        make_shaped_workload, models_as_vmem)

__all__ = [
    "ActivitySpec", "CoreCoordinator", "ExperimentConfig",
    "ExperimentResult", "ScenarioResult", "ValidationError",
]

BACKENDS = ("simulate", "cuda")

# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ActivitySpec:
    strategy: str              # Table-I letter
    pool: str                  # pool name ("hbm", "host", ...)
    buffer_bytes: int
    # optional traffic-shape parameters (ScenarioSpec DSL; the defaults
    # reproduce the seed's steady streams exactly)
    read_fraction: Optional[float] = None   # mixed r/w ratio
    duty_cycle: float = 1.0                 # bursty/duty-cycled
    stride: int = 1                         # strided pointer-chase

    def describe(self) -> str:
        return f"({self.strategy},{self.pool},{self.buffer_bytes >> 10}K)"

    def shape(self) -> Optional[TrafficShape]:
        """The TrafficShape these fields encode (None = steady)."""
        if self.read_fraction is not None:
            # surface grid points carry BOTH a mix and a duty cycle —
            # dropping the duty here would silently rebuild a hotter
            # shape than the one that ran
            return TrafficShape(kind="mixed",
                                read_fraction=self.read_fraction,
                                duty_cycle=self.duty_cycle)
        if self.duty_cycle < 1.0:
            return TrafficShape(kind="burst", duty_cycle=self.duty_cycle)
        if self.stride > 1:
            return TrafficShape(kind="strided", stride=self.stride)
        return None

    @staticmethod
    def from_stressor(s: StressorSpec) -> "ActivitySpec":
        return ActivitySpec(
            s.strategy, s.pool, s.buffer_bytes,
            read_fraction=(s.shape.read_fraction
                           if s.shape.kind == "mixed" else None),
            duty_cycle=s.shape.duty_cycle,
            stride=s.shape.stride)


@dataclass(frozen=True)
class ExperimentConfig:
    main: ActivitySpec
    stress: ActivitySpec
    iters: int = 500
    scenarios: Optional[int] = None      # default: platform.n_engines
    counters: Tuple[str, ...] = ("WALL_NS", "HLO_FLOPS", "HLO_BYTES",
                                 "TRANSACTIONS", "NS_PER_TX")


@dataclass
class ExperimentResult:
    config: ExperimentConfig
    scenarios: List[ScenarioResult] = field(default_factory=list)

    def bandwidth_curve(self) -> List[Tuple[int, float]]:
        return [(s.n_stressors,
                 s.modeled_bw_gbps or s.main.bandwidth_gbps)
                for s in self.scenarios]

    def latency_curve(self) -> List[Tuple[int, float]]:
        return [(s.n_stressors, s.modeled_lat_ns or s.main.latency_ns)
                for s in self.scenarios]


class ValidationError(ValueError):
    pass


# ---------------------------------------------------------------------------


class CoreCoordinator:
    def __init__(self, pool_mgr: Optional[PoolManager] = None,
                 platform: Optional[Platform] = None,
                 backend: str = "auto",
                 device=None):
        """``device`` is ``"cuda"`` (the default) or ``"cpu"``; left
        None it is the given ``pool_mgr``'s device, else the card."""
        if device is None:
            device = pool_mgr.device if pool_mgr is not None else "cuda"
        self.device = resolve_device(device)
        if pool_mgr is not None and pool_mgr.device != self.device:
            raise ValueError(
                f"pool manager places on {pool_mgr.device}, coordinator "
                f"asked for {self.device}")
        self.platform = platform or (
            pool_mgr.platform if pool_mgr is not None
            else detect_platform(device=self.device))
        self.pools = pool_mgr or PoolManager(self.platform, self.device)
        if backend == "auto":
            backend = "cuda"
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS} or 'auto', "
                             f"got {backend!r}")
        self.backend = backend

    # -- Experiment Instantiator ----------------------------------------
    def validate(self, cfg: ExperimentConfig) -> None:
        for which, spec in (("main", cfg.main), ("stress", cfg.stress)):
            if spec.strategy not in _REGISTRY:
                raise ValidationError(
                    f"{which}: unknown strategy {spec.strategy!r}")
            pool = self.pools.pool(spec.pool)   # raises PoolError if absent
            if spec.strategy != "i" and spec.buffer_bytes > pool.available:
                raise ValidationError(
                    f"{which}: buffer {spec.buffer_bytes}B exceeds free "
                    f"space in pool {spec.pool} ({pool.available}B)")
        if cfg.iters <= 0:
            raise ValidationError("iters must be positive")
        n = cfg.scenarios if cfg.scenarios is not None \
            else self.platform.n_engines
        if not 1 <= n <= self.platform.n_engines:
            raise ValidationError(
                f"scenarios must be in [1, {self.platform.n_engines}]")

    # -- scenario ladder ----------------------------------------------------
    def run(self, cfg: ExperimentConfig) -> ExperimentResult:
        self.validate(cfg)
        n_scen = cfg.scenarios if cfg.scenarios is not None \
            else self.platform.n_engines
        result = ExperimentResult(cfg)

        main_pool = self.pools.pool(cfg.main.pool)
        stress_pool = self.pools.pool(cfg.stress.pool)

        measured: Optional[WorkloadResult] = None
        if self.backend == "cuda":
            wl = make_shaped_workload(cfg.main.strategy, main_pool,
                                      cfg.main.buffer_bytes,
                                      cfg.main.shape())
            try:
                measured = wl.run(cfg.iters)
            finally:
                wl.release()

        for k in range(n_scen):
            modeled = self._model_scenario(cfg, main_pool, stress_pool, k)
            main_res = measured if measured is not None else WorkloadResult(
                cfg.main.strategy, cfg.main.pool, cfg.main.buffer_bytes,
                cfg.iters, 0, 0.0, 0)
            result.scenarios.append(ScenarioResult(
                n_stressors=k,
                main=main_res,
                modeled_bw_gbps=modeled[0],
                modeled_lat_ns=modeled[1],
                stress_bw_gbps=modeled[2],
            ))
        # per-scenario/experiment teardown (paper §III-A step 6) is done by
        # wl.release() above; pools stay clean for the next experiment.
        return result

    def _model_scenario(self, cfg: ExperimentConfig, main_pool: MemoryPool,
                        stress_pool: MemoryPool,
                        k: int) -> Tuple[float, float, float]:
        obs_node = self._model_node(cfg.main, main_pool,
                                    other=cfg.stress, other_engines=k)
        stress_node = self._model_node(cfg.stress, stress_pool,
                                       other=cfg.main, other_engines=1)
        classes = [sim.ActivityClass(
            "obs", obs_node, cfg.main.strategy, 1,
            read_fraction=cfg.main.read_fraction,
            duty_cycle=cfg.main.duty_cycle, stride=cfg.main.stride)]
        if k and cfg.stress.strategy != "i":
            classes.append(sim.ActivityClass(
                "stress", stress_node, cfg.stress.strategy, k,
                read_fraction=cfg.stress.read_fraction,
                duty_cycle=cfg.stress.duty_cycle,
                stride=cfg.stress.stride))
        res = sim.simulate_scenario(self.platform, classes)
        obs = res.get("obs")
        stress = res.get("stress")
        return (obs.bw_gbps if obs else 0.0,
                obs.lat_ns if obs else 0.0,
                stress.bw_gbps if stress else 0.0)

    # -- cache semantics ------------------------------------------------------
    _CACHEABLE = ("r", "w", "l", "c", "b")

    def _model_node(self, spec: ActivitySpec, pool: MemoryPool,
                    other: Optional[ActivitySpec] = None,
                    other_engines: int = 0):
        """Where does this activity's traffic actually land?

        Cacheable strategies on small buffers hit the platform's cache
        (the transparent shared L2 of the H100 and of the ZCU102; private
        on-chip residency on a tree without a cache node) — UNLESS, for
        a *shared* cache, the combined cacheable footprint exceeds it
        (inter-engine evictions, the red case of Fig. 12)."""
        node = pool.node
        if node.kind in ("vmem", "cache"):
            return node
        if spec.strategy not in self._CACHEABLE:
            return node

        cache_name = getattr(self.platform, "cache_node", None)
        if cache_name:                     # transparent shared cache
            cache = self.platform.memories[cache_name]
            if spec.buffer_bytes > cache.size_bytes:
                return node
            footprint = spec.buffer_bytes
            if other is not None and other.strategy in self._CACHEABLE:
                other_pool = self.pools.pool(other.pool)
                if other_pool.node.kind not in ("vmem", "cache"):
                    footprint += other_engines * other.buffer_bytes
            return cache if footprint <= cache.size_bytes else node

        # no cache node: private on-chip residency, no cross-engine eviction
        vmem = self.platform.memories.get("vmem")
        if vmem is not None and models_as_vmem(spec.buffer_bytes):
            return vmem
        return node

    # -- ladder sweep ---------------------------------------------------------
    def ladder(self, main: ActivitySpec, stress: ActivitySpec,
               iters: int = 500) -> ExperimentResult:
        return self.run(ExperimentConfig(main=main, stress=stress,
                                         iters=iters))

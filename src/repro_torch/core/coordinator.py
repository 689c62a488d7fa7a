"""Core Coordinator — scenario ladders with the barrier "sandwich".

Mirrors the paper's §III-D: an *Experiment Instantiator* validates the
configuration and binds workloads; a *Multi-Engine Synchronizer* enforces
the four measurement invariants.  On the card the synchronizer is one
persistent kernel (``kernels/csrc/contention.cu``) in which an engine is
a disjoint group of CTAs, one CTA an SM: engine 0 runs the observed
activity, engines 1..k the stressors, and every rung sample sits between
two barriers over global-memory counters — the paper's spin-lock
sandwich:

  (1) measurement starts only after every engine passed the start
      barrier;
  (2) the scenario is stable: one launch, every engine resident;
  (3) the stop barrier completes only after every engine's activity
      finished — measurement closes before teardown;
  (4) the next rung sample starts only behind the previous one's stop
      barrier, inside the same launch.

Backends:

``simulate``  nothing executes; every rung is modeled.
``cuda``      the observed activity's hand-written CUDA kernel really
              runs (its plain PyTorch version on ``device="cpu"``);
              contended rungs come from the model.  The counterpart of
              the JAX package's ``tpu`` / ``interpret`` backends.
``spmd``      *executes* the contention ladders: observer + coupled
              sibling observers + live stressor engines in one launch of
              the ladder kernel, stamped by the card's ``%globaltimer``
              (the plain version engine by engine on ``device="cpu"``).
``auto``      is ``cuda``.  It never resolves to ``simulate``: asked
              for the card where there is none, the coordinator raises.

:meth:`CoreCoordinator.run_matrix` runs a scenario matrix on any
backend.  On ``cuda`` same-signature observers are measured together, one
launch over a leading member axis per group.  On ``spmd`` the machinery
is the explicit plan -> build -> dispatch -> assemble pipeline of
:mod:`repro_torch.core.exec`: the default dispatch mode
(``spmd_dispatch="batched"``) stacks same-signature ladders into ONE
launch per group and, when the engines are enough (``spmd_pack="auto"``),
runs several shallow ladders side by side on disjoint engine subsets of
that launch, each subset with its own barriers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import compat
from repro_torch.compat import resolve_device
from repro_torch.core import simulate as sim
from repro_torch.core.devicetree import Platform, detect_platform
from repro_torch.core.exec import journal as exec_journal
from repro_torch.core.exec import plan as exec_plan
from repro_torch.core.exec import resilience as exec_resilience
from repro_torch.core.exec.assemble import (MatrixResult, ScenarioResult,
                                            ScenarioRun, assemble_runs)
from repro_torch.core.exec.dispatch import Dispatcher, DispatchStats
from repro_torch.core.pools import MemoryPool, PoolManager
from repro_torch.core.scenarios import (ObserverSpec, ScenarioSpec,
                                        StressorSpec, TrafficShape)
from repro_torch.core.workloads import (_REGISTRY, WorkloadResult,
                                        make_shaped_workload, measure_group,
                                        models_as_vmem)

__all__ = [
    "ActivitySpec", "CoreCoordinator", "DispatchStats", "ExperimentConfig",
    "ExperimentResult", "MatrixResult", "ScenarioResult", "ScenarioRun",
    "ValidationError",
]

BACKENDS = ("simulate", "cuda", "spmd")

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
    # built spmd programs kept per coordinator (LRU), the JAX package's
    # count.  Each entry holds its placed operands (three (engines,
    # rows, 128) tensors at the widest role: 24 GiB at eight 1 GiB
    # roles), so the cache also evicts by their bytes against what the
    # card has free, before each build (exec.dispatch.ProgramCache).
    _SPMD_CACHE_CAP = 32

    def __init__(self, pool_mgr: Optional[PoolManager] = None,
                 platform: Optional[Platform] = None,
                 backend: str = "auto",
                 device=None,
                 spmd_dispatch: str = "batched",
                 spmd_samples: int = 3,
                 spmd_cache_cap: Optional[int] = None,
                 spmd_pack: str = "auto",
                 faults=None,
                 retry: Optional[exec_resilience.RetryPolicy] = None,
                 quality="auto"):
        """``device`` is ``"cuda"`` (the default) or ``"cpu"``; left
        None it is the given ``pool_mgr``'s device, else the card.

        The ``spmd_*``, ``faults``, ``retry`` and ``quality`` arguments
        configure the ``spmd`` backend, with the JAX package's defaults.
        What fills its rungs follows from the device alone: the ladder
        kernel on the card (after :func:`compat.kernels_supported`, which
        raises instead of falling back), its plain version on
        ``device="cpu"``.  The JAX package's ``spmd_activity`` has no
        counterpart: neither can stand in for the other."""
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
        # sweep dispatch granularity: "batched" (default) stacks
        # same-signature ladders into ONE launch per group, "ladder"
        # one ladder per launch, "rung" the host-timed one-launch-per-
        # rung path
        if spmd_dispatch not in ("batched", "ladder", "rung"):
            raise ValueError(f"spmd_dispatch must be 'batched', 'ladder' "
                             f"or 'rung', got {spmd_dispatch!r}")
        if spmd_samples < 1:
            raise ValueError(f"spmd_samples must be >= 1, got {spmd_samples}")
        # engine-subset width-packing (the planner transform): "auto"
        # packs same-signature shallow ladders side by side whenever
        # the engines are at least twice a ladder's width ("off"
        # disables; bools accepted).  A packed launch still counts ONE
        # host sync for its whole group.
        if isinstance(spmd_pack, bool):
            spmd_pack = "auto" if spmd_pack else "off"
        if spmd_pack not in ("auto", "off"):
            raise ValueError(f"spmd_pack must be 'auto' or 'off', got "
                             f"{spmd_pack!r}")
        self.spmd_dispatch = spmd_dispatch
        self.spmd_samples = spmd_samples
        self.spmd_pack = spmd_pack
        self.spmd_cache_cap = (spmd_cache_cap if spmd_cache_cap
                               is not None else self._SPMD_CACHE_CAP)
        if self.spmd_cache_cap < 1:
            raise ValueError(f"spmd_cache_cap must be >= 1, got "
                             f"{self.spmd_cache_cap}")
        # resilience wiring (exec.resilience): deterministic fault
        # injection (None reads REPRO_FAULT_SPEC), retry/degradation
        # policy, and the per-rung measurement quality gate
        self.fault_spec = exec_resilience.resolve_faults(faults)
        self.retry_policy = retry or exec_resilience.RetryPolicy()
        self.quality_gate = exec_resilience.resolve_gate(quality)
        # the spmd backend's engines: the platform's ladder width, at most
        # one an SM, each of sm_count // engines CTAs, one on each SM
        # (132 // 8 = 16 on an H100 SXM; the remaining SMs idle).  On the
        # CPU the platform's width, of one "CTA" each.
        n = max(1, self.platform.n_engines)
        if self.device.type == "cuda":
            sms = torch.cuda.get_device_properties(
                self.device).multi_processor_count
            self._engines = min(n, sms)
            self._ctas = max(1, sms // self._engines)
        else:
            self._engines, self._ctas = n, 1
        # stage 3 of the exec pipeline: program/operand LRU, launch,
        # fence check, decode
        self._dispatcher = Dispatcher(
            self.spmd_cache_cap, spmd_samples, device=self.device,
            ctas_per_engine=self._ctas,
            faults=(self.fault_spec.injector() if self.fault_spec
                    else None))

    def _spmd_engines(self) -> int:
        """Engines of one ladder launch."""
        return self._engines

    def _ctas_per_engine(self) -> int:
        """CTAs of one engine, one on each SM."""
        return self._ctas

    def _resolved_activity(self) -> str:
        """The rung-activity implementation the spmd backend will use:
        on the card the kernels, after the probe (which raises when they
        do not build or run); on the CPU their plain versions."""
        if self.device.type != "cuda":
            return "plain"
        compat.kernels_supported(self.device)
        return "cuda"

    # the spmd program cache (LRU, coordinator lifetime; the storage
    # lives on the Dispatcher)
    @property
    def _spmd_programs(self):
        return self._dispatcher.cache.entries

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

    # ==================================================================
    # ScenarioSpec matrix execution (the v2 characterization engine)
    # ==================================================================

    def validate_spec(self, spec: ScenarioSpec) -> None:
        # exact-duplicate observers would alias one curve key per
        # buffer and silently overwrite each other's ladders in
        # CurveDB — reject up front (observers differing in ANY field
        # are legitimate twins and key distinctly via the buf= suffix)
        seen = set()
        for obs in spec.observers:
            if obs in seen:
                raise ValidationError(
                    f"{spec.name}: duplicate observer "
                    f"({obs.pool}:{obs.strategy}"
                    f"{'@' + obs.shape.tag() if obs.shape.tag() else ''}, "
                    f"buffers={obs.buffers}) — its curves would alias "
                    f"the first occurrence's keys")
            seen.add(obs)
        for obs in spec.observers:
            if obs.strategy not in _REGISTRY:
                raise ValidationError(
                    f"{spec.name}: unknown observer strategy "
                    f"{obs.strategy!r}")
            pool = self.pools.pool(obs.pool)
            for b in obs.buffers:
                if obs.strategy != "i" and b > pool.available:
                    raise ValidationError(
                        f"{spec.name}: observer buffer {b}B exceeds pool "
                        f"{obs.pool} ({pool.available}B free)")
        for s in spec.stressors:
            if s.strategy not in _REGISTRY:
                raise ValidationError(
                    f"{spec.name}: unknown stressor strategy "
                    f"{s.strategy!r}")
            self.pools.pool(s.pool)
        if spec.iters <= 0:
            raise ValidationError(f"{spec.name}: iters must be positive")
        if spec.max_stressors is not None and not (
                0 <= spec.max_stressors < self.platform.n_engines):
            raise ValidationError(
                f"{spec.name}: max_stressors out of "
                f"[0, {self.platform.n_engines})")

    def _obs_activity(self, observer: ObserverSpec,
                      buffer_bytes: int) -> ActivitySpec:
        sh = observer.shape
        return ActivitySpec(
            observer.strategy, observer.pool, buffer_bytes,
            read_fraction=(sh.read_fraction if sh.kind == "mixed"
                           else None),
            duty_cycle=sh.duty_cycle, stride=sh.stride)

    def _model_spec_scenario(self, spec: ScenarioSpec,
                             observer: ObserverSpec, buffer_bytes: int,
                             k: int) -> Tuple[float, float, float]:
        """Model one rung: one observer + k stress engines distributed
        round-robin over the stressor ensemble — plus, for a *coupled*
        multi-observer scenario, one always-on single-engine class per
        sibling observer (:func:`sim.co_observer_class`).
        ``spec.coupled=False`` keeps the historical stressor-only
        semantics."""
        obs_act = self._obs_activity(observer, buffer_bytes)
        obs_pool = self.pools.pool(observer.pool)
        first = spec.stressors[0] if spec.stressors else None
        obs_node = self._model_node(
            obs_act, obs_pool,
            other=ActivitySpec.from_stressor(first) if first else None,
            other_engines=k)
        classes = [sim.ActivityClass(
            "obs", obs_node, obs_act.strategy, 1,
            read_fraction=obs_act.read_fraction,
            duty_cycle=obs_act.duty_cycle, stride=obs_act.stride)]
        for j, sib in enumerate(self._coupled_siblings(spec, observer)):
            if sib.strategy == "i":
                continue
            act = self._obs_activity(sib, sib.buffers[0])
            node = self._model_node(act, self.pools.pool(sib.pool),
                                    other=obs_act, other_engines=1)
            classes.append(sim.co_observer_class(
                f"co{j}", node, act.strategy,
                read_fraction=act.read_fraction,
                duty_cycle=act.duty_cycle, stride=act.stride))
        m = len(spec.stressors)
        if k and m:
            share = [k // m + (1 if j < k % m else 0) for j in range(m)]
            for j, (s, e) in enumerate(zip(spec.stressors, share)):
                if e == 0 or s.strategy == "i":
                    continue
                act = ActivitySpec.from_stressor(s)
                node = self._model_node(act, self.pools.pool(s.pool),
                                        other=obs_act, other_engines=1)
                classes.append(sim.ActivityClass(
                    f"stress{j}", node, s.strategy, e,
                    read_fraction=act.read_fraction,
                    duty_cycle=act.duty_cycle, stride=act.stride))
        res = sim.simulate_scenario(self.platform, classes)
        obs = res.get("obs")
        stress_bw = sum(r.bw_gbps for n, r in res.items()
                        if n.startswith("stress"))
        return (obs.bw_gbps if obs else 0.0,
                obs.lat_ns if obs else 0.0,
                stress_bw)

    @staticmethod
    def _coupled_siblings(spec: ScenarioSpec,
                          observer: ObserverSpec) -> Tuple[ObserverSpec, ...]:
        """The sibling observers sharing this observer's measured
        region (the logic lives on :meth:`ScenarioSpec.coupled_siblings`
        so the sweep-level grouping signature can reuse it)."""
        return spec.coupled_siblings(observer)

    def _ladder_depth(self, spec: ScenarioSpec) -> int:
        mesh = self._spmd_engines() if self.backend == "spmd" else None
        return exec_plan.ladder_depth(spec, self.platform.n_engines,
                                      mesh)

    def run_matrix(self, specs: List[ScenarioSpec], *,
                   batched: bool = True, journal=None) -> MatrixResult:
        """Execute a scenario matrix.

        The measured observer pass is where the ``cuda`` backend spends
        its launches; ``batched=True`` groups same-signature observers
        (strategy, shape, buffer, iters, residency, effective memory
        placement — :func:`repro_torch.core.exec.plan.observer_groups`)
        and measures each group with ONE launch over a leading member
        axis, instead of the naive one-measurement-per-scenario loop.
        Multi-observer scenarios contribute one ladder per (observer,
        buffer) and their observers join the same signature groups.

        Backends: ``simulate``/``cuda`` model the contention ladder per
        rung (``cuda`` additionally measures the uncontended observer);
        ``spmd`` *executes* every rung its engines can hold and its
        curves carry ``source == "executed"``.  On ``spmd``
        ``batched=True`` (with ``spmd_dispatch="batched"``) stacks
        same-signature ladders into ONE launch per group — and
        width-packs shallow groups onto disjoint engine subsets
        (``spmd_pack``) — so a sweep costs one host-synchronous launch
        per distinct signature; ``batched=False`` degrades to one launch
        per ladder.  Every curve's ``execution`` provenance records the
        backend, executed-vs-modeled rungs, the effective ``coupled``
        state, and the ``activity`` that ran: ``"cuda"`` when the
        hand-written kernels ran on the card, ``"plain"`` when their
        plain PyTorch versions ran (``device="cpu"``), ``"none"`` on
        ``simulate``; on ``spmd`` also the verified ``fenced`` state,
        the ``timing_source``, ``batched``/``group_size`` and the
        width-packing slot ``packed``/``subset_width``/``subset_index``.

        Execution on ``spmd`` is resilient
        (:mod:`repro_torch.core.exec.resilience`): a failed launch
        retries with backoff, degrades down the
        packed->batched->ladder->rung->modeled ladder isolated to its
        signature group, and noisy rungs re-measure under the quality
        gate; pass ``journal=<path>`` (fused paths) to make the sweep
        crash-resumable via a :class:`SweepJournal` sidecar.  Other
        backends model their rungs and have nothing to resume:
        ``journal=`` raises there."""
        if journal is not None and self.backend != "spmd":
            raise ValidationError(
                "journal= requires the spmd backend (other backends "
                "model and have nothing to resume)")
        for spec in specs:
            self.validate_spec(spec)
        triples = [(spec, obs, b) for spec in specs
                   for obs in spec.observers for b in obs.buffers]
        stats = DispatchStats(n_scenarios=len(specs),
                              n_ladders=len(triples))

        measured: Dict[int, WorkloadResult] = {}
        executed: Dict[Tuple[int, int], WorkloadResult] = {}
        fenced_by_triple: Dict[int, bool] = {}
        timing_by_triple: Dict[int, Dict[str, Any]] = {}
        if self.backend == "cuda":
            activity = "cuda" if self.device.type == "cuda" else "plain"
            measured = self._measure_triples(triples, batched, stats)
        elif self.backend == "spmd":
            activity = self._resolved_activity()
            executed, fenced_by_triple, timing_by_triple = \
                self._execute_spmd(triples, stats, activity,
                                   batched=batched, journal=journal)
        else:
            activity = "none"       # nothing executes on this backend

        spmd = self.backend == "spmd"
        runs = assemble_runs(
            triples, backend=self.backend, activity=activity,
            stats=stats, depth_fn=self._ladder_depth,
            model_fn=self._model_spec_scenario, measured=measured,
            executed=executed, fenced_by_triple=fenced_by_triple,
            timing_by_triple=timing_by_triple,
            n_engines=self._spmd_engines() if spmd else None,
            operand_kinds_fn=self._operand_memory_kinds if spmd else None)
        return MatrixResult(runs=runs, stats=stats)

    def _operand_memory_kinds(self, spec: ScenarioSpec,
                              obs: ObserverSpec) -> List[str]:
        return sorted(
            {self.pools.pool(p).effective_memory_kind() or "default"
             for p in ([obs.pool]
                       + [o.pool for o in
                          self._coupled_siblings(spec, obs)]
                       + [s.pool for s in spec.stressors])})

    def _measure_triples(self, triples, batched: bool,
                         stats: DispatchStats) -> Dict[int, WorkloadResult]:
        """The measured observer pass over all (spec, observer, buffer)
        triples (uncontended: one observer on the card at a time)."""
        measured: Dict[int, WorkloadResult] = {}
        if not batched:
            for i, (spec, obs, buf) in enumerate(triples):
                wl = make_shaped_workload(
                    obs.strategy, self.pools.pool(obs.pool), buf,
                    obs.shape)
                try:
                    measured[i] = wl.run(spec.iters)
                finally:
                    wl.release()
                stats.measure_dispatches += 1
            return measured

        groups = exec_plan.observer_groups(triples, self.pools)
        for (strategy, shape, buf, iters, _kind, _vm), idxs in \
                groups.items():
            member_pools = [self.pools.pool(triples[i][1].pool)
                            for i in idxs]
            results, dispatches = measure_group(
                strategy, member_pools[0], buf, len(idxs), iters,
                shape=shape, member_pools=member_pools)
            stats.measure_dispatches += dispatches
            for i, res in zip(idxs, results):
                measured[i] = res
        return measured

    # -- the spmd backend: executable multi-engine contention -----------

    def _execute_spmd(
        self, triples, stats: DispatchStats, activity: str,
        batched: bool = True, journal=None,
    ) -> Tuple[Dict[Tuple[int, int], WorkloadResult], Dict[int, bool],
               Dict[int, Dict[str, Any]]]:
        """Execute every (spec, observer, buffer) triple's contention
        ladder through the exec pipeline: the planner builds a
        DispatchPlan (one launch per same-signature group when
        ``spmd_dispatch="batched"``, per triple under ``"ladder"``),
        width-packing re-plans shallow groups onto disjoint engine
        subsets, and the resilient executor
        (:mod:`repro_torch.core.exec.journal`) builds, runs, verifies the
        fence of, retries/degrades and optionally journals each planned
        dispatch (``"rung"`` is the host-timed one-launch-per-rung
        path).  Returns per-(triple, rung) observer results, per-triple
        verified fence state, and per-triple timing provenance."""
        n_eng = self._spmd_engines()
        if n_eng < 2:
            raise ValidationError(
                "spmd backend needs >= 2 engines (the platform's "
                "n_engines and, on the card, its SMs)")
        # the JAX package falls back to "rung" where it has no in-dispatch
        # clock; the port always has one (%globaltimer on the card, the
        # host's clock for the plain version)
        dispatch = self.spmd_dispatch
        if dispatch == "batched" and not batched:
            dispatch = "ladder"       # megabatching explicitly disabled
        if dispatch in ("batched", "ladder"):
            plan = exec_plan.build_plan(
                triples, n_eng, self.pools, self.platform.n_engines,
                grouped=(dispatch == "batched"))
            if dispatch == "batched":
                stats.spmd_groups += len(plan.dispatches)
                if self.spmd_pack == "auto":
                    plan = exec_plan.pack_engine_subsets(plan)
            return exec_journal.execute_plan(
                self._dispatcher, plan, n_eng=n_eng, activity=activity,
                mode=dispatch, stats=stats, policy=self.retry_policy,
                gate=self.quality_gate, journal=journal)
        if journal is not None:
            raise ValidationError(
                "journal= needs a fused dispatch path "
                "(spmd_dispatch='batched' or 'ladder'), not 'rung'")
        return exec_journal.execute_rung_path(
            self._dispatcher, triples, n_eng=n_eng, activity=activity,
            stats=stats, depth_fn=self._ladder_depth, pools=self.pools,
            policy=self.retry_policy, gate=self.quality_gate)

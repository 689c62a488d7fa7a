"""Adversarial worst-case contention search over the surface space.

Fixed characterization grids (``characterize_surface``) find *average*
corners; production placement needs the worst ones.  This module hunts
peak-interference configurations over the full probe coordinate space —
the :class:`SurfaceCoord` axes (``n_stressors``, ``rw_ratio``,
``inject_rate``) plus the remaining :class:`TrafficShape` knobs the
surface does not sweep (stressor strategy, chase stride) — with a
model-seeded acquisition loop instead of a sweep:

* the **prior** is the Bard–Schweitzer queueing model
  (:func:`repro_torch.core.simulate.simulate_scenario`), calibrated to
  a measured CurveDB edge when one is supplied
  (:func:`~repro_torch.core.simulate.calibrate_to_surface`);
* the strategy/stride knobs form a small set of **arms** played by a
  UCB bandit (one arm per iteration, so every probe of a batch shares
  one chain requirement and legally stacks — see
  :func:`repro_torch.core.exec.plan.probe_batch`);
* within the chosen arm, lattice-sampled candidate coordinates are
  ranked by *acquired badness*: the model's predicted badness times a
  kernel-weighted measured/model residual correction times a novelty
  bonus for unexplored regions;
* each iteration executes as exactly ONE re-planned batched dispatch
  through the existing plan -> program -> fence -> dispatch -> assemble
  pipeline (``DispatchStats.host_sync_dispatches`` grows by one per
  iteration — asserted);
* the result is a per-observer **worst-case envelope**: a 1-axis
  (``n_stressors``) surface of the worst bandwidth/latency found at
  each stressor count, emitted into CurveDB under
  ``SurfaceKey(qualifier="worstcase")`` with full provenance
  (acquisition trace, probes executed, model-vs-measured gap per
  iteration).  ``PlacementAdvisor(pessimistic=True)`` advises against
  this envelope instead of the mean surface.

*Badness* is normalized per observer strategy so one bandit can rank
both: ``edge_bw / bw`` for bandwidth observers, ``lat / edge_lat`` for
latency observers (both ~1 uncontended, larger = worse), with the edge
taken from the (calibrated) model's own uncontended corner.

Determinism: every acquisition decision draws from one
``random.Random(spec.seed)`` stream and all scoring is pure arithmetic,
so two searches against the same CurveDB produce byte-identical
envelopes — on the modeled path (``execute=False``) bit-for-bit,
including across a save/load round-trip of the database.

A copy of the JAX package's ``repro/core/search.py`` with its imports
re-pointed: on the modeled path its envelopes, points and trace are
byte-identical to the reference's for the same spec and platform tree.
One decided change: ``execute=None`` follows the coordinator's backend
alone.  A ``spmd`` coordinator probes (on the card, each iteration is one
launch of the hand-written ladder kernel, ``kernels/csrc/contention.cu``;
on ``device="cpu"`` its plain version), every other backend models.  The
reference asks JAX for two devices or more and models otherwise; the port
never degrades to the model outside the resilience ladder's own
``modeled_floor``: a card that fails raises.
"""
from __future__ import annotations

import logging
import math
import random
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.characterize import (AXIS_N, CurveDB, Surface,
                                           SurfaceAxis, SurfaceKey)
from repro_torch.core.exec import plan as exec_plan
from repro_torch.core.exec import resilience as exec_resilience
from repro_torch.core.exec.assemble import observer_result
from repro_torch.core.exec.dispatch import DispatchStats
from repro_torch.core.scenarios import (ObserverSpec, ScenarioSpec,
                                        StressorSpec, TrafficShape)
from repro_torch.core.simulate import (ActivityClass, _modeled_edge,
                                       calibrate_to_surface,
                                       simulate_scenario)

log = logging.getLogger(__name__)

#: structured SurfaceKey qualifier the envelope is stored under
WORSTCASE_QUALIFIER = "worstcase"


# ---------------------------------------------------------------------------
# The search space
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SearchArm:
    """One discrete stressor-shape choice (strategy + chase stride).

    Arms quantize the knobs the surface's continuous axes do not carry.
    A probe batch plays ONE arm so all its stressors share a single
    pointer-chain requirement (mixed strides cannot share one operand —
    ``plan.merge_probe_operand_roles`` would refuse the batch)."""
    strategy: str
    stride: int = 1

    def label(self) -> str:
        return (f"{self.strategy}/st{self.stride}"
                if self.strategy == "t" else self.strategy)

    def shape(self, rw: float, ir: float) -> TrafficShape:
        if self.strategy == "t":
            return TrafficShape(kind="strided", stride=self.stride,
                                duty_cycle=ir)
        if self.strategy in ("w", "x", "y"):    # pure-write streams
            return TrafficShape.burst(ir) if ir != 1.0 else \
                TrafficShape.steady()
        return TrafficShape.traffic(rw, ir)

    def read_fraction(self, rw: float) -> Optional[float]:
        """The model-class read fraction this arm honours (mixed
        streams take the coordinate; pure strategies keep their native
        traffic multiplier)."""
        return rw if self.strategy in ("b", "c") else None


DEFAULT_ARMS: Tuple[SearchArm, ...] = (
    SearchArm("b"),             # mixed stream: rw_ratio is live
    SearchArm("y"),             # posted write stream (2x MLP)
    SearchArm("t", 8),          # default-stride pointer chase
    SearchArm("t", 64),         # locality-defeating wide chase
)


@dataclass(frozen=True)
class SearchSpec:
    """Budget, space bounds and every random choice's seed.

    The probe budget is ``iterations * batch`` coordinates (each
    coordinate is measured under every observer strategy inside the
    same batched dispatch)."""
    pool: str = "hbm"
    stress_pool: Optional[str] = None
    obs_strategies: Tuple[str, ...] = ("r", "l")
    iterations: int = 4
    batch: int = 4
    max_stressors: Optional[int] = None
    buffer_bytes: int = 256 << 10
    iters: int = 20
    seed: int = 0
    arms: Tuple[SearchArm, ...] = DEFAULT_ARMS
    explore: float = 0.35       # novelty bonus weight
    ucb: float = 0.8            # bandit exploration constant
    rw_step: float = 0.125      # rw_ratio lattice pitch
    ir_min: float = 0.25        # inject_rate lattice floor
    ir_step: float = 0.125


@dataclass(frozen=True)
class ProbePoint:
    """One executed (or modeled) probe: a full coordinate plus what was
    measured there and what the prior predicted."""
    iteration: int
    arm: str
    strategy: str
    stride: int
    n_stressors: int
    rw_ratio: float
    inject_rate: float
    obs_strat: str
    bandwidth_gbps: float
    latency_ns: float
    model_badness: float
    measured_badness: float

    def to_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in (
            "iteration", "arm", "strategy", "stride", "n_stressors",
            "rw_ratio", "inject_rate", "obs_strat", "bandwidth_gbps",
            "latency_ns", "model_badness", "measured_badness")}


@dataclass
class SearchResult:
    spec: SearchSpec
    envelope: Dict[SurfaceKey, Surface]
    points: List[ProbePoint]
    trace: List[Dict[str, Any]]
    stats: DispatchStats
    fenced: bool
    executed: bool

    def worst(self, obs_strat: str) -> ProbePoint:
        """The single worst probe found for one observer strategy."""
        pts = [p for p in self.points if p.obs_strat == obs_strat]
        if not pts:
            raise KeyError(f"no probes for observer {obs_strat!r}")
        return max(pts, key=lambda p: p.measured_badness)

    def install(self, db: CurveDB) -> List[SurfaceKey]:
        """Emit the envelope into ``db`` (same Surface/SurfaceKey API
        the mean surfaces use)."""
        for k, s in self.envelope.items():
            db.surfaces[k] = s
        return sorted(self.envelope)


# ---------------------------------------------------------------------------
# The model prior
# ---------------------------------------------------------------------------


def _model_rates(platform, pool: str, sp: str, ostrat: str, arm: SearchArm,
                 n: int, rw: float, ir: float) -> Tuple[float, float]:
    """(bw_gbps, lat_ns) the queueing model predicts for one observer
    under ``n`` arm-shaped stressors."""
    classes = [ActivityClass("obs", platform.memories[pool], ostrat, 1)]
    if n > 0:
        classes.append(ActivityClass(
            "stress", platform.memories[sp], arm.strategy, n,
            read_fraction=arm.read_fraction(rw), duty_cycle=ir,
            stride=arm.stride))
    res = simulate_scenario(platform, classes)["obs"]
    return res.bw_gbps, res.lat_ns


def _badness(ostrat: str, bw: float, lat: float,
             edges: Tuple[float, float]) -> float:
    """Normalized how-bad-is-this-corner: ~1 uncontended, larger =
    worse, comparable across observer strategies."""
    e_bw, e_lat = edges
    if ostrat == "l":
        return lat / max(e_lat, 1e-12)
    return e_bw / max(bw, 1e-12)


# ---------------------------------------------------------------------------
# Acquisition
# ---------------------------------------------------------------------------

_KERNEL_H = 0.2     # residual kernel width in normalized coordinates


def _coord_vec(arm_idx: int, n: int, rw: float, ir: float, max_n: int,
               n_arms: int) -> Tuple[float, ...]:
    return (arm_idx / max(1, n_arms - 1), n / max(1, max_n), rw, ir)


def _residual(observations, vec, ostrat: str) -> float:
    """Kernel-weighted mean of measured/model badness ratios near
    ``vec`` — the acquisition's learned correction of the prior."""
    num = den = 0.0
    for o_vec, o_strat, ratio in observations:
        if o_strat != ostrat:
            continue
        d2 = sum((a - b) ** 2 for a, b in zip(vec, o_vec))
        w = math.exp(-d2 / (2.0 * _KERNEL_H * _KERNEL_H))
        num += w * ratio
        den += w
    return num / den if den > 1e-12 else 1.0


def _novelty(observations, vec) -> float:
    """Distance to the nearest observation, saturated to [0, 1]."""
    if not observations:
        return 1.0
    d2min = min(sum((a - b) ** 2 for a, b in zip(vec, o_vec))
                for o_vec, _strat, _ratio in observations)
    return min(1.0, 4.0 * math.sqrt(d2min))


def _lattice_draw(rng: random.Random, spec: SearchSpec,
                  max_n: int) -> Tuple[int, float, float]:
    n = rng.randint(1, max_n)
    rw = round(rng.randint(0, int(round(1.0 / spec.rw_step)))
               * spec.rw_step, 6)
    ir_steps = int(round((1.0 - spec.ir_min) / spec.ir_step))
    ir = round(spec.ir_min + rng.randint(0, ir_steps) * spec.ir_step, 6)
    return n, rw, ir


# ---------------------------------------------------------------------------
# Probe execution (one batched dispatch per call)
# ---------------------------------------------------------------------------


def _probe_scenario(spec: SearchSpec, arm: SearchArm, ostrat: str, sp: str,
                    n: int, rw: float, ir: float, max_n: int,
                    it: int) -> ScenarioSpec:
    shape = arm.shape(rw, ir)
    tag = shape.tag()
    name = (f"wc{it}.{spec.pool}.{ostrat}|{sp}.{arm.strategy}"
            + (f"@{tag}" if tag else "") + f".n{n}")
    return ScenarioSpec(
        name=name,
        observer=ObserverSpec(ostrat, spec.pool, (spec.buffer_bytes,)),
        stressors=(StressorSpec(arm.strategy, sp, spec.buffer_bytes,
                                shape),),
        iters=spec.iters, max_stressors=max_n)


def plan_probes(coord, spec: SearchSpec, arm: SearchArm, cands, *,
                it: int = 0) -> exec_plan.PlannedDispatch:
    """The one probe batch that :func:`measure_candidates` launches for
    the (n, rw, ir) ``cands`` under ``arm``: every candidate under every
    observer strategy, in that order, packed by
    :func:`repro_torch.core.exec.plan.probe_batch` for ``coord``'s
    engines."""
    sp = spec.stress_pool or spec.pool
    max_n = _max_stressors(coord, spec, executed=True)
    probes = []
    for n, rw, ir in cands:
        for o in spec.obs_strategies:
            ps = _probe_scenario(spec, arm, o, sp, n, rw, ir, max_n, it)
            probes.append((ps, ps.observer, ps.observer.buffers[0], n))
    return exec_plan.probe_batch(probes, coord._spmd_engines(), coord.pools,
                                 coord.platform.n_engines)


def measure_candidates(coord, spec: SearchSpec, arm: SearchArm, cands,
                       *, it: int = 0, stats: Optional[DispatchStats] = None,
                       ) -> Tuple[Dict[Tuple[int, str],
                                       Tuple[float, float]], bool]:
    """Measure every (n, rw, ir) candidate under every observer strategy
    with ONE host-synchronous batched dispatch
    (:func:`repro_torch.core.exec.plan.probe_batch`).  Returns
    ``({(cand_index, obs_strat): (bw_gbps, lat_ns) | None}, fenced)``
    — a ``None`` value is a DEAD probe: its dispatch exhausted the
    resilience ladder (see :mod:`repro_torch.core.exec.resilience`) and
    the caller must treat the arm as unplayed rather than fold a modeled
    number into the acquisition state.

    This is the only execution path of the search — the JAX package's
    equal-budget fixed-grid baseline (``benchmarks/worstcase_search.py``)
    measures its grid through the same call, so search and baseline pay
    the same per-probe cost.  On a clean dispatch (no faults, retries,
    degradations or re-measures) the 1-host-sync accounting is still
    asserted exactly."""
    stats = stats if stats is not None else DispatchStats()
    n_eng = coord._spmd_engines()
    planned = plan_probes(coord, spec, arm, cands, it=it)
    before = stats.host_sync_dispatches
    dirty_before = (stats.faults_injected + stats.retried_dispatches
                    + stats.degraded_ladders + stats.noisy_remeasures)
    outcomes = exec_resilience.run_group(
        coord._dispatcher, planned, n_eng=n_eng,
        activity=coord._resolved_activity(), mode="batched",
        stats=stats, policy=getattr(coord, "retry_policy", None),
        gate=getattr(coord, "quality_gate", None))
    dirty = (stats.faults_injected + stats.retried_dispatches
             + stats.degraded_ladders + stats.noisy_remeasures
             - dirty_before)
    if not dirty and stats.host_sync_dispatches != before + 1:
        raise AssertionError(
            f"clean probe batch took "
            f"{stats.host_sync_dispatches - before} host syncs, "
            f"expected exactly 1")
    out: Dict[Tuple[int, str], Optional[Tuple[float, float]]] = {}
    fenced = True
    n_obs = len(spec.obs_strategies)
    for g, oc in enumerate(outcomes):
        ci, oi = divmod(g, n_obs)
        m = oc.med[0]
        if m is None:                   # probe died: modeled floor
            out[(ci, spec.obs_strategies[oi])] = None
            continue
        res = observer_result(oc.entry.observer, oc.entry.buffer_bytes,
                              oc.entry.spec.iters, float(max(m, 1.0)))
        out[(ci, spec.obs_strategies[oi])] = (res.bandwidth_gbps,
                                              res.latency_ns)
        fenced = fenced and oc.fenced
    return out, fenced


def _max_stressors(coord, spec: SearchSpec, *, executed: bool) -> int:
    cap = coord.platform.n_engines - 1
    if executed:
        cap = min(cap, coord._spmd_engines() - 1)
    if spec.max_stressors is not None:
        cap = min(cap, spec.max_stressors)
    return max(1, cap)


# ---------------------------------------------------------------------------
# The search loop
# ---------------------------------------------------------------------------


def worst_case_search(coord, spec: SearchSpec = SearchSpec(),
                      db: Optional[CurveDB] = None, *,
                      execute: Optional[bool] = None) -> SearchResult:
    """Hunt the worst contention corner within ``spec``'s budget.

    ``db`` (optional) calibrates the model prior to the measured
    surface edge before the search starts; the envelope can be
    installed back into the same database
    (:meth:`SearchResult.install`).  ``execute=None`` probes when the
    coordinator's backend is ``spmd`` (the ladder kernel on the card,
    its plain version on ``device="cpu"``) and models on every other
    backend; ``execute=False`` forces the deterministic modeled path
    (the acquisition loop runs identically — only the measurement is
    the model itself)."""
    platform = coord.platform
    if db is not None:
        try:
            platform = calibrate_to_surface(
                platform, db, pools=[spec.pool]).platform
        except (KeyError, ValueError) as exc:
            log.warning("worst_case_search: calibration skipped: %s", exc)
    if execute is None:
        execute = getattr(coord, "backend", None) == "spmd"
    sp = spec.stress_pool or spec.pool
    max_n = _max_stressors(coord, spec, executed=execute)
    edge = _modeled_edge(platform, spec.pool)
    edges = {o: edge for o in spec.obs_strategies}

    rng = random.Random(spec.seed)
    observations: List[Tuple[Tuple[float, ...], str, float]] = []
    points: List[ProbePoint] = []
    trace: List[Dict[str, Any]] = []
    stats = DispatchStats()
    fenced_all = True
    arm_plays = [0] * len(spec.arms)
    arm_value = [0.0] * len(spec.arms)

    for it in range(spec.iterations):
        # -- bandit: pick the arm (play each once, then UCB).  An arm
        # whose whole probe batch DIED never got a play recorded, so
        # the unplayed-first rule naturally replays it on the next
        # iteration instead of dividing by arm_plays == 0.
        unplayed = [i for i in range(len(spec.arms))
                    if arm_plays[i] == 0]
        if unplayed:
            ai = unplayed[0]
        else:
            total = sum(arm_plays)
            ai = max(range(len(spec.arms)),
                     key=lambda i: (arm_value[i] / arm_plays[i]
                                    + spec.ucb * math.sqrt(
                                        math.log(total) / arm_plays[i]),
                                    -i))
        arm = spec.arms[ai]

        # -- acquisition: rank lattice candidates under this arm --------
        seen, drawn = set(), []
        for _ in range(max(32, 8 * spec.batch)):
            c = _lattice_draw(rng, spec, max_n)
            if c not in seen:
                seen.add(c)
                drawn.append(c)
        scored = []
        for n, rw, ir in drawn:
            vec = _coord_vec(ai, n, rw, ir, max_n, len(spec.arms))
            model: Dict[str, Tuple[float, float, float]] = {}
            acq = 0.0
            for o in spec.obs_strategies:
                bw, lat = _model_rates(platform, spec.pool, sp, o, arm,
                                       n, rw, ir)
                mb = _badness(o, bw, lat, edges[o])
                model[o] = (bw, lat, mb)
                acq += (mb * _residual(observations, vec, o)
                        * (1.0 + spec.explore
                           * _novelty(observations, vec)))
            scored.append((acq, n, rw, ir, vec, model))
        scored.sort(key=lambda s: (-s[0], s[1], s[2], s[3]))
        chosen = scored[:spec.batch]

        # -- ONE batched dispatch for the whole iteration ---------------
        sync_before = stats.host_sync_dispatches
        if execute:
            results, fenced = measure_candidates(
                coord, spec, arm, [(n, rw, ir)
                                   for _a, n, rw, ir, _v, _m in chosen],
                it=it, stats=stats)
            fenced_all = fenced_all and fenced
        else:
            results = {(ci, o): model[o][:2]
                       for ci, (_a, _n, _rw, _ir, _v, model)
                       in enumerate(chosen) for o in spec.obs_strategies}

        # -- fold measurements back into the acquisition state ----------
        # (a dead probe — resilience ladder exhausted — contributes
        # nothing: folding its modeled floor would teach the bandit
        # the corner is harmless when in fact it is unmeasured)
        gaps: List[float] = []
        reward = 0.0
        alive = dead = 0
        for ci, (_acq, n, rw, ir, vec, model) in enumerate(chosen):
            for o in spec.obs_strategies:
                r = results[(ci, o)]
                if r is None:
                    dead += 1
                    continue
                bw, lat = r
                alive += 1
                mb = model[o][2]
                meas = _badness(o, bw, lat, edges[o])
                ratio = meas / max(mb, 1e-12)
                observations.append((vec, o, ratio))
                gaps.append(abs(ratio - 1.0))
                reward = max(reward, meas)
                points.append(ProbePoint(
                    iteration=it, arm=arm.label(),
                    strategy=arm.strategy, stride=arm.stride,
                    n_stressors=n, rw_ratio=rw, inject_rate=ir,
                    obs_strat=o, bandwidth_gbps=bw, latency_ns=lat,
                    model_badness=mb, measured_badness=meas))
        if alive:
            arm_plays[ai] += 1
            arm_value[ai] += reward
        trace.append({
            "iteration": it, "arm": arm.label(),
            "candidates": [[n, rw, ir]
                           for _a, n, rw, ir, _v, _m in chosen],
            "acquisition": [s[0] for s in chosen],
            "reward": reward,
            "model_gap": (sum(gaps) / len(gaps)) if gaps else 0.0,
            "host_sync_dispatches": (stats.host_sync_dispatches
                                     - sync_before if execute else 0),
            "dead_probes": dead,
        })

    envelope = _envelope(spec, sp, points, trace, executed=execute)
    if (execute and stats.resilience_clean()
            and stats.host_sync_dispatches != spec.iterations):
        raise AssertionError(
            f"search ran {stats.host_sync_dispatches} host syncs for "
            f"{spec.iterations} iterations — expected exactly one each")
    return SearchResult(spec=spec, envelope=envelope, points=points,
                        trace=trace, stats=stats, fenced=fenced_all,
                        executed=bool(execute))


def _envelope(spec: SearchSpec, sp: str, points: List[ProbePoint],
              trace: List[Dict[str, Any]], *,
              executed: bool) -> Dict[SurfaceKey, Surface]:
    """Per-observer worst-case envelope: the worst probe at each
    visited stressor count, as a 1-axis surface under the
    ``worstcase`` qualifier.  The stressor strategy in the key is the
    canonical ``"b"`` so the placement resolution ladder (which walks
    ``(strategy, "b")``) finds the envelope for ANY nominal stressor
    letter — the search already maximized over strategies."""
    out: Dict[SurfaceKey, Surface] = {}
    for o in spec.obs_strategies:
        pts = [p for p in points if p.obs_strat == o]
        if not pts:
            continue
        worst_at: Dict[int, ProbePoint] = {}
        for p in pts:
            cur = worst_at.get(p.n_stressors)
            if cur is None or p.measured_badness > cur.measured_badness:
                worst_at[p.n_stressors] = p
        ns = sorted(worst_at)
        key = SurfaceKey(spec.pool, o, sp, "b",
                         qualifier=WORSTCASE_QUALIFIER)
        out[key] = Surface(
            axes=(SurfaceAxis(AXIS_N, tuple(float(n) for n in ns)),),
            bandwidth_gbps=[worst_at[n].bandwidth_gbps for n in ns],
            latency_ns=[worst_at[n].latency_ns for n in ns],
            provenance={"worstcase": {
                "seed": spec.seed,
                "iterations": spec.iterations,
                "batch": spec.batch,
                "executed": executed,
                "acquisition_trace": trace,
                "probes": [p.to_dict() for p in pts],
                "worst": max(pts,
                             key=lambda p: p.measured_badness).to_dict(),
            }})
    return out

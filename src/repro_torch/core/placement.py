"""Placement Advisor — characterization-driven memory management.

The upool payoff (paper §IV-E): once the curves are known, framework
objects are *deliberately* placed across heterogeneous memories — and the
right answer is often counter-intuitive (Fig. 14: allocate the victim's
heap in the module the stressors are NOT hammering... which can be the
nominally slower one).

The advisor solves a small assignment problem: given
  * memory objects (size, bytes moved per step, latency sensitivity),
  * candidate pools with capacities,
  * an expected contention level (stressor count + their target pool),
it minimises the predicted per-step time

    t(obj, pool) = traffic_bytes / eff_bw(pool | contention)
                 + lat_weight * eff_lat(pool | contention) * dependent_accesses

greedily by "regret density" (largest time delta between best and
second-best pool per byte first), respecting capacities.

Framework integration (in the JAX package, and in the port once its
serving and training stacks are ported): the serving engine asks the
advisor where the KV cache goes (device memory vs. pinned host memory,
under decode-time contention); the train loop asks where optimizer state
lives (ZeRO-offload decision).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.characterize import CurveDB
from repro_torch.core.devicetree import Platform

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class MemObject:
    """One placeable framework object."""
    name: str
    size_bytes: int
    bytes_per_step: float          # streaming traffic it generates
    dependent_accesses: float = 0.0  # serialized (latency-bound) accesses
    pinned_pool: Optional[str] = None  # force placement (escape hatch)


@dataclass(frozen=True)
class ContentionSpec:
    """Expected background load while this application runs.

    ``rw_ratio`` / ``inject_rate`` are surface coordinates (CurveDB
    v3): the stressors' read share of line-touches and their injection
    duty.  The cost model interpolates the characterized surface at
    these coordinates instead of snapping to the nearest tagged curve.
    ``stress_shape_tag`` still selects a legacy per-shape curve exactly
    (e.g. ``"st8"`` for a strided chase — see ``TrafficShape.tag()``)
    when one was characterized.
    """
    n_stressors: int = 0
    stress_pool: str = "hbm"
    stress_strategy: str = "w"
    stress_shape_tag: str = ""
    rw_ratio: Optional[float] = None
    inject_rate: Optional[float] = None

    @staticmethod
    def shaped(n_stressors: int, stress_pool: str, stress_strategy: str,
               shape) -> "ContentionSpec":
        """Build from a :class:`repro_torch.core.scenarios.TrafficShape`:
        mixed/burst shapes become surface coordinates (interpolated),
        and every shape also carries its tag so legacy per-shape
        curves keep resolving exactly."""
        rw = shape.read_fraction if shape.kind == "mixed" else None
        ir = shape.duty_cycle if shape.duty_cycle != 1.0 else None
        return ContentionSpec(n_stressors, stress_pool, stress_strategy,
                              stress_shape_tag=shape.tag(),
                              rw_ratio=rw, inject_rate=ir)


@dataclass
class PlacementDecision:
    pool: str
    predicted_step_ns: float
    alternatives: Dict[str, float] = field(default_factory=dict)
    # True when the winning pool's cost came from an extrapolated
    # surface query (coordinates beyond the characterized grid, or a
    # fallback past a missing axis) — the prediction is a clamp, not a
    # measurement
    extrapolated: bool = False


@dataclass
class PlacementPlan:
    decisions: Dict[str, PlacementDecision] = field(default_factory=dict)

    def pool_of(self, name: str) -> str:
        return self.decisions[name].pool

    def total_predicted_ns(self) -> float:
        return sum(d.predicted_step_ns for d in self.decisions.values())

    def report(self) -> str:
        lines = ["object              pool     t_pred(us)   alternatives"]
        for name, d in self.decisions.items():
            alts = " ".join(f"{p}:{t / 1e3:.1f}" for p, t in
                            sorted(d.alternatives.items()))
            lines.append(f"{name:19s} {d.pool:8s} "
                         f"{d.predicted_step_ns / 1e3:10.1f}   {alts}")
        return "\n".join(lines)


class PlacementAdvisor:
    """``pessimistic=True`` advises against the worst-case search
    envelope (``SurfaceKey(qualifier="worstcase")``) instead of the
    mean surface: the cost of a pool is what the ADVERSARIAL stressor
    mix does to it at the given stressor count, whatever mix the
    contention spec nominally expects.  Decisions fall back to the
    mean surface (flagged extrapolated) when no envelope was
    characterized for a pool.

    ``qualifier`` selects a variant surface for every cost query —
    serving passes :data:`repro_torch.core.characterize.ONLINE_QUALIFIER` so
    that, once the contention watchdog has refreshed a cell, the
    re-advise runs against the LIVE measurement and falls through to
    the offline surface where no refresh has happened."""

    def __init__(self, db: CurveDB, platform: Platform,
                 pools: Optional[Sequence[str]] = None,
                 pessimistic: bool = False, qualifier: str = ""):
        self.db = db
        self.platform = platform
        self.pessimistic = pessimistic
        self.qualifier = qualifier
        self.pools = list(pools) if pools is not None else \
            db.observer_pools()

    # -- cost model ---------------------------------------------------------
    def _predict(self, obj: MemObject, pool: str,
                 contention: ContentionSpec) -> Tuple[float, bool]:
        """(predicted ns, extrapolated?) — both surface queries
        interpolated at the contention's coordinates."""
        kw = dict(stress_pool=contention.stress_pool,
                  stress_strat=contention.stress_strategy,
                  shape_tag=contention.stress_shape_tag,
                  rw_ratio=contention.rw_ratio,
                  inject_rate=contention.inject_rate,
                  qualifier=self.qualifier)
        if self.pessimistic:
            # the envelope is 1-axis (n_stressors): the adversarial
            # search already minimized/maximized over the mix, duty and
            # shape knobs, so the spec's mix coordinates do not apply
            kw.update(qualifier="worstcase", shape_tag="",
                      rw_ratio=None, inject_rate=None)
        bw_q = self.db.query(pool, contention.n_stressors,
                             obs_strat="r", **kw)
        lat_q = self.db.query(pool, contention.n_stressors,
                              obs_strat="l", **kw)
        stream_ns = obj.bytes_per_step / max(bw_q.bandwidth_gbps, 1e-9)
        lat_ns = obj.dependent_accesses * lat_q.latency_ns
        return stream_ns + lat_ns, bw_q.extrapolated or lat_q.extrapolated

    def predict_ns(self, obj: MemObject, pool: str,
                   contention: ContentionSpec) -> float:
        return self._predict(obj, pool, contention)[0]

    # -- solver ---------------------------------------------------------------
    def advise(self, objects: Sequence[MemObject],
               contention: ContentionSpec = ContentionSpec(),
               capacities: Optional[Dict[str, int]] = None) -> PlacementPlan:
        caps = dict(capacities) if capacities is not None else {
            p: self.platform.memories[p].size_bytes
            for p in self.pools if p in self.platform.memories}

        costs: Dict[str, Dict[str, float]] = {}
        extrap: Dict[str, Dict[str, bool]] = {}
        for obj in objects:
            costs[obj.name] = {}
            extrap[obj.name] = {}
            for p in self.pools:
                if p not in caps:
                    continue
                t, ex = self._predict(obj, p, contention)
                costs[obj.name][p] = t
                extrap[obj.name][p] = ex
            if not costs[obj.name] and obj.pinned_pool is None:
                raise RuntimeError(
                    f"no candidate pools for {obj.name!r}: advisor pools "
                    f"{self.pools} and capacity pools {sorted(caps)} "
                    f"have no common member")

        # pinned objects first
        plan = PlacementPlan()
        todo = []
        for obj in objects:
            if obj.pinned_pool is not None:
                p = obj.pinned_pool
                caps[p] = caps.get(p, 0) - obj.size_bytes
                plan.decisions[obj.name] = PlacementDecision(
                    p, costs[obj.name].get(p, 0.0), costs[obj.name],
                    extrapolated=extrap[obj.name].get(p, False))
            else:
                todo.append(obj)

        # greedy by regret: the object that loses most from a bad pool
        # gets first pick
        def regret(obj: MemObject) -> float:
            c = sorted(costs[obj.name].values())
            return (c[1] - c[0]) if len(c) > 1 else c[0]

        for obj in sorted(todo, key=regret, reverse=True):
            ranked = sorted(costs[obj.name].items(), key=lambda kv: kv[1])
            placed = False
            for pool, t in ranked:
                if caps.get(pool, 0) >= obj.size_bytes:
                    caps[pool] -= obj.size_bytes
                    ex = extrap[obj.name][pool]
                    if ex:
                        log.warning(
                            "placement of %r in %r relies on an "
                            "EXTRAPOLATED surface query (contention %r "
                            "beyond the characterized grid)",
                            obj.name, pool, contention)
                    plan.decisions[obj.name] = PlacementDecision(
                        pool, t, costs[obj.name], extrapolated=ex)
                    placed = True
                    break
            if not placed:
                raise RuntimeError(
                    f"object {obj.name} ({obj.size_bytes}B) fits no pool "
                    f"(free: { {p: c for p, c in caps.items()} })")
        return plan

    # -- the online re-advise (migration-guarded serving path) ---------------
    def readvise(self, objects: Sequence[MemObject],
                 contention: ContentionSpec,
                 current: Dict[str, str], *,
                 capacities: Optional[Dict[str, int]] = None,
                 min_gain_frac: float = 0.1) -> "ReadviseDecision":
        """Re-run the placement solve against the CURRENT placement
        with hysteresis: an object only *moves* when the fresh plan
        puts it elsewhere AND the predicted per-step gain of the move
        is at least ``min_gain_frac`` of its current predicted cost.
        Marginal flips are ``held`` (with the reason), so surface noise
        around a decision boundary cannot flap live caches between
        pools.  The solver itself is unchanged — this is a pure
        post-filter over :meth:`advise`."""
        plan = self.advise(objects, contention, capacities)
        moves: Dict[str, Tuple[str, str]] = {}
        held: Dict[str, str] = {}
        gain_ns = 0.0
        cur_total = 0.0
        for obj in objects:
            d = plan.decisions[obj.name]
            cur = current.get(obj.name)
            if cur is None:
                continue            # not currently placed: nothing to move
            cur_cost = d.alternatives.get(cur)
            if cur_cost is None:
                # current pool wasn't even a candidate (capacity lost?):
                # that is a forced move, not a hysteresis question
                moves[obj.name] = (cur, d.pool)
                continue
            cur_total += cur_cost
            if d.pool == cur:
                continue
            gain = cur_cost - d.predicted_step_ns
            frac = gain / max(cur_cost, 1e-9)
            if frac < min_gain_frac:
                held[obj.name] = (
                    f"predicted gain {frac:.1%} below the "
                    f"{min_gain_frac:.0%} hysteresis floor "
                    f"({cur} {cur_cost:.0f}ns -> {d.pool} "
                    f"{d.predicted_step_ns:.0f}ns)")
                continue
            moves[obj.name] = (cur, d.pool)
            gain_ns += gain
        return ReadviseDecision(
            plan=plan, moves=moves, held=held,
            predicted_gain_ns=gain_ns,
            predicted_gain_frac=gain_ns / max(cur_total, 1e-9))


@dataclass
class ReadviseDecision:
    """The hysteresis-filtered outcome of one re-advise pass."""
    plan: PlacementPlan
    moves: Dict[str, Tuple[str, str]]   # name -> (from_pool, to_pool)
    held: Dict[str, str]                # name -> why the flip was held
    predicted_gain_ns: float
    predicted_gain_frac: float


# ---------------------------------------------------------------------------
# Framework object profiles (what serve/train hand to the advisor)
# ---------------------------------------------------------------------------


def kv_cache_object(name: str, size_bytes: int,
                    bytes_read_per_token: float) -> MemObject:
    """Decode reads the whole cache once per generated token."""
    return MemObject(name=name, size_bytes=size_bytes,
                     bytes_per_step=bytes_read_per_token)


def optimizer_state_object(name: str, size_bytes: int) -> MemObject:
    """Touched exactly once per step (streamed read+write)."""
    return MemObject(name=name, size_bytes=size_bytes,
                     bytes_per_step=2.0 * size_bytes)


def params_object(name: str, size_bytes: int,
                  reads_per_step: float = 1.0) -> MemObject:
    return MemObject(name=name, size_bytes=size_bytes,
                     bytes_per_step=reads_per_step * size_bytes)

"""Closed queueing-network model of the heterogeneous memory system.

The ``simulate`` backend: the ``cuda`` backend measures the observer
alone, so the multi-engine contention ladders are not *executed* yet.
They are instead *modeled* as a multiclass closed queueing network solved with
approximate Mean-Value Analysis (Bard–Schweitzer AMVA), extended with a
shared-entry blocking term that captures the paper's key microarchitectural
finding: transactions to a slow memory hold shared interconnect queue
entries for their full downstream round-trip, throttling traffic to fast
memories that merely *share the bus* (MEMSCOPE §IV-B(4), Fig. 6/7).

Model structure (per platform device tree):
  * one FCFS station per memory module     (service = line/peak_bw)
  * one FCFS station per interconnect port (service = line/port_bw)
  * a per-class delay term                 (base_latency, no queueing)
  * route: off-core transactions traverse the shared port (noc / CCI),
    then the module's last-hop port (pcie, ici) if different, then the
    module; on-chip (``vmem``-kind) traffic stays on the core port.
  * shared-port entry blocking: entries held per class = X_c * (downstream
    round trip), total capped at ``queue_entries``; excess demand appears
    as pre-bus waiting time.

Customers of class c = outstanding transactions of one activity
(population = n_engines x per-engine MLP; latency workloads have MLP=1 by
construction — that is their definition).
"""
from __future__ import annotations

import dataclasses
import logging
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.devicetree import MemoryNode, Platform

log = logging.getLogger(__name__)

# traffic multiplier per access strategy: transactions on the memory
# station per *useful* line delivered (WAWB: a write miss = read + victim
# writeback; write-streaming bypasses the allocate read; copy moves a
# read line plus an allocated write line per two useful lines).
STRATEGY_TRAFFIC = {
    "r": 1.0, "s": 1.0, "l": 1.0, "m": 1.0, "t": 1.0,
    "w": 2.0, "x": 2.0,
    "y": 1.0,
    "c": 1.5,
    "b": 1.5,          # default 1:1 mix; read_fraction overrides
    "i": 0.0,
}

# traffic cost of one pure read / one pure (allocating) write line — the
# endpoints a mixed read/write ratio interpolates between
_READ_TRAFFIC, _WRITE_TRAFFIC = 1.0, 2.0

# per-engine MLP by strategy kind: latency chases are serialised (one
# outstanding transaction — that is the measurement method), bandwidth
# streams run at the module's MLP limit.  Write-streaming (y) is *posted*
# — stores never wait for a reply, so a y-engine keeps twice the
# transactions in flight (this is what makes dc-zva streams the most
# aggressive stressor in Fig. 8/13).
def strategy_mlp(strategy: str, node: MemoryNode) -> int:
    if strategy in ("l", "m", "t"):
        return 1
    if strategy == "i":
        return 0
    if strategy == "y":
        return 2 * node.max_mlp
    return node.max_mlp


@dataclass(frozen=True)
class ActivityClass:
    """One class of customers in the closed network.

    The optional *traffic-shape* parameters generalise the steady
    streams of the seed model:

    read_fraction  mixed read/write ratio: the per-line traffic
                   interpolates between a pure read (1 Tx) and a pure
                   write-allocate (2 Tx).  ``None`` = use the
                   strategy's native multiplier.
    duty_cycle     bursty/duty-cycled issue: the class only keeps
                   ``duty_cycle`` of its MLP in flight on time-average
                   (a burst's off phase holds zero entries), shrinking
                   its customer population.
    stride         pointer-chase hop distance in lines: hops beyond
                   one line forfeit row-buffer/prefetch locality, so
                   the per-transaction base latency grows with the hop
                   distance (logarithmically saturating).
    """
    name: str
    node: MemoryNode
    strategy: str
    n_engines: int
    read_fraction: Optional[float] = None
    duty_cycle: float = 1.0
    stride: int = 1

    def population(self) -> int:
        pop = self.n_engines * strategy_mlp(self.strategy, self.node)
        if self.duty_cycle < 1.0 and pop:
            pop = max(1, int(round(pop * self.duty_cycle)))
        return pop

    @property
    def traffic(self) -> float:
        if self.read_fraction is not None:
            return (self.read_fraction * _READ_TRAFFIC
                    + (1.0 - self.read_fraction) * _WRITE_TRAFFIC)
        return STRATEGY_TRAFFIC[self.strategy]

    def base_latency_ns(self) -> float:
        z = self.node.base_latency_ns
        stride = self.stride
        if stride <= 1 and self.strategy == "t":
            stride = _DEFAULT_T_STRIDE    # the t workload's default hop
        if stride > 1:
            z *= 1.0 + _STRIDE_LATENCY_ALPHA * math.log2(
                min(stride, _STRIDE_SATURATION))
        return z


# locality-loss penalty per doubling of the chase hop distance, and the
# distance beyond which a longer stride cannot hurt further (every hop
# already misses the row buffer / defeats the prefetcher)
_STRIDE_LATENCY_ALPHA = 0.12
_STRIDE_SATURATION = 64
_DEFAULT_T_STRIDE = 8     # matches workloads._mk_strided's default


@dataclass
class ClassResult:
    name: str
    x_tx_per_ns: float        # transaction throughput
    r_ns: float               # per-transaction round trip (queueing incl.)
    bw_gbps: float            # useful bytes / s extracted by the class
    lat_ns: float             # per-access latency (for latency workloads)
    entry_wait_ns: float      # time waiting for a shared bus entry


def _route(platform: Platform, cls: "ActivityClass") -> List[str]:
    """Port visits for one class.  Cacheable strategies (and zva write
    streams) traverse the shared-cache bank port when the platform has a
    transparent cache; cache-target classes stop there."""
    node = cls.node
    r: List[str] = []
    cache_name = getattr(platform, "cache_node", None)
    if cache_name and cache_name in platform.memories:
        cache_port = platform.memories[cache_name].port
        if (cls.strategy in ("r", "w", "l", "y", "c", "b")
                and node.port != "core" and cache_port not in r):
            r.append(cache_port)
    if node.kind == "cache":
        return r or [node.port]
    if node.port == "core":
        return r + ["core"]
    shared = getattr(platform, "shared_port", "noc")
    if shared in platform.ports and shared not in r:
        r.append(shared)
    if node.port not in r:
        r.append(node.port)
    return r


def simulate_scenario(
    platform: Platform,
    classes: List[ActivityClass],
    *,
    tol: float = 1e-9,
    max_iter: int = 5000,
) -> Dict[str, ClassResult]:
    """Solve the network for one scenario (one set of concurrent classes)."""
    classes = [c for c in classes if c.population() > 0]
    if not classes:
        return {}
    line = platform.line_bytes

    # stations: ports then memories
    stations: List[Tuple[str, float]] = []   # (name, service_ns)
    for pname, port in platform.ports.items():
        stations.append((f"port:{pname}", line / port.bw_gbps))
    for mname, mem in platform.memories.items():
        stations.append((f"mem:{mname}", line / mem.peak_bw_gbps))
    s_index = {name: i for i, (name, _) in enumerate(stations)}

    # demands D[c][s] (visits x service x traffic) and delay Z[c]
    C = len(classes)
    S = len(stations)
    D = [[0.0] * S for _ in range(C)]
    Z = [0.0] * C
    N = [float(c.population()) for c in classes]
    for ci, c in enumerate(classes):
        t = max(c.traffic, 1e-12)
        for pname in _route(platform, c):
            D[ci][s_index[f"port:{pname}"]] = \
                stations[s_index[f"port:{pname}"]][1] * t
        D[ci][s_index[f"mem:{c.node.name}"]] = \
            stations[s_index[f"mem:{c.node.name}"]][1] * t
        Z[ci] = c.base_latency_ns()

    # Bard–Schweitzer AMVA with shared-entry blocking on the shared port
    # and posted-write-stream blocking on the cache bank port.
    Q = [[N[ci] / S for _ in range(S)] for ci in range(C)]
    entry_wait = [0.0] * C      # shared-port (CCI/noc) entry wait
    bank_wait = [0.0] * C       # cache-bank writeback-buffer wait
    shared = getattr(platform, "shared_port", "noc")
    shared_station = s_index.get(f"port:{shared}")
    entries = (platform.ports[shared].queue_entries
               if shared in platform.ports else math.inf)
    cache_name = getattr(platform, "cache_node", None)
    bank_station = None
    bank_entries = math.inf
    if cache_name and cache_name in platform.memories:
        bank_port = platform.memories[cache_name].port
        bank_station = s_index.get(f"port:{bank_port}")
        if bank_port in platform.ports:
            bank_entries = platform.ports[bank_port].queue_entries

    X = [0.0] * C
    R = [[0.0] * S for _ in range(C)]
    for _ in range(max_iter):
        max_delta = 0.0
        for ci in range(C):
            for si in range(S):
                if D[ci][si] == 0.0:
                    R[ci][si] = 0.0
                    continue
                q_others = sum(Q[cj][si] for cj in range(C))
                q_others -= Q[ci][si] / max(N[ci], 1.0)
                R[ci][si] = D[ci][si] * (1.0 + q_others)
            r_total = sum(R[ci]) + Z[ci] + entry_wait[ci] + bank_wait[ci]
            x_new = N[ci] / r_total
            max_delta = max(max_delta, abs(x_new - X[ci]))
            X[ci] = x_new
            for si in range(S):
                Q[ci][si] = X[ci] * R[ci][si]

        # ---- shared-entry blocking update ----------------------------
        # An entry is held from bus admission until the memory reply, so
        # entries held by class c = X_c * downstream_c (Little).  When the
        # wanted in-flight population exceeds the entry count, arrivals
        # wait for *any* entry to free: the expected wait is the overflow
        # times the bus-wide MEAN holding time — which a slow-memory
        # class inflates for everyone (the paper's Fig. 6/7 mechanism).
        if shared_station is not None and math.isfinite(entries):
            uses_bus = [D[ci][shared_station] > 0.0 for ci in range(C)]
            holds = []
            total_x = 0.0
            for ci in range(C):
                if not uses_bus[ci]:
                    holds.append(0.0)
                    continue
                downstream = sum(R[ci]) + Z[ci]
                holds.append(X[ci] * downstream)
                total_x += X[ci]
            used = sum(holds)
            if used > entries and total_x > 0.0:
                mean_hold = used / total_x
                target = (used - entries) * mean_hold / entries
                for ci in range(C):
                    if uses_bus[ci]:
                        entry_wait[ci] += 0.3 * (target - entry_wait[ci])
            else:
                for ci in range(C):
                    entry_wait[ci] *= 0.7

        # ---- cache-bank writeback-buffer blocking (Fig. 13) -----------
        # Posted write streams (y) hold a bank writeback-buffer slot for
        # the full downstream drain; ordinary misses release the bank
        # after the tag access (they wait in MSHRs instead).  When the
        # streams' in-flight population exceeds the buffer count, the
        # bank pipeline stalls for EVERY class that touches the cache —
        # which is why partitioning cannot mitigate it.
        if bank_station is not None and math.isfinite(bank_entries):
            y_pop = 0.0
            y_x = 0.0
            drain_acc = 0.0
            for ci, c in enumerate(classes):
                if c.strategy == "y" and D[ci][bank_station] > 0.0:
                    y_pop += N[ci]
                    y_x += X[ci]
                    # time to drain downstream once a buffer is held —
                    # excludes the buffer wait itself (else runaway)
                    drain_acc += X[ci] * (sum(R[ci]) + Z[ci]
                                          + entry_wait[ci])
            if y_pop > bank_entries and y_x > 0.0:
                mean_drain = drain_acc / y_x
                target = (y_pop - bank_entries) * mean_drain / bank_entries
                for ci in range(C):
                    if D[ci][bank_station] > 0.0:
                        bank_wait[ci] += 0.3 * (target - bank_wait[ci])
            else:
                for ci in range(C):
                    bank_wait[ci] *= 0.7
        if max_delta < tol:
            break

    out: Dict[str, ClassResult] = {}
    for ci, c in enumerate(classes):
        r_total = sum(R[ci]) + Z[ci] + entry_wait[ci] + bank_wait[ci]
        useful_bw = X[ci] * line / max(c.traffic, 1e-12)
        out[c.name] = ClassResult(
            name=c.name,
            x_tx_per_ns=X[ci],
            r_ns=r_total,
            bw_gbps=useful_bw,          # bytes/ns == GB/s
            lat_ns=r_total * max(c.traffic, 1e-12),
            entry_wait_ns=entry_wait[ci],
        )
    return out


def co_observer_class(name: str, node: MemoryNode, strategy: str, *,
                      read_fraction: Optional[float] = None,
                      duty_cycle: float = 1.0,
                      stride: int = 1) -> ActivityClass:
    """The queueing-network term for one *coupled* co-observer.

    A sibling observer of a coupled multi-observer scenario is always
    on — it occupies exactly one engine at its strategy's native MLP at
    EVERY ladder rung (unlike the stressor ensemble, which grows with
    the rung index).  This mirrors the spmd backend's executed rungs,
    where every sibling runs as a live engine inside the measured
    region; an uncoupled scenario simply omits these classes (the
    historical semantics)."""
    return ActivityClass(name, node, strategy, 1,
                         read_fraction=read_fraction,
                         duty_cycle=duty_cycle, stride=stride)


# ---------------------------------------------------------------------------
# Surface-calibrated mode (CurveDB v3)
# ---------------------------------------------------------------------------


@dataclass
class SurfaceCalibration:
    """A platform re-fit to a measured bandwidth–latency surface.

    ``platform`` carries the rescaled per-module service rates;
    ``scale_bw`` / ``scale_lat`` record the fitted per-pool factors and
    ``residual_bw`` / ``residual_lat`` the relative error still left at
    the surface's uncontended edge after the fit (the fidelity number
    the tests hold the mode to)."""
    platform: Platform
    scale_bw: Dict[str, float] = field(default_factory=dict)
    scale_lat: Dict[str, float] = field(default_factory=dict)
    residual_bw: Dict[str, float] = field(default_factory=dict)
    residual_lat: Dict[str, float] = field(default_factory=dict)


def _modeled_edge(platform: Platform, pool: str) -> Tuple[float, float]:
    """The model's own uncontended edge for one pool: the bandwidth a
    single streaming reader extracts, and the latency a single
    serialized chaser sees (the two measurement methods the surface's
    n_stressors=0 edge was characterized with)."""
    node = platform.memories[pool]
    bw = simulate_scenario(
        platform, [ActivityClass("obs", node, "r", 1)])["obs"].bw_gbps
    lat = simulate_scenario(
        platform, [ActivityClass("obs", node, "l", 1)])["obs"].lat_ns
    return bw, lat


def calibrate_to_surface(platform: Platform, db, *,
                         pools: Optional[List[str]] = None,
                         rounds: int = 4) -> SurfaceCalibration:
    """Fit per-class service rates to a measured surface edge.

    For every characterized pool, rescales the memory node's
    ``peak_bw_gbps`` (the FCFS station's service rate) and
    ``base_latency_ns`` (the per-class delay term) until the model's
    uncontended edge reproduces the surface's measured
    ``n_stressors=0`` edge.  The two knobs interact (latency feeds the
    bandwidth edge and queueing feeds the latency edge), so the fit
    runs a short fixpoint iteration instead of a one-shot division.

    ``db`` is any CurveDB (v1/v2/v3) — the v3 surface interpolates its
    rw_ratio/inject_rate axes at the pure-read full-duty corner, which
    is exactly the edge the model's single-reader class reproduces.
    """
    cal = SurfaceCalibration(platform=platform)
    names = pools if pools is not None else db.observer_pools()
    names = [p for p in names if p in platform.memories]

    def edge(pool: str, obs_strat: str) -> float:
        # the n_stressors=0 edge is uncontended, so ANY characterized
        # stressor pairing for this observer carries it — but prefer a
        # pairing the surface resolves WITHOUT extrapolating, tolerate
        # pairings that only exist under a shape tag, and ignore
        # variant surfaces (structured qualifiers like "worstcase":
        # calibration fits the mean surface, not an envelope)
        pairings = sorted({(k.stress_pool, k.stress_strat, k.tag)
                           for k in db.surfaces
                           if k.obs_pool == pool
                           and k.obs_strat == obs_strat
                           and (not k.qualifier
                                or any(c in k.qualifier for c in ":|@"))})
        if not pairings:
            raise KeyError(
                f"pool {pool!r} has no {obs_strat!r}-observer surface "
                f"pairings at all; have "
                f"{sorted(k.to_string() for k in db.surfaces)}")
        fallback: Optional[Tuple[str, str, float]] = None
        for sp, ss, tag in pairings:
            try:
                q = db.query(pool, 0, obs_strat=obs_strat,
                             stress_pool=sp, stress_strat=ss,
                             shape_tag=tag)
            except KeyError:
                continue    # tagged-only pairing with no steady fallback
            v = q.bandwidth_gbps if obs_strat == "r" else q.latency_ns
            if not q.extrapolated:
                return v
            if fallback is None:
                fallback = (sp, ss, v)
        if fallback is None:
            raise KeyError(
                f"no resolvable {obs_strat!r} pairing for pool {pool!r}")
        sp, ss, v = fallback
        log.warning("calibrate_to_surface: every %r pairing for pool %r "
                    "extrapolates at the n_stressors=0 edge; using "
                    "(%s, %s)", obs_strat, pool, sp, ss)
        return v

    measured: Dict[str, Tuple[float, float]] = {}
    for pool in names:
        try:
            bw, lat = edge(pool, "r"), edge(pool, "l")
        except KeyError as exc:
            # pool not characterized with both probes: skip the fit for
            # it, loudly — a silent skip here masked real coverage gaps
            log.warning("calibrate_to_surface: skipping pool %r: %s",
                        pool, exc)
            continue
        if bw > 0.0 and lat > 0.0:
            measured[pool] = (bw, lat)

    plat = platform
    for _ in range(max(1, rounds)):
        mems = dict(plat.memories)
        for pool, (m_bw, m_lat) in measured.items():
            mod_bw, mod_lat = _modeled_edge(plat, pool)
            node = mems[pool]
            mems[pool] = dataclasses.replace(
                node,
                peak_bw_gbps=node.peak_bw_gbps * m_bw / max(mod_bw, 1e-12),
                base_latency_ns=(node.base_latency_ns
                                 * m_lat / max(mod_lat, 1e-12)))
        plat = dataclasses.replace(plat, memories=mems)

    for pool, (m_bw, m_lat) in measured.items():
        mod_bw, mod_lat = _modeled_edge(plat, pool)
        cal.scale_bw[pool] = (plat.memories[pool].peak_bw_gbps
                              / platform.memories[pool].peak_bw_gbps)
        cal.scale_lat[pool] = (plat.memories[pool].base_latency_ns
                               / platform.memories[pool].base_latency_ns)
        cal.residual_bw[pool] = abs(mod_bw - m_bw) / m_bw
        cal.residual_lat[pool] = abs(mod_lat - m_lat) / m_lat
    cal.platform = plat
    return cal


def scenario_ladder(
    platform: Platform,
    *,
    obs_node: MemoryNode,
    obs_strategy: str,
    stress_node: MemoryNode,
    stress_strategy: str,
    max_stressors: Optional[int] = None,
    co_observers: Optional[List[Tuple[MemoryNode, str]]] = None,
) -> List[Dict[str, ClassResult]]:
    """The paper's best->worst scenario sequence: 0..p-1 stressor
    engines.  ``co_observers`` — (node, strategy) pairs — adds coupled
    sibling observers present at every rung (see
    :func:`co_observer_class`)."""
    p = platform.n_engines if max_stressors is None else max_stressors + 1
    results = []
    for k in range(p):
        classes = [ActivityClass("obs", obs_node, obs_strategy, 1)]
        for j, (node, strat) in enumerate(co_observers or ()):
            if strat != "i":
                classes.append(co_observer_class(f"co{j}", node, strat))
        if k and stress_strategy != "i":
            classes.append(
                ActivityClass("stress", stress_node, stress_strategy, k))
        results.append(simulate_scenario(platform, classes))
    return results

"""plan — stage 1 of the spmd execution pipeline.

Turns (specs -> (spec, observer, buffer) triples -> signature groups)
into a declarative :class:`DispatchPlan`: a sequence of
:class:`PlannedDispatch`es, each describing ONE host-synchronous launch
of the contention ladder — which ladders it stacks, the per-rung
per-engine role tables, the operand memory kind, and the engine geometry
(how many engine subsets run side by side, how many stacked waves).

Nothing in here touches the card: the plan is pure data, so planner
transforms compose.  The first such transform is
:func:`pack_engine_subsets` (engine-subset width-packing): when a launch
has at least twice a ladder's width of engines, several same-signature
shallow ladders run side by side on disjoint engine subsets of one
launch — each subset keeps its own barrier pair — instead of stacking
every ladder behind the last.  The worst-case contention search emits
its "next grid" as a plan too (:func:`probe_batch`).

The measured observer pass of the ``cuda`` backend groups through
:func:`observer_groups` in this module too, so grouping logic lives in
exactly one place.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

from repro_torch.core.scenarios import ObserverSpec, ScenarioSpec
from repro_torch.core.workloads import resolve_strategy, rows_for as _wl_rows

# ---------------------------------------------------------------------------


def effective_duty(shape) -> float:
    """Duty cycle of a role's traffic shape, with the degenerate-value
    guard every call site must share: absent shapes and 0/None duties
    count as always-on.  Work balancing *divides* by this (a 0-duty
    role would otherwise get an infinite iteration budget) and the
    observer's ``n_active`` stamping multiplies by it — both sides of
    the accounting must use the same number."""
    if shape is None:
        return 1.0
    return getattr(shape, "duty_cycle", 1.0) or 1.0


def ladder_depth(spec: ScenarioSpec, platform_engines: int,
                 mesh_engines: Optional[int] = None) -> int:
    """Rungs this spec's ladder measures: ``max_stressors + 1`` capped
    by the platform, and — on the spmd backend (``mesh_engines``
    given) — by the launch's engines: rung k needs k stress engines + 1
    observer,
    plus one engine per coupled sibling observer, which runs live
    inside every rung (same count for every observer)."""
    n = (spec.max_stressors + 1 if spec.max_stressors is not None
         else platform_engines)
    n = min(n, platform_engines)
    if mesh_engines is not None:
        n = min(n, mesh_engines - spec.n_coupled_siblings)
    return max(1, n)


def rung_roles(spec: ScenarioSpec, obs: ObserverSpec, buf: int, k: int,
               width: int) -> Tuple[List[Tuple], List[str]]:
    """The per-engine role layout of rung k, padded to ``width``
    engines: engine 0 runs the observer, the next engines its coupled
    sibling observers (every observer of a coupled multi-observer spec
    is live inside every sibling's measured region), then k stressor
    engines (ensemble round-robin), the rest idle.  Returns
    ``(roles, role_pools)`` with one ``(strategy, shape, rows, iters)``
    tuple per engine.

    Sibling and stressor iteration budgets are work-balanced against
    the passes the observer branch will actually execute (its duty
    cycle included, via :func:`effective_duty` on BOTH sides of the
    division) so role imbalance does not masquerade as contention;
    residual per-kind speed differences (a chase row costs more than a
    stream row) remain and are what the in-dispatch rung clocks
    measure."""
    iters = spec.iters
    obs_rows = _wl_rows(buf)
    roles: List[Tuple] = [(obs.strategy, obs.shape, obs_rows, iters)]
    role_pools = [obs.pool]
    m = len(spec.stressors)
    obs_work = obs_rows * max(
        1, round(iters * effective_duty(obs.shape)))
    for sib in spec.coupled_siblings(obs)[:width - 1]:
        sib_rows = _wl_rows(sib.buffers[0])
        sib_iters = max(1, round(
            obs_work / (sib_rows * effective_duty(sib.shape))))
        roles.append((sib.strategy, sib.shape, sib_rows, sib_iters))
        role_pools.append(sib.pool)
    for e in range(min(k, width - len(roles))):
        if m:
            s = spec.stressors[e % m]
            s_rows = _wl_rows(s.buffer_bytes)
            s_iters = max(1, round(
                obs_work / (s_rows * effective_duty(s.shape))))
            roles.append((s.strategy, s.shape, s_rows, s_iters))
            role_pools.append(s.pool)
        else:
            roles.append(("i", None, 1, iters))
            role_pools.append(obs.pool)
    while len(roles) < width:
        roles.append(("i", None, 1, iters))
        role_pools.append(obs.pool)
    return roles, role_pools


def group_key(spec: ScenarioSpec, obs: ObserverSpec, buf: int,
              pools) -> Tuple:
    """Sweep-level grouping key: triples with equal keys expand to the
    SAME per-rung role tables and operand placement, so their ladders
    legally stack into one batched dispatch.  The spec-level role
    signature (pool-free — see :meth:`ScenarioSpec.ladder_signature`)
    is refined by each role pool's *effective* memory kind: pools that
    differ only in name but land in one physical memory merge (like
    the interpret path's signature groups); pools that really differ
    split."""
    kinds = tuple(pools.pool(p).effective_memory_kind()
                  for p in spec.role_pools(obs))
    return (spec.ladder_signature(obs, buf), kinds)


def operand_kind(role_pools, pools) -> Optional[str]:
    """Per-pool operand placement: when every engine's pool lands in
    one effective memory kind, the stacked operands carry that kind's
    sharding into the fused dispatch; mixed-pool programs fall back to
    the default memory (one stacked array has one memory kind —
    per-engine kinds need a real multi-chip slice and per-pool operand
    splitting, the remaining ROADMAP item)."""
    kinds = {pools.pool(p).effective_memory_kind() for p in role_pools}
    return kinds.pop() if len(kinds) == 1 else None


def observer_groups(triples, pools) -> "OrderedDict[Tuple, List[int]]":
    """The measured pass's signature groups.  Group signature:
    everything that changes the measured launch or the numbers stamped
    on its results.  ``iters`` is part of the signature — members must
    be measured at THEIR OWN budget, not silently at the group max.  The
    pool appears only through its *effective* placement
    (:meth:`MemoryPool.effective_memory_kind`): on the card device
    memory and pinned host memory are different memories and never
    share a group; with ``device="cpu"``, where no page-locked memory
    exists, both are ordinary host memory and may share one stacked
    batch."""
    groups: "OrderedDict[Tuple, List[int]]" = OrderedDict()
    for i, (spec, obs, buf) in enumerate(triples):
        pool = pools.pool(obs.pool)
        sig = (obs.strategy, obs.shape, buf, spec.iters,
               pool.effective_memory_kind(), pool.node.kind == "vmem")
        groups.setdefault(sig, []).append(i)
    return groups


# ---------------------------------------------------------------------------
# The plan data model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LadderEntry:
    """One (spec, observer, buffer) contention ladder in the matrix."""
    index: int                  # position in the matrix's triple list
    spec: ScenarioSpec
    observer: ObserverSpec
    buffer_bytes: int


@dataclass(frozen=True)
class PlannedDispatch:
    """ONE host-synchronous launch, fully described as data.

    ``rungs`` holds the per-rung role tuples at ``subset_width``
    engines; the program builder tiles them across ``n_subsets``
    disjoint engine subsets (width-packed dispatches) and idles any
    leftover engines, then scan-stacks the whole table ``waves``
    times.  Unpacked dispatches are the degenerate geometry: one
    subset as wide as the launch, one wave per stacked ladder.

    ``probe=True`` marks a :func:`probe_batch` dispatch, whose rows are
    already laid out at FULL packed width (``n_subsets * subset_width``
    engines, one row per scan step): the builder pads each row to the
    launch and stacks them verbatim instead of tiling/repeating."""
    entries: Tuple[LadderEntry, ...]
    rungs: Tuple[Tuple[Tuple, ...], ...]    # (n_scen, subset_width)
    n_scen: int
    ladder_width: int       # engines one ladder really occupies
    subset_width: int       # engines per subset (launch width unpacked)
    n_subsets: int          # ladders side by side per wave (1 unpacked)
    waves: int              # scan-stacked repeats of the rung table
    kind: Optional[str]     # operand memory kind (None = mixed pools)
    packed: bool = False
    probe: bool = False

    @property
    def group(self) -> int:
        return len(self.entries)

    def subsets(self) -> Optional[Tuple[Tuple[int, ...], ...]]:
        """Engine-index tuples of the real (decoded) subsets; ``None``
        for unpacked dispatches (one barrier over every engine)."""
        if not self.packed:
            return None
        return tuple(tuple(range(j * self.subset_width,
                                 (j + 1) * self.subset_width))
                     for j in range(self.n_subsets))

    def member_slot(self, g: int) -> Tuple[int, int]:
        """(wave, subset) coordinates of stacked ladder ``g``."""
        return g // self.n_subsets, g % self.n_subsets

    def cache_key(self, mode: str, n_eng: int, activity: str,
                  samples: int) -> Tuple:
        return (mode, n_eng, activity, self.kind, samples, self.group,
                self.n_subsets, self.subset_width, self.waves,
                self.probe, self.rungs)


@dataclass(frozen=True)
class DispatchPlan:
    n_engines: int
    dispatches: Tuple[PlannedDispatch, ...]


def _plan_dispatch(entries: List[LadderEntry], n_eng: int, pools,
                   platform_engines: int) -> PlannedDispatch:
    """One dispatch for a (possibly singleton) same-signature group:
    roles expanded at launch width, one wave per stacked ladder."""
    first = entries[0]
    spec, obs, buf = first.spec, first.observer, first.buffer_bytes
    n_scen = ladder_depth(spec, platform_engines, n_eng)
    per_rung = [rung_roles(spec, obs, buf, k, n_eng)
                for k in range(n_scen)]
    kind = operand_kind([p for _r, ps in per_rung for p in ps], pools)
    return PlannedDispatch(
        entries=tuple(entries),
        rungs=tuple(tuple(r) for r, _p in per_rung),
        n_scen=n_scen,
        ladder_width=1 + spec.n_coupled_siblings + (n_scen - 1),
        subset_width=n_eng, n_subsets=1, waves=len(entries),
        kind=kind, packed=False)


def build_plan(triples, n_eng: int, pools, platform_engines: int, *,
               grouped: bool = True) -> DispatchPlan:
    """Stage 1: the whole matrix as a DispatchPlan.  ``grouped=True``
    (the sweep-batched mode) stacks same-signature ladders into one
    dispatch per distinct :func:`group_key`; ``grouped=False`` plans
    one dispatch per ladder (the fused-per-ladder mode)."""
    entries = [LadderEntry(i, spec, obs, buf)
               for i, (spec, obs, buf) in enumerate(triples)]
    if not grouped:
        return DispatchPlan(n_eng, tuple(
            _plan_dispatch([e], n_eng, pools, platform_engines)
            for e in entries))
    groups: "OrderedDict[Tuple, List[LadderEntry]]" = OrderedDict()
    for e in entries:
        key = group_key(e.spec, e.observer, e.buffer_bytes, pools)
        groups.setdefault(key, []).append(e)
    return DispatchPlan(n_eng, tuple(
        _plan_dispatch(members, n_eng, pools, platform_engines)
        for members in groups.values()))


# ---------------------------------------------------------------------------
# Planner transforms
# ---------------------------------------------------------------------------


def pack_engine_subsets(plan: DispatchPlan, *,
                        min_group: int = 2) -> DispatchPlan:
    """Engine-subset width-packing, as a PURE plan transform.

    A dispatch whose ladders occupy ``W = ladder_width`` engines on a
    launch with ``n_engines >= 2 * W`` engines idles most of them:
    the stacked steps run one ladder at a time with ``n_engines - W``
    engines spinning.  This transform re-plans such a group to run
    ``P = min(n_engines // W, group)`` ladders SIDE BY SIDE on
    disjoint W-engine subsets of one dispatch — the rung table shrinks
    to natural ladder width (the trailing idle padding drops off), the
    program builder tiles it across the P subsets, and the table stacks
    only ``ceil(group / P)`` waves instead of ``group``.  An 8-engine
    launch running 2-engine rungs executes 4 ladders per dispatch
    instead of 1.

    Each packed subset keeps an INDEPENDENT barrier pair (a barrier
    counter of its own in the ladder kernel), and the fence check
    verifies every subset's stamps separately, so a
    packed ladder's measurement is attributable to exactly its own
    engine slice.  Dispatches that cannot pack (launch too narrow,
    singleton groups, already packed) pass through unchanged — as do
    probe-batch dispatches, whose rows are already laid out at full
    packed width by :func:`probe_batch`."""
    out = []
    for d in plan.dispatches:
        w, g = d.ladder_width, d.group
        if (d.packed or d.probe or w < 1 or plan.n_engines < 2 * w
                or g < min_group):
            out.append(d)
            continue
        p = min(plan.n_engines // w, g)
        out.append(replace(
            d,
            rungs=tuple(r[:w] for r in d.rungs),
            subset_width=w, n_subsets=p,
            waves=-(-g // p),           # ceil(group / P)
            packed=True))
    return replace(plan, dispatches=tuple(out))


def unpack_dispatch(d: PlannedDispatch) -> PlannedDispatch:
    """The inverse degradation rewrite of :func:`pack_engine_subsets`:
    re-plan a width-packed dispatch at the degenerate one-subset
    geometry (one barrier over every engine, one wave per stacked
    ladder).

    The rung rows stay at their truncated natural width — the program
    builder pads every row back to the launch with the same idle role
    the original unpacked plan carried (observer ``iters``), so the
    rewritten dispatch compiles to exactly the program the group would
    have run had packing never happened.  The resilience layer uses
    this as the first rung of the retry-degradation ladder: a packed
    dispatch that keeps faulting falls back to plain batched stacking.
    Unpacked and probe dispatches pass through unchanged (probe rows
    are laid out at full packed width — see :func:`split_probes`)."""
    if not d.packed or d.probe:
        return d
    return replace(d, subset_width=d.ladder_width, n_subsets=1,
                   waves=d.group, packed=False)


def split_ladders(d: PlannedDispatch) -> Tuple[PlannedDispatch, ...]:
    """Degradation rewrite: one single-ladder dispatch per stacked
    entry (the ``batched -> fused ladder`` step of the resilience
    ladder).  Every member of a batched group shares ONE rung table —
    that is what made them a group — so the split is pure geometry:
    the same rungs, one entry, one wave.  All the splits also share
    one program-cache key (entries are not part of the key), so a
    healthy split re-dispatches without re-tracing.  Packed dispatches
    unpack first; probe batches go through :func:`split_probes`."""
    if d.probe:
        return split_probes(d)
    base = unpack_dispatch(d)
    return tuple(replace(base, entries=(e,), waves=1)
                 for e in base.entries)


def split_probes(d: PlannedDispatch) -> Tuple[PlannedDispatch, ...]:
    """Degradation rewrite for probe batches: one single-probe
    dispatch per entry.  Probe rows are laid out at FULL packed width
    (``n_subsets * subset_width`` engines, slot ``g % P`` of wave
    ``g // P``), so probe ``g``'s roles are a contiguous slice of its
    wave's row; the single-probe dispatch carries that slice as its
    one row (the builder pads it back to the launch) behind a
    barrier over every engine."""
    if not d.probe:
        return split_ladders(d)
    w = d.subset_width
    out = []
    for g, e in enumerate(d.entries):
        wave, slot = d.member_slot(g)
        row = d.rungs[wave][slot * w:(slot + 1) * w]
        out.append(replace(d, entries=(e,), rungs=(tuple(row),),
                           ladder_width=w, subset_width=w, n_subsets=1,
                           waves=1, packed=False))
    return tuple(out)


def rung_row(d: PlannedDispatch, k: int, n_eng: int) -> Tuple[Tuple, ...]:
    """Rung ``k``'s role row padded to the launch — the per-rung
    degradation floor hands this straight to ``Dispatcher.run_rung``.
    Probe dispatches have exactly one row (``n_scen == 1``)."""
    row = list(d.rungs[0 if d.probe else k])
    idle = ("i", None, 1, d.rungs[0][0][3])
    while len(row) < n_eng:
        row.append(idle)
    return tuple(row)


# ---------------------------------------------------------------------------
# Probe batching (the worst-case search's planner transform)
# ---------------------------------------------------------------------------


def probe_batch(probes, n_eng: int, pools,
                platform_engines: int) -> PlannedDispatch:
    """ONE host-synchronous dispatch for a heterogeneous probe batch.

    ``probes`` is a sequence of ``(spec, observer, buffer_bytes, k)``
    tuples, each asking for a SINGLE contention rung (observer + ``k``
    live stressor engines at the spec's shape) — the worst-case search
    emits every iteration's candidate coordinates this way.  Unlike
    :func:`build_plan`'s same-signature stacking, the probes may carry
    DIFFERENT shapes, strategies and stressor counts: the per-rung
    branch table is pure data, so heterogeneous rungs legally stack as
    scan steps of one program.

    Geometry: every probe occupies one ``subset_width``-wide slot
    (the widest probe's natural width; narrower probes idle-pad their
    slot).  When the launch fits ``P >= 2`` slots the batch width-packs —
    ``P`` probes run side by side per scan wave, each slot with its own
    own barrier pair — otherwise the degenerate one-slot geometry
    scan-stacks one probe per wave behind a global sandwich.  Each row
    of ``rungs`` is one scan step at FULL packed width
    (``n_subsets * subset_width``); a ragged last wave idle-fills its
    spare slots.  ``member_slot`` and the dispatcher's clock decode
    work unchanged: probe ``g`` is wave ``g // P``, slot ``g % P``,
    ``n_scen == 1``.

    The dispatch reuses the builder/dispatcher verbatim — no new
    execution machinery — so a search iteration costs exactly one
    host sync (``DispatchStats.host_sync_dispatches += 1``)."""
    probes = list(probes)
    if not probes:
        raise ValueError("probe_batch needs at least one probe")
    widths = []
    for spec, obs, buf, k in probes:
        depth = ladder_depth(spec, platform_engines, n_eng)
        if not 0 <= k < depth:
            raise ValueError(
                f"probe {spec.name!r}: k={k} outside this mesh's ladder "
                f"depth [0, {depth})")
        widths.append(1 + spec.n_coupled_siblings + k)
    w = max(widths)
    p = max(1, min(n_eng // w, len(probes)))
    if p == 1:
        w = n_eng               # degenerate slot: one barrier over all
    waves = -(-len(probes) // p)
    idle = ("i", None, 1, probes[0][0].iters)
    rows: List[Tuple[Tuple, ...]] = []
    role_pools: List[str] = []
    for v in range(waves):
        row: List[Tuple] = []
        for j in range(p):
            g = v * p + j
            if g < len(probes):
                spec, obs, buf, k = probes[g]
                roles, rp = rung_roles(spec, obs, buf, k, w)
                row.extend(roles)
                role_pools.extend(rp)
            else:
                row.extend([idle] * w)
        rows.append(tuple(row))
    merge_probe_operand_roles(rows)     # raise on chain conflicts now
    return PlannedDispatch(
        entries=tuple(LadderEntry(g, spec, obs, buf)
                      for g, (spec, obs, buf, _k) in enumerate(probes)),
        rungs=tuple(rows),
        n_scen=1,
        ladder_width=w, subset_width=w, n_subsets=p, waves=waves,
        kind=operand_kind(role_pools, pools),
        packed=p > 1, probe=True)


def _chain_req(role) -> Optional[Tuple]:
    """The pointer-chain an engine running ``role`` needs seeded into
    its int operand: ``None`` for streams/idle, ``("stride", s, rows)``
    for strided chases, ``("cycle", rows)`` for seeded Sattolo walks."""
    strategy, shape, rows, _iters = role
    strat = resolve_strategy(strategy, shape)
    if strat == "t":
        return ("stride", getattr(shape, "stride", 8) or 8, rows)
    if strat in ("l", "m"):
        return ("cycle", rows)
    return None


def merge_probe_operand_roles(rows) -> List[Tuple]:
    """One operand-seeding role per engine serving EVERY scan row of a
    probe batch.  Operands are built once per dispatch, so an engine
    whose rows disagree on the chain they need (different stride or
    traversal length — a truncated Sattolo cycle is not a cycle) has no
    single valid operand: that is a planning error, raised here with
    the conflicting requirements named.  Streams only ever read the
    shared float buffer, so a chase row and a stream row on one engine
    coexist; among chain-free rows the widest wins (row count only
    feeds the operand padding)."""
    width = max(len(r) for r in rows)
    merged: List[Optional[Tuple]] = [None] * width
    chains: List[Optional[Tuple]] = [None] * width
    for row in rows:
        for e, role in enumerate(row):
            req = _chain_req(role)
            if req is not None:
                if chains[e] is not None and chains[e] != req:
                    raise ValueError(
                        f"probe batch: engine {e} needs conflicting "
                        f"chase chains {chains[e]} and {req} across "
                        f"scan rows — split these probes into "
                        f"separate batches")
                if chains[e] is None:
                    chains[e] = req
                    merged[e] = role
            elif chains[e] is None and (merged[e] is None
                                        or role[2] > merged[e][2]):
                merged[e] = role
    return [m if m is not None else ("i", None, 1, 1) for m in merged]

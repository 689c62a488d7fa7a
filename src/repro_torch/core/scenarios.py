"""Declarative scenario DSL — the characterization matrix, as data.

The seed hard-coded one scenario family: a 4-tuple cross-product
(obs_pool x obs_strategy x stress_pool x stress_strategy) of *steady*
streams.  Real contention is richer ("A Mess of Memory System
Benchmarking": bandwidth-latency surfaces are only meaningful swept
across read/write ratios and traffic shapes; worst-case SoC analysis
needs bursty and copy-style interference).  This module makes the
scenario the unit of configuration:

* :class:`TrafficShape`   — HOW an activity touches memory: steady,
  mixed read/write ratio (2:1, 1:1, 1:2, ...), bursty/duty-cycled,
  or strided (pointer-chase hop distance).
* :class:`ObserverSpec`   — the measured activity: strategy letter,
  pool, and a *buffer-size ladder*.
* :class:`StressorSpec`   — one member of the stressor ensemble.
* :class:`ScenarioSpec`   — observer(s) + stressor ensemble + iteration
  budget; serialisable, hashable, and the key-provider for CurveDB v2.
  A scenario may carry SEVERAL observers (measure many pools at once);
  each observer keys its own curve via :meth:`ScenarioSpec.key_for`.

Specs are plain frozen dataclasses with exact dict round-trips
(:func:`ScenarioSpec.to_dict` / :func:`ScenarioSpec.from_dict`), so a
scenario matrix can be checked into a JSON file, diffed, and replayed.

Adding a new traffic shape (see README "Scenario DSL"):
  1. give it a ``kind`` + parameters here (and a ``tag`` spelling),
  2. teach the queueing model its traffic/population effect
     (``repro_torch.core.simulate``),
  3. optionally give it an executable kernel (``repro_torch.kernels``) and
     register the workload (``repro_torch.core.workloads``).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field, replace
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

SCHEMA_VERSION = 2


def _exact(v: float) -> str:
    """Shortest fixed-point spelling that round-trips ``v`` exactly."""
    for prec in (2, 3, 4, 6):
        s = f"{v:.{prec}f}"
        if float(s) == v:
            return s
    return repr(v)


# ---------------------------------------------------------------------------
# Traffic shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TrafficShape:
    """How an activity's transactions are distributed in kind and time.

    kind          "steady" | "mixed" | "burst" | "strided"
    read_fraction fraction of line-touches that are reads (mixed): a
                  2:1 read:write mix is read_fraction=2/3.
    duty_cycle    fraction of wall time the activity is issuing (burst);
                  1.0 = steady.
    burst_len     iterations per active burst (executable backends).
    stride        lines skipped per pointer-chase hop (strided).
    """
    kind: str = "steady"
    read_fraction: float = 1.0
    duty_cycle: float = 1.0
    burst_len: int = 64
    stride: int = 1

    def __post_init__(self):
        if self.kind not in ("steady", "mixed", "burst", "strided"):
            raise ValueError(f"unknown traffic shape kind {self.kind!r}")
        if not 0.0 <= self.read_fraction <= 1.0:
            raise ValueError(f"read_fraction out of [0,1]: "
                             f"{self.read_fraction}")
        if not 0.0 < self.duty_cycle <= 1.0:
            raise ValueError(f"duty_cycle out of (0,1]: {self.duty_cycle}")
        if self.stride < 1:
            raise ValueError(f"stride must be >= 1: {self.stride}")

    # -- constructors -------------------------------------------------------
    @staticmethod
    def steady() -> "TrafficShape":
        return TrafficShape()

    @staticmethod
    def mixed(reads: int, writes: int) -> "TrafficShape":
        """Mixed read/write ratio, e.g. ``mixed(2, 1)`` for 2:1."""
        if reads < 0 or writes < 0 or reads + writes == 0:
            raise ValueError(f"bad ratio {reads}:{writes}")
        return TrafficShape(kind="mixed",
                            read_fraction=reads / (reads + writes))

    @staticmethod
    def burst(duty_cycle: float, burst_len: int = 64) -> "TrafficShape":
        return TrafficShape(kind="burst", duty_cycle=duty_cycle,
                            burst_len=burst_len)

    @staticmethod
    def strided(stride: int) -> "TrafficShape":
        return TrafficShape(kind="strided", stride=stride)

    @staticmethod
    def traffic(rw_ratio: float, inject_rate: float = 1.0) -> "TrafficShape":
        """One bandwidth–latency *surface* grid point: a mixed stream
        issuing ``rw_ratio`` reads per line-touch at ``inject_rate``
        duty (Mess-style surfaces sweep both axes at once, so the two
        parameters combine in a single shape)."""
        return TrafficShape(kind="mixed", read_fraction=rw_ratio,
                            duty_cycle=inject_rate)

    # -- identity ----------------------------------------------------------
    @property
    def is_steady(self) -> bool:
        return self.kind == "steady"

    def tag(self) -> str:
        """Short spelling used inside CurveDB keys ('' for steady).

        The parameter spelling must round-trip the float exactly —
        distinct ratios MUST NOT alias one key (two different mixed
        ratios landing on the same ``rf`` spelling would collide in
        CurveDB and trip the characterize_matrix collision guard).
        Common ratios keep the short 2-decimal form (``rf0.50``);
        non-terminating ones widen until exact (``rf0.6666666666666666``).
        """
        if self.kind == "steady":
            return ""
        if self.kind == "mixed":
            tag = f"rf{_exact(self.read_fraction)}"
            # surface grid points carry both axes; a duty-cycled mix
            # must not alias the always-on mix of the same ratio
            if self.duty_cycle != 1.0:
                tag = f"{tag}dc{_exact(self.duty_cycle)}"
            return tag
        if self.kind == "burst":
            tag = f"dc{_exact(self.duty_cycle)}"
            # non-default burst lengths are part of the identity too
            return tag if self.burst_len == 64 else f"{tag}x{self.burst_len}"
        tag = f"st{self.stride}"
        # a duty-cycled strided chase (the search's inject_rate knob on
        # the stride arm) must not alias the always-on chase of the
        # same stride
        return tag if self.duty_cycle == 1.0 else \
            f"{tag}dc{_exact(self.duty_cycle)}"


# ---------------------------------------------------------------------------
# Activities
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ObserverSpec:
    """The measured activity: one strategy on one pool, swept over a
    buffer-size ladder (a single size is a 1-rung ladder)."""
    strategy: str
    pool: str
    buffers: Tuple[int, ...]
    shape: TrafficShape = field(default_factory=TrafficShape)

    def __post_init__(self):
        object.__setattr__(self, "buffers", tuple(self.buffers))
        if not self.buffers:
            raise ValueError("observer needs at least one buffer size")


@dataclass(frozen=True)
class StressorSpec:
    """One member of the stressor ensemble."""
    strategy: str
    pool: str
    buffer_bytes: int
    shape: TrafficShape = field(default_factory=TrafficShape)

    def descriptor(self) -> str:
        t = self.shape.tag()
        base = f"{self.pool}:{self.strategy}"
        return f"{base}@{t}" if t else base


@dataclass(frozen=True)
class ScenarioSpec:
    """One named scenario: observer(s) + stressor ensemble + budget.

    ``observer`` accepts either a single :class:`ObserverSpec` or a
    tuple of them — a *multi-observer* scenario measures several pools
    at once (each observer gets its own CurveDB curve, all collapsed
    into the matrix runner's same-signature vmapped passes).  The first
    observer stays the ``observer`` attribute (v1-compatible keying);
    the rest land in ``co_observers``.

    ``coupled`` (default True) makes co-observers part of each other's
    measured region: on the spmd backend every sibling observer runs as
    a live engine inside each observer's rung dispatch, and on modeled
    backends each sibling contributes an always-on single-engine class
    to the queueing network.  ``coupled=False`` restores the historical
    semantics (each observer sees only the stressor ensemble); curves
    record which one produced them via the CurveDB ``execution``
    provenance entry.
    """
    name: str
    observer: ObserverSpec
    stressors: Tuple[StressorSpec, ...] = ()
    iters: int = 500
    max_stressors: Optional[int] = None     # ladder depth; None = n_engines
    co_observers: Tuple[ObserverSpec, ...] = ()
    coupled: bool = True

    def __post_init__(self):
        obs, co = self.observer, tuple(self.co_observers)
        if not isinstance(obs, ObserverSpec):
            seq = tuple(obs)
            if not seq:
                raise ValueError(f"{self.name}: need at least one observer")
            obs, co = seq[0], tuple(seq[1:]) + co
            object.__setattr__(self, "observer", obs)
        object.__setattr__(self, "co_observers", co)
        object.__setattr__(self, "stressors", tuple(self.stressors))

    @property
    def observers(self) -> Tuple[ObserverSpec, ...]:
        """All measured activities, primary first."""
        return (self.observer,) + self.co_observers

    @property
    def n_coupled_siblings(self) -> int:
        """Engines each observer's ladder devotes to live sibling
        observers — 0 when uncoupled or single-observer.  The planner
        sizes ladder widths (and packing subsets) from this."""
        return len(self.observers) - 1 if self.coupled else 0

    def coupled_siblings(self,
                         observer: ObserverSpec) -> Tuple[ObserverSpec, ...]:
        """The sibling observers sharing ``observer``'s measured region
        (empty when the scenario is uncoupled).  Drops exactly ONE
        occurrence of the measured observer — by identity when it is
        one of this spec's own entries (so value-equal twins still see
        each other), by value for reconstructed/deserialized equal
        observers."""
        if not self.coupled:
            return ()
        rest = list(self.observers)
        for i, o in enumerate(rest):
            if o is observer:
                del rest[i]
                break
        else:
            for i, o in enumerate(rest):
                if o == observer:
                    del rest[i]
                    break
        return tuple(rest)

    # -- cross-ladder grouping (sweep-level megabatching) -------------------
    def role_pools(self, observer: ObserverSpec) -> Tuple[str, ...]:
        """Every pool a ladder of this (spec, observer) pair can place
        an engine's operands in, in role order: the observer first (idle
        engines share its pool), then coupled siblings, then the
        stressor ensemble."""
        return (observer.pool,
                *(o.pool for o in self.coupled_siblings(observer)),
                *(s.pool for s in self.stressors))

    def ladder_signature(self, observer: ObserverSpec,
                         buffer_bytes: int) -> Tuple:
        """Hashable *role-program* identity of this (spec, observer,
        buffer) ladder, for sweep-level grouping: two triples with equal
        signatures AND equal per-pool effective memory kinds (see
        :meth:`role_pools`) expand to identical per-rung role tables at
        any mesh size, so their ladders legally stack into ONE batched
        SPMD dispatch.  Pool *names* are deliberately absent — pools
        that differ only in name but land in the same physical memory
        merge, exactly like the interpret path's signature groups;
        anything that changes the compiled program or the stamped
        numbers (strategies, shapes, buffer sizes, iteration budgets,
        ladder depth, sibling coupling) splits."""
        return (
            (observer.strategy, observer.shape, int(buffer_bytes)),
            tuple((o.strategy, o.shape, o.buffers[0])
                  for o in self.coupled_siblings(observer)),
            tuple((s.strategy, s.shape, s.buffer_bytes)
                  for s in self.stressors),
            self.iters,
            self.max_stressors,
        )

    # -- CurveDB keying ------------------------------------------------------
    def _stress_key(self) -> str:
        if self.stressors:
            return "+".join(s.descriptor() for s in self.stressors)
        return "none:i"

    def key_for(self, observer: ObserverSpec,
                buffer_bytes: Optional[int] = None) -> str:
        """Per-observer curve key (multi-observer scenarios yield one
        curve per observer, all sharing the stressor half).  The
        ``buf=`` suffix appears for multi-buffer ladders AND whenever a
        sibling observer shares this observer's pool/strategy/shape —
        two observers differing only in buffer size must not alias one
        curve key."""
        obs = f"{observer.pool}:{observer.strategy}"
        t = observer.shape.tag()
        if t:
            obs = f"{obs}@{t}"
        key = f"{obs}|{self._stress_key()}"
        # count by VALUE, not identity: key_for must return the stored
        # key for a reconstructed/deserialized equal observer too
        twins = sum(1 for o in self.observers
                    if o.pool == observer.pool
                    and o.strategy == observer.strategy
                    and o.shape.tag() == t)
        if buffer_bytes is not None and (len(observer.buffers) > 1
                                         or twins > 1):
            key = f"{key}|buf={buffer_bytes}"
        return key

    def key(self, buffer_bytes: Optional[int] = None) -> str:
        """Curve key of the primary observer.  For a steady observer +
        single steady stressor this is EXACTLY the v1 key format
        ``obs_pool:obs_strat|stress_pool:stress_strat`` so v1 consumers
        (placement, MLP tables) keep resolving; shaped/ensemble
        scenarios append their shape tags."""
        return self.key_for(self.observer, buffer_bytes)

    # -- serialisation -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ScenarioSpec":
        stressors = tuple(
            StressorSpec(strategy=s["strategy"], pool=s["pool"],
                         buffer_bytes=s["buffer_bytes"],
                         shape=TrafficShape(**s.get("shape", {})))
            for s in d.get("stressors", ()))
        return ScenarioSpec(name=d["name"],
                            observer=_obs_from_dict(d["observer"]),
                            stressors=stressors,
                            iters=d.get("iters", 500),
                            max_stressors=d.get("max_stressors"),
                            co_observers=tuple(
                                _obs_from_dict(o)
                                for o in d.get("co_observers", ())),
                            coupled=d.get("coupled", True))


def _obs_from_dict(obs: Dict[str, Any]) -> ObserverSpec:
    return ObserverSpec(strategy=obs["strategy"], pool=obs["pool"],
                        buffers=tuple(obs["buffers"]),
                        shape=TrafficShape(**obs.get("shape", {})))


# ---------------------------------------------------------------------------
# Matrix constructors
# ---------------------------------------------------------------------------


#: The default stressor shape ensemble: the seed's steady ladder plus the
#: three new traffic-shape families (mixed r/w ratio, bursty, copy) and a
#: strided chase.  (strategy letter, shape) pairs.
DEFAULT_STRESS_SHAPES: Tuple[Tuple[str, TrafficShape], ...] = (
    ("r", TrafficShape.steady()),
    ("w", TrafficShape.steady()),
    ("y", TrafficShape.steady()),
    ("c", TrafficShape.steady()),           # copy: read + write stream
    ("r", TrafficShape.mixed(2, 1)),        # 2:1 read:write
    ("r", TrafficShape.mixed(1, 1)),
    ("r", TrafficShape.mixed(1, 2)),
    ("w", TrafficShape.burst(0.5)),         # duty-cycled write stress
    ("m", TrafficShape.strided(8)),         # strided pointer-chase
)


def scenario_matrix(
    *,
    pools: Sequence[str],
    buffer_bytes: int,
    obs_strategies: Sequence[str] = ("r", "w", "l"),
    stress_shapes: Sequence[Tuple[str, TrafficShape]] = DEFAULT_STRESS_SHAPES,
    stress_pools: Optional[Sequence[str]] = None,
    iters: int = 500,
    max_stressors: Optional[int] = None,
    name_prefix: str = "",
) -> List[ScenarioSpec]:
    """The full cross-product matrix as a flat spec list.

    Replaces the seed's hard-coded 4-tuple loop: every combination of
    (observer pool, observer strategy, stressor pool, stressor
    strategy+shape) becomes one named :class:`ScenarioSpec`.
    """
    specs: List[ScenarioSpec] = []
    s_pools = list(stress_pools) if stress_pools is not None else list(pools)
    for op in pools:
        for ostrat in obs_strategies:
            for sp in s_pools:
                for sstrat, shape in stress_shapes:
                    tag = shape.tag()
                    name = f"{name_prefix}{op}.{ostrat}|{sp}.{sstrat}"
                    if tag:
                        name = f"{name}@{tag}"
                    specs.append(ScenarioSpec(
                        name=name,
                        observer=ObserverSpec(ostrat, op, (buffer_bytes,)),
                        stressors=(StressorSpec(sstrat, sp, buffer_bytes,
                                                shape),),
                        iters=iters,
                        max_stressors=max_stressors))
    return specs


#: Default surface grid (Mess-style): read/write mix from pure-write to
#: pure-read, injection rate from a 25% duty trickle to full blast.
DEFAULT_RW_RATIOS: Tuple[float, ...] = (0.0, 0.5, 1.0)
DEFAULT_INJECT_RATES: Tuple[float, ...] = (0.25, 0.5, 1.0)


def surface_matrix(
    *,
    pools: Sequence[str],
    buffer_bytes: int,
    obs_strategies: Sequence[str] = ("r", "l"),
    stress_pools: Optional[Sequence[str]] = None,
    rw_ratios: Sequence[float] = DEFAULT_RW_RATIOS,
    inject_rates: Sequence[float] = DEFAULT_INJECT_RATES,
    iters: int = 500,
    max_stressors: Optional[int] = None,
    name_prefix: str = "surface.",
) -> List[ScenarioSpec]:
    """The rf x dc x stressor-count grid behind ``characterize_surface``.

    Every grid cell is one :class:`ScenarioSpec` whose single stressor
    is the ``b`` mixed stream at ``TrafficShape.traffic(rf, dc)`` — the
    cell's ladder supplies the ``n_stressors`` axis, the shape supplies
    the other two.  Only the shape varies across cells, so the whole
    grid runs through the coordinator's sweep-batched dispatch with one
    stacked program per distinct (rf, dc) signature.
    """
    specs: List[ScenarioSpec] = []
    s_pools = list(stress_pools) if stress_pools is not None else list(pools)
    for op in pools:
        for ostrat in obs_strategies:
            for sp in s_pools:
                for rf in rw_ratios:
                    for dc in inject_rates:
                        shape = TrafficShape.traffic(rf, dc)
                        specs.append(ScenarioSpec(
                            name=(f"{name_prefix}{op}.{ostrat}|{sp}.b"
                                  f"@{shape.tag()}"),
                            observer=ObserverSpec(ostrat, op,
                                                  (buffer_bytes,)),
                            stressors=(StressorSpec("b", sp, buffer_bytes,
                                                    shape),),
                            iters=iters,
                            max_stressors=max_stressors))
    return specs


def save_matrix(specs: Iterable[ScenarioSpec], path: str) -> None:
    import json
    with open(path, "w") as f:
        json.dump({"schema": SCHEMA_VERSION,
                   "scenarios": [s.to_dict() for s in specs]}, f, indent=1)


def load_matrix(path: str) -> List[ScenarioSpec]:
    import json
    with open(path) as f:
        d = json.load(f)
    return [ScenarioSpec.from_dict(s) for s in d["scenarios"]]

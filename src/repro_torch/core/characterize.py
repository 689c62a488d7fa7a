"""Characterization driver — bandwidth–latency surfaces + Little's-law MLP.

v3: the paper's curves are 1-D slices of the object that actually
predicts application behaviour — the **bandwidth–latency surface**
swept over read/write ratio and injection rate ("A Mess of Memory
System Benchmarking").  This module stores that object directly:

* :class:`SurfaceAxis` / :class:`SurfaceCoord` — named, ordered
  coordinates (``n_stressors``, ``rw_ratio`` from ``TrafficShape.mix``,
  ``inject_rate`` from ``duty_cycle``).
* :class:`Surface` — a dense point grid over those axes with
  multilinear interpolation; queries beyond the characterized grid
  clamp to the nearest edge and are *flagged* as extrapolated.
* :class:`SurfaceKey` — the typed curve identity
  ``(obs_pool, obs_strat, stress_pool, stress_strat)`` that replaces
  the flat ``"pool:strat|pool:strat@tag"`` string-key scheme.  Legacy
  spellings survive only as a serialisation detail inside this class;
  consumers (placement, roofline, simulate, serve) query through the
  coordinate API and never string-split keys (the JAX package's test
  suite holds a grep lint for it).

Results persist as a **versioned CurveDB** (schema 3): surfaces keyed
by :class:`SurfaceKey` with per-surface provenance.  Schema-1 (seed)
and schema-2 files still load — each old curve becomes a 1-axis
surface — and a v3 database still *saves* as schema 2 for downgrade
(multi-axis surfaces slice back into tagged per-shape curves).

Execution goes through the coordinator's batched matrix runner;
:func:`characterize_surface` emits the rf x dc x stressor-count grid
and records the :class:`DispatchStats` proof that the sweep measured
one launch per signature group (and chunk of it).
"""
from __future__ import annotations

import json
import os
import tempfile
from bisect import bisect_right
from dataclasses import asdict, dataclass, field
from itertools import product
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.coordinator import CoreCoordinator, MatrixResult
from repro_torch.core.devicetree import Platform
from repro_torch.core.scenarios import (DEFAULT_INJECT_RATES, DEFAULT_RW_RATIOS,
                                  ObserverSpec, ScenarioSpec, StressorSpec,
                                  TrafficShape, surface_matrix)

#: CurveDB on-disk schema written by default (see CurveDB.save).
CURVEDB_SCHEMA = 3

#: Canonical axis names, in canonical grid order.
AXIS_N = "n_stressors"
AXIS_RW = "rw_ratio"
AXIS_IR = "inject_rate"

#: rw_ratio a pure-strategy stressor sits at on the surface's mix axis:
#: read-side strategies are the rw=1 edge, write/writeback streams the
#: rw=0 edge, copy/mixed streams the midpoint.  This is what lets ONE
#: measured surface answer queries phrased in legacy stressor letters.
STRATEGY_RW_RATIO = {"r": 1.0, "s": 1.0, "l": 1.0, "m": 1.0, "t": 1.0,
                     "w": 0.0, "x": 0.0, "y": 0.0, "c": 0.5, "b": 0.5}


@dataclass
class CurvePoint:
    n_stressors: int
    bandwidth_gbps: float
    latency_ns: float


# ---------------------------------------------------------------------------
# The coordinate system
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SurfaceAxis:
    """One named, ordered surface axis (strictly ascending grid values)."""
    name: str
    values: Tuple[float, ...]

    def __post_init__(self):
        vals = tuple(float(v) for v in self.values)
        object.__setattr__(self, "values", vals)
        if not vals:
            raise ValueError(f"axis {self.name!r} needs at least one value")
        if any(b <= a for a, b in zip(vals, vals[1:])):
            raise ValueError(
                f"axis {self.name!r} values must be strictly ascending: "
                f"{vals}")

    def locate(self, v: float) -> Tuple[int, int, float, bool]:
        """Bracketing indices + interpolation fraction for ``v``:
        ``(lo, hi, t, clamped)``.  Out-of-range coordinates clamp to
        the nearest edge with ``clamped=True`` — the caller surfaces
        that as an *extrapolated* query instead of silently returning
        the edge point (the seed's ``min(n, len-1)`` bug).

        A coordinate ON an edge (``rw_ratio=1.0`` on a grid ending at
        1.0, or any value of a single-point axis) is in-range, and so
        is one that differs from the edge only by float noise
        (``0.1 * 3 > 0.3``): the clamped flag uses a relative-epsilon
        comparison, not strict inequality."""
        vals = self.values
        eps = 1e-9 * max(1.0, abs(vals[0]), abs(vals[-1]))
        if v <= vals[0]:
            return 0, 0, 0.0, v < vals[0] - eps
        if v >= vals[-1]:
            last = len(vals) - 1
            return last, last, 0.0, v > vals[-1] + eps
        hi = bisect_right(vals, v)
        lo = hi - 1
        t = (v - vals[lo]) / (vals[hi] - vals[lo])
        return lo, hi, t, False


@dataclass(frozen=True)
class SurfaceCoord:
    """A named point in surface coordinate space (ordered name/value
    pairs).  Build with :meth:`of`; ``None`` values are dropped so
    callers can pass optional coordinates straight through."""
    coords: Tuple[Tuple[str, float], ...] = ()

    @staticmethod
    def of(**kw: Optional[float]) -> "SurfaceCoord":
        return SurfaceCoord(tuple((k, float(v)) for k, v in kw.items()
                                  if v is not None))

    def get(self, name: str) -> Optional[float]:
        for k, v in self.coords:
            if k == name:
                return v
        return None

    def names(self) -> Tuple[str, ...]:
        return tuple(k for k, _ in self.coords)

    def to_dict(self) -> Dict[str, float]:
        return dict(self.coords)


@dataclass(frozen=True)
class SurfaceQuery:
    """One interpolated surface reading.  ``extrapolated`` is True when
    any coordinate fell outside the characterized grid (nearest-edge
    clamp), or when the query asked for an axis the resolved surface
    does not carry (legacy fallback)."""
    bandwidth_gbps: float
    latency_ns: float
    extrapolated: bool
    coord: SurfaceCoord = SurfaceCoord()


#: The legacy key spelling's separators: pool ``:`` strategy, observer
#: ``|`` stressor, ``@`` shape tag, ``#`` qualifier, ``+`` between the
#: stressors of an ensemble.  Named here, not spelled inline, because the
#: JAX package's key lint (tests/test_surface.py) exempts only its own copy
#: of this parser.
_KEY_SEP = (":", "|", "@", "#", "+")


@dataclass(frozen=True, order=True)
class SurfaceKey:
    """Typed curve identity.  ``tag`` carries a stressor shape tag for
    legacy per-shape curves ('' for steady / full surfaces).

    ``qualifier`` is overloaded two ways, told apart by spelling:

    * a *structured* qualifier (``"worstcase"`` — no ``:|@``
      characters) names a variant of the canonical surface and spells
      as ``base[@tag]#qualifier`` (legacy keys never contain ``#``);
    * a *verbatim* qualifier (contains ``:|@``) preserves the exact
      legacy spelling of keys that carry more than the canonical
      4-tuple (observer shape tags, stressor ensembles, ``buf=``
      ladder suffixes), so v1/v2 files round-trip byte-exactly."""
    obs_pool: str
    obs_strat: str
    stress_pool: str
    stress_strat: str
    tag: str = ""
    qualifier: str = ""

    def to_string(self) -> str:
        if self.qualifier and any(c in self.qualifier for c in ":|@"):
            return self.qualifier         # verbatim legacy spelling
        base = (f"{self.obs_pool}:{self.obs_strat}"
                f"|{self.stress_pool}:{self.stress_strat}")
        if self.tag:
            base = f"{base}@{self.tag}"
        return f"{base}#{self.qualifier}" if self.qualifier else base

    @staticmethod
    def from_string(key: str) -> "SurfaceKey":
        """The one place a legacy key string is parsed."""
        pool_sep, pair_sep, tag_sep, qual_sep, ens_sep = _KEY_SEP
        base, _, qual = key.partition(qual_sep)
        obs, _, stress = base.partition(pair_sep)
        op, _, orest = obs.partition(pool_sep)
        ostrat, _, otag = orest.partition(tag_sep)
        parts = stress.split(pair_sep)    # ["sp:ss@tag+...", "buf=..."]
        ensemble = parts[0].split(ens_sep)
        sp, _, srest = ensemble[0].partition(pool_sep)
        sstrat, _, stag = srest.partition(tag_sep)
        canonical = not otag and len(parts) == 1 and len(ensemble) == 1
        return SurfaceKey(op, ostrat, sp, sstrat, tag=stag,
                          qualifier=(qual if canonical else key))

    def with_tag(self, tag: str) -> "SurfaceKey":
        return SurfaceKey(self.obs_pool, self.obs_strat, self.stress_pool,
                          self.stress_strat, tag=tag)


def _cell(grid: Any, idx: Sequence[int]) -> float:
    for i in idx:
        grid = grid[i]
    return float(grid)


@dataclass
class Surface:
    """A dense bandwidth/latency grid over named ordered axes.

    ``bandwidth_gbps`` / ``latency_ns`` are nested lists indexed in
    axis order (JSON-native, so a surface file is diffable).  Queries
    interpolate multilinearly between bracketing grid cells; off-grid
    coordinates clamp to the nearest edge and flag the result as
    extrapolated.
    """
    axes: Tuple[SurfaceAxis, ...]
    bandwidth_gbps: Any
    latency_ns: Any
    provenance: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self.axes = tuple(self.axes)
        if not self.axes:
            raise ValueError("surface needs at least one axis")

    # -- axis helpers -------------------------------------------------------
    def axis(self, name: str) -> SurfaceAxis:
        for ax in self.axes:
            if ax.name == name:
                return ax
        raise KeyError(f"surface has no axis {name!r}; "
                       f"have {[a.name for a in self.axes]}")

    def has_axis(self, name: str) -> bool:
        return any(ax.name == name for ax in self.axes)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(len(ax.values) for ax in self.axes)

    # -- the query ----------------------------------------------------------
    def query(self, coord: SurfaceCoord) -> SurfaceQuery:
        """Multilinear interpolation at ``coord`` (every axis of this
        surface must be present; extra coordinate names are the
        caller's concern)."""
        brackets: List[Tuple[int, int, float]] = []
        clamped = False
        for ax in self.axes:
            v = coord.get(ax.name)
            if v is None:
                raise ValueError(
                    f"query missing coordinate {ax.name!r} "
                    f"(have {list(coord.names())})")
            lo, hi, t, cl = ax.locate(v)
            brackets.append((lo, hi, t))
            clamped = clamped or cl
        bw = self._interp(self.bandwidth_gbps, brackets)
        lat = self._interp(self.latency_ns, brackets)
        return SurfaceQuery(bw, lat, clamped, coord)

    @staticmethod
    def _interp(grid: Any, brackets: List[Tuple[int, int, float]]) -> float:
        total = 0.0
        for corner in product((0, 1), repeat=len(brackets)):
            w = 1.0
            idx = []
            for bit, (lo, hi, t) in zip(corner, brackets):
                w *= t if bit else (1.0 - t)
                idx.append(hi if bit else lo)
            if w == 0.0:
                continue
            total += w * _cell(grid, idx)
        return total

    # -- slicing back to legacy 1-axis curves --------------------------------
    def n_axis_points(self, idx: Tuple[int, ...] = ()) -> List[CurvePoint]:
        """The 1-axis (n_stressors) slice at fixed trailing indices."""
        n_ax = self.axes[0]
        if n_ax.name != AXIS_N:
            raise ValueError(f"first axis is {n_ax.name!r}, not {AXIS_N!r}")
        return [CurvePoint(int(n),
                           _cell(self.bandwidth_gbps, (i,) + idx),
                           _cell(self.latency_ns, (i,) + idx))
                for i, n in enumerate(n_ax.values)]

    # -- persistence --------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"axes": [{"name": ax.name, "values": list(ax.values)}
                         for ax in self.axes],
                "bandwidth_gbps": self.bandwidth_gbps,
                "latency_ns": self.latency_ns,
                "provenance": self.provenance}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Surface":
        return Surface(axes=tuple(SurfaceAxis(a["name"], tuple(a["values"]))
                                  for a in d["axes"]),
                       bandwidth_gbps=d["bandwidth_gbps"],
                       latency_ns=d["latency_ns"],
                       provenance=d.get("provenance", {}))

    @staticmethod
    def from_points(points: List[CurvePoint],
                    provenance: Optional[Dict[str, Any]] = None) -> "Surface":
        """A legacy curve as a 1-axis surface (v1/v2 forward-load)."""
        pts = sorted(points, key=lambda p: p.n_stressors)
        return Surface(
            axes=(SurfaceAxis(AXIS_N, tuple(float(p.n_stressors)
                                            for p in pts)),),
            bandwidth_gbps=[p.bandwidth_gbps for p in pts],
            latency_ns=[p.latency_ns for p in pts],
            provenance=provenance or {})


# ---------------------------------------------------------------------------
# The database
# ---------------------------------------------------------------------------


@dataclass
class CurveDB:
    platform: str
    surfaces: Dict[SurfaceKey, Surface] = field(default_factory=dict)
    schema: int = CURVEDB_SCHEMA
    meta: Dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def key(obs_pool: str, obs_strat: str, stress_pool: str,
            stress_strat: str, shape_tag: str = "") -> SurfaceKey:
        return SurfaceKey(obs_pool, obs_strat, stress_pool, stress_strat,
                          tag=shape_tag)

    # -- legacy views --------------------------------------------------------
    def _slices(self) -> Iterable[Tuple[str, List[CurvePoint],
                                        Dict[str, Any]]]:
        """Every surface as (legacy key string, points, provenance)
        1-axis slices — multi-axis surfaces slice per (rw, ir) cell
        under the cell shape's tag spelling."""
        for key, surf in self.surfaces.items():
            if len(surf.axes) == 1:
                yield key.to_string(), surf.n_axis_points(), surf.provenance
                continue
            rw_ax = surf.axis(AXIS_RW)
            ir_ax = surf.axis(AXIS_IR) if surf.has_axis(AXIS_IR) else None
            cells = surf.provenance.get("cells", {})
            for j, rw in enumerate(rw_ax.values):
                irs = ir_ax.values if ir_ax is not None else (1.0,)
                for k, ir in enumerate(irs):
                    tag = TrafficShape.traffic(rw, ir).tag()
                    idx = (j, k) if ir_ax is not None else (j,)
                    yield (key.with_tag(tag).to_string(),
                           surf.n_axis_points(idx),
                           cells.get(tag, surf.provenance))

    @property
    def curves(self) -> Dict[str, List[CurvePoint]]:
        """Read-only legacy view: ``{key string: [CurvePoint, ...]}``."""
        return {k: pts for k, pts, _prov in self._slices()}

    @property
    def provenance(self) -> Dict[str, Dict[str, Any]]:
        """Read-only legacy view of per-curve provenance."""
        return {k: prov for k, _pts, prov in self._slices() if prov}

    def get(self, obs_pool: str, obs_strat: str, stress_pool: str,
            stress_strat: str, shape_tag: str = "") -> List[CurvePoint]:
        k = SurfaceKey(obs_pool, obs_strat, stress_pool, stress_strat,
                       tag=shape_tag)
        surf = self.surfaces.get(k)
        if surf is not None and len(surf.axes) == 1:
            return surf.n_axis_points()
        return self.curves[k.to_string()]

    def observer_pools(self) -> List[str]:
        """Every pool with at least one characterized surface."""
        return sorted({k.obs_pool for k in self.surfaces})

    # -- the coordinate query (what placement/roofline/simulate consume) -----
    def _resolve(self, obs_pool: str, obs_strat: str, stress_pool: str,
                 stress_strat: str, shape_tag: str, qualifier: str = "",
                 ) -> Tuple[SurfaceKey, Surface, bool, bool]:
        """Surface lookup with the v3 resolution ladder: exact shaped
        key -> exact steady key -> the canonical mixed surface (pure
        stressor strategies are edges of its rw_ratio axis).  Returns
        (key, surface, tag_matched, fell_back).

        A requested ``qualifier`` (e.g. ``"worstcase"``) prefers the
        qualified surface at every ladder step, then falls through to
        the unqualified ladder — the caller flags the fallback via
        ``key.qualifier != qualifier``."""
        quals = (qualifier, "") if qualifier else ("",)
        if shape_tag:
            for q in quals:
                k = SurfaceKey(obs_pool, obs_strat, stress_pool,
                               stress_strat, tag=shape_tag, qualifier=q)
                s = self.surfaces.get(k)
                if s is not None:
                    return k, s, True, False
        for q in quals:
            for sstrat in (stress_strat, "b"):
                k = SurfaceKey(obs_pool, obs_strat, stress_pool, sstrat,
                               qualifier=q)
                s = self.surfaces.get(k)
                if s is not None:
                    return k, s, False, bool(shape_tag)
        raise KeyError(
            f"no surface for ({obs_pool!r}, {obs_strat!r}, "
            f"{stress_pool!r}, {stress_strat!r}); have "
            f"{sorted(k.to_string() for k in self.surfaces)}")

    def query(self, pool: str, n_stressors: float, *,
              obs_strat: str = "r", stress_pool: Optional[str] = None,
              stress_strat: str = "w", rw_ratio: Optional[float] = None,
              inject_rate: Optional[float] = None,
              shape_tag: str = "", qualifier: str = "") -> SurfaceQuery:
        """One interpolated reading of the characterized surface.

        ``rw_ratio`` / ``inject_rate`` select the stressor traffic mix
        and injection duty on a swept surface; when the surface lacks
        the axis (a 1-axis legacy curve) an explicitly-requested
        coordinate flags the result as extrapolated instead of being
        silently dropped.  ``shape_tag`` keeps resolving legacy
        per-shape curves exactly.  ``qualifier`` selects a variant
        surface (e.g. the ``"worstcase"`` search envelope), flagging
        the result when only the unqualified surface exists."""
        sp = stress_pool or pool
        key, surf, tag_hit, fell_back = self._resolve(
            pool, obs_strat, sp, stress_strat, shape_tag, qualifier)
        flagged = fell_back or (bool(qualifier)
                                and key.qualifier != qualifier)
        coords: Dict[str, float] = {AXIS_N: float(n_stressors)}
        if surf.has_axis(AXIS_RW):
            coords[AXIS_RW] = (rw_ratio if rw_ratio is not None
                               else STRATEGY_RW_RATIO.get(stress_strat, 0.5))
        elif rw_ratio is not None and not tag_hit:
            flagged = True
        if surf.has_axis(AXIS_IR):
            coords[AXIS_IR] = (inject_rate if inject_rate is not None
                               else 1.0)
        elif inject_rate is not None and not tag_hit:
            flagged = True
        q = surf.query(SurfaceCoord.of(**coords))
        return SurfaceQuery(q.bandwidth_gbps, q.latency_ns,
                            q.extrapolated or flagged, q.coord)

    # -- the numbers placement cares about (thin interpolating queries) ------
    def effective_bw(self, pool: str, n_stressors: float,
                     stress_pool: Optional[str] = None,
                     strat: str = "r", stress_strat: str = "w",
                     shape_tag: str = "",
                     rw_ratio: Optional[float] = None,
                     inject_rate: Optional[float] = None,
                     qualifier: str = "") -> float:
        return self.query(pool, n_stressors, obs_strat=strat,
                          stress_pool=stress_pool, stress_strat=stress_strat,
                          rw_ratio=rw_ratio, inject_rate=inject_rate,
                          shape_tag=shape_tag,
                          qualifier=qualifier).bandwidth_gbps

    def effective_lat(self, pool: str, n_stressors: float,
                      stress_pool: Optional[str] = None,
                      stress_strat: str = "w",
                      shape_tag: str = "",
                      rw_ratio: Optional[float] = None,
                      inject_rate: Optional[float] = None,
                      qualifier: str = "") -> float:
        return self.query(pool, n_stressors, obs_strat="l",
                          stress_pool=stress_pool, stress_strat=stress_strat,
                          rw_ratio=rw_ratio, inject_rate=inject_rate,
                          shape_tag=shape_tag,
                          qualifier=qualifier).latency_ns

    # -- Little's law -------------------------------------------------------
    def _worst(self, pool: str, obs_strat: str,
               stress_strat: str) -> SurfaceQuery:
        surf = self._resolve(pool, obs_strat, pool, stress_strat, "")[1]
        n_max = surf.axis(AXIS_N).values[-1]
        return self.query(pool, n_max, obs_strat=obs_strat,
                          stress_strat=stress_strat)

    def mlp(self, pool: str, line_bytes: int,
            stress_strat: str = "r") -> float:
        """Avg MLP = Avg latency [ns/Tx] x Avg bandwidth [Tx/ns], computed
        at the worst-case scenario like Tables II/III."""
        lat = self._worst(pool, "l", stress_strat).latency_ns
        bw = self._worst(pool, "r", stress_strat).bandwidth_gbps
        return lat * (bw / line_bytes)

    # -- persistence ----------------------------------------------------------
    def save(self, path: str, schema: Optional[int] = None) -> None:
        """Write the database.  Default: the schema it carries (so
        legacy-loaded files re-save in their own format); pass
        ``schema=2`` to downgrade a v3 database — multi-axis surfaces
        slice back into tagged per-shape curves, losslessly for every
        grid point."""
        schema = self.schema if schema is None else schema
        if schema >= CURVEDB_SCHEMA:
            doc: Dict[str, Any] = {
                "schema": CURVEDB_SCHEMA,
                "platform": self.platform,
                "surfaces": [dict(key=asdict(k), **s.to_dict())
                             for k, s in self.surfaces.items()],
                "meta": self.meta}
        else:
            doc = {"schema": schema,
                   "platform": self.platform,
                   "curves": {k: [asdict(p) for p in v]
                              for k, v in self.curves.items()},
                   "provenance": self.provenance,
                   "meta": self.meta}
        # atomic: write a sibling temp file and rename over the
        # target, so a crash (or injected fault) mid-save leaves any
        # existing database intact instead of torn
        d = os.path.dirname(os.path.abspath(path))
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".curvedb-",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    @staticmethod
    def load(path: str) -> "CurveDB":
        with open(path) as f:
            d = json.load(f)
        # schema 1 (the seed format) has no "schema" key and no
        # provenance — old curve files keep working; v1/v2 curves each
        # become a 1-axis surface under their typed key
        schema = int(d.get("schema", 1))
        db = CurveDB(platform=d["platform"], schema=schema,
                     meta=d.get("meta", {}))
        if schema >= CURVEDB_SCHEMA:
            for entry in d["surfaces"]:
                db.surfaces[SurfaceKey(**entry["key"])] = \
                    Surface.from_dict(entry)
            return db
        prov = d.get("provenance", {})
        for k, pts in d["curves"].items():
            db.surfaces[SurfaceKey.from_string(k)] = Surface.from_points(
                [CurvePoint(**p) for p in pts], prov.get(k))
        return db


DEFAULT_BW_STRATS = ("r", "w")
DEFAULT_STRESS_STRATS = ("r", "w", "y")


def characterize(
    coord: CoreCoordinator,
    *,
    pools: Optional[Iterable[str]] = None,
    # default above the cache (5x the H100's 50 MB L2): the curves must
    # characterize the MODULE, not the cache in front of it (cache-fit
    # behaviour is the fig5 buffer sweep's subject instead)
    buffer_bytes: int = 256 << 20,
    obs_strategies: Tuple[str, ...] = DEFAULT_BW_STRATS + ("l",),
    stress_strategies: Tuple[str, ...] = DEFAULT_STRESS_STRATS,
    stress_shapes: Optional[
        Iterable[Tuple[str, TrafficShape]]] = None,
    iters: int = 500,
    batched: bool = True,
    journal=None,
) -> CurveDB:
    """Build the curve database for the scenario matrix.

    Default matrix = the seed's steady cross-product (so existing
    consumers see identical keys); pass ``stress_shapes`` — e.g.
    :data:`repro_torch.core.scenarios.DEFAULT_STRESS_SHAPES` — to add shaped
    stressor scenarios (mixed r/w ratios, bursts, copies, strided
    chases) on top.
    """
    platform = coord.platform
    pool_names = list(pools) if pools is not None else [
        p.node.name for p in coord.pools.pools()
        if p.node.kind != "vmem"]      # vmem probed via small buffers
    shapes: List[Tuple[str, TrafficShape]] = [
        (s, TrafficShape.steady()) for s in stress_strategies]
    if stress_shapes is not None:
        for pair in stress_shapes:
            if pair not in shapes:
                shapes.append(pair)

    specs: List[ScenarioSpec] = []
    for op in pool_names:
        cap = coord.pools.pool(op).node.size_bytes
        nbytes = min(buffer_bytes, cap // 2)
        for ostrat in obs_strategies:
            for sp in pool_names:
                s_cap = coord.pools.pool(sp).node.size_bytes
                s_bytes = min(buffer_bytes, s_cap // 2)
                for sstrat, shape in shapes:
                    spec = ScenarioSpec(
                        name=f"{op}.{ostrat}|{sp}.{sstrat}"
                             f"{('@' + shape.tag()) if shape.tag() else ''}",
                        observer=ObserverSpec(ostrat, op, (nbytes,)),
                        stressors=(StressorSpec(sstrat, sp, s_bytes,
                                                shape),),
                        iters=iters)
                    specs.append(spec)
    return characterize_matrix(coord, specs, batched=batched,
                               journal=journal)


def characterize_matrix(coord: CoreCoordinator,
                        specs: List[ScenarioSpec], *,
                        batched: bool = True,
                        journal=None) -> CurveDB:
    """Run an explicit scenario matrix and persist it as a CurveDB.

    Each curve's provenance records the scenario spec AND an
    ``execution`` entry (which backend produced it, which ladder rungs
    were *executed* vs *modeled*, what ``activity`` ran the measured
    pass — "cuda" kernels, their "plain" PyTorch versions, or "none" —
    and whether co-observers were ``coupled`` into the model) — a curve
    whose uncontended observer was measured on the card is
    distinguishable from a pure queueing-model curve after the fact,
    and a coupled curve from an uncoupled one.

    ``journal=<path>`` (crash-resumable sweeps) belongs to the
    multi-engine path, which is not ported: the coordinator raises."""
    result: MatrixResult = coord.run_matrix(specs, batched=batched,
                                            journal=journal)
    return curvedb_from_result(result, coord.platform.name,
                               backend=coord.backend)


def _stats_meta(result: MatrixResult, backend: str) -> Dict[str, Any]:
    return {
        "backend": backend,
        "n_scenarios": result.stats.n_scenarios,
        "n_ladders": result.stats.n_ladders,
        "measure_dispatches": result.stats.measure_dispatches,
        "model_evals": result.stats.model_evals,
        "spmd_rungs": result.stats.spmd_rungs,
        "host_sync_dispatches": result.stats.host_sync_dispatches,
        "program_cache_hits": result.stats.program_cache_hits,
        # sweep-level megabatching + build attribution of the spmd
        # backend: distinct stacked-signature groups, programs actually
        # built, and how many compiled ahead of time (always 0 here: the
        # ladder is one kernel, built once by nvcc)
        "spmd_groups": result.stats.spmd_groups,
        "programs_built": result.stats.programs_built,
        "aot_compiles": result.stats.aot_compiles,
        # engine-subset width-packing of the same path: ladders run
        # side by side on disjoint subsets, and the subset width
        "packed_ladders": result.stats.packed_ladders,
        "subset_width": result.stats.subset_width,
        # resilient execution of the same path: injected faults,
        # retries and degradations survived, quality-gate activity,
        # resumed groups
        "faults_injected": result.stats.faults_injected,
        "retried_dispatches": result.stats.retried_dispatches,
        "degraded_ladders": result.stats.degraded_ladders,
        "modeled_floor_ladders": result.stats.modeled_floor_ladders,
        "noisy_remeasures": result.stats.noisy_remeasures,
        "noisy_rungs": result.stats.noisy_rungs,
        "resumed_ladders": result.stats.resumed_ladders,
    }


def _run_entry(run) -> Dict[str, Any]:
    entry = run.spec.to_dict()
    entry["curve"] = {"observer": (asdict(run.observer)
                                   if run.observer is not None
                                   else None),
                      "buffer_bytes": run.buffer_bytes}
    return entry


def _run_points(run) -> List[CurvePoint]:
    # the curve methods pick executed values where the backend ran
    # the rung and modeled values elsewhere
    return [CurvePoint(k, bw, lat)
            for (k, bw), (_k, lat) in zip(run.bandwidth_curve(),
                                          run.latency_curve())]


def curvedb_from_result(result: MatrixResult, platform: str, *,
                        backend: str = "") -> CurveDB:
    """Persist an already-executed :class:`MatrixResult` as a CurveDB
    of 1-axis surfaces (no re-execution — callers that want both the
    runs and the DB pass their ``run_matrix`` result here instead of
    characterizing twice)."""
    db = CurveDB(platform=platform)
    db.meta = _stats_meta(result, backend)
    for run in result.runs:
        entry = _run_entry(run)
        key = SurfaceKey.from_string(run.key)
        prev = db.surfaces.get(key)
        if prev is not None and {k: v for k, v in prev.provenance.items()
                                 if k != "execution"} != entry:
            # distinct scenarios/observers/buffers aliasing one key
            # (e.g. shape tags rounding to the same spelling) must not
            # silently overwrite curves
            raise ValueError(
                f"curve key collision: {run.key!r} produced by both "
                f"{prev.provenance['name']!r} and {run.spec.name!r}")
        entry["execution"] = run.execution
        db.surfaces[key] = Surface.from_points(_run_points(run), entry)
    return db


# ---------------------------------------------------------------------------
# The surface sweep (the tentpole: rf x dc x stressor-count in one matrix)
# ---------------------------------------------------------------------------


def characterize_surface(
    coord: CoreCoordinator,
    *,
    pools: Optional[Iterable[str]] = None,
    stress_pools: Optional[Iterable[str]] = None,
    buffer_bytes: int = 256 << 20,
    obs_strategies: Tuple[str, ...] = ("r", "l"),
    rw_ratios: Sequence[float] = DEFAULT_RW_RATIOS,
    inject_rates: Sequence[float] = DEFAULT_INJECT_RATES,
    iters: int = 500,
    max_stressors: Optional[int] = None,
    batched: bool = True,
    journal=None,
) -> CurveDB:
    """Characterize full bandwidth–latency surfaces.

    Emits the rf x dc x stressor-count scenario grid
    (:func:`repro_torch.core.scenarios.surface_matrix`) and runs it
    through ONE ``run_matrix`` call: the grid varies only the stressors'
    ``TrafficShape``, so every observer of one pool and strategy lands in
    one signature group, measured in one launch per chunk, and the
    resulting ``meta`` records the :class:`DispatchStats` proof
    (``measure_dispatches``).

    Returns a CurveDB whose entries are dense 3-axis surfaces keyed
    ``(obs_pool, obs_strat, stress_pool, "b")`` — one surface per
    observer/stressor pool pairing, answering interpolated queries at
    any (n_stressors, rw_ratio, inject_rate) coordinate.
    """
    rws = tuple(sorted(float(v) for v in rw_ratios))
    irs = tuple(sorted(float(v) for v in inject_rates))
    if len(set(rws)) != len(rws) or len(set(irs)) != len(irs):
        raise ValueError("surface grid values must be unique")
    pool_names = list(pools) if pools is not None else [
        p.node.name for p in coord.pools.pools()
        if p.node.kind != "vmem"]
    s_pools = list(stress_pools) if stress_pools is not None else pool_names

    specs: List[ScenarioSpec] = []
    for op in pool_names:
        cap = coord.pools.pool(op).node.size_bytes
        nb_o = min(buffer_bytes, cap // 2)
        for sp in s_pools:
            s_cap = coord.pools.pool(sp).node.size_bytes
            nb = min(nb_o, s_cap // 2)
            specs.extend(surface_matrix(
                pools=[op], stress_pools=[sp], buffer_bytes=nb,
                obs_strategies=obs_strategies, rw_ratios=rws,
                inject_rates=irs, iters=iters,
                max_stressors=max_stressors))
    result = coord.run_matrix(specs, batched=batched, journal=journal)
    return surfacedb_from_result(result, coord.platform.name,
                                 rw_ratios=rws, inject_rates=irs,
                                 backend=coord.backend)


def surfacedb_from_result(result: MatrixResult, platform: str, *,
                          rw_ratios: Sequence[float],
                          inject_rates: Sequence[float],
                          backend: str = "") -> CurveDB:
    """Assemble an executed surface-grid :class:`MatrixResult` into
    dense 3-axis surfaces (axes: n_stressors, rw_ratio, inject_rate).
    Per-surface provenance keeps every grid cell's scenario spec and
    execution record under its shape tag."""
    rws = tuple(sorted(float(v) for v in rw_ratios))
    irs = tuple(sorted(float(v) for v in inject_rates))
    db = CurveDB(platform=platform)
    db.meta = _stats_meta(result, backend)
    db.meta["surface"] = {"rw_ratios": list(rws), "inject_rates": list(irs)}

    grouped: Dict[SurfaceKey, Dict[Tuple[float, float], Any]] = {}
    for run in result.runs:
        if len(run.spec.stressors) != 1 or run.observer is None:
            raise ValueError(
                f"{run.spec.name!r}: surface grids are single-stressor, "
                f"single-observer scenarios")
        s = run.spec.stressors[0]
        key = SurfaceKey(run.observer.pool, run.observer.strategy,
                         s.pool, s.strategy)
        cell = (s.shape.read_fraction, s.shape.duty_cycle)
        grouped.setdefault(key, {})[cell] = run

    for key, cells in grouped.items():
        missing = [(rf, dc) for rf in rws for dc in irs
                   if (rf, dc) not in cells]
        if missing:
            raise ValueError(
                f"surface {key.to_string()!r} missing grid cells "
                f"{missing}")
        first_pts = _run_points(cells[(rws[0], irs[0])])
        n_values = tuple(float(p.n_stressors) for p in first_pts)
        bw = []
        lat = []
        prov_cells: Dict[str, Any] = {}
        for i in range(len(n_values)):
            bw.append([[0.0] * len(irs) for _ in rws])
            lat.append([[0.0] * len(irs) for _ in rws])
        for j, rf in enumerate(rws):
            for k, dc in enumerate(irs):
                run = cells[(rf, dc)]
                pts = _run_points(run)
                if tuple(float(p.n_stressors) for p in pts) != n_values:
                    raise ValueError(
                        f"surface {key.to_string()!r}: ladder depth "
                        f"differs across grid cells")
                for i, p in enumerate(pts):
                    bw[i][j][k] = p.bandwidth_gbps
                    lat[i][j][k] = p.latency_ns
                entry = _run_entry(run)
                entry["execution"] = run.execution
                prov_cells[TrafficShape.traffic(rf, dc).tag()] = entry
        db.surfaces[key] = Surface(
            axes=(SurfaceAxis(AXIS_N, n_values),
                  SurfaceAxis(AXIS_RW, rws),
                  SurfaceAxis(AXIS_IR, irs)),
            bandwidth_gbps=bw, latency_ns=lat,
            provenance={"grid": {"rw_ratios": list(rws),
                                 "inject_rates": list(irs)},
                        "cells": prov_cells})
    return db


# ---------------------------------------------------------------------------
# Targeted-cell online refresh (serving-time re-characterization)
# ---------------------------------------------------------------------------

#: qualifier under which online re-characterization stores refreshed
#: surfaces (the serving watchdog's probe sweeps) — consumers opt in
#: via ``db.query(..., qualifier=ONLINE_QUALIFIER)``, which prefers the
#: online surface at every resolution-ladder step and falls through to
#: the offline one when no refresh has happened yet.
ONLINE_QUALIFIER = "online"


def refresh_surface_cells(
    coord: CoreCoordinator,
    db: CurveDB,
    *,
    pools: Iterable[str],
    rw_ratio: float,
    inject_rate: float,
    stress_pools: Optional[Iterable[str]] = None,
    obs_strategies: Tuple[str, ...] = ("r", "l"),
    buffer_bytes: int = 64 << 10,
    iters: int = 50,
    max_stressors: Optional[int] = None,
    qualifier: str = ONLINE_QUALIFIER,
    drift: Optional[Dict[str, Any]] = None,
    batched: bool = True,
    journal=None,
) -> Tuple[List[SurfaceKey], Dict[str, Any]]:
    """Re-characterize ONE surface grid cell at live coordinates.

    Instead of the full rf x dc grid, this sweeps only the
    ``(rw_ratio, inject_rate)`` cell the serving engine is actually
    operating at — a single-cell probe sweep small enough to run in
    the background of a serving loop.  Each refreshed surface is
    stored *into* ``db`` under ``qualifier`` (default
    :data:`ONLINE_QUALIFIER`) as a single-point rw/ir surface that
    REPLACES any previous online surface for the same pairing: the
    online qualifier always reflects the latest observed regime, it
    is not a merged history (the offline full-grid surface stays
    untouched underneath it).

    Provenance: each refreshed surface records ``provenance["online"]``
    with the refresh ordinal, the caller's ``drift`` evidence
    (observed-vs-predicted gap), and the sweep's resilience stats
    (faults injected, degradations, noisy rungs ...) so a surface that
    survived a chaotic probe sweep is distinguishable from a clean one.

    ``journal=<path>`` (crash-resumable probe sweeps) belongs to the
    multi-engine path, which is not ported: the coordinator raises.

    Returns ``(refreshed_keys, stats_meta)``.
    """
    rw = float(rw_ratio)
    ir = float(inject_rate)
    pool_names = list(pools)
    s_pools = list(stress_pools) if stress_pools is not None else pool_names

    specs: List[ScenarioSpec] = []
    for op in pool_names:
        cap = coord.pools.pool(op).node.size_bytes
        nb_o = min(buffer_bytes, cap // 2)
        for sp in s_pools:
            s_cap = coord.pools.pool(sp).node.size_bytes
            nb = min(nb_o, s_cap // 2)
            specs.extend(surface_matrix(
                pools=[op], stress_pools=[sp], buffer_bytes=nb,
                obs_strategies=obs_strategies, rw_ratios=(rw,),
                inject_rates=(ir,), iters=iters,
                max_stressors=max_stressors, name_prefix="online."))
    result = coord.run_matrix(specs, batched=batched, journal=journal)
    fresh = surfacedb_from_result(result, coord.platform.name,
                                  rw_ratios=(rw,), inject_rates=(ir,),
                                  backend=coord.backend)
    stats = _stats_meta(result, coord.backend)

    refreshed: List[SurfaceKey] = []
    for key, surf in fresh.surfaces.items():
        qkey = SurfaceKey(key.obs_pool, key.obs_strat, key.stress_pool,
                          key.stress_strat, tag=key.tag,
                          qualifier=qualifier)
        prev = db.surfaces.get(qkey)
        n_prev = (prev.provenance.get("online", {}).get("refreshes", 0)
                  if prev is not None else 0)
        surf.provenance["online"] = {
            "refreshes": n_prev + 1,
            "coord": {AXIS_RW: rw, AXIS_IR: ir},
            "drift": dict(drift or {}),
            "sweep": stats,
        }
        db.surfaces[qkey] = surf
        refreshed.append(qkey)
    return refreshed, stats


def mlp_table(db: CurveDB, platform: Platform) -> str:
    """Tables II/III, for every characterized module."""
    lines = ["pool      pairing        lat(ns/Tx)  BW(Tx/ns)   MLP"]
    for pool in db.observer_pools():
        for stress in ("r", "w"):
            try:
                lat = db._worst(pool, "l", stress).latency_ns
                bw = db._worst(pool, "r", stress).bandwidth_gbps
            except KeyError:
                continue
            tx = bw / platform.line_bytes
            lines.append(
                f"{pool:9s} (l,{stress})x(r,{stress})  {lat:10.2f}"
                f"  {tx:9.4f}  {lat * tx:5.2f}")
    return "\n".join(lines)

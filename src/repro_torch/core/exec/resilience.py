"""resilience — fault injection, retry-with-degradation, quality gate.

The paper owns its hardware; this reproduction earns the same
consistency through detection and recovery.  Everything wraps the
Dispatcher — degradation is a PLAN rewrite (planner-seam convention):

* :class:`FaultSpec`/:class:`FaultInjector` — deterministic seeded
  fault injection (compile/runtime/timeout/corrupt-timing rates) that
  plugs into ``Dispatcher(faults=...)``; every draw is a pure sha256
  of ``(seed, site, phase, attempt)``, so schedules are
  byte-reproducible and retry attempts see fresh draws.  Set via
  ``CoreCoordinator(faults=...)`` or ``REPRO_FAULT_SPEC`` (CI chaos).

* :func:`run_group` — retries a failed planned dispatch with capped
  exponential backoff, then degrades ``packed -> batched -> fused
  ladder -> per-rung -> modeled`` via the pure plan rewrites
  (``unpack_dispatch``/``split_ladders``), isolating failure to its
  signature group; provenance records ``attempts`` /
  ``degraded_from`` / ``fault_kind``.

* :class:`QualityGate` — per-rung ``rung_time_spread_ns`` vs a
  relative threshold; noisy device-timed groups re-measure up to N
  times (counted in ``stats.noisy_remeasures`` + extra
  ``host_sync_dispatches``; logical counters stay stable) before
  rungs are flagged ``noisy=True`` instead of silently persisted.

Sweep-level orchestration (plan execution + the crash-resume journal)
lives in the sibling :mod:`repro_torch.core.exec.journal`.

A copy of the JAX package's module (``repro/core/exec/resilience.py``)
with its imports re-pointed: the same env var, spellings, hash draws and
ladder, so one seed gives the same fault schedule in both packages.  One
change: a fused group's ``timing_source`` is the dispatcher's clock
(``"device"`` on the card, ``"host"`` for the plain version on the CPU)
where the reference always writes ``"device"``.  And one rule of the
card's: with ``activity == "cuda"`` a failure the card itself raised (a
build, a launch, a CUDA error, running out of memory) is never retried,
degraded or modeled, but raised (:func:`is_fatal`); only injected faults
and corrupt decoded timings walk the ladder there, so a CurveDB from the
card holds kernel results or nothing.
"""
from __future__ import annotations

import hashlib
import logging
import math
import os
import time as _time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.exec import plan as exec_plan

log = logging.getLogger(__name__)

ENV_FAULT_SPEC = "REPRO_FAULT_SPEC"

#: the injectable fault kinds, in ladder order of their injection site
FAULT_KINDS = ("compile_error", "runtime_error", "timeout",
               "corrupt_timing")

_PHASE_KINDS = {"compile": ("compile_error",),
                "dispatch": ("runtime_error", "timeout"),
                "decode": ("corrupt_timing",)}

#: programming errors retrying cannot fix — surface immediately,
#: wrapped with the failing group's context
_NON_RETRYABLE = (ValueError, TypeError, KeyError, IndexError,
                  AttributeError, AssertionError)


class InjectedFault(RuntimeError):
    """A fault the :class:`FaultInjector` decided to fire."""

    def __init__(self, kind: str, site: str):
        self.kind = kind
        self.site = site
        super().__init__(f"injected {kind} at site {site}")


class _CorruptTiming(RuntimeError):
    """Decoded timings failed validation (non-finite/non-positive)."""


class GroupExecutionError(RuntimeError):
    """A dispatch failed — and the error names WHICH group (spec
    names, observer keys, buffers) instead of a bare traceback."""

    def __init__(self, context: str, cause: BaseException):
        self.context = context
        self.cause = cause
        super().__init__(f"{context}: {cause!r}")


def group_context(entries) -> str:
    specs = sorted({e.spec.name for e in entries})
    observers = sorted({f"{e.observer.pool}:{e.observer.strategy}"
                        for e in entries})
    bufs = sorted({e.buffer_bytes for e in entries})
    return (f"dispatch group (specs={specs}, observers={observers}, "
            f"buffers={bufs})")


def is_fatal(exc: BaseException, activity: str) -> bool:
    """True for an error no retry, degradation or modeled floor may
    cover: a programming error anywhere, and on the card (``"cuda"``)
    every error but an injected fault or a corrupt decoded timing."""
    if isinstance(exc, _NON_RETRYABLE):
        return True
    return activity == "cuda" and not isinstance(
        exc, (InjectedFault, _CorruptTiming))


def classify_fault(exc: BaseException) -> str:
    kind = getattr(exc, "kind", None)
    if isinstance(kind, str) and kind in FAULT_KINDS:
        return kind
    if isinstance(exc, _CorruptTiming):
        return "corrupt_timing"
    if isinstance(exc, TimeoutError):
        return "timeout"
    return "runtime_error"


# ---------------------------------------------------------------------------
# Fault specification + deterministic injector
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FaultSpec:
    """Per-kind injection rates (probability per injection site visit)
    plus the seed every draw hashes against."""
    compile_error: float = 0.0
    runtime_error: float = 0.0
    timeout: float = 0.0
    corrupt_timing: float = 0.0
    seed: int = 0

    def __post_init__(self):
        for k in FAULT_KINDS:
            r = getattr(self, k)
            if not 0.0 <= r <= 1.0:
                raise ValueError(f"fault rate {k}={r} outside [0, 1]")

    def rate(self, kind: str) -> float:
        return float(getattr(self, kind))

    def injector(self) -> "FaultInjector":
        return FaultInjector(self)

    @staticmethod
    def parse(text: str) -> "FaultSpec":
        """Parse the ``REPRO_FAULT_SPEC`` spelling: comma-separated
        ``key=value`` over ``compile``/``runtime``/``timeout``/
        ``corrupt`` (long spellings accepted), ``seed``, and
        ``mixed=R`` splitting R evenly — e.g. ``"mixed=0.25,seed=3"``."""
        alias = {"compile": "compile_error", "runtime": "runtime_error",
                 "corrupt": "corrupt_timing"}
        vals: Dict[str, float] = {}
        seed, mixed = 0, None
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"fault spec field {part!r}: "
                                 f"expected key=value")
            k, v = (s.strip() for s in part.split("=", 1))
            k = alias.get(k, k)
            if k == "seed":
                seed = int(v)
            elif k == "mixed":
                mixed = float(v)
            elif k in FAULT_KINDS:
                vals[k] = float(v)
            else:
                raise ValueError(f"unknown fault spec field {k!r}")
        if mixed is not None:
            for k in FAULT_KINDS:
                vals.setdefault(k, mixed / len(FAULT_KINDS))
        return FaultSpec(seed=seed, **vals)

    @staticmethod
    def from_env(environ=None) -> Optional["FaultSpec"]:
        env = os.environ if environ is None else environ
        text = (env.get(ENV_FAULT_SPEC) or "").strip()
        if not text or text.lower() in ("0", "off", "none"):
            return None
        return FaultSpec.parse(text)


class FaultInjector:
    """Per-(site, phase) attempt counters over stateless hash draws:
    attempt ``a`` draws ``sha256(f"{seed}|{site}|{phase}|{a}")`` in
    [0, 1) — pure, so one seed gives byte-identical schedules for the
    same site visits, and a RETRY (attempt a+1) sees a fresh draw."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self._attempt: Dict[Tuple[str, str], int] = {}

    def draw(self, site: str, phase: str, attempt: int) -> float:
        msg = f"{self.spec.seed}|{site}|{phase}|{attempt}".encode()
        h = hashlib.sha256(msg).digest()
        return int.from_bytes(h[:8], "big") / 2.0 ** 64

    def check(self, site: str, phase: str) -> Optional[str]:
        key = (site, phase)
        attempt = self._attempt.get(key, 0)
        self._attempt[key] = attempt + 1
        u = self.draw(site, phase, attempt)
        acc = 0.0
        for kind in _PHASE_KINDS[phase]:
            acc += self.spec.rate(kind)
            if u < acc:
                return kind
        return None

    def error(self, kind: str, site: str) -> InjectedFault:
        return InjectedFault(kind, site)


# ---------------------------------------------------------------------------
# Retry policy + measurement quality gate
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """``retries`` extra attempts per ladder level with capped
    exponential backoff (``backoff_s * 2**n``, cap ``backoff_cap_s``);
    ``degrade=False`` disables the ladder (exhaustion goes straight to
    the floor), ``modeled_floor=False`` turns the floor into a raised
    :class:`GroupExecutionError` instead of modeled rungs."""
    retries: int = 1
    backoff_s: float = 0.05
    backoff_cap_s: float = 1.0
    degrade: bool = True
    modeled_floor: bool = True
    sleep: Callable[[float], None] = field(default=_time.sleep,
                                           repr=False)

    def pause(self, n: int) -> None:
        delay = min(self.backoff_cap_s, self.backoff_s * (2.0 ** n))
        if delay > 0:
            self.sleep(delay)


@dataclass(frozen=True)
class QualityGate:
    """Per-rung spread acceptance: a rung whose sample spread exceeds
    ``rel_spread`` times its median (and the absolute
    ``min_spread_ns`` floor — microsecond rungs jitter harmlessly) is
    *noisy*.  Device-timed dispatches re-measure up to ``remeasure``
    times, keeping each rung's lower-spread sample set; rungs still
    noisy after that are flagged ``noisy=True`` in provenance.  The
    default is a wide guard (spread 8x median) firing only on real
    interference, so zero-noise accounting normally holds exactly."""
    rel_spread: float = 8.0
    remeasure: int = 2
    min_spread_ns: float = 100_000.0

    def noisy(self, med: float, spread: float) -> bool:
        return (spread > self.min_spread_ns
                and spread > self.rel_spread * max(med, 1e-9))


def resolve_faults(faults, environ=None) -> Optional[FaultSpec]:
    """``CoreCoordinator(faults=...)`` resolution: ``None`` reads
    ``REPRO_FAULT_SPEC``; ``False``/``"off"`` disables even with the
    env var set; a string parses; a FaultSpec passes through."""
    if faults is None:
        return FaultSpec.from_env(environ)
    if faults is False or (isinstance(faults, str)
                           and faults.lower() in ("off", "none")):
        return None
    if isinstance(faults, str):
        return FaultSpec.parse(faults)
    if isinstance(faults, FaultSpec):
        return faults
    raise TypeError(f"faults must be None, False, 'off', a spec "
                    f"string or a FaultSpec — got {faults!r}")


def resolve_gate(quality) -> Optional[QualityGate]:
    if quality is None or quality == "auto":
        return QualityGate()
    if quality is False or quality == "off":
        return None
    if isinstance(quality, QualityGate):
        return quality
    raise TypeError(f"quality must be None, 'auto', 'off', False or a "
                    f"QualityGate — got {quality!r}")


# ---------------------------------------------------------------------------
# Resilient group execution (the retry-degradation ladder)
# ---------------------------------------------------------------------------


@dataclass
class EntryOutcome:
    """One ladder's final result: per-rung observer nanoseconds
    (``None`` = fell to the modeled floor for that rung) plus the full
    per-curve timing/resilience provenance dict."""
    entry: Any                          # plan.LadderEntry
    med: List[Optional[float]]
    fenced: bool
    timing: Dict[str, Any]


@dataclass
class _Ctx:
    dispatcher: Any
    n_eng: int
    activity: str
    mode: str
    stats: Any
    policy: RetryPolicy
    gate: Optional[QualityGate]


class _GroupState:
    """Mutable per-group resilience bookkeeping threaded through the
    degradation recursion (split children get a copy of the prefix)."""
    __slots__ = ("attempts", "fault_kind", "path", "remeasures")

    def __init__(self, attempts=0, fault_kind=None, path=None,
                 remeasures=0):
        self.attempts = attempts
        self.fault_kind = fault_kind
        self.path = list(path or ())
        self.remeasures = remeasures

    def child(self) -> "_GroupState":
        return _GroupState(self.attempts, self.fault_kind, self.path,
                           self.remeasures)

    def note(self, exc: BaseException) -> None:
        self.fault_kind = classify_fault(exc)

    def origin(self) -> Optional[str]:
        return self.path[0] if self.path else None


def _timings_ok(med) -> bool:
    a = np.asarray(med, dtype=float)
    return bool(np.all(np.isfinite(a)) and np.all(a > 0))


def run_group(dispatcher, planned, *, n_eng: int, activity: str,
              mode: str, stats, policy: Optional[RetryPolicy] = None,
              gate: Optional[QualityGate] = None) -> List[EntryOutcome]:
    """Execute one planned dispatch resiliently: retry with backoff,
    walk the degradation ladder on exhaustion, quality-gate the
    timings.  Always returns one outcome per planned entry (modeled
    floor outcomes carry ``med=[None, ...]``); raises only
    :class:`GroupExecutionError` (non-retryable programming errors,
    or fault exhaustion under ``modeled_floor=False``)."""
    ctx = _Ctx(dispatcher, n_eng, activity, mode, stats,
               policy or RetryPolicy(), gate)
    return _run_group(ctx, planned, _GroupState())


def _run_group(ctx: _Ctx, planned, state: _GroupState,
               ) -> List[EntryOutcome]:
    try:
        med, spread, fenced, aot = _attempt_planned(ctx, planned, state)
    except GroupExecutionError:
        raise
    except Exception as exc:
        if is_fatal(exc, ctx.activity):
            raise GroupExecutionError(group_context(planned.entries),
                                      exc) from exc
        return _degrade(ctx, planned, state, exc)
    med, spread, noisy = _apply_gate(ctx, planned, med, spread, state)
    return _pack_outcomes(ctx, planned, med, spread, fenced, aot,
                          state, noisy)


def _attempt_planned(ctx: _Ctx, planned, state: _GroupState):
    last: Optional[BaseException] = None
    for a in range(max(0, ctx.policy.retries) + 1):
        if a:
            ctx.stats.retried_dispatches += 1
            ctx.policy.pause(a - 1)
        state.attempts += 1
        try:
            med, spread, fenced, aot = ctx.dispatcher.run_planned(
                planned, ctx.n_eng, ctx.activity, ctx.mode, ctx.stats)
        except Exception as exc:
            if is_fatal(exc, ctx.activity):
                raise
            state.note(exc)
            last = exc
            continue
        if not _timings_ok(med):
            last = _CorruptTiming(
                f"{group_context(planned.entries)}: non-positive/"
                f"non-finite decoded rung times")
            state.note(last)
            continue
        return med, spread, fenced, aot
    raise last


def _apply_gate(ctx: _Ctx, planned, med, spread, state: _GroupState):
    gate = ctx.gate
    noisy = _noisy_cells(gate, med, spread)
    tries = 0
    while noisy and gate is not None and tries < gate.remeasure:
        tries += 1
        ctx.stats.noisy_remeasures += 1
        state.remeasures += 1
        try:
            med2, spread2, _f, _a = ctx.dispatcher.run_planned(
                planned, ctx.n_eng, ctx.activity, ctx.mode, ctx.stats)
        except Exception as exc:        # a fault burned the remeasure
            if is_fatal(exc, ctx.activity):
                raise
            state.note(exc)
            break
        # the remeasure re-ran the SAME rungs: keep the logical
        # counters stable — host_sync_dispatches + noisy_remeasures
        # carry the honest extra cost
        ctx.stats.measure_dispatches -= 1
        ctx.stats.spmd_rungs -= planned.group * planned.n_scen
        if planned.packed:
            ctx.stats.packed_ladders -= planned.group
        if not _timings_ok(med2):
            state.fault_kind = "corrupt_timing"
            continue
        better = spread2 < spread       # keep each rung's calmer set
        med = np.where(better, med2, med)
        spread = np.where(better, spread2, spread)
        noisy = _noisy_cells(gate, med, spread)
    if noisy:
        ctx.stats.noisy_rungs += len(noisy)
        log.warning("quality gate: %d rung(s) of %s still noisy after "
                    "%d re-measurement(s)", len(noisy),
                    group_context(planned.entries), tries)
    return med, spread, noisy


def _noisy_cells(gate: Optional[QualityGate], med,
                 spread) -> List[Tuple[int, int]]:
    if gate is None:
        return []
    return [(g, k) for g in range(med.shape[0])
            for k in range(med.shape[1])
            if gate.noisy(float(med[g, k]), float(spread[g, k]))]


def _degrade(ctx: _Ctx, planned, state: _GroupState,
             exc: BaseException) -> List[EntryOutcome]:
    log.warning("resilient dispatch: %s failed after %d attempt(s) "
                "(%s); degrading", group_context(planned.entries),
                state.attempts, state.fault_kind)
    if not ctx.policy.degrade:
        if ctx.policy.modeled_floor:
            return _modeled_outcomes(ctx, planned, state)
        raise GroupExecutionError(group_context(planned.entries),
                                  exc) from exc
    if planned.packed and not planned.probe:
        state.path.append("packed")
        return _run_group(ctx, exec_plan.unpack_dispatch(planned),
                          state)
    if planned.group > 1:
        state.path.append("packed" if planned.packed else "batched")
        outs: List[EntryOutcome] = []
        for sub in exec_plan.split_ladders(planned):
            outs.extend(_run_group(ctx, sub, state.child()))
        return outs
    state.path.append("ladder")
    return _run_rungs(ctx, planned, state)


def _attempt_rung(ctx: _Ctx, roles, kind, state: _GroupState):
    last: Optional[BaseException] = None
    for a in range(max(0, ctx.policy.retries) + 1):
        if a:
            ctx.stats.retried_dispatches += 1
            ctx.policy.pause(a - 1)
        state.attempts += 1
        try:
            elapsed, fenced, spread, aot = ctx.dispatcher.run_rung(
                roles, ctx.n_eng, ctx.activity, kind, ctx.stats)
        except Exception as exc:
            if is_fatal(exc, ctx.activity):
                raise
            state.note(exc)
            last = exc
            continue
        if not (math.isfinite(elapsed) and elapsed > 0):
            last = _CorruptTiming(f"non-positive rung time {elapsed}")
            state.note(last)
            continue
        return elapsed, fenced, spread, aot
    raise last


def _run_rungs(ctx: _Ctx, planned, state: _GroupState,
               ) -> List[EntryOutcome]:
    """The per-rung degradation floor: the single remaining ladder
    runs rung by rung on the host-timed legacy path; a rung that
    exhausts its retries is modeled (the rest of the ladder still
    measures)."""
    entry = planned.entries[0]
    med: List[Optional[float]] = []
    spreads: List[int] = []
    noisy_ks: List[int] = []
    fenced_all, aot_all, dispatches = True, True, 0
    for k in range(planned.n_scen):
        roles = exec_plan.rung_row(planned, k, ctx.n_eng)
        try:
            elapsed, fenced, spread, aot = _attempt_rung(
                ctx, roles, planned.kind, state)
        except GroupExecutionError:
            raise
        except Exception as exc:
            if is_fatal(exc, ctx.activity) or not ctx.policy.modeled_floor:
                raise GroupExecutionError(
                    group_context(planned.entries), exc) from exc
            state.note(exc)
            med.append(None)
            continue
        med.append(float(elapsed))
        spreads.append(int(spread))
        fenced_all = fenced_all and fenced
        aot_all = aot_all and aot
        dispatches += 1 + ctx.dispatcher.samples
        if ctx.gate is not None and ctx.gate.noisy(elapsed, spread):
            noisy_ks.append(k)          # host path: flag, no remeasure
    executed_any = any(m is not None for m in med)
    if noisy_ks:
        ctx.stats.noisy_rungs += len(noisy_ks)
    if not executed_any:
        state.path.append("rung")
        ctx.stats.modeled_floor_ladders += 1
    if state.path:
        ctx.stats.degraded_ladders += 1
    timing = {
        "timing_source": "host" if executed_any else "none",
        "samples": ctx.dispatcher.samples,
        "rung_time_spread_ns": spreads,
        "dispatches": dispatches,
        "remeasures": state.remeasures,
        "batched": False, "group_size": 1,
        "aot": aot_all if executed_any else False,
        "packed": False, "subset_width": ctx.n_eng, "subset_index": 0,
        "attempts": state.attempts,
        "degraded_from": state.origin(),
        "fault_kind": state.fault_kind,
        "noisy": bool(noisy_ks), "noisy_rungs": noisy_ks,
    }
    return [EntryOutcome(entry, med, fenced_all and executed_any,
                         timing)]


def _modeled_outcomes(ctx: _Ctx, planned,
                      state: _GroupState) -> List[EntryOutcome]:
    ctx.stats.modeled_floor_ladders += planned.group
    if state.path:
        ctx.stats.degraded_ladders += planned.group
    outs = []
    for e in planned.entries:
        timing = {
            "timing_source": "none",
            "samples": ctx.dispatcher.samples,
            "rung_time_spread_ns": [], "dispatches": 0,
            "remeasures": state.remeasures,
            "batched": False, "group_size": 1, "aot": False,
            "packed": False, "subset_width": ctx.n_eng,
            "subset_index": 0,
            "attempts": state.attempts,
            "degraded_from": state.origin(),
            "fault_kind": state.fault_kind,
            "noisy": False, "noisy_rungs": [],
        }
        outs.append(EntryOutcome(e, [None] * planned.n_scen, False,
                                 timing))
    return outs


def _pack_outcomes(ctx: _Ctx, planned, med, spread, fenced: bool,
                   aot: bool, state: _GroupState,
                   noisy) -> List[EntryOutcome]:
    noisy_by_g: Dict[int, List[int]] = {}
    for g, k in noisy:
        noisy_by_g.setdefault(g, []).append(k)
    if state.path:
        ctx.stats.degraded_ladders += planned.group
    outs = []
    for g, e in enumerate(planned.entries):
        _wave, subset = planned.member_slot(g)
        ks = noisy_by_g.get(g, [])
        timing = {
            # "device" on the card; the plain version's stamps are the
            # host's (the dispatcher says which)
            "timing_source": getattr(ctx.dispatcher, "clock_source",
                                     "device"),
            "samples": ctx.dispatcher.samples,
            "rung_time_spread_ns": [int(s) for s in spread[g]],
            "dispatches": 1 + state.remeasures,
            "remeasures": state.remeasures,
            "batched": ctx.mode == "batched",
            "group_size": planned.group,
            "aot": aot,
            "packed": planned.packed,
            "subset_width": planned.subset_width,
            "subset_index": subset,
            "attempts": state.attempts,
            "degraded_from": state.origin(),
            "fault_kind": state.fault_kind,
            "noisy": bool(ks), "noisy_rungs": ks,
        }
        outs.append(EntryOutcome(e, [float(m) for m in med[g]], fenced,
                                 timing))
    return outs

"""journal — sweep-level resilient execution + crash-resume journal.

The sweep layer above :mod:`repro_torch.core.exec.resilience`:
:func:`execute_plan` runs every planned dispatch of a DispatchPlan
through the resilient group path and folds outcomes into the
coordinator's triple-indexed maps; :func:`execute_rung_path` is the
legacy host-timed one-dispatch-per-rung loop behind the same retry
discipline; :class:`SweepJournal` is the append-only JSON-lines
sidecar that makes a killed sweep resumable — completed dispatch
groups restore VALUE-identically (exact decoded floats round-trip
through JSON) and only missing groups execute, with a warm program
cache making the restart cheap.

A copy of the JAX package's module (``repro/core/exec/journal.py``) with
its imports re-pointed: the journal format is the same, so a journal
written by either package restores in the other.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.exec import plan as exec_plan
from repro_torch.core.exec.assemble import observer_result
from repro_torch.core.exec.resilience import (
    EntryOutcome, GroupExecutionError, QualityGate, RetryPolicy,
    _Ctx, _GroupState, _attempt_rung, is_fatal, run_group)

log = logging.getLogger(__name__)


def entry_key(e) -> str:
    """Stable journal identity of one (spec, observer, buffer) ladder:
    spec name + CurveDB curve key + buffer (the curve key alone can
    legally collide across distinctly-named specs)."""
    return "|".join((e.spec.name,
                     e.spec.key_for(e.observer, e.buffer_bytes),
                     str(e.buffer_bytes)))


def plan_fingerprint(plan, n_eng: int, mode: str, activity: str,
                     samples: int) -> str:
    keys = sorted(entry_key(e) for d in plan.dispatches
                  for e in d.entries)
    doc = json.dumps([n_eng, mode, activity, samples, keys])
    return hashlib.sha256(doc.encode()).hexdigest()[:32]


class SweepJournal:
    """Append-only JSON-lines sweep journal: a fingerprint header,
    then one line per completed dispatch group carrying every member
    ladder's exact decoded timings and provenance.  Restoring replays
    those floats verbatim, so a resumed sweep's finished curves are
    VALUE-EQUAL to the run that wrote them."""

    VERSION = 1

    def __init__(self, path: str, fingerprint: str,
                 done: Dict[str, Dict[str, Any]]):
        self.path = path
        self.fingerprint = fingerprint
        self._done = done

    @classmethod
    def open(cls, path, fingerprint: str) -> "SweepJournal":
        path = os.fspath(path)
        done: Dict[str, Dict[str, Any]] = {}
        if os.path.exists(path) and os.path.getsize(path) > 0:
            with open(path, encoding="utf-8") as f:
                lines = f.read().splitlines()
            try:
                head = json.loads(lines[0])
            except ValueError:
                raise ValueError(f"sweep journal {path!r}: unreadable "
                                 f"header — delete it to start over")
            if head.get("fingerprint") != fingerprint:
                raise ValueError(
                    f"sweep journal {path!r} belongs to a different "
                    f"sweep (matrix/mode/mesh changed) — delete it or "
                    f"pass a fresh path")
            for line in lines[1:]:
                try:
                    rec = json.loads(line)
                except ValueError:
                    break               # torn tail line from a crash
                for ent in rec.get("entries", ()):
                    done[ent["key"]] = ent
            return cls(path, fingerprint, done)
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps({"journal": "repro-sweep",
                                "version": cls.VERSION,
                                "fingerprint": fingerprint}) + "\n")
            f.flush()
            os.fsync(f.fileno())
        return cls(path, fingerprint, done)

    def lookup(self, planned) -> Optional[List[Dict[str, Any]]]:
        """All of this dispatch's ladders, if EVERY one completed in a
        previous run (partial groups re-execute whole — a dispatch is
        the atomic unit of work)."""
        recs = []
        for e in planned.entries:
            r = self._done.get(entry_key(e))
            if r is None:
                return None
            recs.append(r)
        return recs

    def record(self, planned, outcomes: List[EntryOutcome]) -> None:
        ents = [{"key": entry_key(o.entry), "med": o.med,
                 "fenced": o.fenced, "timing": o.timing}
                for o in outcomes]
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps({"entries": ents}) + "\n")
            f.flush()
            os.fsync(f.fileno())
        for ent in ents:
            self._done[ent["key"]] = ent


def _fold(outcome: EntryOutcome, executed, fenced_by, timing_by):
    e = outcome.entry
    for k, m in enumerate(outcome.med):
        if m is not None:
            executed[(e.index, k)] = observer_result(
                e.observer, e.buffer_bytes, e.spec.iters,
                float(max(m, 1.0)))
    fenced_by[e.index] = outcome.fenced
    timing_by[e.index] = outcome.timing


def execute_plan(dispatcher, plan, *, n_eng: int, activity: str,
                 mode: str, stats, policy: Optional[RetryPolicy] = None,
                 gate: Optional[QualityGate] = None, journal=None,
                 ) -> Tuple[Dict, Dict, Dict]:
    """Run every planned dispatch of a DispatchPlan resiliently and
    fold the outcomes into the coordinator's
    ``(executed, fenced_by_triple, timing_by_triple)`` maps.  With a
    ``journal`` (path or open :class:`SweepJournal`), completed groups
    from a previous run restore value-identically and each newly
    completed group is journaled before the next starts."""
    executed: Dict[Tuple[int, int], Any] = {}
    fenced_by: Dict[int, bool] = {}
    timing_by: Dict[int, Dict[str, Any]] = {}
    jr: Optional[SweepJournal] = None
    if journal is not None:
        jr = journal if isinstance(journal, SweepJournal) else \
            SweepJournal.open(journal, plan_fingerprint(
                plan, n_eng, mode, activity, dispatcher.samples))
    for planned in plan.dispatches:
        if jr is not None:
            recs = jr.lookup(planned)
            if recs is not None:
                for e, r in zip(planned.entries, recs):
                    _fold(EntryOutcome(
                        e, [None if m is None else float(m)
                            for m in r["med"]],
                        bool(r["fenced"]), dict(r["timing"])),
                        executed, fenced_by, timing_by)
                stats.resumed_ladders += planned.group
                continue
        outcomes = run_group(dispatcher, planned, n_eng=n_eng,
                             activity=activity, mode=mode, stats=stats,
                             policy=policy, gate=gate)
        for o in outcomes:
            _fold(o, executed, fenced_by, timing_by)
        if jr is not None:
            jr.record(planned, outcomes)
    return executed, fenced_by, timing_by


def execute_rung_path(dispatcher, triples, *, n_eng: int, activity: str,
                      stats, depth_fn, pools,
                      policy: Optional[RetryPolicy] = None,
                      gate: Optional[QualityGate] = None,
                      ) -> Tuple[Dict, Dict, Dict]:
    """The legacy host-timed one-dispatch-per-rung path, now behind
    the same retry/flagging discipline: a faulted rung retries with
    backoff and then models (isolated to its rung); noisy host-timed
    rungs are flagged without re-measurement."""
    ctx = _Ctx(dispatcher, n_eng, activity, "rung", stats,
               policy or RetryPolicy(), gate)
    executed: Dict[Tuple[int, int], Any] = {}
    fenced_by: Dict[int, bool] = {}
    timing_by: Dict[int, Dict[str, Any]] = {}
    for i, (spec, obs, buf) in enumerate(triples):
        state = _GroupState()
        fenced = True
        noisy_ks: List[int] = []
        timing: Dict[str, Any] = {
            "timing_source": "host", "samples": dispatcher.samples,
            "rung_time_spread_ns": [], "dispatches": 0,
            "batched": False, "group_size": 1, "aot": True,
            "packed": False, "subset_width": n_eng, "subset_index": 0}
        for k in range(depth_fn(spec)):
            roles, role_pools = exec_plan.rung_roles(spec, obs, buf, k,
                                                     n_eng)
            kind = exec_plan.operand_kind(role_pools, pools)
            try:
                elapsed, rung_fenced, spread, rung_aot = _attempt_rung(
                    ctx, roles, kind, state)
            except Exception as exc:
                if is_fatal(exc, activity) or not ctx.policy.modeled_floor:
                    raise GroupExecutionError(
                        f"dispatch group (specs=[{spec.name!r}], "
                        f"observers=[{obs.pool!r}:{obs.strategy!r}], "
                        f"buffers=[{buf}])", exc) from exc
                state.note(exc)
                log.warning("rung %d of %s faulted (%s); modeled",
                            k, spec.name, state.fault_kind)
                continue
            executed[(i, k)] = observer_result(obs, buf, spec.iters,
                                               elapsed)
            fenced = fenced and rung_fenced
            timing["aot"] = timing["aot"] and rung_aot
            timing["rung_time_spread_ns"].append(spread)
            # 1 warm + the timed samples
            timing["dispatches"] += 1 + dispatcher.samples
            if gate is not None and gate.noisy(elapsed, spread):
                noisy_ks.append(k)
        if noisy_ks:
            stats.noisy_rungs += len(noisy_ks)
        timing.update({"remeasures": 0, "attempts": state.attempts,
                       "degraded_from": state.origin(),
                       "fault_kind": state.fault_kind,
                       "noisy": bool(noisy_ks),
                       "noisy_rungs": noisy_ks})
        fenced_by[i] = fenced
        timing_by[i] = timing
    return executed, fenced_by, timing_by

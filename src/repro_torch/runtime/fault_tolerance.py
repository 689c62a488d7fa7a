"""Fault tolerance: the resilient train loop and the straggler monitor.

The port of ``repro/runtime/fault_tolerance.py`` for one device:

* :class:`ResilientLoop` — wraps the train step; on an injected fault it
  restores the newest checkpoint, rebuilds the (restart-safe) data stream
  at the restored step, and continues.  Fault drills go through the
  SHARED seam (:class:`repro_torch.core.exec.resilience.FaultSpec` — one
  spelling, one env var, one deterministic hash schedule): pass
  ``faults="runtime=0.1,seed=3"`` / a :class:`FaultSpec`, or ``None`` to
  read ``REPRO_FAULT_SPEC`` as the sweep dispatcher does; ``fault_hook``
  takes a step-pinned drill (:func:`drill_at`).
* :class:`StragglerMonitor` — per-step wall-time EWMA + rolling median;
  a step slower than ``threshold x`` the running median is flagged.  The
  serving watchdog (:mod:`repro_torch.serve.monitor`) builds on it.
* :func:`drill_at` — a one-shot fault at a given step, in the shared
  fault spelling (:class:`repro_torch.core.exec.resilience.InjectedFault`).

* :func:`elastic_remesh` — a state moved onto another mesh (another
  shape, or fewer of the job's ranks) through the host.

On a mesh the loop's checkpoints go through a :class:`CheckpointManager`
given the state's placement (``shardings``): rank 0 writes the whole
state, and a restore re-cuts it to each rank's block.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.exec.resilience import (FaultInjector, FaultSpec,
                                              InjectedFault, resolve_faults)

__all__ = ["InjectedFault", "FaultSpec", "LoopResult", "ResilientLoop",
           "StragglerEvent", "StragglerMonitor", "drill_at",
           "elastic_remesh"]


@dataclass
class StragglerEvent:
    step: int
    wall_s: float
    median_s: float


class StragglerMonitor:
    """Per-step wall-time tracker: rolling median over ``window`` steps
    plus an exponentially-weighted moving average (``ewma_alpha``).
    :meth:`record` flags a step slower than ``threshold x`` the running
    median; :meth:`median` / ``ewma_s`` expose the smoothed state for
    composition (the serve watchdog's deviation test runs on them)."""

    def __init__(self, threshold: float = 3.0, window: int = 32,
                 ewma_alpha: float = 0.2):
        self.threshold = threshold
        self.window = window
        self.ewma_alpha = ewma_alpha
        self.ewma_s: Optional[float] = None
        self.times: List[float] = []
        self.events: List[StragglerEvent] = []

    def median(self, exclude_last: bool = False) -> Optional[float]:
        """Rolling median of the last ``window`` recorded steps."""
        hist = self.times[-self.window:]
        if exclude_last:
            hist = hist[:-1]
        if not hist:
            return None
        return float(np.median(hist))

    def reset(self) -> None:
        """Forget the timing history (events are kept) — called when
        the regime legitimately changed (re-mesh, cache migration)."""
        self.times.clear()
        self.ewma_s = None

    def record(self, step: int, wall_s: float) -> Optional[StragglerEvent]:
        self.times.append(wall_s)
        a = self.ewma_alpha
        self.ewma_s = (wall_s if self.ewma_s is None
                       else a * wall_s + (1.0 - a) * self.ewma_s)
        if len(self.times[-self.window:]) < 5:
            return None
        med = self.median(exclude_last=True)
        if wall_s > self.threshold * med:
            ev = StragglerEvent(step, wall_s, med)
            self.events.append(ev)
            return ev
        return None


def drill_at(at_step: int) -> Callable[[int], None]:
    """A step-pinned one-shot drill hook in the shared fault spelling:
    raises :class:`InjectedFault("runtime_error", ...)` the first time
    the loop reaches ``at_step``."""
    fired = {"done": False}

    def hook(step: int) -> None:
        if step == at_step and not fired["done"]:
            fired["done"] = True
            raise InjectedFault("runtime_error", f"train-drill-{step}")

    return hook


@dataclass
class LoopResult:
    final_step: int
    metrics_history: List[Dict[str, float]] = field(default_factory=list)
    restarts: int = 0
    faults_injected: int = 0
    straggler_events: List[StragglerEvent] = field(default_factory=list)
    # the state the loop ended with: a restore replaces the caller's
    # tensors, so an in-place step's caller reads its final state here
    state: Any = None


def _scalars(metrics) -> Dict[str, float]:
    """The 0-d metrics as floats: the tensors among them reach the host in
    one copy (one sync a step), the rest as they are."""
    keys = [k for k, v in metrics.items() if np.ndim(v) == 0]
    tens = [k for k in keys if isinstance(metrics[k], torch.Tensor)]
    out = {k: float(metrics[k]) for k in keys if k not in tens}
    if tens:
        vals = torch.stack([metrics[k].detach().to(torch.float64)
                            for k in tens]).tolist()
        out.update(zip(tens, vals))
    return {k: out[k] for k in keys}


class ResilientLoop:
    """Checkpoint/restart train loop with straggler tracking.

    ``step_fn(state, batch) -> (state, metrics)``; ``batch_fn(step) ->
    batch`` must be restart-safe (a pure function of the step index — see
    :class:`repro_torch.data.pipeline.SyntheticSource`).  The step may
    update the state in place (the port's train step does): a fault is
    injected before a step starts, so the state it interrupts is whole.

    On a mesh ``ckpt`` carries the state's placement: every rank steps
    and saves together, and a restore gives each rank its block of the
    restored state.

    ``faults`` resolves exactly like the sweep coordinator's
    (:func:`repro_torch.core.exec.resilience.resolve_faults`): ``None``
    reads ``REPRO_FAULT_SPEC``, ``False``/``"off"`` pins injection off, a
    spec string parses, a :class:`FaultSpec` passes through.  Each step
    is one injection site (``train-step-<n>``), so a restart that replays
    the step sees a fresh deterministic draw.  A restore puts every leaf
    back on the device and in the dtype of the state it replaces.  With
    ``ckpt=None`` nothing is written (a state too large for the disk's
    time): a fault then goes on from the state as it is, at the first
    step, as the reference does before its first checkpoint.
    """

    def __init__(self, step_fn: Callable, batch_fn: Callable,
                 ckpt: Optional[CheckpointManager], *, checkpoint_every: int = 100,
                 max_restarts: int = 3,
                 faults=False,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 monitor: Optional[StragglerMonitor] = None,
                 async_checkpoint: bool = True):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ckpt = ckpt
        self.checkpoint_every = checkpoint_every
        self.max_restarts = max_restarts
        self.fault_spec = resolve_faults(faults)
        self._injector: Optional[FaultInjector] = (
            self.fault_spec.injector() if self.fault_spec else None)
        self.fault_hook = fault_hook
        self.monitor = monitor or StragglerMonitor()
        self.async_checkpoint = async_checkpoint

    def _maybe_inject(self, step: int) -> None:
        if self._injector is not None:
            kind = self._injector.check(f"train-step-{step}", "dispatch")
            if kind is not None:
                raise self._injector.error(kind, f"train-step-{step}")
        if self.fault_hook is not None:
            self.fault_hook(step)

    def run(self, state, n_steps: int, start_step: int = 0) -> LoopResult:
        result = LoopResult(final_step=start_step)
        step = start_step
        restarts = 0
        while step < n_steps:
            try:
                self._maybe_inject(step)
                batch = self.batch_fn(step)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batch)
                scalars = _scalars(metrics)       # waits for the step
                wall = time.perf_counter() - t0
                ev = self.monitor.record(step, wall)
                if ev is not None:
                    result.straggler_events.append(ev)
                result.metrics_history.append(scalars)
                step += 1
                if self.ckpt is not None and (
                        step % self.checkpoint_every == 0
                        or step == n_steps):
                    if self.async_checkpoint:
                        self.ckpt.save_async(state, step)
                    else:
                        self.ckpt.save(state, step)
            except InjectedFault:
                result.faults_injected += 1
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                restore_step = None
                if self.ckpt is not None:
                    self.ckpt.wait()
                    restore_step = self.ckpt.latest_step()
                if restore_step is None:
                    # no checkpoint yet: go on from the state as it is, at
                    # the first step, as the reference does
                    step = start_step
                    continue
                state = self.ckpt.restore(state, restore_step)
                step = restore_step
        if self.ckpt is not None:
            self.ckpt.wait()
        result.final_step = step
        result.restarts = restarts
        result.state = state
        return result


# ---------------------------------------------------------------------------
# Elastic re-mesh
# ---------------------------------------------------------------------------


def elastic_remesh(state, new_shardings, *, shardings=None):
    """Move a state onto new placements (a tree of
    :class:`repro_torch.parallel.collectives.NamedSharding`, possibly on
    another mesh shape or on fewer of the job's ranks).  The state is
    gathered whole (from its blocks under ``shardings``; ``None``: it is
    whole already), copied to the host, and re-cut on the new mesh, each
    block on the device its leaf was on.  A rank outside the new mesh gets
    ``None``.  On a real fleet the same contract is met by a resharded
    checkpoint restore, so the whole state never sits on one host."""
    from repro_torch.parallel.collectives import gather_tree, shard
    whole = state if shardings is None else gather_tree(state, shardings)
    devices = [t.device for t in tree.leaves(state)]
    host = tree.tree_map(lambda t: t.detach().to("cpu", copy=True), whole)
    del whole
    mesh = tree.leaves(new_shardings)[0].mesh
    if mesh.rank is not None and not mesh.bound:
        return None
    flat = [shard(h, sh.spec, sh.mesh).to(d)
            for h, sh, d in zip(tree.leaves(host), tree.leaves(new_shardings),
                                devices)]
    return tree.unflatten_like(new_shardings, flat)

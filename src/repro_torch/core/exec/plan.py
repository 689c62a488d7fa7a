"""plan — the grouping decisions of the matrix runner.

The measured observer pass of ``run_matrix`` groups its (spec, observer,
buffer) triples through :func:`observer_groups`, so grouping logic lives
in exactly one place.  The rest of the JAX package's planner (the
dispatch plan of the multi-engine contention path, role tables,
engine-subset width-packing, probe batches) comes with that path.

Nothing in here touches the card: the plan is pure data.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Tuple

from repro_torch.core.scenarios import ScenarioSpec

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


def ladder_depth(spec: ScenarioSpec, platform_engines: int) -> int:
    """Rungs this spec's ladder measures: ``max_stressors + 1`` capped
    by the platform.  (The multi-engine path will also cap it by the
    engines a launch has, less one per coupled sibling observer.)"""
    n = (spec.max_stressors + 1 if spec.max_stressors is not None
         else platform_engines)
    n = min(n, platform_engines)
    return max(1, n)


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

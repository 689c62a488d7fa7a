"""fence — verification of the measured region's barrier pair.

The JAX package verifies its fence structurally, by walking the traced
program (``repro/core/exec/fence.py:measured_region_is_fenced``): the
measured work must depend on the start psum by dataflow, and a packed
program's collectives must be grouped along the declared engine subsets.
The port's ladder is one CUDA kernel whose program order is fixed, so it
verifies what the kernel DID, from the stamps every launch records:

* for every step and every barrier group, no engine began its role
  before the last engine of its group arrived at the start barrier
  (``max(arrive) <= min(begin)``), and the group leader's stop stamp
  follows every engine's end (``max(end) <= t1``);
* for a width-packed launch, the kernel's barrier groups isolate the
  declared subsets (:func:`groups_isolate`, the counterpart of
  ``_psum_groups_isolate``): each subset barriers on a counter of its own,
  so no engine's stamps fall under another subset's barrier.

The negative case — a launch whose start barrier does not wait, engines
arriving skewed — is refused by :func:`stamps_fenced`; ``chip_smoke.py``
and a card-only test show it on the card.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def groups_isolate(groups: Sequence[Sequence[int]],
                   subsets: Optional[Sequence[Sequence[int]]]) -> bool:
    """Do the kernel's barrier ``groups`` isolate the declared engine
    ``subsets``?  Each subset must be exactly one group (its own barrier
    — neither merged with a sibling nor split in half) and every other
    group disjoint from all subsets (leftover engines barriering among
    themselves are harmless).  Without subsets (an unpacked launch) one
    group must span every engine."""
    gset = {tuple(int(i) for i in g) for g in groups}
    if not subsets:
        return len(gset) == 1
    declared = {tuple(int(i) for i in s) for s in subsets}
    if not declared <= gset:
        return False
    members = {i for s in declared for i in s}
    return all(not (set(g) & members) for g in gset - declared)


def _ns(stamps: np.ndarray) -> np.ndarray:
    """(..., 2) int32 ``[s, ns]`` pairs as int64 nanoseconds."""
    s = np.asarray(stamps).astype(np.int64)
    return s[..., 0] * 1_000_000_000 + s[..., 1]


def stamps_fenced(out, layout) -> bool:
    """The fence of one launch, from its stamps (``out`` a
    :class:`repro_torch.kernels.contention.LadderOut` on the host,
    ``layout`` the launch's barrier groups and leaders)."""
    arrive, begin, end = (np.asarray(t) for t in (out.arrive, out.begin,
                                                 out.end))
    t1 = _ns(out.t1s)
    for g in layout.groups:
        idx = list(g)
        if (arrive[idx].max(axis=0) > begin[idx].min(axis=0)).any():
            return False
        lead = [e for e in idx if layout.leaders[e]]
        if lead and (end[idx].max(axis=0) > t1[lead[0]]).any():
            return False
    return True


def measured_region_is_fenced(out, layout, subsets=None) -> bool:
    """The port's ``measured_region_is_fenced``: the barrier layout
    isolates ``subsets`` and the launch's stamps keep the fence."""
    return groups_isolate(layout.groups, subsets) and \
        stamps_fenced(out, layout)

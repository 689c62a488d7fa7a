"""program — stage 2 of the spmd execution pipeline.

Turns a :class:`~repro_torch.core.exec.plan.PlannedDispatch` into a
:class:`CompiledProgram`: each engine's role as a descriptor (the
counterpart of the JAX package's branch closures, ``spmd_branch_fn`` /
``_pallas_branch_fn``), the operands placed in the planned memory, the
step table (waves x rungs x samples, one row a step), and the engine
groups that barrier together with their clock leaders.

A program is data, not code: every program runs on the one contention
ladder kernel (``kernels/csrc/contention.cu``), built once by ``nvcc``.
Nothing is traced or compiled per program, so ``aot`` stays False and
``DispatchStats.aot_compiles`` stays 0.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.exec import fence
from repro_torch.core.exec.plan import (PlannedDispatch, effective_duty,
                                        merge_probe_operand_roles)
from repro_torch.core.workloads import (LINE_BYTES, _fits_vmem,
                                        resolve_strategy)
from repro_torch.kernels import _build
from repro_torch.kernels import contention as kc
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import mixed_split

_SPMD_CHASES = ("l", "m", "t")      # latency walks: dependent loads
_SPMD_STREAM_2X = ("c", "x")        # copy/rmw touch two lines per line
LANE = LINE_BYTES // 4


def build_rung_operands(roles, n_eng: int, rows_max: int, *,
                        device="cpu", pin: bool = False,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-engine operands for one program: a float stream buffer and an
    int chase chain (seeded by engine index), padded to the widest role:
    the JAX package's bytes.  Built where they will be read: on
    ``device``, or in pinned host memory when ``pin``."""
    n = rows_max * LANE
    shape = (n_eng, rows_max, LANE)
    if pin:
        xf = torch.empty(shape, dtype=torch.float32, pin_memory=True)
        xf.copy_(torch.arange(n, dtype=torch.float32).reshape(rows_max,
                                                               LANE))
        xi = torch.zeros(shape, dtype=torch.int32, pin_memory=True)
    else:
        xf = (torch.arange(n, dtype=torch.float32, device=device)
              .reshape(1, rows_max, LANE).expand(shape).contiguous())
        xi = torch.zeros(shape, dtype=torch.int32, device=device)
    for e, (strategy, shape_, rows, _ri) in enumerate(roles):
        strat = resolve_strategy(strategy, shape_)
        if strat in _SPMD_CHASES:
            if strat == "t":
                chain = kops.strided_chain_buffer(
                    rows, getattr(shape_, "stride", 8) or 8)
            else:
                chain = kops.chain_buffer(rows, seed=e)
            xi[e, :rows, :chain.shape[1]] = torch.from_numpy(chain)
    return xf, xi


def role_descriptor(strategy: str, shape, rows: int,
                    iters: int) -> Tuple[int, ...]:
    """One engine's activity for one rung, as the ladder kernel's role
    row (``kernels.contention.ROLE_FIELDS`` ints): the counterpart of
    ``spmd_branch_fn(..., activity="pallas")``, which closes over the
    same (strategy, shape, rows, iters).  ``n`` active passes; ``i`` is
    the memory-idle spin whatever the activity, as in the reference."""
    strat = resolve_strategy(strategy, shape)
    n = max(1, int(round(iters * effective_duty(shape))))

    def role(code, rows_, read_rows=0, write_rows=0):
        return (code, rows_, n, read_rows, write_rows, 0, 0, 0)

    if strategy == "i":
        return role(kc.IDLE, 1)
    if strat in _SPMD_CHASES:
        shared = strat == "l" and _fits_vmem(rows * LINE_BYTES)
        return role(kc.CHASE_SHARED if shared else kc.CHASE_GLOBAL, rows)
    if strat == "y":
        return role(kc.SEEDED_WRITE, rows)
    if strat in ("w", "x"):
        # write-allocate: read + write back, carried — deliberate for
        # 'w' too (the reference's split, ROADMAP queue 3)
        return role(kc.RMW, rows)
    if strat == "c":
        return role(kc.COPY, rows)
    if strat == "b":
        rf = (shape.read_fraction
              if getattr(shape, "kind", None) == "mixed" else 0.5)
        blk, n_r, n_w = mixed_split(rows, rf, min(512, rows))
        return role(kc.MIXED, rows, n_r * blk, n_w * blk)
    return role(kc.READ, rows)                  # r / s: pure read stream


class Layout(NamedTuple):
    """The engines' barrier groups: ``group_of[e]`` the counter engine
    ``e`` barriers on, ``leaders[e]`` 1 where it stamps its group's
    clock, ``groups`` the engine tuples of each group in group order."""
    group_of: np.ndarray
    leaders: np.ndarray
    groups: Tuple[Tuple[int, ...], ...]


def _subset_layout(n_engines: int, subsets) -> Layout:
    """Each declared subset is its own barrier group with its first
    engine stamping the clock; leftover engines form one extra group
    whose idle spin barriers only with itself.  Unpacked programs get one
    group over every engine and engine 0 as the only leader — the same
    kernel serves both."""
    group_of = np.zeros(n_engines, np.int32)
    leaders = np.zeros(n_engines, np.int32)
    if not subsets:
        leaders[0] = 1
        return Layout(group_of, leaders, (tuple(range(n_engines)),))
    groups = [tuple(int(i) for i in s) for s in subsets]
    members = {i for g in groups for i in g}
    leftover = tuple(i for i in range(n_engines) if i not in members)
    if leftover:
        groups.append(leftover)
    for j, g in enumerate(groups):
        group_of[list(g)] = j
    for s in subsets:
        leaders[int(s[0])] = 1
    return Layout(group_of, leaders, tuple(groups))


class CompiledProgram:
    """One built ladder program with its placed operands — the cache
    entry the dispatcher runs.  :meth:`drop_operands` is what the LRU
    calls on eviction: the operand tensors go at once, not when the
    garbage collector gets to them."""

    def __init__(self, layout: Layout, table: np.ndarray, roles: np.ndarray,
                 fenced: bool, xf: torch.Tensor, xi: torch.Tensor,
                 ctas_per_engine: int):
        self.layout = layout
        self.table = table
        self.roles = roles
        self.fenced = fenced            # the layout isolates the subsets
        self.xf = xf
        self.xi = xi
        self.dst = _build.empty_like_placed(xf)   # pinned beside pinned
        # where the operands live and their bytes: the cache's byte bound
        self.place = "pinned_host" if xf.is_pinned() else xf.device.type
        self.nbytes = sum(t.numel() * t.element_size()
                          for t in (xf, xi, self.dst))
        self.ctas = ctas_per_engine
        self.aot = False                # nothing is compiled per program

    def launch(self, **kw) -> kc.LadderOut:
        """One launch of the ladder kernel (the plain version for CPU
        operands); returns without waiting for the card."""
        return kops.contention_ladder(
            self.xf, self.xi, self.dst, self.table, self.roles,
            self.layout.group_of, self.layout.leaders,
            ctas_per_engine=self.ctas, **kw)

    def is_fenced(self, out: kc.LadderOut) -> bool:
        """The verified fence of one launch: this layout's isolation and
        the launch's own stamps."""
        return self.fenced and fence.stamps_fenced(out, self.layout)

    def drop_operands(self) -> None:
        self.xf = self.xi = self.dst = None


def build_program(rows: Sequence[Tuple[Tuple, ...]], n_eng: int, *,
                  kind: Optional[str], samples: int, subsets,
                  op_roles: Sequence[Tuple], rows_max: int, device,
                  ctas_per_engine: int, stats) -> CompiledProgram:
    """The step table of full-width role ``rows`` (each repeated
    ``samples`` times, as consecutive steps), its role descriptors, the
    operands for ``op_roles`` padded to ``rows_max`` and placed for
    ``kind``, and the barrier layout of ``subsets``."""
    descs: List[Tuple[int, ...]] = []
    desc_of: Dict[Tuple, int] = {}
    table = np.zeros((len(rows), n_eng), np.int32)
    for k, roles in enumerate(rows):
        for e, sig in enumerate(roles):
            if sig not in desc_of:
                desc_of[sig] = len(descs)
                descs.append(role_descriptor(*sig))
            table[k, e] = desc_of[sig]
    table = np.repeat(table, int(samples), axis=0)
    xf, xi = build_rung_operands(op_roles, n_eng, rows_max, device=device,
                                 pin=kind == "pinned_host")
    layout = _subset_layout(n_eng, subsets)
    stats.programs_built += 1
    return CompiledProgram(layout, table, np.asarray(descs, np.int32),
                           fence.groups_isolate(layout.groups, subsets),
                           xf, xi, ctas_per_engine)


def operand_bytes(n_eng: int, rows_max: int) -> int:
    """Bytes of one program's operands: ``xf``, ``xi`` and ``dst``, each
    (n_eng, rows_max, 128) of 4-byte elements."""
    return 3 * n_eng * rows_max * LINE_BYTES


def _full_width(planned: PlannedDispatch, n_eng: int):
    """The planned rungs expanded to every engine, the roles the
    operands are seeded from, and the widest role's rows."""
    idle_iters = planned.rungs[0][0][3]
    full_rungs = []
    for roles in planned.rungs:
        row = (list(roles) if planned.probe
               else list(roles) * planned.n_subsets)
        while len(row) < n_eng:
            row.append(("i", None, 1, idle_iters))
        full_rungs.append(tuple(row))
    if planned.probe:
        op_roles = merge_probe_operand_roles(full_rungs)
        rows_max = max(r[2] for row in full_rungs for r in row)
    else:
        op_roles = full_rungs[-1]
        rows_max = max(r[2] for r in op_roles)
    return full_rungs, op_roles, rows_max


def ladder_operand_rows(planned: PlannedDispatch, n_eng: int) -> int:
    """The operands' rows of :func:`build_ladder_entry`'s program, known
    before it is built."""
    return _full_width(planned, n_eng)[2]


def build_ladder_entry(planned: PlannedDispatch, n_eng: int, samples: int,
                       stats, *, device,
                       ctas_per_engine: int) -> CompiledProgram:
    """Build and place one planned dispatch's ladder program.

    The planned rung table is expanded to every engine: width-packed
    dispatches tile the subset-width roles across ``n_subsets`` disjoint
    engine slices (leftover engines idle in their own barrier group) and
    stack ``waves`` repeats; unpacked group dispatches reduce to one
    wave per ladder.  Probe batches (``planned.probe``) carry their rows
    verbatim — already at full packed width, one heterogeneous row per
    step — and seed operands from the MERGED role layout so one operand
    set serves every row (``merge_probe_operand_roles``).  Wave w's rungs
    are steps [w*K*S, (w+1)*K*S): every stacked rung sample keeps its own
    barrier pair and stamp pair, and wave w+1 starts behind wave w as
    rung k+1 behind rung k."""
    full_rungs, op_roles, rows_max = _full_width(planned, n_eng)
    if planned.waves > 1 and not planned.probe:
        full_rungs = full_rungs * planned.waves
    return build_program(full_rungs, n_eng, kind=planned.kind,
                         samples=samples, subsets=planned.subsets(),
                         op_roles=op_roles, rows_max=rows_max,
                         device=device, ctas_per_engine=ctas_per_engine,
                         stats=stats)

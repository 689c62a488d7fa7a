"""The multi-engine contention ladder and the kernel-support probe.

The wrappers of ``csrc/contention.cu``.  :func:`contention_ladder` runs a
whole table of steps (waves x rungs x samples of a planned dispatch) in
ONE persistent cooperative launch in which an engine is a disjoint group
of CTAs, one CTA an SM: per step and engine group, a start barrier, the
leader's start stamp, every engine's role, a stop barrier, the leader's
stop stamp.  :func:`probe_add_one` is the trivial kernel whose build and
launch decide whether the kernels can run at all
(:func:`repro_torch.compat.kernels_supported`).

A role is a row of ints (:data:`ROLE_FIELDS` of them): its code, rows,
passes, and for the mixed stream its read and written rows.  The table
names a role per (step, engine).  The operands are per engine: ``xf`` and
``dst`` (n_eng, rows_max, 128) float32, ``xi`` (n_eng, rows_max, 128)
int32 holding each chasing engine's chain.

On a CPU tensor both wrappers take their plain versions in
:mod:`repro_torch.kernels.ref`; on a CUDA or pinned tensor they launch
their kernel or raise.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import _build, counts, ref

LANE = 128

# role codes, as csrc/contention.cu numbers them
IDLE, READ, SEEDED_WRITE, RMW, COPY, MIXED, CHASE_GLOBAL, CHASE_SHARED = \
    range(8)
# a role: code, rows, passes, read rows, written rows, 3 spare
ROLE_FIELDS = 8
BARRIER_TIMEOUT_S = 300.0    # a barrier wait this long ends the launch

_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


@dataclass
class LadderOut:
    """What one launch returns: ``outs`` (n_eng, steps) float32, the
    engine value of every step; ``t0s``/``t1s`` (n_eng, steps, 2) int32
    ``[s, ns]`` stamp pairs, non-zero on the group leaders only (the JAX
    package's layout); ``arrive``/``begin``/``end`` (n_eng, steps) int64
    ns: when the last CTA of the engine arrived at the start barrier, the
    first began its role, the last ended it."""
    outs: torch.Tensor
    t0s: torch.Tensor
    t1s: torch.Tensor
    arrive: torch.Tensor
    begin: torch.Tensor
    end: torch.Tensor

    def to_cpu(self) -> "LadderOut":
        return LadderOut(*(t.cpu() for t in (self.outs, self.t0s, self.t1s,
                                             self.arrive, self.begin,
                                             self.end)))


def _check_operands(xf, xi, dst) -> None:
    for t, dt, what in ((xf, torch.float32, "xf"), (xi, torch.int32, "xi"),
                        (dst, torch.float32, "dst")):
        if t.dim() != 3 or t.shape[-1] != LANE or not t.is_contiguous():
            raise ValueError(f"contention_ladder: {what} must be a contiguous "
                             f"(n_eng, rows, 128) tensor, got "
                             f"{tuple(t.shape)}")
        if t.dtype != dt:
            raise TypeError(f"contention_ladder: {what} must be {dt}")
        if tuple(t.shape) != tuple(xf.shape):
            raise ValueError("contention_ladder: xf, xi and dst differ in "
                             "shape")
    places = {_build.launches_kernel(t) for t in (xf, xi, dst)}
    if len(places) != 1:
        raise ValueError("contention_ladder: operands must all be reachable "
                         "from the card, or all on the CPU")


def _check_tables(table: np.ndarray, roles: np.ndarray, group_of: np.ndarray,
                  leaders: np.ndarray, n_eng: int, rows_max: int) -> None:
    if table.ndim != 2 or table.shape[1] != n_eng or table.shape[0] < 1:
        raise ValueError(f"contention_ladder: table must be (steps, {n_eng}),"
                         f" got {table.shape}")
    if roles.ndim != 2 or roles.shape[1] != ROLE_FIELDS:
        raise ValueError(f"contention_ladder: roles must be (n, "
                         f"{ROLE_FIELDS}), got {roles.shape}")
    if table.min() < 0 or table.max() >= roles.shape[0]:
        raise ValueError("contention_ladder: table names a role that does "
                         "not exist")
    if not (roles[:, 0] >= 0).all() or not (roles[:, 0] <= CHASE_SHARED).all():
        raise ValueError("contention_ladder: unknown role code")
    if (roles[:, 1] > rows_max).any() or (roles[:, 3] > rows_max).any() or \
            (roles[:, 4] > rows_max).any() or (roles[:, 2] < 1).any():
        raise ValueError("contention_ladder: a role's rows exceed the "
                         "operands, or it has no pass")
    if group_of.shape != (n_eng,) or leaders.shape != (n_eng,):
        raise ValueError("contention_ladder: group_of and leaders need one "
                         "entry an engine")
    if group_of.min() < 0 or group_of.max() >= n_eng:
        raise ValueError("contention_ladder: a group id out of range")


def ladder_work(table, roles) -> counts.Work:
    """The counted work of a ladder launch over every step of ``table``:
    each pass of a stream its rows once (copy and rmw twice, the mixed
    stream its read and written rows), a chase one 32-byte sector a hop,
    the idle spin nothing; an operation an element the read, rmw, seeded
    write and the mixed stream's read rows add."""
    flops = nbytes = 0
    for role in np.asarray(roles)[np.asarray(table)].reshape(-1, ROLE_FIELDS):
        code, rows, n, rd, wr = (int(v) for v in role[:5])
        line = rows * LANE * 4
        nbytes += n * {READ: line, SEEDED_WRITE: line, RMW: 2 * line,
                       COPY: 2 * line, MIXED: (rd + wr) * LANE * 4,
                       CHASE_GLOBAL: rows * counts.SECTOR_BYTES,
                       CHASE_SHARED: rows * counts.SECTOR_BYTES}.get(code, 0)
        flops += n * {READ: rows, SEEDED_WRITE: rows, RMW: rows,
                      MIXED: rd}.get(code, 0) * LANE
    return counts.Work(flops, nbytes)


def contention_ladder(xf: torch.Tensor, xi: torch.Tensor, dst: torch.Tensor,
                      table, roles, group_of, leaders, *,
                      ctas_per_engine: int, skew_ns: int = 0,
                      skip_start_wait: bool = False,
                      barrier_timeout_s: float = BARRIER_TIMEOUT_S,
                      ) -> LadderOut:
    """Run every step of ``table`` on the engines, in one launch.

    Replaces ``repro/core/exec/program.py:build_ladder_program`` (and the
    role bodies of ``_pallas_branch_fn``).  Bound by bytes: every engine
    streams its role's rows once a pass, all engines at once (the chases
    by the latency of one load).  Design: one persistent cooperative
    kernel, ``ctas_per_engine`` CTAs an engine, one CTA an SM, per-group
    global-memory barrier counters; see ``csrc/contention.cu``.

    ``skip_start_wait`` with ``skew_ns`` exists for the fence's negative
    check only: engines arrive ``e * skew_ns`` apart and begin without
    waiting, so the stamps must show an unfenced region.  The
    coordinator never passes them."""
    _check_operands(xf, xi, dst)
    n_eng, rows_max = xf.shape[0], xf.shape[1]
    table = np.ascontiguousarray(table, dtype=np.int32)
    roles = np.ascontiguousarray(roles, dtype=np.int32)
    group_of = np.ascontiguousarray(group_of, dtype=np.int32)
    leaders = np.ascontiguousarray(leaders, dtype=np.int32)
    _check_tables(table, roles, group_of, leaders, n_eng, rows_max)
    if ctas_per_engine < 1:
        raise ValueError("contention_ladder: ctas_per_engine must be >= 1")
    w = ladder_work(table, roles)
    if not _build.launches_kernel(xf):
        with counts.plain("contention_ladder", w):
            return ref.contention_ladder_ref(
                xf, xi, table, roles, group_of, leaders, skew_ns=skew_ns,
                skip_start_wait=skip_start_wait)
    dev = _build.compute_device(xf)
    steps = table.shape[0]
    ctas = ctas_per_engine
    partials = torch.zeros((n_eng, steps, ctas), dtype=torch.float32,
                           device=dev)
    t0s = torch.zeros((n_eng, steps, 2), dtype=torch.int32, device=dev)
    t1s = torch.zeros_like(t0s)
    stamps = torch.zeros((n_eng, ctas, steps, 3), dtype=torch.int64,
                         device=dev)
    counters = torch.zeros(n_eng, dtype=torch.int32, device=dev)
    # these small tables are released when this returns, the launch still
    # running: PyTorch's caching allocator is stream-ordered, so their
    # memory goes only to work queued behind the kernel on this stream
    d_table, d_roles, d_group, d_lead = (
        torch.from_numpy(a).to(dev) for a in (table, roles, group_of, leaders))
    shared = roles[roles[:, 0] == CHASE_SHARED]
    chase_smem = int(shared[:, 1].max()) * LANE * 4 if len(shared) else 0
    fn = _build.bind("contention", "repro_contention_ladder",
                     (_VP, _VP, _VP, _LL, _VP, _I, _VP, _VP, _VP, _VP, _VP,
                      _VP, _VP, _VP, _I, _I, _LL, _I, _LL, _I, _VP))
    code = fn(xf.data_ptr(), xi.data_ptr(), dst.data_ptr(),
              rows_max * LANE, d_table.data_ptr(), steps,
              d_roles.data_ptr(), d_group.data_ptr(), d_lead.data_ptr(),
              counters.data_ptr(), partials.data_ptr(), t0s.data_ptr(),
              t1s.data_ptr(), stamps.data_ptr(), n_eng, ctas, int(skew_ns),
              int(bool(skip_start_wait)), int(barrier_timeout_s * 1e9),
              chase_smem, _build.current_stream(dev))
    _build.check_launch("contention", "contention_ladder", code)
    counts.launched("contention_ladder", w)
    # the partials are summed outside the kernel, as the TPU program
    # reduces its per-block partials; the stamps reduce over each
    # engine's CTAs: the last arrival, the first begin, the last end
    return LadderOut(partials.sum(dim=-1), t0s, t1s,
                     stamps[..., 0].amax(dim=1), stamps[..., 1].amin(dim=1),
                     stamps[..., 2].amax(dim=1))


def probe_add_one(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` for an (8, 128) float32 block, in a new tensor.

    Replaces the ``pallas_call`` of ``repro/compat.py:pallas_supported``.
    Bound by the launch: 4 KiB read and 4 KiB written.  Design: one CTA
    of 256 threads, each one 16-byte load and one 16-byte store."""
    if tuple(x.shape) != (8, LANE) or x.dtype != torch.float32 or \
            not x.is_contiguous():
        raise ValueError("probe_add_one: want a contiguous (8, 128) float32 "
                         f"block, got {tuple(x.shape)} {x.dtype}")
    w = counts.Work(x.numel(), 2 * x.numel() * 4)
    if not _build.launches_kernel(x):
        with counts.plain("probe_add_one", w):
            return ref.probe_add_one_ref(x)
    dev = _build.compute_device(x)
    out = torch.empty((8, LANE), dtype=torch.float32, device=dev)
    fn = _build.bind("contention", "repro_probe_add_one", (_VP, _VP, _I, _VP))
    code = fn(x.data_ptr(), out.data_ptr(), x.numel(),
              _build.current_stream(dev))
    _build.check_launch("contention", "probe_add_one", code)
    counts.launched("probe_add_one", w)
    return out

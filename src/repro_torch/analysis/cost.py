"""The cost counter: the port's counterpart of ``repro/analysis/hlo.py``.

The reference re-derives the roofline's three inputs from the post-SPMD
HLO text, each while body multiplied by its trip count.  The port has no
HLO: its program is the eager sequence of aten operations it dispatches,
so this module counts them as they run, in a ``TorchDispatchMode``:

* ``flops``            — the products of ``torch.utils.flop_counter``'s
                         registry (mm, addmm, bmm, baddbmm, convolution
                         and its backward: 2·M·N·K a product), plus the
                         counted work of each hand-written kernel;
* ``bytes``            — the operand and output bytes of every operation,
                         by the elements it touches: a slice of a stacked
                         parameter counts its slice, not the storage; an
                         expanded operand its storage; a gather its
                         indices and twice the rows it gathers; an
                         in-place scatter its indices and twice its
                         update; plus the kernels' bytes;
* ``movement_bytes``   — the part of ``bytes`` that only re-types or
                         re-lays data (``_to_copy``, ``copy_``, ``clone``:
                         dtype copies, contiguous transposes).  The
                         reference leaves such traffic out of ``bytes`` as
                         an artifact of compiling for the CPU; the port
                         runs it on the card (the float32 copies of the
                         cross-entropy, q, k, v and o between (B, S, H, D)
                         and (B, H, S, D)), so it stays in ``bytes``;
* ``collective_bytes`` — the operand bytes of the c10d collectives the
                         mode sees (none on one device).

An operation that returns an alias (``OpOverload.is_view``) or only
allocates (``aten.empty*``) counts nothing, as the reference's
``_FREE_OPS``.  Eager code runs every iteration of a loop and each is
counted as it runs, so ``while_trips`` and ``unknown_trip_whiles`` stay
empty: they are kept so that ``roofline.compute_terms`` reads a
:class:`Cost` as the reference's reads an ``HloCost``.  The recompute of
``torch.utils.checkpoint`` runs, and is counted, in the backward pass, as
the reference's HLO holds ``jax.checkpoint``'s.

A hand-written kernel launched through ``ctypes`` is invisible to the
mode: its wrapper reports the kernel's counted work to the active
counters (:mod:`repro_torch.kernels.counts`) and hides the operations of
its plain version from them, so a call counts the same on CPU tensors and
on the card, whatever tiling the plain version runs.  Only operations
that touch a tensor on a device of the counted call's tensors are
counted: a call on the card is not charged for the host's bookkeeping (a
checkpoint's copy of the card's RNG state).

Never run a counter and ``torch.profiler`` at once: the counter's host
work would be in the trace.  A counter refuses to start under an active
profiler.
"""
from __future__ import annotations

import contextlib
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import counts

#: allocations, reshapes without a copy, and the query of a tensor's
#: placement: no bytes of their own (views are told by ``is_view``)
_FREE_OPS = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "_unsafe_view", "is_pinned"}
#: operations that write their output and read none of their tensors
_WRITE_ONLY = {"fill_", "zero_", "zeros_like", "ones_like", "full_like",
               "new_zeros", "new_ones", "new_full"}
#: gathers: the rows they gather read once and written once, + indices
_GATHER_OPS = {"index", "index_select", "embedding", "gather"}
#: in-place scatters: the update read once and written once, + indices
_SCATTER_OPS = {"index_put_", "index_add_", "index_copy_", "scatter_",
                "scatter_add_", "scatter_reduce_", "masked_scatter_"}
#: dtype and layout copies: ``movement_bytes`` (and ``bytes``)
_MOVEMENT_OPS = {"_to_copy", "copy_", "copy", "clone"}
#: c10d operations, by the name with its underscores removed -> the
#: reference's collective kind
_COLLECTIVE_KINDS = (("allreduce", "all-reduce"),
                     ("allgather", "all-gather"),
                     ("reducescatter", "reduce-scatter"),
                     ("alltoall", "all-to-all"),
                     ("send", "collective-permute"),
                     ("recv", "collective-permute"))
_C10D = ("c10d", "_c10d_functional", "c10d_functional",
         "_c10d_functional_autograd")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NOT_SITES = tuple(os.path.join(_PKG, d) + os.sep
                   for d in ("analysis", "kernels"))


@dataclass
class CollectiveOp:
    kind: str
    bytes_per_call: int
    group_size: int
    trips: int
    name: str

    @property
    def total_bytes(self) -> int:
        return self.bytes_per_call * self.trips


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    movement_bytes: float = 0.0      # dtype/layout copies, inside bytes
    collectives: List[CollectiveOp] = field(default_factory=list)
    while_trips: Dict[str, int] = field(default_factory=dict)
    unknown_trip_whiles: List[str] = field(default_factory=list)
    # hand-written kernel -> [calls, flops, bytes], inside the totals
    kernels: Dict[str, List[float]] = field(default_factory=dict)
    # aten operation -> [calls, flops, bytes], inside the totals
    ops: Dict[str, List[float]] = field(default_factory=dict)

    def collective_summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for c in self.collectives:
            k = c.kind.replace("-start", "")
            out[k] = out.get(k, 0.0) + c.total_bytes
        return out


def _touched_bytes(t: torch.Tensor) -> int:
    """The bytes of the elements ``t`` touches: its storage's elements
    under a broadcast (stride 0) dimension are counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in _pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def _site() -> str:
    """The innermost frame in ``repro_torch`` outside ``analysis/`` and
    ``kernels/``, as ``models/mlp.py:<line> <function>``; in the
    backward pass the autograd node is added in brackets."""
    f = sys._getframe(1)
    site = "<outside repro_torch>"
    while f is not None:
        path = _path_of(f.f_code.co_filename)
        if path is not None:
            site = f"{path}:{f.f_lineno} {f.f_code.co_name}"
            break
        f = f.f_back
    node = torch._C._current_autograd_node()
    return site if node is None else f"{site} [{node.name()}]"


_PATHS: Dict[str, Optional[str]] = {}


def _path_of(filename: str) -> Optional[str]:
    if filename not in _PATHS:
        full = os.path.abspath(filename)
        _PATHS[filename] = (os.path.relpath(full, _PKG)
                            if full.startswith(_PKG + os.sep)
                            and not full.startswith(_NOT_SITES) else None)
    return _PATHS[filename]


def _collective(func, args) -> Optional[tuple]:
    """(kind, operand bytes, group size) of a c10d collective; None for
    any other c10d operation (a wait, a wrapper), which moves nothing of
    its own."""
    ns, _, name = func._schema.name.partition("::")
    bare = name.replace("_", "")
    kind = next((k for prefix, k in _COLLECTIVE_KINDS
                 if bare.startswith(prefix)), None)
    if kind is None:
        return None
    # the process-group operations put their outputs first where they
    # have any (gather, scatter, all-to-all); the functional ones never
    src = args[1] if (ns == "c10d" and len(args) > 1 and kind in (
        "all-gather", "reduce-scatter", "all-to-all")) else args[0]
    nbytes = sum(_touched_bytes(t) for t in _tensors(src))
    if ns == "c10d":             # the process group is an argument
        group = next(torch.distributed.ProcessGroup.unbox(a).size()
                     for a in args if isinstance(a, torch.ScriptObject)
                     and a._type().name() == "ProcessGroup")
    else:                        # a functional one names its group last
        group = torch.distributed.distributed_c10d._resolve_process_group(
            args[-1]).size()
    return kind, nbytes, group


class CostCounter(TorchDispatchMode):
    """Counts every aten operation dispatched while it is active, and the
    work the hand-written kernels report, into :attr:`cost`.

    ``devices``: count only operations that touch a tensor on one of
    these devices (None: every operation).  ``sites``: also attribute
    each operation's bytes and flops to its site (:func:`_site`; a
    kernel's site is its name) in :attr:`by_site` (site -> [bytes,
    flops]) and the collectives to :attr:`collective_rows`."""

    def __init__(self, devices=None, sites: bool = False):
        super().__init__()
        self.cost = Cost()
        self.devices = None if devices is None else set(devices)
        self.sites = sites
        self.by_site: Dict[str, List[float]] = {}
        self.collective_rows: List[tuple] = []
        self._hidden = 0

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            raise RuntimeError("a cost counter does not run under "
                               "torch.profiler")
        counts.SINKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        counts.SINKS.remove(self)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def hidden(self) -> Iterator[None]:
        """Operations and kernel reports inside are not counted."""
        self._hidden += 1
        try:
            yield
        finally:
            self._hidden -= 1

    def _add(self, table: Dict[str, List[float]], key: str, flops: float,
             nbytes: float) -> None:
        row = table.setdefault(key, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        self.cost.flops += flops
        self.cost.bytes += nbytes

    def _attribute(self, site: str, flops: float, nbytes: float) -> None:
        row = self.by_site.setdefault(site, [0.0, 0.0])
        row[0] += nbytes
        row[1] += flops

    def kernel(self, name: str, work: counts.Work) -> None:
        """A hand-written kernel's call and its counted work."""
        if self._hidden:
            return
        self._add(self.cost.kernels, name, float(work.flops),
                  float(work.bytes))
        if self.sites:
            self._attribute(name, float(work.flops), float(work.bytes))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._hidden:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if self.devices is not None and not any(
                t.device in self.devices for t in ins + outs):
            return
        if func.namespace in _C10D:
            coll = _collective(func, args)
            if coll is None:
                return
            kind, nbytes, group = coll
            op = CollectiveOp(kind, nbytes, group, 1, str(func))
            self.cost.collectives.append(op)
            self.cost.collective_bytes += nbytes
            if self.sites:
                self.collective_rows.append((float(nbytes), kind, _site()))
            return
        name = func._schema.name.partition("::")[2]
        if func.is_view or name in _FREE_OPS:
            return
        if name in _WRITE_ONLY:
            nbytes = sum(_touched_bytes(t) for t in outs)
        elif name in _GATHER_OPS:
            nbytes = (2 * sum(_touched_bytes(t) for t in outs)
                      + sum(_touched_bytes(t) for t in ins[1:]))
        elif name in _SCATTER_OPS:
            idx = [t for t in ins[1:] if not t.is_floating_point()]
            upd = [t for t in ins[1:] if t.is_floating_point()]
            upd_bytes = (_touched_bytes(upd[-1]) if upd else
                         sum(t.numel() for t in idx) * ins[0].element_size())
            nbytes = 2 * upd_bytes + sum(_touched_bytes(t) for t in idx)
        elif name == "copy_":
            nbytes = _touched_bytes(args[0]) + _touched_bytes(args[1])
        else:
            nbytes = sum(_touched_bytes(t) for t in ins + outs)
        fl = flop_registry.get(func.overloadpacket)
        flops = float(fl(*args, **kwargs, out_val=out)) if fl else 0.0
        self._add(self.cost.ops, name, flops, float(nbytes))
        if name in _MOVEMENT_OPS:
            self.cost.movement_bytes += nbytes
        if self.sites:
            self._attribute(_site(), flops, float(nbytes))


def devices_of(*trees) -> Optional[set]:
    """The devices of the tensors in ``trees`` (None where there is
    none)."""
    devs = {t.device for t in _tensors(trees)}
    return devs or None


def analyze(fn, *args, **kwargs) -> Cost:
    """Runs ``fn(*args, **kwargs)`` once under a counter, on whatever
    device its tensors lie on, and returns what it counted.  The
    reference's ``analyze`` takes the HLO text of a compiled program; the
    port counts the call itself."""
    with CostCounter(devices=devices_of(args, kwargs)) as counter:
        fn(*args, **kwargs)
    return counter.cost

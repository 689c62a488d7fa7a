"""Live device memory of one call: the port's counterpart of XLA's
``memory_analysis``.

The reference reads a compiled program's buffer assignment: its arguments,
outputs, temporaries and the outputs that alias a donated argument.  The
port has no compiled program, so it runs the call once and watches its
storages: a :class:`MemoryTracker` is a ``TorchDispatchMode`` that counts
the bytes of every storage an operation's outputs hold on the tracked
devices, from the operation that makes it to the moment the storage is
freed (a finalizer on its storage object), and keeps the peak taken after
each operation.  Tensors made before the call (its arguments) count from
:meth:`MemoryTracker.track_external` on.  On ``meta`` tensors nothing is
allocated, and the count is the same as on the card's or the CPU's tensors
of the same shapes, because it counts storages, not memory.

Bytes are counted as the storages hold them.  The card's caching allocator
rounds each block up to 512 bytes and may hand out a cached block up to
1 MiB larger than asked for; cuBLAS takes its workspace from it too (one a
thread and stream that runs a GEMM, kept for the process's life).  An
operation's own temporaries are not seen either, since the mode sees what
an operation returns: a CUDA reduction may hold a buffer while it runs.
None of that is modelled: ``torch.cuda.max_memory_allocated`` reads a
little more than the peak counted here.

Inside a hand-written kernel's plain version (``counts.plain``, which
hides its operations from the active counters) the temporaries are the
plain version's, not the kernel's: the tracker keeps their storages but
takes no peak inside the block, and at its end takes the peak of what is
live then (the kernel's outputs).  A kernel launched on the card, or
modelled on ``meta``, allocates its outputs and its scratch as ordinary
operations, which count as any other.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict, Iterator, Tuple

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import counts


def _tensors(tree):
    return [x for x in _pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def storage_bytes(*trees, devices=None) -> Dict[int, int]:
    """The distinct storages of the tensors in ``trees`` on ``devices``
    (None: any): storage key -> its bytes."""
    out: Dict[int, int] = {}
    for t in _tensors(trees):
        if devices is None or t.device in devices:
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


class MemoryTracker(TorchDispatchMode):
    """Counts the live bytes of the storages made on ``devices`` (None:
    every device) while it is active, and their peak (:attr:`peak`)."""

    def __init__(self, devices=None):
        super().__init__()
        self.devices = None if devices is None else set(devices)
        self.live = 0
        self.peak = 0
        # storage key -> (bytes, finalizer)
        self._storages: Dict[int, Tuple[int, weakref.finalize]] = {}
        self._hidden = 0

    def __enter__(self):
        counts.SINKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        counts.SINKS.remove(self)
        for _, fin in self._storages.values():
            fin.detach()
        return super().__exit__(*exc)

    # -- the counters' protocol (``counts.SINKS``) --------------------------
    def kernel(self, name: str, work: counts.Work) -> None:
        """A kernel's counted work: no memory of its own."""

    @contextlib.contextmanager
    def hidden(self) -> Iterator[None]:
        """A plain version's block: no peak inside, one at its end."""
        self._hidden += 1
        try:
            yield
        finally:
            self._hidden -= 1
            self._mark()

    # -- tracking -------------------------------------------------------------
    def track_external(self, *trees) -> int:
        """Counts the storages of the tensors in ``trees`` from now on (the
        call's arguments); returns the bytes added."""
        added = sum(self._track(t) for t in _tensors(trees))
        self._mark()
        return added

    def _track(self, t: torch.Tensor) -> int:
        if self.devices is not None and t.device not in self.devices:
            return 0
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return 0
        n = st.nbytes()
        self._storages[key] = (n, weakref.finalize(st, self._free, key))
        self.live += n
        return n

    def _free(self, key: int) -> None:
        n, _ = self._storages.pop(key, (0, None))
        self.live -= n

    def _mark(self) -> None:
        if not self._hidden and self.live > self.peak:
            self.peak = self.live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            self._track(t)
        self._mark()
        return out

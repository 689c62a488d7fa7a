"""Memory Pool Manager — one allocator per detected memory module.

The genalloc/genpool analog: every :class:`MemoryNode` from the device
tree gets a :class:`MemoryPool` that (a) tracks allocations against the
module's capacity exactly like ``gen_pool_alloc/gen_pool_free``, and
(b) places tensors in the right physical memory: ``memory_kind
"device"`` is the card's own memory, ``"pinned_host"`` is page-locked
host memory that a kernel reads over PCIe through the same pointer.
Shared memory is not addressable from the host, so an on-chip pool
(``memory_kind None``) hands out *residency grants* consumed by the
workloads (which kernel to launch) — the scratchpad equivalent of an
allocation.

``upool()`` exports a pool to applications — the ``/dev/upool<ID>`` mmap
analog: it returns a placement function usable by any framework object
(KV caches, optimizer state, ...).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.compat import resolve_device
from repro_torch.core.devicetree import MemoryNode, Platform, detect_platform


class PoolError(RuntimeError):
    pass


@dataclass
class Allocation:
    """A live allocation handle (the gen_pool_alloc return value)."""
    pool_id: int
    nbytes: int
    array: Optional[torch.Tensor] = None   # None for residency grants
    tag: str = ""


class MemoryPool:
    """Allocator over one memory module, placing on ``device``."""

    def __init__(self, pool_id: int, node: MemoryNode, device="cuda"):
        self.id = pool_id
        self.node = node
        self.device = resolve_device(device)
        self.capacity = node.size_bytes
        self.allocated = 0
        self._handles: Dict[int, Allocation] = {}
        self._next = itertools.count()

    # -- genpool API ---------------------------------------------------
    def alloc(self, shape: Tuple[int, ...], dtype=torch.float32, *,
              init: Optional[Callable[[Tuple[int, ...], Any], Any]] = None,
              tag: str = "") -> Allocation:
        nbytes = math.prod(shape) * dtype.itemsize
        if self.allocated + nbytes > self.capacity:
            raise PoolError(
                f"pool {self.node.name}#{self.id}: alloc {nbytes}B exceeds "
                f"capacity ({self.allocated}/{self.capacity}B used)")
        arr = None
        if self.node.memory_kind is not None:
            data = (init(shape, dtype) if init is not None
                    else torch.zeros(shape, dtype=dtype))
            arr = self._place(data)
        a = Allocation(self.id, nbytes, arr, tag)
        a.handle = next(self._next)
        self._handles[a.handle] = a
        self.allocated += nbytes
        return a

    def free(self, a: Allocation) -> None:
        if self._handles.pop(getattr(a, "handle", -1), None) is None:
            raise PoolError(f"double free / foreign handle in pool {self.id}")
        self.allocated -= a.nbytes
        a.array = None

    def destroy(self) -> None:
        self._handles.clear()
        self.allocated = 0

    # -- placement -------------------------------------------------------
    def place(self, data: torch.Tensor) -> torch.Tensor:
        """Place a tensor in this pool's memory (public hook for
        transient measurement buffers that bypass alloc accounting)."""
        return self._place(data)

    def _place(self, data: torch.Tensor) -> torch.Tensor:
        if self.effective_memory_kind() == "pinned_host":
            out = torch.empty(data.shape, dtype=data.dtype, pin_memory=True)
            out.copy_(data)
            return out
        return data.to(self.device)

    def effective_memory_kind(self) -> Optional[str]:
        """The memory kind :meth:`place` actually lands tensors in.

        ``None`` = the default memory of ``self.device``.  Page-locked
        memory exists only beside a card, so a ``pinned_host`` pool on
        ``device="cpu"`` holds ordinary host tensors and reports
        ``None``: there it is execution-equivalent to a ``device``
        pool.  On the card the two are different physical memories and
        never report the same kind."""
        kind = self.node.memory_kind
        if kind == "pinned_host" and self.device.type == "cuda":
            return kind
        return None

    # -- status -----------------------------------------------------------
    @property
    def available(self) -> int:
        return self.capacity - self.allocated

    def status(self) -> str:
        n = self.node
        return (f"pool {self.id}: {n.name:8s} kind={n.kind:5s} "
                f"size={self.capacity >> 20} MiB "
                f"free={self.available >> 20} MiB "
                f"allocs={len(self._handles)}")


class PoolManager:
    """Auto-instantiates one pool per device-tree memory node."""

    def __init__(self, platform: Optional[Platform] = None, device="cuda"):
        self.device = resolve_device(device)
        self.platform = platform or detect_platform(device=self.device)
        self._pools: Dict[str, MemoryPool] = {}
        for i, (name, node) in enumerate(
                sorted(self.platform.memories.items())):
            self._pools[name] = MemoryPool(i, node, self.device)

    def pool(self, name_or_id) -> MemoryPool:
        if isinstance(name_or_id, int):
            for p in self._pools.values():
                if p.id == name_or_id:
                    return p
            raise PoolError(f"no pool with id {name_or_id}")
        if name_or_id not in self._pools:
            raise PoolError(
                f"no pool {name_or_id!r}; have {sorted(self._pools)}")
        return self._pools[name_or_id]

    def pools(self) -> List[MemoryPool]:
        return sorted(self._pools.values(), key=lambda p: p.id)

    # the /dev/upool<ID> analog: applications get a placement handle
    def upool(self, name_or_id) -> "UserPool":
        return UserPool(self.pool(name_or_id))

    def status(self) -> str:
        return "\n".join(p.status() for p in self.pools())

    def destroy_all(self) -> None:
        for p in self.pools():
            p.destroy()


@dataclass
class UserPool:
    """User-space export of a pool (mmap-on-/dev/upool analog)."""
    pool: MemoryPool

    def place(self, tree):
        """Place a dict / list / tuple of tensors (nested freely) into
        this pool's memory."""
        if isinstance(tree, dict):
            return {k: self.place(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.place(v) for v in tree)
        return self.pool.place(tree)

    @property
    def name(self) -> str:
        return self.pool.node.name

"""Meshes: the production meshes and the host's mesh.

The port of ``repro/launch/mesh.py``.  A mesh here is a descriptor: its
axis names and shape, and, once a ``torch.distributed`` process group
exists, this rank's coordinates on it and one process group per axis
(:func:`repro_torch.parallel.collectives.bind`).  Ranks lie on the mesh
in row-major order, the first axis outermost, as ``jax.make_mesh`` lays
devices out.  Specs (:mod:`repro_torch.parallel.sharding`) need only the
descriptor, so they are computed for the (16, 16) and (2, 16, 16)
production meshes with no process group at all.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import MeshConfig


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes; ``rank`` and ``groups`` once bound to a
    process group (``rank`` None: a descriptor; -1: this process lies
    outside the mesh).  ``groups`` maps a tuple of axes (in the mesh's
    order) to the group of the ranks that differ from this one only along
    those axes (:class:`repro_torch.parallel.collectives.AxisGroup`)."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: Optional[int] = None
    groups: Dict[Any, Any] = field(default_factory=dict, compare=False,
                                   hash=False, repr=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"mesh axes {self.axis_names} and shape "
                             f"{self.shape} differ in length")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def bound(self) -> bool:
        """True once this process holds a place on a bound mesh."""
        return self.rank is not None and self.rank >= 0

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on each axis, row-major (all 0 on an
        unbound mesh of one device: one process holds everything)."""
        if self.rank is None and self.size == 1:
            return {a: 0 for a in self.axis_names}
        if self.rank is None or self.rank < 0:
            raise ValueError("coords: the mesh is not bound to a process "
                             "group, or this process lies outside it")
        out, r = {}, self.rank
        for name, n in reversed(tuple(zip(self.axis_names, self.shape))):
            out[name] = r % n
            r //= n
        return {a: out[a] for a in self.axis_names}


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    return Mesh(tuple(axes), tuple(shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's target: one pod of 16x16 devices, or two pods
    (2x16x16) with a leading "pod" data-parallel axis.  A descriptor."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def mesh_from_config(mc: MeshConfig) -> Mesh:
    return _mesh(mc.shape, mc.axis_names)


def world_size() -> int:
    """The process group's size, 1 where there is none."""
    import torch.distributed as dist
    return dist.get_world_size() if (dist.is_available()
                                     and dist.is_initialized()) else 1


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """The (data, model) mesh of this job, shrunk to fit its world as the
    reference's shrinks to the host's devices (data first, then model);
    bound to the process group where one exists."""
    n = world_size()
    data = min(data, n)
    model = min(model, n // data) if data else 1
    mesh = _mesh((data, model), ("data", "model"))
    from repro_torch.parallel import collectives
    return collectives.bind(mesh) if collectives.initialized() else mesh


def describe(mesh: Mesh) -> str:
    return "x".join(f"{n}={s}" for n, s in zip(mesh.axis_names, mesh.shape))

"""Collectives over ``torch.distributed``: process groups and blocks.

The reference writes placement as partition specs and lets GSPMD derive
the collectives; the port derives them itself, from the same specs
(:mod:`repro_torch.parallel.sharding`):

* **process groups**: :func:`setup` creates the default group from the
  environment ``torchrun`` gives, or from a file store; :func:`setup_dry`
  creates one in this process alone, on torch's ``fake`` backend, whose
  collectives move no data (the dry-run's: one rank's share of a
  production mesh, :mod:`repro_torch.launch.dryrun`); :func:`bind` puts
  this rank on a mesh (row-major) and makes one group for every set of
  its axes (every axis, every set of batch axes, every set a spec names).
  A group that spans the whole world is the world group.
* **blocks**: a leaf under a spec is cut to the block its rank's
  coordinates select (:func:`shard`, :func:`shard_tree`); one
  ``all_gather_into_tensor`` over the group of the spec's axes rebuilds
  it (:func:`gather`, :func:`gather_tree`).
* **the step's placement**: :func:`relative_spec` gives the axes a
  moment's spec adds to its parameter's (ZeRO-1), the block of a
  parameter block that this rank updates.  The train step that runs on
  these blocks is :func:`repro_torch.train.step.make_train_step`.
* **tensor parallelism**: :class:`TensorParallel` is the context a
  layer's arithmetic reads, the "model" group and the group of the KV
  cache's sequence, and :func:`tp_copy`, :func:`tp_sum`,
  :func:`tp_all_gather` and :func:`lse_combine` are the collectives the
  layers run on it.  The first three are differentiable, Megatron's way:
  :func:`tp_copy` (*f*) is the identity forward and sums the gradient over
  the group backward, at the entry of a column split; :func:`tp_sum` (*g*)
  sums forward and passes the gradient through, after a row split;
  :func:`tp_all_gather` hands each rank its slice of the gradient.  Each
  of these skips itself on a group of one rank.

Serving splits the arithmetic of every family over "model": attention
heads, MLP columns and the vocabulary (:mod:`repro_torch.models.
attention`, ``mlp``, ``lm``), experts (``moe``: every rank routes all its
rows, runs its own experts, one :func:`tp_sum` of the ``(B, S, D)``
partials) and SSM heads (``mamba``: head-aligned columns, one
:func:`tp_sum` of the gated norm's ``(B, S, 1)`` sum of squares and one
of the ``(B, S, D)`` partials).  The train step of every family splits
its arithmetic the same way (:func:`repro_torch.train.step.
make_train_step`), with two more sums backward: the MoE gates' gradient
(a :func:`tp_copy` of the gates) and the Mamba sum of squares' (a
:func:`tp_copy` after its :func:`tp_sum`).  On a bound
mesh the step's collectives run over their groups even where a group has
one rank, so a bound 1x1 mesh takes the path a larger one takes; a
one-device mesh with no process group (``rank`` None) has no groups, and
:func:`axis_group` and :func:`gather` run nothing there.  Only calls that
PyTorch 2.11 and later both have are used: ``all_reduce`` (SUM, MAX),
``all_gather_into_tensor``, ``broadcast``, ``isend``/``irecv`` and
``new_group``.
"""
from __future__ import annotations

import itertools
import os
import warnings
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel.sharding import P

# ---------------------------------------------------------------------------
# Process groups
# ---------------------------------------------------------------------------


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def setup(backend: str, *, store_path: Optional[str] = None,
          rank: Optional[int] = None,
          world_size: Optional[int] = None) -> bool:
    """Create the default process group; True if this call created it
    (the caller destroys it, :func:`teardown`), False if one existed.

    With ``store_path`` the ranks meet in a file store there (``rank`` and
    ``world_size`` given); otherwise ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) is read.  With
    ``nccl`` each rank takes the card ``LOCAL_RANK`` (else its rank), and
    a world larger than the cards present raises before any NCCL call."""
    if initialized():
        return False
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if store_path is None:
        if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
            raise RuntimeError("setup: no store path and no torchrun "
                               "environment (RANK, WORLD_SIZE)")
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
    elif rank is None or world_size is None:
        raise ValueError("setup: a file store needs rank and world_size")
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        local = int(os.environ.get("LOCAL_RANK", rank))
        if world_size > cards or local >= cards:
            raise RuntimeError(
                f"nccl: a world of {world_size} ranks (local rank {local}) "
                f"on {cards} card(s); NCCL takes one card a rank")
        torch.cuda.set_device(local)
    if store_path is None:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world_size)
    else:
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size)
    return True


def setup_dry(rank: int, world_size: int) -> bool:
    """Create the default process group in this process alone, as
    ``rank`` of ``world_size``, on torch's ``fake`` backend: every
    collective returns at once and leaves its tensors as they are, on any
    device (``meta`` too), so that one process can run one rank's share of
    a mesh of any size.  True if this call created it (the caller destroys
    it, :func:`teardown`), False if one existed."""
    if initialized():
        return False
    if not 0 <= rank < world_size:
        raise ValueError(f"setup_dry: rank {rank} of a world of {world_size}")
    # importing the module registers the backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    return True


def teardown() -> None:
    if initialized():
        dist.destroy_process_group()


def _device() -> torch.device:
    """The device a collective's tensors live on for this backend."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    """Every rank waits for every other (an all-reduce of one element)."""
    if initialized():
        dist.all_reduce(torch.zeros(1, device=_device()))


def _norm_axes(mesh: Mesh, axes) -> Tuple[str, ...]:
    axes = {axes} if isinstance(axes, str) else set(axes)
    return tuple(a for a in mesh.axis_names if a in axes)


def _members(mesh: Mesh, rank: int, axes: Tuple[str, ...]) -> List[int]:
    """The ranks that differ from ``rank`` only along ``axes``, ascending."""
    coords = _coords_of(mesh, rank)
    ranges = [range(n) if a in axes else (coords[a],)
              for a, n in zip(mesh.axis_names, mesh.shape)]
    return sorted(_rank_of(mesh, dict(zip(mesh.axis_names, c)))
                  for c in itertools.product(*ranges))


def _coords_of(mesh: Mesh, rank: int) -> Dict[str, int]:
    return replace(mesh, rank=rank, groups={}).coords


def _rank_of(mesh: Mesh, coords: Dict[str, int]) -> int:
    r = 0
    for a, n in zip(mesh.axis_names, mesh.shape):
        r = r * n + coords[a]
    return r


@dataclass(frozen=True)
class AxisGroup:
    """The process group of the ranks that differ only along ``axes``."""
    axes: Tuple[str, ...]
    members: Tuple[int, ...]         # global ranks, ascending (row-major)
    group: Any

    @property
    def size(self) -> int:
        return len(self.members)


def bind(mesh: Mesh) -> Mesh:
    """``mesh`` with this process's rank and a group for every non-empty
    set of its axes.  Every rank of the world calls it, in the same order
    (``new_group`` is collective); ranks past the mesh's size lie outside
    it (``rank`` -1, no groups)."""
    if not initialized():
        raise RuntimeError("bind: no process group; call setup() first")
    world, me = dist.get_world_size(), dist.get_rank()
    if mesh.size > world:
        raise ValueError(f"bind: a mesh of {mesh.size} ranks over a world "
                         f"of {world}")
    groups: Dict[Tuple[str, ...], AxisGroup] = {}
    names = mesh.axis_names
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(names, k):
            seen = set()
            for r in range(mesh.size):
                ranks = tuple(_members(mesh, r, axes))
                if ranks in seen:
                    continue
                seen.add(ranks)
                g = (dist.group.WORLD if len(ranks) == world
                     else dist.new_group(list(ranks)))
                if me in ranks:
                    groups[axes] = AxisGroup(axes, ranks, g)
    if me >= mesh.size:
        return replace(mesh, rank=-1, groups={})
    return replace(mesh, rank=me, groups=groups)


def axis_group(mesh: Mesh, axes) -> Optional[AxisGroup]:
    """The group over ``axes`` (an axis, or a set of them); None for no
    axes, or on a one-device mesh with no process group, where there is
    nothing to reduce."""
    key = _norm_axes(mesh, axes)
    if not key or (mesh.rank is None and mesh.size == 1):
        return None
    if key not in mesh.groups:
        raise ValueError(f"axis_group: mesh {mesh.axis_names} is not bound "
                         f"or has no group over {key}")
    return mesh.groups[key]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement: its spec on a mesh, and the whole leaf's shape
    (a local block does not know it)."""
    mesh: Mesh
    spec: P
    shape: Tuple[int, ...]


def _entry_axes(e) -> Tuple[str, ...]:
    return () if e is None else ((e,) if isinstance(e, str) else tuple(e))


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec names, in its order."""
    return tuple(a for e in spec for a in _entry_axes(e))


def block_slices(shape: Sequence[int], spec, mesh: Mesh,
                 coords: Optional[Dict[str, int]] = None) -> Tuple[slice, ...]:
    """The index of the block that ``coords`` (default: this rank's)
    select of a leaf of ``shape`` under ``spec``: each dimension cut into
    as many blocks as its axes' sizes multiply to, the first axis
    outermost."""
    coords = mesh.coords if coords is None else coords
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for dim, e in zip(shape, entries):
        axes = _entry_axes(e)
        if not axes:
            out.append(slice(None))
            continue
        n, idx = 1, 0
        for a in axes:
            size = mesh.axis_sizes[a]
            n, idx = n * size, idx * size + coords[a]
        if dim % n:
            raise ValueError(f"block_slices: dimension {dim} does not "
                             f"divide over {axes} ({n})")
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def block_shape(shape: Sequence[int], spec, mesh: Mesh) -> Tuple[int, ...]:
    zero = {a: 0 for a in mesh.axis_names}
    return tuple(s.stop - s.start if s.start is not None else d
                 for d, s in zip(shape, block_slices(shape, spec, mesh, zero)))


def shard(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``x`` (whole on every rank): a new tensor, or
    ``x`` itself where the spec cuts nothing."""
    sl = block_slices(tuple(x.shape), spec, mesh)
    if all(s == slice(None) for s in sl):
        return x
    return x[sl].clone()


def gather(block: torch.Tensor, spec, mesh: Mesh,
           shape: Sequence[int]) -> torch.Tensor:
    """The whole leaf of ``shape`` from every rank's ``block`` under
    ``spec``: one ``all_gather_into_tensor`` over the group of the spec's
    axes, the blocks placed by their ranks' coordinates.  Where there is
    no group (:func:`axis_group`) it returns ``block`` itself."""
    g = axis_group(mesh, spec_axes(spec))
    if g is None:
        return block
    flat = block.contiguous().reshape(-1)
    out = torch.empty(g.size * flat.numel(), dtype=block.dtype,
                      device=block.device)
    with warnings.catch_warnings():      # renamed after PyTorch 2.11
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, flat, group=g.group)
    out = out.view(g.size, *block.shape)
    full = torch.empty(tuple(shape), dtype=block.dtype, device=block.device)
    for i, r in enumerate(g.members):
        full[block_slices(shape, spec, mesh, _coords_of(mesh, r))] = out[i]
    return full


def shard_tree(state, shardings):
    """Every leaf of a whole ``state`` cut to this rank's block."""
    return tree.tree_map(lambda x, sh: shard(x, sh.spec, sh.mesh), state,
                         shardings)


def gather_tree(state, shardings):
    """Every leaf rebuilt whole from the ranks' blocks (collective: every
    rank of the mesh calls it, and every rank gets the whole tree)."""
    return tree.tree_map(lambda b, sh: gather(b, sh.spec, sh.mesh, sh.shape),
                         state, shardings)


def shardings_of(mesh: Mesh, specs, struct):
    """The placement of every leaf of ``struct`` (tensors or ``meta``
    tensors, whole) under the same-shaped tree of ``specs``."""
    return tree.tree_map(
        lambda sp, s: NamedSharding(mesh, sp, tuple(s.shape)), specs, struct)


def relative_spec(pspec, mspec, ndim: int) -> P:
    """The axes a moment's spec adds to its parameter's (ZeRO-1's
    "data"), as a spec over the parameter's block."""
    pe = tuple(pspec) + (None,) * (ndim - len(tuple(pspec)))
    me = tuple(mspec) + (None,) * (ndim - len(tuple(mspec)))
    out = []
    for p, m in zip(pe, me):
        if p == m:
            out.append(None)
        elif p is None:
            out.append(m)
        else:
            raise ValueError(f"a moment's spec {mspec} cuts a dimension its "
                             f"parameter's spec {pspec} already cuts")
    return P(*out)


# ---------------------------------------------------------------------------
# Tensor parallelism: the groups a layer's arithmetic runs over
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TensorParallel:
    """What a layer reads to split its arithmetic, from the rules.

    ``group`` is the "model" group (None where the model axis is 1),
    ``size`` its ranks and ``index`` this rank's place in it (its "model"
    coordinate).  ``seq_group`` is the group of ``kv_seq_axes``, over
    which a cache cut by sequence ("seq" mode) is cut, ``seq_size`` and
    ``seq_index`` likewise (the block's index along the sequence, as
    :func:`block_slices` numbers it)."""
    group: Optional[AxisGroup]
    size: int
    index: int
    attn_mode: str
    q_heads_tp: bool
    kv_seq_axes: Tuple[str, ...]
    seq_group: Optional[AxisGroup]
    seq_size: int
    seq_index: int

    def cuts(self, dim: int) -> bool:
        """Do the rules cut a dimension of ``dim`` over the model axis
        (``sharding._maybe``)?"""
        return self.size > 1 and dim % self.size == 0

    @property
    def seq_cut(self) -> bool:
        """Does each rank hold a block of the KV cache's positions?"""
        return self.attn_mode == "seq" and self.seq_size > 1


def _place(g: Optional[AxisGroup], mesh: Mesh) -> Tuple[int, int]:
    return (1, 0) if g is None else (g.size, g.members.index(mesh.rank))


def tensor_parallel(rules) -> Optional[TensorParallel]:
    """The context of ``rules`` on its mesh; None where nothing is split:
    no process group, or a model axis of 1 with no axis cutting the
    cache's sequence (a (d, 1) mesh splits the batch only)."""
    mesh = rules.mesh
    if not mesh.bound:
        return None
    g = axis_group(mesh, rules.tp)
    sg = axis_group(mesh, rules.kv_seq_axes)
    (size, index), (seq_size, seq_index) = _place(g, mesh), _place(sg, mesh)
    if size == 1 and seq_size == 1:
        return None
    return TensorParallel(group=g if size > 1 else None, size=size,
                          index=index, attn_mode=rules.attn_mode,
                          q_heads_tp=rules.q_heads_tp,
                          kv_seq_axes=tuple(rules.kv_seq_axes),
                          seq_group=sg if seq_size > 1 else None,
                          seq_size=seq_size, seq_index=seq_index)


def rank_view(rules, index: int) -> TensorParallel:
    """Rank ``index`` of ``rules``' model axis with no group: a layer given
    it computes that rank's share on the rank's blocks and skips every
    collective, so that one process can run each rank's share in turn and
    sum the partials itself.  No sequence cut."""
    size = rules.mesh.axis_sizes.get(rules.tp, 1)
    if not 0 <= index < size:
        raise ValueError(f"rank_view: rank {index} of a model axis of {size}")
    return TensorParallel(group=None, size=size, index=index,
                          attn_mode=rules.attn_mode,
                          q_heads_tp=rules.q_heads_tp, kv_seq_axes=(),
                          seq_group=None, seq_size=1, seq_index=0)


def _alone(group: Optional[AxisGroup]) -> bool:
    return group is None or group.size == 1


def _all_reduce_copy(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """The SUM of every rank's ``x`` over ``group`` in a new tensor."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group.group)
    return out


class _Copy(torch.autograd.Function):
    """Megatron's *f*: identity forward, the gradient summed backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_copy(g, ctx.group), None


class _Sum(torch.autograd.Function):
    """Megatron's *g*: the sum forward (out of place), identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_copy(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_copy(x: torch.Tensor, group: Optional[AxisGroup]) -> torch.Tensor:
    """``x`` entering a region whose ranks each compute a share from it
    (a column split): the identity, whose gradient is summed over
    ``group`` in the backward pass, so that every rank gets the whole
    gradient of ``x``.  ``x`` itself on a group of one rank or none."""
    if _alone(group):
        return x
    return _Copy.apply(x, group)


def tp_sum(x: torch.Tensor, group: Optional[AxisGroup]) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group`` in a new tensor, or
    ``x`` itself on a group of one rank or none.  Its gradient passes to
    ``x`` unchanged (each rank's share gets the whole gradient of the
    sum)."""
    if _alone(group):
        return x
    return _Sum.apply(x, group)


class _AllGather(torch.autograd.Function):
    """The gather along ``dim``; backward, this rank's slice of the
    gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.index = group.members.index(dist.get_rank())
        return _gather_along(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None


def _gather_along(x: torch.Tensor, dim: int,
                  group: AxisGroup) -> torch.Tensor:
    flat = x.contiguous().reshape(-1)
    out = torch.empty(group.size * flat.numel(), dtype=x.dtype,
                      device=x.device)
    with warnings.catch_warnings():      # renamed after PyTorch 2.11
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, flat, group=group.group)
    out = out.view(group.size, *x.shape).movedim(0, dim)
    return out.reshape(*x.shape[:dim], group.size * x.shape[dim],
                       *x.shape[dim + 1:])


def tp_all_gather(x: torch.Tensor, dim: int,
                  group: Optional[AxisGroup]) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in the group's order
    (its members ascending, the order :func:`block_slices` cuts in), or
    ``x`` itself on a group of one rank or none.  The gradient of ``x`` is
    this rank's slice of the gradient of the result."""
    if _alone(group):
        return x
    return _AllGather.apply(x, dim % x.dim(), group)


def lse_combine(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                group: Optional[AxisGroup]) -> torch.Tensor:
    """Attention over keys cut across ``group``, combined: each rank's
    running maximum ``m`` (..., 1), its sum ``l`` (..., 1) of
    ``exp(s - m)`` over its keys and its output ``o`` (..., D), the same
    weights' sum of values.  One all-reduce (MAX) of the maxima, then one
    (SUM) of the sums and outputs rescaled to it; returns ``o / l``.  A
    rank with no key holds ``l = 0`` and ``o = 0``."""
    if group is not None and group.size > 1:
        mx = m.clone()
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group.group)
        c = torch.exp(m - mx)
        lo = torch.cat([o * c, l * c], dim=-1)
        dist.all_reduce(lo, op=dist.ReduceOp.SUM, group=group.group)
        o, l = lo[..., :-1], lo[..., -1:]
    return o / l


def broadcast_text(text: str, group: Optional[AxisGroup],
                   nbytes: int = 32) -> str:
    """The first member's ``text`` on every rank of ``group`` (at most
    ``nbytes`` UTF-8 bytes); ``text`` itself on a group of one rank."""
    if group is None or group.size == 1:
        return text
    raw = text.encode()
    if len(raw) > nbytes:
        raise ValueError(f"broadcast_text: {text!r} is over {nbytes} bytes")
    t = torch.zeros(nbytes, dtype=torch.uint8, device=_device())
    t[:len(raw)] = torch.tensor(list(raw), dtype=torch.uint8)
    dist.broadcast(t, src=group.members[0], group=group.group)
    return bytes(t.cpu().tolist()).rstrip(b"\0").decode()

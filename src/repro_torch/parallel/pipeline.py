"""GPipe-style pipeline parallelism over a "stage" mesh axis.

The port of ``repro/parallel/pipeline.py``.  One stage a rank along
``stage``; the schedule is plain GPipe, the reference's tick for tick:
``n_micro + n_stages - 1`` ticks, stage ``s`` live for
``s <= t < s + n_micro``, stage 0 feeding microbatch ``t``, the last stage
banking microbatch ``t - (S-1)``.  Where the reference's
``jax.lax.ppermute`` hands every stage its left neighbour's activation
each tick, here an activation hops from stage ``s`` to ``s + 1`` by
``torch.distributed`` point to point inside the stage group, on the ticks
the receiver is live: each tick posts its receive and its send together
(``irecv`` then ``isend``) and waits for both, so no rank blocks on a
receive before its neighbour has sent.  At the end one ``all_reduce``
(SUM) over the stage group, the reference's ``psum``, leaves the result
on every stage (only the last stage banked anything; the rest hold
zeros).  With a stage axis of one rank, or no process group, no
collective runs.

``apply_stage(stage_params, x)`` is user code (e.g. a slab of decoder
layers); it must be shape-preserving, which all our decoder stacks are.
Bubble fraction is the textbook (S-1)/(T+S-1); pick n_micro >> n_stages.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import P


def gpipe_schedule(apply_stage: Callable[[Any, torch.Tensor], torch.Tensor],
                   *, n_stages: int, n_micro: int, stage: int = 0,
                   group=None):
    """Returns per_device(params_stage, x_micro) -> y_micro for stage
    ``stage`` of ``n_stages``, its neighbours in ``group`` (an
    :class:`repro_torch.parallel.collectives.AxisGroup` whose members are
    the stages in order; None for one stage).

    params_stage: this stage's parameters (its slice, no stage dimension).
    x_micro: (n_micro, mb, ...) — read on stage 0 only.
    Returns (n_micro, mb, ...), the same on every stage."""
    if n_micro < 1 or n_stages < 1:
        raise ValueError((n_micro, n_stages))
    if n_stages > 1 and (group is None or group.size != n_stages):
        raise ValueError(f"gpipe_schedule: {n_stages} stages need a group "
                         f"of {n_stages} ranks")
    ticks = n_micro + n_stages - 1
    last = n_stages - 1

    def live(s: int, t: int) -> bool:
        return s <= t < s + n_micro

    def per_device(params_stage, x_micro):
        out = torch.zeros_like(x_micro)
        act = torch.zeros_like(x_micro[0])
        for t in range(ticks):
            # 1) the activation hops one stage right: stage s receives on
            # the ticks it is live what s-1 made, live, on the tick before
            reqs, act_in = [], act
            if stage > 0 and live(stage, t):
                act_in = torch.empty_like(act)
                reqs.append(dist.irecv(act_in, group.members[stage - 1],
                                       group=group.group))
            if stage < last and live(stage + 1, t):
                reqs.append(dist.isend(act.contiguous(),
                                       group.members[stage + 1],
                                       group=group.group))
            for r in reqs:
                r.wait()
            # 2) stage 0 injects microbatch t instead
            if stage == 0:
                act_in = x_micro[min(t, n_micro - 1)]
            # 3) compute when this stage has live data
            act = apply_stage(params_stage, act_in) if live(stage, t) \
                else act_in
            # 4) the last stage banks finished microbatch t - (S-1)
            if stage == last and live(stage, t):
                out[t - last] = act
        # only the last stage banked anything (zeros elsewhere): the sum
        # leaves the result on every stage
        return collectives.tp_sum(out, group)

    return per_device


def make_gpipe(mesh: Mesh, apply_stage, *, n_micro: int,
               axis: str = "stage", x_spec: P = P(None),
               params_spec: P = None):
    """GPipe on ``mesh`` (which must carry ``axis``): ``run(params, x)``
    takes the stacked stage parameters (every leaf (n_stages, ...)) and the
    microbatches ``x`` (n_micro, mb, ...), whole on every rank, keeps this
    rank's stage slice (``params_spec``, default ``P(axis)``, cuts each
    leaf) and its block of ``x`` (``x_spec``, which must not name
    ``axis``), and returns its block of the output, cut as ``x``."""
    if params_spec is None:
        params_spec = P(axis)
    if axis not in mesh.axis_names:
        raise ValueError(f"make_gpipe: mesh {mesh.axis_names} has no "
                         f"axis {axis!r}")
    if axis in collectives.spec_axes(x_spec):
        raise ValueError(f"make_gpipe: x_spec {x_spec} names the stage axis")
    n_stages = mesh.axis_sizes[axis]
    group = collectives.axis_group(mesh, axis) if n_stages > 1 else None
    per_device = gpipe_schedule(apply_stage, n_stages=n_stages,
                                n_micro=n_micro, stage=mesh.coords[axis],
                                group=group)

    def run(params_all, x_micro):
        def stage_slice(a):
            blk = collectives.shard(a, params_spec, mesh)
            if blk.shape[0] != 1:
                raise ValueError(f"make_gpipe: a leaf of {a.shape[0]} "
                                 f"stages on {n_stages} stage ranks")
            return blk[0]

        params = tree.tree_map(stage_slice, params_all)
        return per_device(params, collectives.shard(x_micro, x_spec, mesh))

    return run


def reference_pipeline(apply_stage, params_all, x_micro):
    """Oracle: run every stage sequentially on one device.

    params_all: (n_stages, ...) stacked stage params; x_micro (n_micro, ...).
    """
    n_stages = tree.leaves(params_all)[0].shape[0]

    def run_micro(x):
        for s in range(n_stages):
            x = apply_stage(tree.tree_map(lambda a: a[s], params_all), x)
        return x

    return torch.stack([run_micro(x) for x in x_micro])

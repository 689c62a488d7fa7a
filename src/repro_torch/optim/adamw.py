"""AdamW with float32 moments + warmup-cosine schedule.

The port of ``repro/optim/adamw.py`` for one device.  Moments are stored
float32 whatever the parameters' dtype (bf16 training); the update is
computed in float32 and rounded once to the parameter's dtype; weight
decay applies to every leaf, as the reference's does.  The reference
returns new trees (its step donates the old state); here the parameters
and moments are updated in place, which keeps one copy of the 12 bytes a
parameter of moments on the card, and the same tensors come back.
With ``zero1`` the moments' specs (:func:`opt_specs`) additionally shard
the largest still-whole dimension over the ``data`` mesh axis: ZeRO
stage 1, which :mod:`repro_torch.parallel.collectives` carries out (each
rank updates its block of the moments and refreshes its parameter block
with an all-gather).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import TrainConfig

Params = Any


class OptState(NamedTuple):
    m: Params
    v: Params
    step: torch.Tensor         # scalar int32, on the parameters' device


def init_opt_state(params: Params) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    m = tree.tree_map(zeros, params)
    first = tree.leaves(params)[0]
    return OptState(m=m, v=tree.tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32,
                                     device=first.device))


def opt_state_struct(param_structs: Params) -> OptState:
    """The moments' and the step's shapes and dtypes as ``meta`` tensors."""
    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    return OptState(m=tree.tree_map(f32, param_structs),
                    v=tree.tree_map(f32, param_structs),
                    step=torch.empty((), dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------------------
# Schedule
# ---------------------------------------------------------------------------


def warmup_cosine(tcfg: TrainConfig):
    """``lr(step)``: linear warmup to the peak, then a cosine to a tenth of
    it, float32 on the step's device (no host sync)."""
    peak, warm, total = tcfg.learning_rate, tcfg.warmup_steps, \
        tcfg.total_steps

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm_lr = peak * (step + 1.0) / max(warm, 1)
        prog = torch.clamp((step - warm) / max(total - warm, 1), 0.0, 1.0)
        cos_lr = 0.1 * peak + 0.9 * peak * 0.5 * (
            1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warm, warm_lr, cos_lr)

    return lr


# ---------------------------------------------------------------------------
# Update
# ---------------------------------------------------------------------------


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, float32, the leaves
    summed in the reference's order."""
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in tree.leaves(grads)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(
    params: Params,
    grads: Params,
    opt: OptState,
    tcfg: TrainConfig,
    lr_fn=None,
    gnorm: Optional[torch.Tensor] = None,
) -> Tuple[Params, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping, in place: ``params``' and
    ``opt``'s tensors hold the new values and are returned, with the new
    step count and ``{"grad_norm", "lr", "update_scale"}``.  The
    arithmetic is the reference's, in its order.  ``gnorm`` is the
    global norm where ``grads`` hold only this rank's blocks of the
    gradients (the sharded step); by default it is ``grads``' own."""
    lr_fn = lr_fn or warmup_cosine(tcfg)
    step = opt.step + 1
    lr = lr_fn(opt.step)
    b1, b2, eps, wd = tcfg.beta1, tcfg.beta2, tcfg.eps, tcfg.weight_decay

    if gnorm is None:
        gnorm = global_norm(grads)
    clip = (torch.clamp(tcfg.grad_clip / (gnorm + 1e-9), max=1.0)
            if tcfg.grad_clip > 0 else torch.ones_like(gnorm))

    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    for p, g, m, v in zip(tree.leaves(params), tree.leaves(grads),
                          tree.leaves(opt.m), tree.leaves(opt.v)):
        g = g.to(torch.float32) * clip
        m.mul_(b1).add_((1.0 - b1) * g)
        v.mul_(b2).add_((1.0 - b2) * g * g)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + wd * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    stats = {"grad_norm": gnorm, "lr": lr, "update_scale": clip}
    return params, OptState(opt.m, opt.v, step), stats


# ---------------------------------------------------------------------------
# ZeRO-1 specs: shard moments over "data" on the largest replicated axis
# ---------------------------------------------------------------------------


def zero1_specs(param_specs, param_structs, mesh) -> Any:
    from repro_torch.parallel.sharding import P, mesh_axis_size
    data = mesh_axis_size(mesh, "data")

    def shard_one(spec, struct):
        if data <= 1:
            return spec
        shape = tuple(struct.shape)
        spec_t = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
        best, best_dim = None, 0
        for i, (ax, dim) in enumerate(zip(spec_t, shape)):
            if ax is None and dim % data == 0 and dim > best_dim:
                best, best_dim = i, dim
        if best is None:
            return P(*spec_t)
        new = list(spec_t)
        new[best] = "data"
        return P(*new)

    return tree.tree_map(shard_one, param_specs, param_structs)


def opt_specs(param_specs, param_structs, mesh, *, zero1: bool) -> OptState:
    from repro_torch.parallel.sharding import P
    mom = zero1_specs(param_specs, param_structs, mesh) if zero1 \
        else param_specs
    return OptState(m=mom, v=tree.tree_map(lambda s: s, mom), step=P())

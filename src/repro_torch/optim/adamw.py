"""AdamW with float32 moments + warmup-cosine schedule.

The port of ``repro/optim/adamw.py`` for one device.  Moments are stored
float32 whatever the parameters' dtype (bf16 training); the update is
computed in float32 and rounded once to the parameter's dtype; weight
decay applies to every leaf, as the reference's does.  The reference
returns new trees (its step donates the old state); here the parameters
and moments are updated in place, which keeps one copy of the 12 bytes a
parameter of moments on the card, and the same tensors come back.
``zero1_specs`` and ``opt_specs`` shard the moments over a mesh and wait
for the multi-device slice.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

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
) -> Tuple[Params, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping, in place: ``params``' and
    ``opt``'s tensors hold the new values and are returned, with the new
    step count and ``{"grad_norm", "lr", "update_scale"}``.  The
    arithmetic is the reference's, in its order."""
    lr_fn = lr_fn or warmup_cosine(tcfg)
    step = opt.step + 1
    lr = lr_fn(opt.step)
    b1, b2, eps, wd = tcfg.beta1, tcfg.beta2, tcfg.eps, tcfg.weight_decay

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

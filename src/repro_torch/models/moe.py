"""Mixture-of-Experts with sort dispatch over the real rows only.

The port of ``repro/models/moe.py``: the same routing (router in float32,
softmax, top-k, renormalised gates), the same Switch aux loss and router
z-loss, the same per-group *stable* sort of the n·k assignments by expert,
each assignment's position inside its expert's run, and in capacity mode
(``dropless=False``, training) the same ``keep = pos < cap``.

The layout differs.  The reference scatters the assignments into a
``(g, e, cap, d)`` buffer and runs its einsums over every slot; dropless
serving sizes ``cap`` at the whole token count (``n·k``), so at olmoe's
width a batch of 4 x 2048 tokens would allocate 17 GB and do 64x the
useful work.  Here the kept assignments of every group are gathered into
one ``(rows, d)`` block sorted by expert, each expert's gated FFN runs on
its own segment (experts that got no row are skipped), and the combine
adds ``gate · y`` into each token's row.  The segment sizes come to the
host once a layer (one ``.tolist()``, a synchronisation of the card; the
counts behind it and the aux loss's one-hot mean are scatter-adds, which
do not synchronise as ``bincount`` and ``one_hot`` do).
On ``meta`` tensors (the dry-run) there are no values to route by, so the
segment sizes are those of balanced routing (:func:`balanced_sizes`): each
group's ``n·k`` assignments dealt evenly over the experts, each capped at
``cap`` in capacity mode.  Every other operation runs as on the card, at
the sizes that routing gives.
The combine scatters each assignment's row into its (token, rank) place
and sums the k ranks in a fixed order, so a token's sum is the same from
run to run (an atomic scatter-add is not).  ``constrain_dispatch`` is
accepted for the reference's signature; on one device there is nothing
to constrain.

Expert parallelism (``tp``, where ``tp.cuts(n_experts)``: the reference's
``dispatch_spec``) splits by route-all, compute-own and sum.  The rank's
``we_in``/``we_gate``/``we_out`` are its block of ``E/tp`` experts; the
router is whole and the hidden states are the same on every rank of the
model group, so every rank routes all the tokens of its rows (gates and
the aux losses whole), runs the GEMMs of its own experts only (its one
``.tolist()`` reads those experts' segment sizes), combines its own
assignments, and the ``(B, S, D)`` partials are summed over the group by
one ``collectives.tp_sum``.  Where the experts do not divide, the leaves
are whole and nothing is summed.  Capacity mode (training) splits the
same way: every rank routes every row with the whole router, so every
rank computes the same ``keep`` (the same ``cap`` and stable order, the
reference's drops) and takes its own experts' kept rows.  The router's
gradient has two parts, the aux and z losses' (whole and the same on
every rank) and the combine's (a rank's own experts' assignments only),
so the renormalised gates enter the dispatch through
``collectives.tp_copy``: its backward sums the ``(g, n, k)`` gate
gradient over the group, after which the router's gradient, and its
gradient of ``x``, are whole and the same on every rank.  The experts'
gradient of ``x`` is summed by the ``tp_copy`` of the dispatched rows.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import activation, dense_init
from repro_torch.parallel import collectives


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict[str, Any]:
    m = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_ff_expert
    return {
        "router": dense_init(gen, (d, e), torch.float32),
        "we_in": dense_init(gen, (e, d, f), dtype, fan_in=d),
        "we_gate": dense_init(gen, (e, d, f), dtype, fan_in=d),
        "we_out": dense_init(gen, (e, f, d), dtype, fan_in=f),
    }


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def route(params, xg: torch.Tensor, k: int):
    """xg: (g, n, d) -> (router logits (g, n, e) in the router's dtype
    (float32), probs, renormalised gates (g, n, k), expert ids (g, n, k)),
    highest probability first."""
    logits = torch.einsum("gnd,de->gne", xg.to(params["router"].dtype),
                          params["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp(
        min=1e-9)
    return logits, probs, gate_vals, expert_ids


def balanced_sizes(g: int, nk: int, e: int, cap: int) -> list:
    """The rows each of ``e`` experts gets where routing is balanced: each
    of ``g`` groups deals its ``nk`` assignments evenly (the first
    ``nk % e`` experts one more), each expert keeping at most ``cap`` of a
    group's."""
    q, r = divmod(nk, e)
    return [g * min(cap, q + (1 if ex < r else 0)) for ex in range(e)]


def _expert_ffn(seg, w_in, w_gate, w_out, act):
    """One expert's gated FFN on its segment of rows."""
    return ((seg @ w_in) * act(seg @ w_gate)) @ w_out


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig, *, n_groups: int = 0,
              constrain_dispatch=None, dropless: bool = False, tp=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (y, aux).  Groups default to the batch dim.

    ``dropless=True`` (serving modes) keeps every assignment, as the
    reference's capacity of ``n·k`` does: capacity-bounded dispatch is a
    training trade-off, and because the capacity depends on the sequence
    length it is non-causal.  ``dropless=False`` keeps the first ``cap``
    assignments of each expert in each group.

    ``tp``: this rank's share on a mesh (the module's notes); with the
    experts cut, ``params``' expert leaves are the rank's block and ``y``
    is the sum over ``tp.group`` of every rank's partial (the partial
    itself where ``tp.group`` is None)."""
    del constrain_dispatch              # the dispatch is placed by ``tp``
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    act = activation(cfg.act_fn)
    dev = x.device
    split = tp is not None and tp.cuts(e)
    # the experts this rank holds, [lo, hi)
    lo, hi = ((tp.index * e // tp.size, (tp.index + 1) * e // tp.size)
              if split else (0, e))

    g = n_groups or b
    n = b * s // g                      # tokens per group
    xg = x.reshape(g, n, d)
    logits, probs, gate_vals, expert_ids = route(params, xg, k)

    # --- aux losses -------------------------------------------------------
    nk = n * k
    flat_expert = expert_ids.reshape(g, nk)
    ones = torch.ones_like(flat_expert)
    per_group = torch.zeros((g, e), dtype=torch.long, device=dev
                            ).scatter_add_(1, flat_expert, ones)
    me = probs.mean(dim=1)                                  # (g, e)
    ce = per_group.float() / nk          # the one-hot mean, with no sync
    aux_loss = e * (me * ce).sum(dim=-1).mean()
    z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean()

    # --- sort dispatch: the assignments of each group by expert, stable ----
    if dropless:
        cap = _round_up(nk, 8)
    else:
        cap = _round_up(int(math.ceil(k * n * m.capacity_factor / e)), 8)
        cap = min(cap, nk)
    if split:
        # the combine's part of the gates' gradient, summed over the group
        gate_vals = collectives.tp_copy(gate_vals, tp.group)
    flat_gate = gate_vals.reshape(g, nk)
    order = torch.argsort(flat_expert, dim=-1, stable=True)       # (g, nk)
    sorted_expert = torch.gather(flat_expert, 1, order)
    sorted_gate = torch.gather(flat_gate, 1, order)
    group_start = torch.searchsorted(
        sorted_expert, torch.arange(e, device=dev).expand(g, e).contiguous())
    pos = torch.arange(nk, device=dev)[None, :] - torch.gather(
        group_start, 1, sorted_expert)
    keep = pos < cap

    # every group's assignments as one block sorted by expert (group-major
    # inside an expert: a stable sort of the group-major flattening), the
    # dropped ones last, in a bucket ``e`` of their own
    bucket = torch.where(keep, sorted_expert, e).reshape(-1)
    by_expert = torch.argsort(bucket, stable=True)
    # an assignment's index a = token·k + rank within its group
    slot = (order + torch.arange(g, device=dev)[:, None] * nk
            ).reshape(-1)[by_expert]
    gate = sorted_gate.reshape(-1)[by_expert]
    sizes = torch.zeros(e + 1, dtype=torch.long, device=dev).scatter_add_(
        0, bucket, torch.ones_like(bucket))
    # the rows before this rank's first expert, then its experts' sizes:
    # the one host sync (balanced routing on ``meta``)
    if dev.type == "meta":
        every = balanced_sizes(g, nk, e, cap)
        head = [sum(every[:lo])] + every[lo:hi]
    else:
        head = torch.cat([sizes[:lo].sum().reshape(1), sizes[lo:hi]]).tolist()
    start, seg_sizes = head[0], head[1:]
    rows = sum(seg_sizes)
    slot = slot[start:start + rows]
    gate = gate[start:start + rows]
    xe = collectives.tp_copy(x, tp.group) if split else x
    xk = xe.reshape(g * n, d).index_select(0, slot // k)

    # one view an expert, and the segments' outputs joined once: in
    # training, indexing a stacked leaf an expert and writing each output
    # into a slice would each cost a whole-sized gradient an expert
    w_in, w_gate, w_out = (params[name].unbind(0)
                           for name in ("we_in", "we_gate", "we_out"))
    outs, at = [], 0
    for ex, size in enumerate(seg_sizes):
        if not size:
            continue
        outs.append(_expert_ffn(xk[at:at + size], w_in[ex], w_gate[ex],
                                w_out[ex], act))
        at += size
    y = torch.cat(outs) if outs else xk[:0]

    # combine: each kept assignment's gate · y into its (token, rank) slot,
    # then the k ranks of a token summed (dropped slots, and another
    # rank's experts' slots, stay zero)
    contrib = x.new_zeros((g * nk, d))
    contrib[slot] = y * gate.to(x.dtype)[:, None]
    out = contrib.reshape(g * n, k, d).sum(dim=1).reshape(b, s, d)
    if split:
        out = collectives.tp_sum(out, tp.group)

    aux = {"moe_aux_loss": aux_loss * m.router_aux_weight,
           "moe_z_loss": z_loss * m.router_z_weight,
           "moe_drop_frac": 1.0 - keep.float().mean()}
    return out, aux

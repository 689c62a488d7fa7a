"""Microbatched train step: chunked CE, remat, AdamW, ZeRO-1, compression.

The port of ``repro/train/step.py``.  A step is

  a loop over microbatches                (bounded activation residency)
    -> lm.forward(mode="train")           (per-period remat; attention
                                           through the flash kernel and
                                           its backward kernel)
    -> chunked cross-entropy              (no (B,S,V) logits tensor)
    -> autograd, float32 gradient accumulation
  -> optional int8-EF gradient compression
  -> global-norm clip + AdamW             (float32 moments)

Where the reference's step is one jit'd program that donates its state
(``repro/launch/train.py:135``), this step updates the state in place:
the parameters, the moments and the error state are the same tensors
after the step, holding the new values, and the same dict comes back.

Sharding is declarative, as in the reference: :func:`state_specs` and
:func:`batch_specs` give the specs of the state and the batch from
``ShardingRules``.  One step serves every mesh: on a mesh bound to a
process group the state is this rank's blocks (ZeRO-1 moments) and the
gradients are averaged over the batch group
(:mod:`repro_torch.parallel.collectives`); on a one-device mesh with no
process group every block is the whole leaf and no collective runs.  On
a model axis of more than one rank the step is tensor-parallel for every
family, Megatron's way: each rank runs its share of the layers on its
parameter blocks (:mod:`repro_torch.models.attention`, ``mlp``, ``moe``,
``mamba``, ``lm``: heads, MLP columns, experts, SSM heads), the
cross-entropy keeps the logits cut by vocabulary
(:func:`vocab_parallel_ce`), and the float32 gradients come out as the
blocks.  The only leaves gathered whole over "model" are a split Mamba
layer's ``w_zxbcdt`` and ``conv_w`` (``conv_b`` the spec replicates):
the state keeps their contiguous spec blocks, a rank computes on its
head-aligned columns.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import attention, lm, mamba
from repro_torch.optim import adamw
from repro_torch.parallel import collectives as col
from repro_torch.parallel import compression
from repro_torch.parallel.sharding import P, ShardingRules, constrain

TrainState = Dict[str, Any]     # {"params", "opt", ["err"]}


# ---------------------------------------------------------------------------
# Sharding helpers
# ---------------------------------------------------------------------------


def make_constrain(rules: ShardingRules) -> Callable:
    """``cst(v, name)`` for the model's named sites, each through
    :func:`constrain` with the reference's spec for it (an unknown name
    leaves ``v`` as it is).  Activations are not split, so every
    placement is the identity (see :mod:`repro_torch.parallel.sharding`)."""
    mesh = rules.mesh
    specs = {
        "hidden": rules.hidden_spec,
        "ffn": rules.ffn_spec,
        "kv": rules.kv_spec,
        "dispatch": rules.dispatch_spec,
        "logits": rules.logits_spec,
        "blocked_q": lambda v: rules.blocked_q_spec(v.shape[1]),
        "blocked_kv": lambda v: rules.blocked_kv_spec(v.shape[1]),
        "q_seq": rules.q_seq_spec,
        "kv_rep": rules.kv_rep_spec,
    }
    by_shape = ("blocked_q", "blocked_kv")

    def cst(v, name: str):
        if name not in specs:
            return v
        spec = specs[name](v) if name in by_shape else specs[name]()
        return constrain(v, mesh, spec)

    return cst


def state_specs(cfg: ModelConfig, rules: ShardingRules,
                tcfg: TrainConfig, params_struct) -> TrainState:
    """The specs of the train state: parameters by ``lm.param_specs``,
    moments by ``adamw.opt_specs`` (ZeRO-1 with ``tcfg.zero1``), the error
    state like the parameters."""
    pspecs = lm.param_specs(rules, params_struct)
    ospecs = adamw.opt_specs(pspecs, params_struct, rules.mesh,
                             zero1=tcfg.zero1)
    specs: TrainState = {"params": pspecs, "opt": ospecs}
    if tcfg.grad_compression == "int8_ef":
        specs["err"] = tree.tree_map(lambda s: s, pspecs)
    return specs


def batch_specs(rules: ShardingRules, cfg: ModelConfig):
    """(tokens, labels, frontend) specs: rows over the batch axes."""
    b = rules.batch if rules.batch else None
    toks = P(b, None)
    fe = None
    if cfg.frontend == "audio":
        fe = {"frame_embeds": P(b, None, None)}
    elif cfg.frontend == "vlm":
        fe = {"prefix_embeds": P(b, None, None)}
    return toks, toks, fe


# ---------------------------------------------------------------------------
# Chunked cross-entropy
# ---------------------------------------------------------------------------


def _chunk_loss(h: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """(sum of the chunk's token losses, its token count): float32 logits
    of one chunk, their log-sum-exp, the label's logit by a gather (one
    term, where the reference sums its iota mask: the same value), label
    < 0 masked."""
    logits = torch.einsum("bcd,vd->bcv", h.to(torch.float32), w)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, torch.clamp(y, min=0)[..., None])[..., 0]
    valid = y >= 0
    loss = torch.where(valid, lse - ll, 0.0)
    return torch.sum(loss), torch.sum(valid.to(torch.float32))


def chunked_ce(params, hidden, labels, *, cfg: ModelConfig, chunk: int,
               cst=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (sum of token losses, token count), float32.  labels < 0 are
    masked.  The sequence is cut into chunks of ``chunk`` tokens and a
    remainder; each chunk's logits (B, chunk, V) are made, reduced and
    dropped, and recomputed in the backward pass
    (``torch.utils.checkpoint``), so at most one chunk's logits and their
    gradient are alive at a time.  The unembedding is taken to float32
    once a call; its float32 gradient sums over the chunks."""
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    n = s // chunk
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    w32 = w.to(torch.float32)
    grad = torch.is_grad_enabled() and (hidden.requires_grad
                                        or w.requires_grad)
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n)]
    if s > n * chunk:
        bounds.append((n * chunk, s))
    for a, e in bounds:
        h, y = hidden[:, a:e], labels[:, a:e]
        if grad:
            ls, cnt = checkpoint(_chunk_loss, h, y, w32, use_reentrant=False)
        else:
            ls, cnt = _chunk_loss(h, y, w32)
        loss_sum, count = loss_sum + ls, count + cnt
    return loss_sum, count


# ---------------------------------------------------------------------------
# Vocabulary-parallel chunked cross-entropy
# ---------------------------------------------------------------------------


def _label_index(y: torch.Tensor, lo: int, n: int):
    """(the labels' rows in a block of ``n`` rows from ``lo``, clamped
    into it; whether the label falls in the block)."""
    local = y - lo
    return local.clamp(0, n - 1), (local >= 0) & (local < n)


def vocab_ce_terms(h: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                   lo: int):
    """One rank's terms of one chunk's cross-entropy over its vocabulary
    block: ``h`` (B, C, D), the labels ``y`` (B, C) (global ids), ``w``
    the float32 rows ``lo .. lo + Vb`` of the unembedding.  Returns
    float32 (B, C) tensors: the rows' largest logit over the block ``m``,
    ``sum exp(logit - m)`` over the block, and the label's logit where the
    label falls in the block (0 elsewhere).  No collective: the group's
    terms combine by :func:`vocab_ce_combine`."""
    logits = torch.einsum("bcd,vd->bcv", h.to(torch.float32), w)
    m = torch.amax(logits, dim=-1)
    s = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
    idx, inside = _label_index(y, lo, w.shape[0])
    ll = torch.gather(logits, -1, idx[..., None])[..., 0]
    return m, s, torch.where(inside, ll, 0.0)


def vocab_ce_combine(m: torch.Tensor, s: torch.Tensor, ll: torch.Tensor,
                     group) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows' log-sum-exp over the whole vocabulary and the label's
    logit, from every rank's :func:`vocab_ce_terms` over the model
    ``group``: one all-reduce (MAX) of the maxima, then one (SUM) of the
    sums rescaled to it and of the label logits (one rank holds each
    label's, the others 0)."""
    mx = m.clone()
    dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group.group)
    sl = torch.stack([s * torch.exp(m - mx), ll])
    dist.all_reduce(sl, op=dist.ReduceOp.SUM, group=group.group)
    return mx + torch.log(sl[0]), sl[1]


def vocab_ce_grads(h: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                   lo: int, lse: torch.Tensor, scale: torch.Tensor):
    """One rank's share of the gradient of one chunk's summed loss, given
    the rows' log-sum-exp over the whole vocabulary ``lse`` (B, C): the
    logits' gradient on the block is ``scale · (softmax - onehot)``, 0 on
    rows whose label is < 0.  Returns (this rank's share of the gradient
    of ``h``, in ``h``'s dtype; the block's float32 gradient (Vb, D)).
    No collective: the shares of ``h``'s gradient sum over the group."""
    hf = h.to(torch.float32)
    logits = torch.einsum("bcd,vd->bcv", hf, w)
    p = torch.exp(logits - lse[..., None])
    idx, inside = _label_index(y, lo, w.shape[0])
    p.scatter_add_(-1, idx[..., None], -inside.to(p.dtype)[..., None])
    p = p * torch.where(y >= 0, scale, 0.0)[..., None]
    return (torch.einsum("bcv,vd->bcd", p, w).to(h.dtype),
            torch.einsum("bcv,bcd->vd", p, hf))


class _VocabParallelCE(torch.autograd.Function):
    """One chunk's summed loss over a vocabulary cut across the model
    group.  The forward keeps ``h``, the block and the rows' log-sum-exp;
    the backward remakes the chunk's logits from them
    (:func:`vocab_ce_grads`): a checkpoint a chunk whose recompute runs no
    collective, and no chunk's logits outlive it."""

    @staticmethod
    def forward(ctx, h, y, w, lo, group):
        lse, label = vocab_ce_combine(*vocab_ce_terms(h, y, w, lo), group)
        ctx.save_for_backward(h, y, w, lse)
        ctx.lo = lo
        return torch.sum(torch.where(y >= 0, lse - label, 0.0))

    @staticmethod
    def backward(ctx, g):
        h, y, w, lse = ctx.saved_tensors
        dh, dw = vocab_ce_grads(h, y, w, ctx.lo, lse, g)
        return dh, None, dw, None, None


def vocab_parallel_ce(params, hidden, labels, *, cfg: ModelConfig,
                      chunk: int, tp) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`chunked_ce` where this rank holds a block of the
    unembedding's rows (``tp``, the model group): -> (sum of token losses,
    token count), float32, the same on every rank of the group.  The
    hidden enters through ``collectives.tp_copy`` (each rank's share of
    its gradient summed backward); each chunk's float32 logits are made
    for the rank's rows only and never gathered; labels < 0 are masked."""
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    n = s // chunk
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    w32 = w.to(torch.float32)
    lo = tp.index * w.shape[0]
    hidden = col.tp_copy(hidden, tp.group)
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n)]
    if s > n * chunk:
        bounds.append((n * chunk, s))
    for a, e in bounds:
        y = labels[:, a:e]
        ls = _VocabParallelCE.apply(hidden[:, a:e], y, w32, lo, tp.group)
        loss_sum = loss_sum + ls
        count = count + torch.sum((y >= 0).to(torch.float32))
    return loss_sum, count


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def make_loss_fn(cfg: ModelConfig, rules: ShardingRules, tcfg: TrainConfig,
                 tp=None):
    """``loss_fn(params, tokens, labels, frontend) -> (loss, metrics)``.
    With ``tp`` (the model group, :func:`repro_torch.parallel.collectives.
    tensor_parallel`) ``params`` are this rank's blocks and the forward
    and the cross-entropy split their arithmetic over the group
    (:func:`vocab_parallel_ce` where the unembedding is cut)."""
    cst = make_constrain(rules)

    def loss_fn(params, tokens, labels, frontend):
        hidden, _, aux = lm.forward(
            params, tokens, cfg=cfg, mode="train", frontend=frontend,
            constrain=cst, remat=tcfg.remat, tp=tp)
        w = params["embed"] if cfg.tie_embeddings else params["unembed"]
        if tp is not None and w.shape[0] < cfg.padded_vocab:
            loss_sum, count = vocab_parallel_ce(
                params, hidden, labels, cfg=cfg, chunk=tcfg.loss_chunk,
                tp=tp)
        else:
            loss_sum, count = chunked_ce(params, hidden, labels, cfg=cfg,
                                         chunk=tcfg.loss_chunk, cst=cst)
        loss = loss_sum / torch.clamp(count, min=1.0)
        metrics = {"ce_loss": loss, "tokens": count}
        if "moe_aux_loss" in aux:
            loss = loss + aux["moe_aux_loss"] + aux["moe_z_loss"]
            metrics.update(moe_aux=aux["moe_aux_loss"],
                           moe_drop_frac=aux["moe_drop_frac"])
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def make_grads_fn(cfg: ModelConfig, rules: ShardingRules,
                  tcfg: TrainConfig, *, microbatches: int = 1, tp=None):
    """``fn(params, tokens, labels, frontend) -> (metrics, gradients)``:
    the gradients a list of float32 tensors in leaf order, the metrics the
    last microbatch's with ``loss`` their mean.  With ``microbatches`` > 1
    the batch is cut into interleaved microbatches (row r in microbatch
    r % mb, the reference's layout: ``x.reshape(b // mb, mb, ...)[:, i]``),
    each microbatch's gradients summed in float32 and divided by ``mb``.
    With ``tp`` the parameters are this rank's blocks and so are the
    gradients (:func:`make_loss_fn`)."""
    loss_fn = make_loss_fn(cfg, rules, tcfg, tp)

    def grads_of(params, tokens, labels, frontend):
        """(loss, metrics, gradients in the parameters' dtypes): autograd
        on detached copies of the parameters' tensors, so the state's own
        tensors never require grad."""
        flat = [p.detach().requires_grad_() for p in tree.leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree.unflatten_like(params, flat),
                                    tokens, labels, frontend)
            gs = torch.autograd.grad(loss, flat, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(flat, gs)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                gs)

    def fn(params, tokens, labels, frontend=None):
        b = tokens.shape[0]
        mb = microbatches
        if b % mb:
            raise ValueError(f"batch {b} is not a multiple of "
                             f"{mb} microbatches")
        if mb == 1:
            _, metrics, gs = grads_of(params, tokens, labels, frontend)
            return metrics, [g.to(torch.float32) for g in gs]

        def slice_mb(x, i):
            return x.reshape(b // mb, mb, *x.shape[1:])[:, i]

        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in tree.leaves(params)]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=tokens.device)
        for i in range(mb):
            fe = None if frontend is None else {
                k: slice_mb(x, i) for k, x in frontend.items()}
            loss, metrics, gs = grads_of(params, slice_mb(tokens, i),
                                         slice_mb(labels, i), fe)
            for acc, g in zip(grads, gs):
                acc.add_(g.to(torch.float32))
            del gs
            loss_sum = loss_sum + loss
        for g in grads:
            g.div_(mb)
        metrics["loss"] = loss_sum / mb
        return metrics, grads

    return fn


def model_split(cfg: ModelConfig, rules: ShardingRules) -> str:
    """How a train step on ``rules.mesh`` uses the model axis:
    ``"arithmetic"`` (more than one rank: each runs its share of every
    layer on its blocks) or ``"none"``."""
    if rules.mesh.axis_sizes.get(rules.tp, 1) == 1:
        return "none"
    return "arithmetic"


# a Mamba layer's leaves whose spec blocks are not the columns a rank
# computes on where its SSM heads are cut (``mamba.head_columns``)
HEAD_ALIGNED = ("w_zxbcdt", "conv_w", "conv_b")


def leaf_roles(cfg: ModelConfig, rules: ShardingRules, paths) -> list:
    """What the step does with each parameter leaf at ``paths`` on the
    model axis: ``"block"`` (the layer computes on the rank's spec block;
    its gradient is the block's), ``"columns"`` (a Mamba leaf of
    :data:`HEAD_ALIGNED` where the heads are cut: gathered whole, the
    layer takes its head-aligned columns, the whole-shaped gradient is
    summed over the model group and cut to the block) or ``"whole"`` (a
    Mamba leaf where the heads are not cut: gathered whole, the layer runs
    whole on every rank, each keeps its block of the identical
    gradient)."""
    size = rules.mesh.axis_sizes.get(rules.tp, 1)
    if size == 1 or cfg.ssm is None:
        return ["block"] * len(paths)
    split = mamba.heads_split(cfg, size)
    roles = []
    for p in paths:
        parts = p.split("/")
        if len(parts) < 2 or parts[-2] != "ssm":
            roles.append("block")
        elif not split:
            roles.append("whole")
        else:
            roles.append("columns" if parts[-1] in HEAD_ALIGNED
                         else "block")
    return roles


def make_train_step(cfg: ModelConfig, rules: ShardingRules,
                    tcfg: TrainConfig, *, microbatches: int = 1):
    """``step(state, tokens, labels, frontend=None) -> (state, metrics)``
    on ``rules.mesh``: ``state`` holds this rank's blocks (by
    :func:`state_specs`; the whole state on a one-device mesh), ``tokens``
    and ``labels`` this rank's rows of the global batch
    (:class:`repro_torch.data.pipeline.DataLoader` with ``mesh=``).

    On a model axis of more than one rank (:func:`model_split`
    ``"arithmetic"``) the step runs :func:`make_grads_fn` on the rank's
    parameter blocks with the model group's context
    (:func:`repro_torch.parallel.collectives.tensor_parallel`): the
    layers (attention heads, MLP columns, experts, SSM heads) and the
    cross-entropy split their arithmetic and the float32 gradients come
    out as the blocks.  The leaves whole on every rank that a rank reads
    for its share of heads only (``attention.partial_leaves``) have their
    gradients summed over the model group once, in one flat all-reduce.
    A split Mamba layer's :data:`HEAD_ALIGNED` leaves are gathered whole
    first (one all-gather a leaf); the layer takes the rank's columns
    and their whole-shaped gradient is summed over the model group (one
    all-reduce a leaf, which also adds up the B/C columns every rank
    reads) and cut to the rank's block (:func:`leaf_roles`).  No other
    leaf is gathered whole over "model", except the cut leaves of a Mamba
    layer whose heads do not divide (it runs whole on every rank).

    Then, on every mesh, the step averages the float32 gradients'
    parameter blocks over the batch group (``all_reduce``; with
    ``int8_ef`` :func:`repro_torch.parallel.compression.compressed_psum`,
    or ``compress_decompress`` where there is no group), takes the global
    norm from the moment blocks, each element counted once, updates its
    moment blocks (AdamW), and refreshes its parameter blocks with an
    all-gather over the ZeRO axes.  On a one-device mesh with no process
    group every block is the whole leaf and no collective runs.  The
    blocks are updated in place and the same dict comes back; the metrics
    are the global batch's (averaged over the batch group, ``tokens``
    summed)."""
    mesh = rules.mesh
    if not mesh.bound and mesh.size != 1:
        raise ValueError("make_train_step: a mesh of more than one device "
                         "must be bound to a process group "
                         "(launch.mesh.make_host_mesh after "
                         "collectives.setup)")
    struct = lm.param_struct(cfg)
    specs = state_specs(cfg, rules, tcfg, struct)
    paths = [p for p, _ in tree.flatten_with_path(struct)]
    shapes = [tuple(s.shape) for s in tree.leaves(struct)]
    pspecs = tree.leaves(specs["params"])
    mspecs = tree.leaves(specs["opt"].m)
    rel = [col.relative_spec(ps, ms, len(s))
           for ps, ms, s in zip(pspecs, mspecs, shapes)]
    pslices = [col.block_slices(s, ps, mesh) for s, ps in zip(shapes, pspecs)]
    bshapes = [col.block_shape(s, ps, mesh) for s, ps in zip(shapes, pspecs)]
    mslices = [col.block_slices(bs, r, mesh) for bs, r in zip(bshapes, rel)]
    batch = col.axis_group(mesh, rules.batch)
    # the groups the norm's sums of squares meet over, and their leaves
    norm_keys = [tuple(a for a in mesh.axis_names if a in col.spec_axes(ms))
                 for ms in mspecs]
    norm_groups = []
    for key in dict.fromkeys(k for k in norm_keys if k):
        g = col.axis_group(mesh, key)
        if g is not None:
            norm_groups.append((g, [i for i, k in enumerate(norm_keys)
                                    if k == key]))
    tp = (col.tensor_parallel(rules)
          if model_split(cfg, rules) == "arithmetic" else None)
    roles = leaf_roles(cfg, rules, paths)
    # the leaves handed to the layers whole, and those whose whole-shaped
    # gradients are summed over the model group
    whole = [i for i, r in enumerate(roles) if r != "block"]
    summed = [i for i, r in enumerate(roles) if r == "columns"]
    # the leaves each rank holds a share of the gradient of
    names = attention.partial_leaves(cfg, tp)
    partial = [i for i, p in enumerate(paths)
               if p.split("/")[-2:] in (["attn", n] for n in names)]
    grads_fn = make_grads_fn(cfg, rules, tcfg, microbatches=microbatches,
                             tp=tp)
    lr_fn = adamw.warmup_cosine(tcfg)
    compress = tcfg.grad_compression == "int8_ef"

    def step(state: TrainState, tokens, labels, frontend=None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        blocks = tree.leaves(state["params"])
        params = state["params"]
        if whole:
            leaves = list(blocks)
            for i in whole:
                leaves[i] = col.gather(blocks[i], pspecs[i], mesh, shapes[i])
            params = tree.unflatten_like(params, leaves)
            del leaves
        metrics, gblocks = grads_fn(params, tokens, labels, frontend)
        del params
        for i in summed:
            dist.all_reduce(gblocks[i], op=dist.ReduceOp.SUM,
                            group=tp.group.group)
        for i in whole:
            # this rank's block of the float32 gradient, the whole freed
            gblocks[i] = gblocks[i][pslices[i]].contiguous()
        if partial:
            _sum_partial(gblocks, partial, tp.group)
        if compress:
            err = state["err"]
            gtree = tree.unflatten_like(err, gblocks)
            if batch is None:
                gtree, new_err = compression.compress_decompress(gtree, err)
            else:
                gtree, new_err = compression.compressed_psum(gtree, err,
                                                             batch.group)
            with torch.no_grad():
                for e, ne in zip(tree.leaves(err), tree.leaves(new_err)):
                    e.copy_(ne)
            gblocks = tree.leaves(gtree)
            del new_err, gtree
        elif batch is not None:
            gblocks = [g.contiguous() for g in gblocks]
            for g in gblocks:
                dist.all_reduce(g, group=batch.group)
                if batch.size > 1:
                    g.div_(batch.size)
        metrics = _global_metrics(metrics, batch)

        # the moment blocks' gradients and the global norm
        gm = [g[sl] for g, sl in zip(gblocks, mslices)]
        sums = [torch.sum(torch.square(g.to(torch.float32))) for g in gm]
        for g, idx in norm_groups:
            vec = torch.stack([sums[i] for i in idx])
            dist.all_reduce(vec, group=g.group)
            for j, i in enumerate(idx):
                sums[i] = vec[j]
        gnorm = torch.sqrt(torch.sum(torch.stack(sums)))

        pm = [b[sl] for b, sl in zip(blocks, mslices)]
        _, new_opt, stats = adamw.adamw_update(
            tree.unflatten_like(state["params"], pm),
            tree.unflatten_like(state["params"], gm), state["opt"], tcfg,
            lr_fn, gnorm=gnorm)
        del gm, gblocks
        # ZeRO-1: refresh each parameter block from the ranks' updates
        with torch.no_grad():
            for b, p, r in zip(blocks, pm, rel):
                if col.spec_axes(r):
                    b.copy_(col.gather(p, r, mesh, tuple(b.shape)))
        state["opt"] = new_opt
        metrics.update(stats)
        return state, metrics

    return step


def _sum_partial(grads, idx, group) -> None:
    """The gradients ``grads[i]`` for ``i`` in ``idx`` summed over
    ``group`` in one flat all-reduce; each becomes a view of the sum."""
    flat = torch.cat([grads[i].reshape(-1) for i in idx])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group.group)
    at = 0
    for i in idx:
        n = grads[i].numel()
        grads[i] = flat[at:at + n].view(grads[i].shape)
        at += n


def _global_metrics(metrics: Dict[str, torch.Tensor], batch
                    ) -> Dict[str, torch.Tensor]:
    """The rank's metrics made the global batch's: one all-reduce over
    the batch group, every metric averaged but ``tokens`` (summed)."""
    if batch is None:
        return metrics
    keys = sorted(metrics)
    vec = torch.stack([metrics[k].to(torch.float32).reshape(())
                       for k in keys])
    dist.all_reduce(vec, group=batch.group)
    return {k: (vec[i] if k == "tokens" else vec[i] / batch.size)
            for i, k in enumerate(keys)}


def init_state(cfg: ModelConfig, tcfg: TrainConfig,
               gen: torch.Generator) -> TrainState:
    """Parameters from ``gen`` (on its device), zero moments and step, and
    a zero error state where the gradients are compressed."""
    params = lm.init_params(cfg, gen)
    state: TrainState = {"params": params,
                         "opt": adamw.init_opt_state(params)}
    if tcfg.grad_compression == "int8_ef":
        state["err"] = compression.init_error_state(params)
    return state


def state_struct(cfg: ModelConfig, tcfg: TrainConfig) -> TrainState:
    """The train state's shapes and dtypes as ``meta`` tensors (nothing is
    allocated), the reference's abstract state for lowering."""
    params_struct = lm.param_struct(cfg)
    struct: TrainState = {
        "params": params_struct,
        "opt": adamw.opt_state_struct(params_struct)}
    if tcfg.grad_compression == "int8_ef":
        struct["err"] = tree.tree_map(
            lambda s: torch.empty(s.shape, dtype=torch.float32,
                                  device="meta"), params_struct)
    return struct

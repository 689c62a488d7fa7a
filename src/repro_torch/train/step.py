"""Microbatched train step: chunked CE, remat, AdamW, grad compression.

The port of ``repro/train/step.py`` for one device.  A step is

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
The model's sharding hook is the one-device :func:`make_constrain`;
``state_specs``, ``batch_specs`` and ``state_struct`` wait for the
multi-device slice.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.parallel import compression
from repro_torch.parallel.sharding import ShardingRules, constrain

TrainState = Dict[str, Any]     # {"params", "opt", ["err"]}


def make_constrain(rules: ShardingRules) -> Callable:
    """``cst(v, name)`` for the model's named sites ("hidden", "ffn",
    ...): each placement through :func:`constrain`, which on one device
    leaves ``v`` as it is."""
    mesh = rules.mesh

    def cst(v, name: str):
        return constrain(v, mesh)

    return cst


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
# The train step
# ---------------------------------------------------------------------------


def make_loss_fn(cfg: ModelConfig, rules: ShardingRules, tcfg: TrainConfig):
    cst = make_constrain(rules)

    def loss_fn(params, tokens, labels, frontend):
        hidden, _, aux = lm.forward(
            params, tokens, cfg=cfg, mode="train", frontend=frontend,
            constrain=cst, remat=tcfg.remat)
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


def make_train_step(cfg: ModelConfig, rules: ShardingRules,
                    tcfg: TrainConfig, *, microbatches: int = 1):
    """``step(state, tokens, labels, frontend=None) -> (state, metrics)``.

    With ``microbatches`` > 1 the batch is cut into interleaved
    microbatches (row r in microbatch r % mb, the reference's layout:
    ``x.reshape(b // mb, mb, ...)[:, i]``), each microbatch's gradients
    summed in float32 and divided by ``mb``; the metrics are the last
    microbatch's and ``loss`` their mean.  The state is updated in place
    and returned."""
    loss_fn = make_loss_fn(cfg, rules, tcfg)
    lr_fn = adamw.warmup_cosine(tcfg)

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

    def step(state: TrainState, tokens, labels, frontend=None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = state["params"]
        b = tokens.shape[0]
        mb = microbatches
        if b % mb:
            raise ValueError(f"batch {b} is not a multiple of "
                             f"{mb} microbatches")
        if mb == 1:
            _, metrics, gs = grads_of(params, tokens, labels, frontend)
            grads = [g.to(torch.float32) for g in gs]
        else:
            def slice_mb(x, i):
                return x.reshape(b // mb, mb, *x.shape[1:])[:, i]

            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
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
        grads = tree.unflatten_like(params, grads)

        if tcfg.grad_compression == "int8_ef":
            grads, new_err = compression.compress_decompress(grads,
                                                             state["err"])
            with torch.no_grad():
                for e, ne in zip(tree.leaves(state["err"]),
                                 tree.leaves(new_err)):
                    e.copy_(ne)
            del new_err

        _, new_opt, stats = adamw.adamw_update(params, grads, state["opt"],
                                               tcfg, lr_fn)
        state["opt"] = new_opt
        metrics.update(stats)
        return state, metrics

    return step


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

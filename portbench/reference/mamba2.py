"""Plain reference of Mamba-2 language-model training (SSD layers).

A layer: RMSNorm; ``in_proj`` split into z, x, B, C, dt; a depthwise
causal conv over x, B, C (``conv1d`` with ``d_conv - 1`` zeros in front)
and SiLU; ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the SSD in
its quadratic form, ``y_t = sum_{s<=t} (C_t . B_s) exp(sum_{s<r<=t} dt_r A)
dt_s x_s + D x_t``, the decays' cumulative sums in float64; ``y *
silu(z)``, an RMSNorm over d_inner with its gain, ``out_proj`` and the
residual.  Then the final norm, the tied logits over the padded
vocabulary, and the mean cross-entropy over every token of the batch.
The step is AdamW with global-norm clipping on float32 master weights,
every leaf decayed.  Queries of the SSD are taken in blocks of ``block``
rows; each layer is recomputed in the backward pass.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.ops import float32_matmuls, mm, rmsnorm

LAYER_LEAVES = ("norm", "in_proj", "conv_w", "conv_b", "A_log", "dt_bias",
                "D", "ssm_norm", "out_proj")


def _ssd(x, dt, A, B, C, block: int, precision: str) -> torch.Tensor:
    """x (S,H,P), dt (S,H), A (H,), B, C (S,N) (one group) -> y (S,H,P)."""
    s = x.shape[0]
    cs = torch.cumsum(dt.double() * A.double(), dim=0)          # (S,H)
    xdt = x * dt[..., None]
    out = []
    for a in range(0, s, block):
        e = min(s, a + block)
        seg = (cs[a:e, None, :] - cs[None, :e, :]).permute(2, 0, 1)
        mask = (torch.arange(e, device=x.device)[None, :]
                <= torch.arange(a, e, device=x.device)[:, None])
        decay = torch.exp(seg.masked_fill(~mask, -math.inf)).float()
        scores = mm(C[a:e], B[:e].T, precision)                  # (q, e)
        m = decay * scores[None]                                  # (H,q,e)
        out.append(mm(m, xdt[:e].transpose(0, 1), precision))    # (H,q,P)
    return torch.cat(out, dim=1).transpose(0, 1)


def _layer(x, lw: dict, cfg: dict, block: int, precision: str):
    s, _ = x.shape
    eps = cfg["rms_norm_eps"]
    di = cfg["expand"] * cfg["d_model"]
    P, N = cfg["headdim"], cfg["d_state"]
    nh = di // P
    h = rmsnorm(x, lw["norm"], eps)
    zxbcdt = mm(h, lw["in_proj"], precision)
    z, xbc, dt = zxbcdt.split([di, di + 2 * N, nh], dim=-1)
    k = lw["conv_w"].shape[0]
    xbc = F.conv1d(xbc.T[None], lw["conv_w"].T[:, None, :], lw["conv_b"],
                   padding=k - 1, groups=xbc.shape[1])[0, :, :s].T
    xbc = F.silu(xbc)
    xs, B, C = xbc.split([di, N, N], dim=-1)
    dt = F.softplus(dt + lw["dt_bias"])
    A = -torch.exp(lw["A_log"])
    xs = xs.view(s, nh, P)
    y = _ssd(xs, dt, A, B, C, block, precision) + lw["D"][:, None] * xs
    y = y.reshape(s, di) * F.silu(z)
    y = rmsnorm(y, lw["ssm_norm"], eps)
    return x + mm(y, lw["out_proj"], precision)


def token_loss_sum(w: dict, tokens, labels, cfg: dict, *, block: int,
                   precision: str) -> torch.Tensor:
    """Sum of the cross-entropy of one sequence's tokens (labels < 0 are
    left out)."""
    x = w["embed"][tokens]
    for i in range(cfg["n_layer"]):
        lw = {name: w[f"layers.{name}"][i] for name in LAYER_LEAVES}
        x = checkpoint(_layer, x, lw, cfg, block, precision,
                       use_reentrant=False)
    h = rmsnorm(x, w["final_norm"], cfg["rms_norm_eps"])
    logits = mm(h, w["embed"].T, precision)
    keep = labels >= 0
    return F.cross_entropy(logits[keep], labels[keep], reduction="sum")


def flat(weights: dict) -> dict:
    """The benchmark's weights as float32 leaves by name
    (``layers.<leaf>`` stacked over the layers)."""
    out = {"embed": weights["embed"], "final_norm": weights["final_norm"]}
    out.update({f"layers.{k}": v for k, v in weights["layers"].items()})
    return {k: v.detach().float().clone() for k, v in out.items()}


def lr_at(opt: dict, step: int) -> float:
    """The learning rate of the update after ``step`` earlier ones: a
    linear warm-up to the peak over ``warmup_steps``, then a cosine to a
    tenth of the peak at ``total_steps``."""
    peak, warm, total = (opt["learning_rate"], opt["warmup_steps"],
                         opt["total_steps"])
    if step < warm:
        return peak * (step + 1) / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return 0.1 * peak + 0.9 * peak * 0.5 * (1 + math.cos(math.pi * prog))


def train(cfg: dict, weights: dict, batches, opt: dict, *, steps: int,
          precision: str = "float32", block: int = 512) -> dict:
    """``steps`` AdamW steps from ``weights`` on ``batches`` (a list of
    (tokens, labels), each (B, S)) -> {"loss": [each step's mean
    cross-entropy], "grad": {leaf: the norm of its clipped gradient at the
    first step}, "change": {leaf: the norm of its change over the
    steps}}, each layer leaf split by layer (``layers.<leaf>.<i>``)."""
    w = flat(weights)
    w0 = flat(weights)
    m = {k: torch.zeros_like(v) for k, v in w.items()}
    v2 = {k: torch.zeros_like(v) for k, v in w.items()}
    b1, b2, eps, wd = (opt["beta1"], opt["beta2"], opt["eps"],
                       opt["weight_decay"])
    losses, first = [], None
    with float32_matmuls():
        for t in range(steps):
            tokens, labels = batches[t]
            leaves = {k: p.requires_grad_() for k, p in w.items()}
            count = int((labels >= 0).sum())
            grads = {k: torch.zeros_like(p) for k, p in w.items()}
            total = 0.0
            for row in range(tokens.shape[0]):
                with torch.enable_grad():
                    loss = token_loss_sum(leaves, tokens[row], labels[row],
                                          cfg, block=block,
                                          precision=precision) / count
                    gs = torch.autograd.grad(loss, list(leaves.values()))
                for k, g in zip(leaves, gs):
                    grads[k] += g
                total += float(loss.detach())
            losses.append(total)
            with torch.no_grad():
                gnorm = torch.sqrt(sum(g.pow(2).sum() for g in grads.values()))
                clip = min(1.0, opt["grad_clip"] / (float(gnorm) + 1e-9)) \
                    if opt["grad_clip"] > 0 else 1.0
                lr = lr_at(opt, t)
                for k, p in w.items():
                    g = grads[k] * clip
                    if t == 0:
                        first = first or {}
                        first[k] = leaf_norms(k, g)
                    m[k].mul_(b1).add_((1 - b1) * g)
                    v2[k].mul_(b2).add_((1 - b2) * g * g)
                    mhat = m[k] / (1 - b1 ** (t + 1))
                    vhat = v2[k] / (1 - b2 ** (t + 1))
                    p.sub_(lr * (mhat / (vhat.sqrt() + eps) + wd * p))
                    p.requires_grad_(False)
            w = {k: p.detach() for k, p in w.items()}
    change = {}
    for k in w:
        change.update(leaf_norms(k, w[k] - w0[k]))
    return {"loss": losses, "grad": {k: v for d in first.values()
                                     for k, v in d.items()},
            "change": change}


def leaf_norms(name: str, t: torch.Tensor) -> dict:
    """{leaf: its float32 norm}: a ``layers.*`` leaf cut into one leaf a
    layer, ``layers.<leaf>.<i>``."""
    if not name.startswith("layers."):
        return {name: float(torch.linalg.vector_norm(t.float()))}
    norms = torch.linalg.vector_norm(t.float().reshape(t.shape[0], -1),
                                     dim=1).tolist()
    return {f"{name}.{i}": n for i, n in enumerate(norms)}

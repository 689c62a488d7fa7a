"""Plain reference of the MoE decoder's forward pass (olmoe's layout).

Per layer: RMSNorm, q/k/v projections, rotary embedding (the halves of
each head rotated, ``theta^(-i/half)``), causal softmax attention, the
output projection and the residual; RMSNorm, a float32 router, softmax,
the top-k experts with their gates renormalised to sum to 1, each expert
a SwiGLU (``(silu(x W_gate) * x W_up) W_down``), the gated sum and the
residual.  Then the final norm and the logits.  Everything in float32
(``precision="float32"``) or with float8 products (``"fp8"``); the
queries are taken in blocks of ``block`` rows, which changes no value
beyond rounding.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.ops import float32_matmuls, mm, rmsnorm


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, H, hd) at positions 0..S-1."""
    s, _, hd = x.shape
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = (torch.arange(s, dtype=torch.float64, device=x.device)[:, None]
           * inv).float()
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, block: int, precision: str) -> torch.Tensor:
    """Causal softmax attention of one sequence: q (S,H,hd), k, v
    (S,KV,hd) -> (S, H*hd), queries in blocks of ``block``."""
    s, h, hd = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)      # (H,S,hd)
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    q = q.transpose(0, 1) / math.sqrt(hd)
    out = []
    for a in range(0, s, block):
        e = min(s, a + block)
        sc = mm(q[:, a:e], k[:, :e].transpose(1, 2), precision)  # (H,q,e)
        pos_q = torch.arange(a, e, device=q.device)[:, None]
        pos_k = torch.arange(e, device=q.device)[None, :]
        sc = sc.masked_fill(pos_k > pos_q, -math.inf)
        out.append(mm(torch.softmax(sc, dim=-1), v[:, :e], precision))
    return torch.cat(out, dim=1).transpose(0, 1).reshape(s, h * hd)


def _experts(h, lw, i: int, cfg: dict, precision: str) -> torch.Tensor:
    k = cfg["num_experts_per_tok"]
    logits = mm(h, lw["router"][i].float(), precision)
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(cfg["num_experts"]):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        y = mm(torch.nn.functional.silu(
            mm(x, lw["w_gate"][i, e].float(), precision))
            * mm(x, lw["w_up"][i, e].float(), precision),
            lw["w_down"][i, e].float(), precision)
        out.index_add_(0, tok, y * gates[tok, slot][:, None])
    return out


@torch.no_grad()
def final_hidden(cfg: dict, w: dict, seq: torch.Tensor, *,
                 precision: str = "float32", block: int = 1024
                 ) -> torch.Tensor:
    """One sequence's ids (S,) -> its final normed hidden states (S, D),
    float32."""
    lw = w["layers"]
    eps = cfg["rms_norm_eps"]
    H, KV, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    with float32_matmuls():
        x = w["embed"][seq].float()
        s = x.shape[0]
        for i in range(cfg["num_hidden_layers"]):
            h = rmsnorm(x, lw["ln1"][i].float(), eps)
            q = mm(h, lw["wq"][i].float(), precision).view(s, H, hd)
            k = mm(h, lw["wk"][i].float(), precision).view(s, KV, hd)
            v = mm(h, lw["wv"][i].float(), precision).view(s, KV, hd)
            q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
            a = _attention(q, k, v, block, precision)
            x = x + mm(a, lw["wo"][i].float(), precision)
            h = rmsnorm(x, lw["ln2"][i].float(), eps)
            x = x + _experts(h, lw, i, cfg, precision)
        return rmsnorm(x, w["final_norm"].float(), eps)


def head(cfg: dict, w: dict) -> torch.Tensor:
    """The unembedding as a float32 (D, padded vocabulary) matrix."""
    u = w["embed"] if cfg["tie_word_embeddings"] else w["unembed"]
    return u.float().T


@torch.no_grad()
def last_logits(cfg: dict, w: dict, tokens: torch.Tensor, *,
                precision: str = "float32", block: int = 1024
                ) -> torch.Tensor:
    """tokens (B, S) -> float32 logits at each sequence's last position,
    (B, padded vocabulary)."""
    u = head(cfg, w)
    with float32_matmuls():
        return torch.cat([mm(final_hidden(cfg, w, seq, precision=precision,
                                          block=block)[-1:], u, precision)
                          for seq in tokens])

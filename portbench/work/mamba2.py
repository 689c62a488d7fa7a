"""Model FLOPs of a Mamba-2 language model, from the configuration and
the shapes alone.  A token's forward: ``in_proj``, the depthwise conv,
the SSD by its chunked algorithm at the configuration's chunk length
(within a chunk, C·Bᵀ over the pairs a causal mask admits and their
product with x; the chunk's state, B·x; its output from the state
entering it, C·h), ``out_proj``, and the tied logits.  Training counts
three forwards (the backward twice the forward) and not the recompute.
Two FLOPs a multiply-add."""
from __future__ import annotations


def forward_flops_per_token(cfg: dict) -> float:
    D = cfg["d_model"]
    di = cfg["expand"] * D
    P, N, ng, Q = (cfg["headdim"], cfg["d_state"], cfg["ngroups"],
                   cfg["chunk_size"])
    nh = di // P
    conv = di + 2 * ng * N
    mean_pairs = (Q + 1) / 2                 # keys a query admits, average
    ssd = (2 * mean_pairs * N * ng           # C·Bᵀ, a group
           + nh * (2 * mean_pairs * P        # scores · x, a head
                   + 2 * N * P               # the chunk state
                   + 2 * N * P))             # output from the state
    layer = (2 * D * (2 * di + 2 * ng * N + nh) + 2 * cfg["d_conv"] * conv
             + ssd + 2 * di * D)
    return cfg["n_layer"] * layer + 2 * D * cfg["padded_vocab_size"]


def train_flops(cfg: dict, batch: int, seq: int) -> float:
    return 3 * batch * seq * forward_flops_per_token(cfg)

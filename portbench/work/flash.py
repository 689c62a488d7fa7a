"""The least work of one causal flash-attention forward call, from its
shapes alone: each input read once and each output written once, and
``4·D`` FLOPs (the two products) for every admitted (query, key) pair of
every head.  Causal with positions from 0 for queries and keys
alike."""
from __future__ import annotations

from portbench.work import peaks


def admitted_pairs(s: int) -> int:
    """(query, key) pairs a causal mask admits, query i (0-based) seeing
    keys 0..i."""
    return s * (s + 1) // 2


def forward(b: int, h: int, kv: int, s: int, d: int, *,
            elem_bytes: int = 2) -> dict:
    flops = 4 * d * h * b * admitted_pairs(s)
    nbytes = elem_bytes * b * s * d * (2 * h + 2 * kv)   # q, o; k, v
    return {"flops": flops, "bytes": nbytes}


def least_seconds(work: dict) -> float:
    return max(work["flops"] / peaks.BF16_FLOPS,
               work["bytes"] / peaks.HBM_BYTES_PER_S)

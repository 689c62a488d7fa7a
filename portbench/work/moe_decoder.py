"""Model FLOPs of the MoE decoder, from the configuration and the shapes
alone: every matrix product a token needs (q, k, v, o, the router, its
``k`` experts' three products), the attention products over the pairs a
causal mask admits, and the logits that are computed (the last position
of each sequence in a prefill).  Two FLOPs a multiply-add."""
from __future__ import annotations

from portbench.work import flash


def prefill_flops(cfg: dict, batch: int, seq: int) -> float:
    D, H, KV, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"], cfg["head_dim"])
    E, K, F = (cfg["num_experts"], cfg["num_experts_per_tok"],
               cfg["intermediate_size"])
    tokens = batch * seq
    per_token = 2 * (D * (H + 2 * KV) * hd + H * hd * D + D * E
                     + K * 3 * D * F)
    attn = flash.forward(batch, H, KV, seq, hd)["flops"]
    logits = 2 * batch * D * cfg["padded_vocab_size"]
    return cfg["num_hidden_layers"] * (tokens * per_token + attn) + logits

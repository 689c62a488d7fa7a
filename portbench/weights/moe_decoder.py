"""Weights of an MoE decoder (olmoe's layout), drawn from the seed on the
device in the type they are served in, one call a kind of leaf.

The layout is the benchmark's own: every layer's leaves stacked over the
layers, projections as ``(in, out)`` matrices, norms as offsets from 1
(``(1 + w) * x_hat``), the vocabulary padded with zero rows.  Both the
plain reference and the adapter onto the port read it.
"""
from __future__ import annotations

import math

import torch

from portbench import seeds


def dims(cfg: dict) -> dict:
    return dict(L=cfg["num_hidden_layers"], D=cfg["hidden_size"],
                H=cfg["num_attention_heads"], KV=cfg["num_key_value_heads"],
                hd=cfg["head_dim"], F=cfg["intermediate_size"],
                E=cfg["num_experts"], K=cfg["num_experts_per_tok"],
                V=cfg["vocab_size"], Vp=cfg["padded_vocab_size"])


def make(cfg: dict, seed: int, device) -> dict:
    d = dims(cfg)
    L, D, H, KV, hd, F, E = (d[k] for k in ("L", "D", "H", "KV", "hd", "F",
                                              "E"))
    dtype = getattr(torch, cfg["torch_dtype"])
    gen = seeds.generator(seed, "weights", device)

    def normal(shape, std, dt=dtype):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dt).mul_(std)

    def embedding():
        w = normal((d["Vp"], D), 0.02)
        w[d["V"]:] = 0
        return w

    w = {"embed": embedding(), "final_norm": normal((D,), 0.02)}
    if not cfg["tie_word_embeddings"]:
        w["unembed"] = embedding()
    w["layers"] = {
        "ln1": normal((L, D), 0.02),
        "wq": normal((L, D, H * hd), 1 / math.sqrt(D)),
        "wk": normal((L, D, KV * hd), 1 / math.sqrt(D)),
        "wv": normal((L, D, KV * hd), 1 / math.sqrt(D)),
        "wo": normal((L, H * hd, D), 1 / math.sqrt(H * hd)),
        "ln2": normal((L, D), 0.02),
        "router": normal((L, D, E), 1 / math.sqrt(D),
                         getattr(torch, cfg["router_dtype"])),
        "w_up": normal((L, E, D, F), 1 / math.sqrt(D)),
        "w_gate": normal((L, E, D, F), 1 / math.sqrt(D)),
        "w_down": normal((L, E, F, D), 1 / math.sqrt(F)),
    }
    return w

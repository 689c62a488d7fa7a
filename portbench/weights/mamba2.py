"""Weights of a Mamba-2 language model, drawn from the seed on the device
in the type they are trained in, one call a kind of leaf.

The layout is the benchmark's own: every layer's leaves stacked over the
layers, ``in_proj`` as a ``(d_model, 2·d_inner + 2·ngroups·d_state +
nheads)`` matrix in the order z, x, B, C, dt, the depthwise conv as
``(d_conv, channels)`` (tap ``d_conv - 1`` on the current position),
norms as offsets from 1, the tied embedding padded with zero rows.
``A_log``, ``dt_bias`` and ``D`` are float32.
"""
from __future__ import annotations

import math

import torch

from portbench import seeds


def dims(cfg: dict) -> dict:
    D = cfg["d_model"]
    di = cfg["expand"] * D
    nh = di // cfg["headdim"]
    ng, N = cfg["ngroups"], cfg["d_state"]
    return dict(L=cfg["n_layer"], D=D, di=di, nh=nh, P=cfg["headdim"],
                ng=ng, N=N, K=cfg["d_conv"], conv=di + 2 * ng * N,
                proj=2 * di + 2 * ng * N + nh, V=cfg["vocab_size"],
                Vp=cfg["padded_vocab_size"], chunk=cfg["chunk_size"])


def make(cfg: dict, seed: int, device) -> dict:
    d = dims(cfg)
    L, D, di, nh = d["L"], d["D"], d["di"], d["nh"]
    dtype = getattr(torch, cfg["param_dtype"])
    f32 = torch.float32
    gen = seeds.generator(seed, "weights", device)

    def normal(shape, std, dt=dtype):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dt).mul_(std)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=device,
                          dtype=f32).mul_(hi - lo).add_(lo)

    embed = normal((d["Vp"], D), 0.02)
    embed[d["V"]:] = 0
    dt = torch.exp(uniform((L, nh), math.log(1e-3), math.log(1e-1)))
    return {
        "embed": embed,
        "final_norm": normal((D,), 0.02),
        "layers": {
            "norm": normal((L, D), 0.02),
            "in_proj": normal((L, D, d["proj"]), 1 / math.sqrt(D)),
            "conv_w": normal((L, d["K"], d["conv"]), 1 / math.sqrt(d["K"])),
            "conv_b": normal((L, d["conv"]), 0.02),
            "A_log": torch.log(uniform((L, nh), 1.0, 16.0)),
            "dt_bias": dt + torch.log(-torch.expm1(-dt)),
            "D": torch.ones((L, nh), dtype=f32, device=device),
            "ssm_norm": normal((L, di), 0.02),
            "out_proj": normal((L, di, D), 1 / math.sqrt(di)),
        },
    }

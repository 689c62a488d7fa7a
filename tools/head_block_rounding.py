"""What cutting the heads over a model axis does to the flash backward's
dk and dv, on the CPU.

Each rank of a model group runs the backward on its block of q heads and
the KV heads they read (``attention.kv_heads_of``); a KV head read by
several ranks gets its gradient as the sum of their bf16 outputs, each
rounded once, where the whole call rounds the float32 sum once.  This
script draws q, k, v and do as ``chip_smoke.py``'s ``train_tp`` phase
does (q and k at sqrt(3), v at 0.5, do standard normal, bf16), runs the
plain backward (``ref.flash_attention_bwd_ref``, float32 on the bf16
values) whole and on each rank's block of qwen2-1.5b's 12 q heads and 2
KV heads for model axes 2 and 4, rounds every output to bf16, and prints
the largest |sum - want| over two limits (<= 1 passes):

    want_only   2^-7 |want| + 2^-12 max|want| (the 12b cases' limit)
    per_term    2^-7 sum|term| + 2^-12 max|want| (each rounded term
                counted; ``train_tp``'s limit)

    python tools/head_block_rounding.py [--seq 512]

It needs no card and prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models.attention import kv_heads_of  # noqa: E402

H, KVH, D = 12, 2, 128


def _draw(shape, scale: float, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).bfloat16().float()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=512)
    s = ap.parse_args(argv).seq
    q = _draw((1, H, s, D), math.sqrt(3), 1)
    k = _draw((1, KVH, s, D), math.sqrt(3), 2)
    v = _draw((1, KVH, s, D), 0.5, 3)
    do = _draw((1, H, s, D), 1.0, 4)
    o, lse = ref.flash_attention_ref(q, k, v, causal=True, return_lse=True)
    _, dk, dv = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    out = {"seq": s, "heads": H, "kv_heads": KVH, "head_dim": D}
    for tp in (2, 4):
        hl = H // tp
        acc = {n: torch.zeros_like(dk) for n in ("dk", "dv", "mk", "mv")}
        for i in range(tp):
            h0 = i * hl
            idx = kv_heads_of(h0, hl, H, KVH)
            qb, kb, vb = q[:, h0:h0 + hl], k[:, idx], v[:, idx]
            ob, lb = ref.flash_attention_ref(qb, kb, vb, causal=True,
                                             return_lse=True)
            _, dkb, dvb = ref.flash_attention_bwd_ref(
                qb, kb, vb, ob, lb, do[:, h0:h0 + hl], causal=True)
            t = torch.tensor(idx)
            for n, g in (("dk", dkb), ("dv", dvb)):
                g = g.bfloat16().float()
                acc[n].index_add_(1, t, g)
                acc["m" + n[1]].index_add_(1, t, g.abs())
        rec = {}
        for n, whole in (("dk", dk), ("dv", dv)):
            want = whole.bfloat16().float()
            err = (acc[n] - want).abs()
            floor = 2.0 ** -12 * float(want.abs().max())
            rec[n] = {
                "want_only": float((err / (2.0 ** -7 * want.abs()
                                           + floor)).max()),
                "per_term": float((err / (2.0 ** -7 * acc["m" + n[1]]
                                          + floor)).max())}
        out[f"tp{tp}"] = rec
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

"""What rounding the softmax's p to bf16 does to attention, on the CPU.

The bf16 flash kernel feeds p into the P·V product on the tensor cores,
whose operands are bf16; the reference keeps p in float32.  This script
computes one causal head's attention three ways from the same bf16 q, k,
v (drawn as ``chip_smoke.py`` draws them: q and k at sqrt(3), v at 0.5)
and holds each against the float32-p result with the chip check's limits:
the largest |got - want| / (2^-7 |want| + 2^-12), which one bf16 rounding
keeps at or under 1, the share of elements above 1, and the normalised
error.  The three: p in float32 (the yardstick itself, 0), p rounded once
to bf16, and p as two bf16 terms hi + lo (what the kernel does).

    python tools/flash_p_rounding.py [--seq 4096] [--dim 128] [--heads 2]

It needs no card (a dense (S, S) score matrix: keep --seq small) and
prints one JSON object.
"""
from __future__ import annotations

import argparse
import json

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    s, d = args.seq, args.dim
    g = torch.Generator().manual_seed(args.seed)
    q = (torch.randn((args.heads, s, d), generator=g) * 3 ** 0.5).bfloat16()
    k = (torch.randn((1, s, d), generator=g) * 3 ** 0.5).bfloat16()
    v = (torch.randn((1, s, d), generator=g) * 0.5).bfloat16()
    sc = (q.float() @ k.float().transpose(-1, -2)) * d ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool).tril()
    sc = sc.masked_fill(~causal, float("-inf"))
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    want = ((p @ v.float()) / l).bfloat16().float()
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    out = {"seq": s, "head_dim": d, "heads": args.heads}
    for name, pp in (("p_float32", p), ("p_bf16", hi), ("p_hi_plus_lo",
                                                         hi + lo)):
        got = ((pp @ v.float()) / l).bfloat16().float()
        diff = (got - want).abs()
        scaled = diff / (2.0 ** -7 * want.abs() + 2.0 ** -12)
        out[name] = {"scaled_max": float(scaled.max()),
                     "share_above_1": float((scaled > 1).float().mean()),
                     "norm_err": float(diff.norm() / want.norm())}
    print(json.dumps(out))


if __name__ == "__main__":
    main()

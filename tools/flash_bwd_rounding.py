"""What feeding p and ds to the tensor cores as bf16 does to the flash
backward, on the CPU.

The tensor-core backward (``csrc/flash_attention_bwd_tc.cu``) feeds P into
dV += P^T dO, and dS into dK += dS^T Q and dQ += dS K, as the bf16 A
operands of its products; the float32 FMA kernel keeps both in float32.
This script computes one causal KV group's gradients from the same bf16
inputs, drawn as ``chip_smoke.py`` draws them (q and k at sqrt(3), v at
0.5, do standard normal; o the forward's output rounded to bf16), with
every gradient rounded once to bf16 at the end, and holds each variant
against the float32 gradients with the chip check's limit: the largest
|got - want| / (2^-7 |want| + 2^-12 max |want|), which one bf16 rounding
keeps at or under 1.  The variants feed P and dS as:

    p_ds_float32   both in float32 (what the FMA kernel does)
    one_term       each rounded once to bf16
    two_terms      each as hi = bf16(x) plus lo = bf16(x - hi), two
                   products (what the tensor-core kernel does)
    p_two_ds_one   P in two terms, dS in one
    p_one_ds_two   P in one term, dS in two

dS = P (dP - delta) is formed from the float32 P in every variant (the
kernel takes P back as hi + lo, within 2^-16 of it).

    python tools/flash_bwd_rounding.py [--seq 1024] [--dim 128] [--heads 6]

It needs no card (dense (heads, S, S) matrices: keep --seq small) and
prints one JSON object.
"""
from __future__ import annotations

import argparse
import json

import torch


def _one(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def _two(x: torch.Tensor) -> torch.Tensor:
    hi = _one(x)
    return hi + _one(x - hi)


FEEDS = {"float32": lambda x: x, "one": _one, "two": _two}
VARIANTS = {"p_ds_float32": ("float32", "float32"),
            "one_term": ("one", "one"), "two_terms": ("two", "two"),
            "p_two_ds_one": ("two", "one"), "p_one_ds_two": ("one", "two")}


def inputs(seq: int, dim: int, heads: int, seed: int):
    """q (heads, S, D); k, v (S, D); do (heads, S, D): bf16 values held in
    float32."""
    g = torch.Generator().manual_seed(seed)

    def draw(shape, sd):
        return _one(torch.randn(shape, generator=g) * sd)

    return (draw((heads, seq, dim), 3 ** 0.5), draw((seq, dim), 3 ** 0.5),
            draw((seq, dim), 0.5), draw((heads, seq, dim), 1.0))


def gradients(q, k, v, do, feed_p: str = "float32",
              feed_ds: str = "float32"):
    """(dq, dk, dv) of causal attention over one KV group, float32, with P
    and dS fed to their products as ``FEEDS[feed_p]`` and
    ``FEEDS[feed_ds]``; dk and dv summed over the group's heads."""
    seq, dim = k.shape
    scale = dim ** -0.5
    s = q @ k.T * scale
    causal = torch.ones(seq, seq, dtype=torch.bool).tril()
    s = s.masked_fill(~causal, float("-inf"))
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    o = _one(p @ v)
    delta = (do * o).sum(-1, keepdim=True)
    ds = p * (do @ v.T - delta)
    pf, dsf = FEEDS[feed_p](p), FEEDS[feed_ds](ds)
    dv = (pf.transpose(-1, -2) @ do).sum(0)
    dk = (dsf.transpose(-1, -2) @ q).sum(0) * scale
    dq = dsf @ k * scale
    return dq, dk, dv


def scaled_error(got: torch.Tensor, want: torch.Tensor) -> float:
    top = float(want.abs().max())
    return float(((got - want).abs()
                  / (2.0 ** -7 * want.abs() + 2.0 ** -12 * top)).max())


def table(seq: int = 1024, dim: int = 128, heads: int = 6,
          seed: int = 0) -> dict:
    """{variant: {dq, dk, dv: scaled error}} on one draw of the inputs."""
    q, k, v, do = inputs(seq, dim, heads, seed)
    want = gradients(q, k, v, do)
    out = {"seq": seq, "head_dim": dim, "heads": heads, "seed": seed}
    for name, (fp, fds) in VARIANTS.items():
        got = gradients(q, k, v, do, fp, fds)
        out[name] = {n: scaled_error(_one(g), w)
                     for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--heads", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(json.dumps(table(args.seq, args.dim, args.heads, args.seed)))


if __name__ == "__main__":
    main()

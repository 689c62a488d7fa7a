"""Why a split layer's bf16 gradients are held in norm, not elementwise,
on the CPU.

One MoE layer (olmoe-1b-7b ``reduced()``) and one Mamba layer
(mamba2-370m ``reduced()``), both widened to ``--d-model``, bf16 weights
from a seed, train mode (capacity) over (2, ``--seq``) tokens and a
seeded upstream gradient, as ``chip_smoke.py``'s ``train_experts`` (a)
draws them.  Three gradients of every input and leaf: the whole layer in
bf16 (``want``), the whole layer recomputed in float32 from the same
bf16 values (``f32``), and the ranks' shares of a model axis of 2 and 4
summed (``split``; one autograd graph, each rank's leaves its own, the
Mamba ranks' sums of squares added before ``mamba_out``, the aux losses
once).  Printed for each, the largest over the layer's gradients of:

    whole_vs_f32_scaled  |want - f32| / (2^-7 |want| + 2^-12 max|want|),
                         the elementwise limit the whole layer itself
                         would need to meet (> 1: it does not)
    whole_vs_f32_norm    ||want - f32|| / ||f32||
    split_vs_f32_norm    ||split - f32|| / ||f32||
    split_vs_whole_norm  ||split - want|| / ||want||, the check's measure

    python tools/split_grad_rounding.py [--d-model 256] [--seq 64]

It needs no card and prints one JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import lm, mamba, moe  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.parallel.sharding import make_rules  # noqa: E402


def layer(cfg, sub: str, seq: int, seed: int = 1):
    gen = torch.Generator().manual_seed(seed)
    init = moe.moe_init if sub == "moe" else mamba.mamba_init
    lp = init(gen, cfg, torch.bfloat16)
    x = torch.randn((2, seq, cfg.d_model), generator=gen).to(torch.bfloat16)
    dy = torch.randn((2, seq, cfg.d_model), generator=gen)
    return lp, x, dy


def grads(cfg, sub: str, lp, x, dy, tp: int = 1) -> dict:
    """Every gradient of the layer, whole (``tp`` 1) or summed over the
    ranks of a model axis of ``tp``."""
    rules = make_rules(cfg, Mesh(("data", "model"), (1, tp)), global_batch=2,
                       shape_kind="train")
    locs, xs, views = [], [], []
    for r in range(tp):
        view = collectives.rank_view(rules, r) if tp > 1 else None
        loc = {}
        for k, v in lp.items():
            if tp > 1 and not (sub == "ssm" and k in ("w_zxbcdt", "conv_w",
                                                      "conv_b")):
                spec = lm.param_spec(rules, f"tail/t0/{sub}/{k}", v.shape)
                v = v[collectives.block_slices(tuple(v.shape), spec,
                                               rules.mesh,
                                               {"data": 0, "model": r})]
            loc[k] = v.detach().clone().requires_grad_()
        locs.append(loc)
        xs.append(x.detach().clone().requires_grad_())
        views.append(view)
    loss = 0.0
    if sub == "moe":
        for i, (loc, x_, v) in enumerate(zip(locs, xs, views)):
            y, aux = moe.moe_apply(loc, x_, cfg, dropless=False, tp=v)
            loss = loss + (y.float() * dy).sum()
            if i == 0:
                loss = loss + aux["moe_aux_loss"] + aux["moe_z_loss"]
    else:
        mixed = [mamba.mamba_mix(mamba.rank_columns(loc, cfg, v), x_,
                                 cfg=cfg, mode="train", tp=v)
                 for loc, x_, v in zip(locs, xs, views)]
        sumsq = sum(m[1] for m in mixed)
        for loc, m in zip(locs, mixed):
            loss = loss + (mamba.mamba_out(loc, m[0], sumsq, cfg).float()
                           * dy).sum()
    loss.backward()
    out = {"x": sum(x_.grad.float() for x_ in xs)}
    for k, v in lp.items():
        if tp == 1 or k == "router" or (sub == "ssm" and k in (
                "w_zxbcdt", "conv_w", "conv_b")):
            out[k] = sum(loc[k].grad.float() for loc in locs)
        else:   # the blocks back in their places
            whole = torch.zeros(v.shape)
            for r, loc in enumerate(locs):
                spec = lm.param_spec(rules, f"tail/t0/{sub}/{k}", v.shape)
                whole[collectives.block_slices(
                    tuple(v.shape), spec, rules.mesh,
                    {"data": 0, "model": r})] = loc[k].grad.float()
            out[k] = whole
    return out


def norm(a, b) -> float:
    d = float(b.norm())
    return float((a - b).norm()) / d if d else 0.0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--seq", type=int, default=64)
    args = ap.parse_args()
    out = {}
    for arch, sub in (("olmoe-1b-7b", "moe"), ("mamba2-370m", "ssm")):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  d_model=args.d_model)
        lp, x, dy = layer(cfg, sub, args.seq)
        want = grads(cfg, sub, lp, x, dy)
        f32 = grads(cfg, sub, {k: v.float() for k, v in lp.items()},
                    x.float(), dy)
        rec = {"whole_vs_f32_scaled": max(
            float(((want[k] - f32[k]).abs()
                   / (2.0 ** -7 * want[k].abs()
                      + 2.0 ** -12 * float(want[k].abs().max()))).max())
            for k in want if float(want[k].abs().max()) > 0),
            "whole_vs_f32_norm": max(norm(want[k], f32[k]) for k in want)}
        for tp in (2, 4):
            split = grads(cfg, sub, lp, x, dy, tp)
            rec[f"tp{tp}"] = {
                "split_vs_f32_norm": max(norm(split[k], f32[k])
                                         for k in split),
                "split_vs_whole_norm": max(norm(split[k], want[k])
                                           for k in split)}
        out[arch] = rec
    print(json.dumps(out))


if __name__ == "__main__":
    main()

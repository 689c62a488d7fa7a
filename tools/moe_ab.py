"""Time two or more versions of the MoE layer (``models/moe.py``) on one
card.

Each ``--variant name=FILE`` names a copy of ``moe.py``; each is loaded
as a module of its own beside the working tree's package (it imports
``repro_torch`` for its configs, activations and collectives).  One
olmoe-1b-7b MoE layer at full width (64 experts, top 8, d_ff 1024) from
``moe_init`` and a seed, bf16, is timed two ways:

    serve   ``moe_apply(dropless=True)`` on (4, 2048), no gradient: the
            chip check's serve prefill shape
    train   ``moe_apply(dropless=False)`` forward and backward on
            (2, 4096), the aux losses in the loss: its train microbatch

Each variant's outputs (and, for train, its gradients) are checked
against the first variant's once, bit for bit.  Then the calls run in
turns: within a round the variants go in one order, in the next round in
the reverse order, so that a drift of the card's clocks falls on all of
them alike.  A round times ``--reps`` back-to-back calls between CUDA
events (the layer syncs the host once a call, its ``.tolist()``, so this
is wall time as the path sees it); the result is each variant's median
over rounds.  To compare a commit's layer with the working tree's::

    mkdir -p build/ab
    git show <commit>:src/repro_torch/models/moe.py > build/ab/moe_old.py
    python tools/moe_ab.py --variant old=build/ab/moe_old.py \\
        --variant new=src/repro_torch/models/moe.py

It needs a card, prints the card's name and power limit, and one JSON
object as its last line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402

DEV = torch.device("cuda")


def load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(f"moe_ab_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def calls(mod, cfg, lp, xs, xt, dy):
    def serve():
        with torch.no_grad():
            return mod.moe_apply(lp, xs, cfg, dropless=True)[0]

    def train():
        w = {k: v.detach().requires_grad_() for k, v in lp.items()}
        x = xt.detach().requires_grad_()
        y, aux = mod.moe_apply(w, x, cfg, dropless=False)
        loss = ((y.float() * dy).sum() + aux["moe_aux_loss"]
                + aux["moe_z_loss"])
        loss.backward()
        return [y.detach(), x.grad] + [w[k].grad for k in sorted(w)]

    return {"serve": serve, "train": train}


def timed(fn, reps: int) -> float:
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", required=True,
                    help="name=path of a moe.py")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("moe_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    variants = dict(v.split("=", 1) for v in args.variant)
    mods = {n: load(n, p) for n, p in variants.items()}
    cfg = get_config("olmoe-1b-7b")
    first = next(iter(mods.values()))
    gen = torch.Generator(device=DEV).manual_seed(0)
    lp = first.moe_init(gen, cfg, torch.bfloat16)
    xs = torch.randn((4, 2048, cfg.d_model), generator=gen,
                     device=DEV).to(torch.bfloat16)
    xt = torch.randn((2, 4096, cfg.d_model), generator=gen,
                     device=DEV).to(torch.bfloat16)
    dy = torch.randn((2, 4096, cfg.d_model), generator=gen, device=DEV)
    fns = {n: calls(m, cfg, lp, xs, xt, dy) for n, m in mods.items()}
    want = {k: fns[next(iter(fns))][k]() for k in ("serve", "train")}
    same = {}
    for n, f in fns.items():
        for k in ("serve", "train"):
            got = f[k]()
            a = got if isinstance(got, list) else [got]
            b = want[k] if isinstance(want[k], list) else [want[k]]
            same[f"{n}:{k}"] = all(torch.equal(x, y) for x, y in zip(a, b))
    del want
    ms = {f"{n}:{k}": [] for n in fns for k in ("serve", "train")}
    order = list(fns)
    for r in range(args.rounds):
        for n in (order if r % 2 == 0 else order[::-1]):
            for k in ("serve", "train"):
                fns[n][k]()
                ms[f"{n}:{k}"].append(timed(fns[n][k], args.reps))
    out = {"card": smi, "config": cfg.name,
           "serve_shape": [4, 2048], "train_shape": [2, 4096],
           "bit_equal_to_first": same,
           "median_ms": {k: statistics.median(v) for k, v in ms.items()},
           "ms": ms}
    print(json.dumps(out))


if __name__ == "__main__":
    main()

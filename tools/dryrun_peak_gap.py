"""Where a rank share's peak on the card exceeds the dry-run's prediction.

Runs the chip check's (c) child (``chip_smoke.DRY_CHILD``: rank 0 of a
production cell, built by ``launch.dryrun.lower_cell`` under the ``fake``
group, one step on the card from seeded blocks) with the memory tracker's
dispatch wrapped to read the caching allocator before and after each
operation, and prints on one card:

- the predicted peak (``bytes_per_device``) and the card's
  ``max_memory_allocated`` above the child's start;
- cuBLAS's workspaces (the child's reading: what clearing them frees);
- the allocator's bytes beyond the tracker's live bytes at the tracker's
  own peak (workspaces and the allocator's rounding);
- the operation at the card's peak, the tracker's live bytes before it,
  and the buffer it held while it ran that none of its outputs holds
  (what a dispatch mode cannot see);
- the operations that held such buffers, largest first.

So the card's peak less the prediction splits into the allocator's excess
at the start of the peak's operation and that operation's share::

    python3 tools/dryrun_peak_gap.py [--arch qwen2-1.5b] [--shape train_4k]

Needs one card.
"""
from __future__ import annotations

import argparse
import ast
import collections
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.analysis import memory  # noqa: E402


def child_source() -> str:
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    return next(n.value.value for n in tree.body
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "DRY_CHILD")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--shape", default="train_4k")
    args = ap.parse_args(argv)
    # (name, allocated before, its peak, allocated after, tracker's live
    # bytes before, after) for each operation the tracker sees
    log = []
    wrapped = memory.MemoryTracker.__torch_dispatch__

    def dispatch(self, func, types, args=(), kwargs=None):
        before, live = torch.cuda.memory_allocated(), self.live
        torch.cuda.reset_peak_memory_stats()
        out = wrapped(self, func, types, args, kwargs)
        log.append((str(func), before, torch.cuda.max_memory_allocated(),
                    torch.cuda.memory_allocated(), live, self.live))
        return out

    memory.MemoryTracker.__torch_dispatch__ = dispatch
    sys.argv = ["dry_child", args.arch, args.shape]
    env: dict = {}
    exec(compile(child_source(), "DRY_CHILD", "exec"), env)
    base, rec = env["base"], env["rec"]
    pred = rec["bytes_per_device"]
    i = max(range(len(log)), key=lambda j: log[j][2])
    name, before, hi, _, live_before, _ = log[i]
    peak = hi - base
    t = max(range(len(log)), key=lambda j: log[j][5])
    excess_at_tracker_peak = log[t][3] - base - log[t][5]
    card = torch.cuda.get_device_name(0)
    print(f"{args.arch} {args.shape} rank 0 of {rec['mesh']} ({card}, "
          f"torch {torch.__version__})")
    print(f"predicted {pred} B, card {peak} B, card - predicted "
          f"{peak - pred} B ({100 * (pred - peak) / peak:+.3f} %)")
    print(f"arguments: predicted "
          f"{rec['memory_analysis']['argument_size_in_bytes']} B, card "
          f"{env['arg_bytes']} B")
    print(f"cuBLAS workspaces {env['workspaces']} B")
    print(f"allocator beyond the tracker at the tracker's peak "
          f"({log[t][0]}, op {t}): {excess_at_tracker_peak} B")
    print(f"the card's peak in {name} (op {i} of {len(log)}): the "
          f"allocator beyond the tracker at its start "
          f"{before - base - live_before} B; its own share "
          f"{live_before + hi - before - pred} B (a buffer of "
          f"{hi - max(before, log[i][3])} B that no output holds)")
    held = collections.defaultdict(lambda: [0, 0])
    for f, b, h, a, _, _ in log:
        if h > max(b, a):
            held[f][0] += 1
            held[f][1] = max(held[f][1], h - max(b, a))
    for f, (n, most) in sorted(held.items(), key=lambda x: -x[1][1])[:10]:
        print(f"  held inside {f}: {n} calls, at most {most} B")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Render the dry-run's records as one markdown table.

Reads every ``<arch>_<shape>_<pod|multipod>.json`` that
``python -m repro_torch.launch.dryrun --all`` wrote (``--dir``, by default
its ``experiments/dryrun_torch``) and prints one row a cell and mesh, in
the order of ``--list``: the bytes a device needs against the H100's
80 GB, the counted FLOPs, bytes and collective bytes a device, the three
roofline terms, the bottleneck and the roofline fraction.  Every figure
is computed on ``meta`` tensors, none measured.  A cell with no record is
listed with the reason ``--all`` kept beside it (``<tag>.error``), or as
missing::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python tools/dryrun_table.py
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch.dryrun import DEFAULT_OUT, all_cells  # noqa: E402

CARD_GB = 80                   # the H100's device memory


def _reason(path: str) -> str:
    if os.path.exists(path):
        return open(path).read().strip() or "no record"
    return "no record"


def rows(directory: str):
    yield ("| arch | shape | mesh | GB/device (of %d) | FLOPs/device | "
           "bytes/device | collective bytes/device | compute ms | "
           "memory ms | collective ms | bottleneck | roofline |" % CARD_GB)
    yield "|" + "---|" * 12
    for arch, shape in all_cells():
        for mesh in ("pod", "multipod"):
            tag = os.path.join(directory,
                               f"{arch}_{shape}_{mesh}".replace("/", "-"))
            if not os.path.exists(tag + ".json"):
                yield (f"| {arch} | {shape} | {mesh} | raised: "
                       f"{_reason(tag + '.error')} |" + " |" * 8)
                continue
            r = json.load(open(tag + ".json"))
            yield (f"| {arch} | {shape} | {mesh} "
                   f"| {r['bytes_per_device'] / 1e9:.2f} "
                   f"| {r['hlo_flops']:.3e} | {r['hlo_bytes']:.3e} "
                   f"| {r['collective_bytes']:.3e} "
                   f"| {r['t_compute'] * 1e3:.2f} "
                   f"| {r['t_memory'] * 1e3:.2f} "
                   f"| {r['t_collective'] * 1e3:.2f} | {r['bottleneck']} "
                   f"| {r['roofline_fraction']:.3f} |")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    for line in rows(args.dir):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

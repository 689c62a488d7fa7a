"""Quickstart: the MEMSCOPE toolkit on the PyTorch/CUDA port.

The twin of ``examples/quickstart.py``.  Detect the platform memory tree,
run one contention-ladder experiment (the observed activity reads device
memory while stressors write it) and print the performance curve and
Little's-law MLP.  The observer alone is measured by its hand-written
kernel on the card; the contended rungs come from the queueing model.

    python examples/torch/quickstart.py                # on the card
    python examples/torch/quickstart.py --device cpu   # plain versions

With ``--device cpu`` the kernels' plain PyTorch versions measure the
observer, at a size the CPU finishes.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

from repro_torch.core.coordinator import (ActivitySpec,  # noqa: E402
                                          CoreCoordinator, ExperimentConfig)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    on_card = args.device == "cuda"
    # above the H100's 50 MB L2 on the card; small on the CPU
    buf = (64 << 20) if on_card else (256 << 10)
    iters = 500 if on_card else 5

    coord = CoreCoordinator(device=args.device)   # backend "cuda"

    print(f"== detected memory pools (device tree: {coord.platform.name}, "
          f"{args.device}) ==")
    print(coord.pools.status())

    print(f"\n== experiment: observed (r, hbm, {buf >> 10}K) vs stressors "
          f"(w, hbm, {buf >> 10}K) ==")
    result = coord.run(ExperimentConfig(
        main=ActivitySpec("r", "hbm", buf),
        stress=ActivitySpec("w", "hbm", buf),
        iters=iters))
    print("stressors  bandwidth GB/s")
    for n, bw in result.bandwidth_curve():
        print(f"{n:9d}  {bw:10.1f}")

    lat = coord.run(ExperimentConfig(
        main=ActivitySpec("l", "hbm", buf),
        stress=ActivitySpec("w", "hbm", buf),
        iters=2))
    worst_lat = lat.latency_curve()[-1][1]
    worst_bw = result.bandwidth_curve()[-1][1]
    mlp = worst_lat * worst_bw / coord.platform.line_bytes
    print(f"\nLittle's law @ worst case: {worst_lat:.0f} ns x "
          f"{worst_bw:.0f} GB/s / {coord.platform.line_bytes}B line "
          f"=> MLP ~= {mlp:.1f}")


if __name__ == "__main__":
    main()

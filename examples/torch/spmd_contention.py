"""The barrier sandwich, executed: multi-observer contention on the card.

The paper's Multi-Engine Synchronizer guarantees that the measured
region only opens after EVERY engine passed the start barrier and only
closes after every engine finished.  The port's ``spmd`` backend runs a
whole contention ladder as one persistent CUDA kernel: an engine is a
group of CTAs (one on each SM), engine 0 runs the observer, the next its
coupled sibling observer, then the stressors, the rest idle, and every
rung sample sits between two barriers over global-memory counters.  The
card's own clock (``%globaltimer``) stamps each rung, and the stamps show
that the fence held.

    python examples/torch/spmd_contention.py                # on the card
    python examples/torch/spmd_contention.py --device cpu   # plain version

With ``--device cpu`` the same ladders run through the kernel's plain
PyTorch version, engine by engine, stamped by the host's clock: the same
keys, rungs and accounting, at a size the CPU finishes.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

from repro_torch.core.characterize import curvedb_from_result  # noqa: E402
from repro_torch.core.coordinator import CoreCoordinator  # noqa: E402
from repro_torch.core.scenarios import (ObserverSpec,  # noqa: E402
                                        ScenarioSpec, StressorSpec,
                                        TrafficShape)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    on_card = args.device == "cuda"
    buf = (64 << 20) if on_card else (128 << 10)

    # one scenario, TWO observers measured at once (bandwidth on hbm,
    # latency on host), against a mixed-ratio write stressor ensemble.
    # coupled=True (the default): each observer's rungs carry the OTHER
    # observer as a live engine
    spec = ScenarioSpec(
        "spmd-demo",
        (ObserverSpec("r", "hbm", (buf,)),
         ObserverSpec("l", "host", (buf // 16,))),
        (StressorSpec("w", "hbm", buf),
         StressorSpec("b", "hbm", buf, TrafficShape.mixed(1, 1))),
        iters=4 if on_card else 2, max_stressors=3)

    coord = CoreCoordinator(backend="spmd", device=args.device)
    print(f"== {coord._spmd_engines()} engines of "
          f"{coord._ctas_per_engine()} CTAs on {args.device} ==")
    res = coord.run_matrix([spec])
    st = res.stats
    print(f"\n{st.spmd_rungs} ladder rungs -> {st.measure_dispatches} "
          f"launches (one per distinct role-program signature: here one "
          f"per observer curve, {st.n_ladders} curves) + "
          f"{st.noisy_remeasures} quality-gate re-measurement(s)")
    for run in res.runs:
        ex = run.execution
        print(f"\n-- curve {run.key} (executed rungs "
              f"{ex['executed_rungs']}, activity={ex['activity']}, "
              f"coupled={ex['coupled']}, fenced={ex['fenced']}, "
              f"timing={ex['timing_source']})")
        for s in run.scenarios:
            val = (f"{s.main.latency_ns:10.1f} ns/hop"
                   if s.main.strategy == "l"
                   else f"{s.main.bandwidth_gbps:10.2f} GB/s")
            print(f"   k={s.n_stressors}: {val}   [{s.source}]")

    kinds = res.runs[0].execution.get("operand_memory_kinds", [])
    if len(kinds) > 1:
        # the JAX package's semantics, kept: operand_memory_kinds names
        # the pools' memories, but one program holds one operand set
        print(f"\nnote: this program mixes memories {kinds}, so, as in "
              f"the JAX package, every operand lives in device memory: "
              f"the host chase reads device memory (not pinned host "
              f"memory), and a rung lasts as long as its slowest engine, "
              f"so the coupled chase also sets the read's rung time.  "
              f"Single-pool scenarios measure each memory on its own.")

    # the executed curves persist with their provenance, no re-execution
    db = curvedb_from_result(res, coord.platform.name, backend="spmd")
    path = os.path.join(tempfile.mkdtemp(), "spmd_curves.json")
    db.save(path)
    print(f"\nCurveDB saved to {path}; execution of {spec.key()!r}: "
          f"{db.provenance[spec.key()]['execution']}")


if __name__ == "__main__":
    main()

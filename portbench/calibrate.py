"""Readings behind the limits of the check that decides ``correct``, on
the card, many seeds in one process:

    python3 portbench/calibrate.py --workload <cell> --what program \\
        --seeds 1,2,3 [--seconds 30]
    python3 portbench/calibrate.py --workload <cell> --what control --seeds 1,2,3
    python3 portbench/calibrate.py --workload <cell> --what half_batch --seeds 1,2,3
    python3 portbench/calibrate.py --workload <cell> --what sweep \\
        --rates 3,4,5 --seconds 15

``program``: the numbers a run with each seed compares (its window of
``--seconds``).  ``control``: those of the reference with float8
products in the program's place.  A fault's name (``faults.FAULTS``): a
run with it planted.  ``sweep`` (a serving cell): a run at each offered
rate, with its time-to-first-token quantiles and how late the last
request started.  One JSON line a reading, on standard output and
appended to ``portbench/out/calibrate-<cell>.jsonl``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--what", required=True)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--rates", default="")
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)

    import torch
    from portbench import faults, harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = harness.load_cell(args.workload)
    out_dir = ROOT / "portbench" / "out"
    out_dir.mkdir(parents=True, exist_ok=True)
    log = open(out_dir / f"calibrate-{args.workload}.jsonl", "a")

    def emit(row):
        row = dict(row, workload=args.workload, what=args.what,
                   card=torch.cuda.get_device_name(device))
        line = json.dumps(row, default=str)
        print(line, flush=True)
        log.write(line + "\n")
        log.flush()

    seeds = [int(s) for s in args.seeds.split(",") if s]
    try:
        if args.what == "sweep":
            for rate in [float(r) for r in args.rates.split(",")]:
                c = copy.deepcopy(cell)
                c.traffic["arrival"]["rate_per_s"] = rate
                c.traffic["check_requests"] = 0
                t = time.perf_counter()
                rec = harness.run_cell(c, seed=seeds[0],
                                       seconds=args.seconds, trace=False,
                                       device=device, t_start=t)
                ttft = [r["done"] - r["due"] for r in rec.requests]
                q = statistics.quantiles(ttft, n=20, method="inclusive")
                emit({"rate": rate, "served": len(rec.requests),
                      "ttft_p50_ms": 1e3 * q[9], "ttft_p95_ms": 1e3 * q[18],
                      "last_late_ms": 1e3 * (rec.requests[-1]["start"]
                                             - rec.requests[-1]["due"]),
                      "service_ms": [1e3 * (r["done"] - r["start"])
                                     for r in rec.requests],
                      "tokens_per_s": sum(r["tokens"] for r in rec.requests)
                      / rec.window_s, "checks": rec.checks})
                del rec
                torch.cuda.empty_cache()
            return 0
        for seed in seeds:
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            if args.what == "control":
                emit({"seed": seed, "readings": faults.control(
                    cell, seed, device), "s": time.perf_counter() - t})
                continue
            ctx = None
            if args.what != "program":
                ctx = faults.FAULTS[cell.traffic["kind"]][args.what]
            rec = harness.run_cell(cell, seed=seed, seconds=args.seconds,
                                   trace=False, device=device, t_start=t,
                                   program_ctx=ctx)
            emit({"seed": seed,
                  "readings": rec.notes.get("readings"),
                  "correct": harness.correct(rec), "setup_s": rec.setup_s,
                  "window_s": rec.window_s, "notes": rec.notes,
                  "served": len(rec.requests), "steps": len(rec.steps),
                  "first_ms": [1e3 * (r["done"] - r["start"])
                               for r in rec.requests[:10]],
                  "peak_bytes": rec.memory_peak_bytes,
                  "s": time.perf_counter() - t})
            del rec
            torch.cuda.empty_cache()
    finally:
        log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""User-space interface — the debugfs entries, as strings + a CLI.

Five entries, mirroring /sys/kernel/debug/membench:

  experiment   write: positional config string; read: last parsed config
  pools        read-only pool listing (id, size, free, allocs)
  perfcount    write: comma-separated event list; read: current selection
  results      read-only formatted results of the last experiment
  cmd          write: start | validate | erase

Config-string grammar (positional, like the paper's sscanf format)::

    <main_strat>,<main_pool>,<main_bytes> <stress_strat>,<stress_pool>,
    <stress_bytes> [iters=<n>] [scenarios=<n>]

Sizes accept K/M/G suffixes.  Example::

    l,hbm,4M w,host,4M iters=500
"""
from __future__ import annotations

import argparse
import re
import sys
from typing import Dict, Optional, Tuple

from repro_torch.core.coordinator import (ActivitySpec, CoreCoordinator,
                                    ExperimentConfig, ExperimentResult,
                                    ValidationError)
from repro_torch.core.counters import EVENTS, MAX_COUNTERS, select_events
from repro_torch.core.devicetree import detect_platform
from repro_torch.core.pools import PoolManager

_SIZE = {"": 1, "K": 1 << 10, "M": 1 << 20, "G": 1 << 30}


def parse_size(s: str) -> int:
    m = re.fullmatch(r"(\d+)([KMG]?)", s.strip(), re.I)
    if not m:
        raise ValueError(f"bad size {s!r}")
    return int(m.group(1)) * _SIZE[m.group(2).upper()]


def parse_activity(s: str) -> ActivitySpec:
    parts = s.split(",")
    if len(parts) != 3:
        raise ValueError(
            f"activity must be <strat>,<pool>,<bytes>: got {s!r}")
    return ActivitySpec(parts[0].strip(), parts[1].strip(),
                        parse_size(parts[2]))


def parse_experiment(line: str) -> ExperimentConfig:
    toks = line.split()
    if len(toks) < 2:
        raise ValueError(
            "need two activities: '<main> <stress> [iters=..] "
            "[scenarios=..]'")
    main = parse_activity(toks[0])
    stress = parse_activity(toks[1])
    kw: Dict[str, int] = {}
    for t in toks[2:]:
        k, _, v = t.partition("=")
        if k not in ("iters", "scenarios"):
            raise ValueError(f"unknown option {k!r}")
        kw[k] = int(v)
    return ExperimentConfig(main=main, stress=stress,
                            iters=kw.get("iters", 500),
                            scenarios=kw.get("scenarios"))


def format_experiment(cfg: ExperimentConfig) -> str:
    extra = f" iters={cfg.iters}"
    if cfg.scenarios is not None:
        extra += f" scenarios={cfg.scenarios}"
    return (f"{cfg.main.strategy},{cfg.main.pool},{cfg.main.buffer_bytes} "
            f"{cfg.stress.strategy},{cfg.stress.pool},"
            f"{cfg.stress.buffer_bytes}{extra}")


def format_results(res: ExperimentResult) -> str:
    cfg = res.config
    lines = [f"# config: {format_experiment(cfg)}",
             "stressors  bw_GBps    lat_ns   stress_bw_GBps"]
    for s in res.scenarios:
        lines.append(f"{s.n_stressors:9d}  {s.modeled_bw_gbps:8.3f} "
                     f"{s.modeled_lat_ns:9.1f}  {s.stress_bw_gbps:8.3f}")
    if res.scenarios and res.scenarios[0].main.launch_bound:
        lines.append("# note: the measured observer ran an on-chip kernel "
                     "whose slope timing failed; its time is the kernel "
                     "launch's, not the memory's")
    return "\n".join(lines)


class MemscopeInterface:
    """Holds the debugfs-entry state machine."""

    def __init__(self, coordinator: Optional[CoreCoordinator] = None):
        # with no coordinator given: the card's, which raises without one
        self.coord = coordinator or CoreCoordinator()
        self._experiment: Optional[ExperimentConfig] = None
        self._events: Tuple[str, ...] = EVENTS[:MAX_COUNTERS]
        self._results: Optional[ExperimentResult] = None

    # entry: experiment -------------------------------------------------
    def write_experiment(self, line: str) -> None:
        self._experiment = parse_experiment(line)

    def read_experiment(self) -> str:
        if self._experiment is None:
            return "(no experiment configured)"
        return format_experiment(self._experiment)

    # entry: pools --------------------------------------------------------
    def read_pools(self) -> str:
        return self.coord.pools.status()

    # entry: perfcount ------------------------------------------------------
    def write_perfcount(self, line: str) -> None:
        self._events = select_events(
            tuple(e.strip() for e in line.split(",") if e.strip()))

    def read_perfcount(self) -> str:
        return ",".join(self._events)

    # entry: cmd --------------------------------------------------------------
    def write_cmd(self, cmd: str) -> str:
        cmd = cmd.strip()
        if cmd == "validate":
            if self._experiment is None:
                return "ERR no experiment configured"
            try:
                self.coord.validate(self._experiment)
                return "OK valid"
            except (ValidationError, Exception) as e:  # noqa: BLE001
                return f"ERR {e}"
        if cmd == "start":
            if self._experiment is None:
                return "ERR no experiment configured"
            self._results = self.coord.run(self._experiment)
            return "OK complete"
        if cmd == "erase":
            self._results = None
            return "OK erased"
        return f"ERR unknown command {cmd!r}"

    # entry: results -------------------------------------------------------
    @property
    def results(self) -> Optional[ExperimentResult]:
        """The last experiment's result object (the measured observer
        beside the modeled rungs that :meth:`read_results` prints)."""
        return self._results

    def read_results(self) -> str:
        if self._results is None:
            return "(no results)"
        return format_results(self._results)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.interface",
        description="MEMSCOPE experiment control (PyTorch/CUDA)")
    ap.add_argument("--experiment", help="config string (see module doc)")
    ap.add_argument("--cmd", default="start",
                    choices=["start", "validate", "erase"])
    ap.add_argument("--pools", action="store_true",
                    help="list pools and exit")
    ap.add_argument("--platform", default=None,
                    choices=["h100-sxm", "zcu102"],
                    help="device tree (default: the detected card's)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "simulate", "cuda"],
                    help="auto is cuda: the observer's kernel really runs")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu runs the kernels' plain PyTorch versions")
    args = ap.parse_args(argv)

    platform = detect_platform(args.platform, device=args.device)
    iface = MemscopeInterface(CoreCoordinator(
        PoolManager(platform, args.device), platform, backend=args.backend,
        device=args.device))

    if args.pools:
        print(iface.read_pools())
        return 0
    if not args.experiment:
        ap.error("--experiment required (or --pools)")
    iface.write_experiment(args.experiment)
    out = iface.write_cmd(args.cmd)
    print(out)
    if args.cmd == "start" and out.startswith("OK"):
        print(iface.read_results())
    return 0 if out.startswith("OK") else 1


if __name__ == "__main__":
    sys.exit(main())

"""Performance-counter analog — analytic cost + device timers.

MEMSCOPE samples ARMv8 PMU events around the measured region.  A GPU's
hardware counters need profiling privileges that a deployment often
lacks, but a microbenchmark's cost is known *before it runs*: the
workload states the operations and the bytes it must move (each input
read once, each output written once).
Together with device-event sandwich timing these cover the paper's
Table-IV methodology (cycles, mem accesses, cache refills -> flops,
bytes, per-access time).

Six "counters" per activity, mirroring the 6-counter/core ARM PMU limit.
The event names are the JAX package's, so selections port; there
``HLO_FLOPS``/``HLO_BYTES`` come from the compiler's cost analysis, here
from the caller's ``flops=``/``bytes=``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple

import torch

from repro_torch.compat import resolve_device

MAX_COUNTERS = 6   # ARM PMU exposes 6 programmable counters per core

#: available events (the pmevtyper analog)
EVENTS = (
    "WALL_NS",          # measured region time
    "HLO_FLOPS",        # analytic operations of one call
    "HLO_BYTES",        # analytic bytes moved by one call
    "TRANSACTIONS",     # bytes / line_bytes
    "NS_PER_TX",        # wall / transactions
    "PEAK_MEMORY",      # peak bytes allocated on the device in the region
)


@dataclass
class CounterSample:
    events: Dict[str, float] = field(default_factory=dict)

    def __getitem__(self, k: str) -> float:
        return self.events[k]

    def as_row(self) -> str:
        return " ".join(f"{k}={v:.4g}" for k, v in self.events.items())


def select_events(names: Tuple[str, ...]) -> Tuple[str, ...]:
    bad = [n for n in names if n not in EVENTS]
    if bad:
        raise KeyError(f"unknown events {bad}; available {EVENTS}")
    if len(names) > MAX_COUNTERS:
        raise ValueError(
            f"at most {MAX_COUNTERS} counters per core (got {len(names)})")
    return names


def sample(fn: Callable, *args, iters: int = 10, line_bytes: int = 512,
           events: Tuple[str, ...] = EVENTS[:MAX_COUNTERS],
           flops: float = 0.0, bytes: float = 0.0, device="cuda",
           **kw) -> CounterSample:
    """Run fn under the selected counters (the warm call is not timed).

    ``flops`` and ``bytes`` are the analytic cost of ONE call of ``fn``.
    On the card the region is timed with a device-event pair and
    ``PEAK_MEMORY`` is ``torch.cuda.max_memory_allocated`` over it; on
    ``device="cpu"`` the host clock times it and ``PEAK_MEMORY`` is 0."""
    events = select_events(tuple(events))
    dev = resolve_device(device)
    fn(*args, **kw)
    peak = 0.0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args, **kw)
        stop.record()
        stop.synchronize()
        wall = start.elapsed_time(stop) * 1e6 / iters
        peak = float(torch.cuda.max_memory_allocated(dev))
    else:
        t0 = time.perf_counter_ns()
        for _ in range(iters):
            fn(*args, **kw)
        wall = (time.perf_counter_ns() - t0) / iters

    tx = bytes / line_bytes
    all_events = {
        "WALL_NS": wall,
        "HLO_FLOPS": float(flops),
        "HLO_BYTES": float(bytes),
        "TRANSACTIONS": tx,
        "NS_PER_TX": wall / tx if tx else 0.0,
        "PEAK_MEMORY": peak,
    }
    return CounterSample({k: all_events[k] for k in events})

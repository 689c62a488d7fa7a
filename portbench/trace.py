"""The traced segment: ranges of the benchmark's own around calls into the
port's layers, host syncs counted, and the card's activity read from a
``torch.profiler`` trace.

Nothing here is added inside ``repro_torch``: :func:`instrument` swaps a
module's function for a wrapper while the context is open, as a test's
monkeypatch would, and puts it back.  A wrapper opens a
``record_function`` range named ``portbench.<label>``; where it is asked
to, it also counts the host syncs its call makes (PyTorch's sync debug
mode, as ``chip_smoke.host_syncs`` counts them) and stamps its wall time
between two synchronisations of the card.

:class:`Trace` reads the profiler's Chrome trace: every kernel, copy and
set on the card, the host's launch of each (its correlation id), the
benchmark's ranges and the host's operators.  A kernel belongs to a range
when the host launched it inside the range.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import time
import warnings
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "portbench."


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Probe:
    """What the wrappers of one traced run gather: wall stamps and host
    syncs by label."""

    def __init__(self, device):
        self.device = device
        self.stamps: Dict[str, List[float]] = defaultdict(list)
        self.syncs: Dict[str, List[int]] = defaultdict(list)
        self.count_syncs = False

    def wrap(self, real: Callable, label: str, *, stamp: bool = False,
             syncs: bool = False) -> Callable:
        probe = self

        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(PREFIX + label):
                if stamp:
                    sync(probe.device)
                    t0 = time.perf_counter()
                if syncs and probe.count_syncs:
                    with warnings.catch_warnings(record=True) as seen:
                        warnings.simplefilter("always")
                        out = real(*args, **kwargs)
                    probe.syncs[label].append(sum(
                        "synchroniz" in str(w.message) for w in seen))
                else:
                    out = real(*args, **kwargs)
                if stamp:
                    sync(probe.device)
                    probe.stamps[label].append(time.perf_counter() - t0)
            return out

        return wrapper

    @contextlib.contextmanager
    def sync_debug(self):
        """Host syncs reported as warnings while the context is open (and
        the warnings kept out of the run's output)."""
        cuda = torch.device(self.device).type == "cuda"
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            self.count_syncs = True
            try:
                yield
            finally:
                self.count_syncs = False
                if cuda:
                    torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def instrument(patches):
    """``patches``: (module, attribute, replacement) triples, in place
    while the context is open."""
    saved = [(m, a, getattr(m, a)) for m, a, _ in patches]
    try:
        for m, a, new in patches:
            setattr(m, a, new)
        yield
    finally:
        for m, a, old in reversed(saved):
            setattr(m, a, old)


@contextlib.contextmanager
def profiled(path: str, device, *, host: bool):
    """A ``torch.profiler`` trace while the context is open, written to
    ``path``; yields a holder whose ``trace`` is set on exit.  With
    ``host`` the host's operators and the benchmark's ranges are traced
    too, inside one ``portbench.traced`` range: tracing them slows the
    host several fold, so the device's busy share is read from a trace
    without them, whose window is the host's wall time between two
    synchronisations."""
    holder = type("Holder", (), {"trace": None})()
    cuda = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CUDA] if cuda else []
    if host or not cuda:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(PREFIX + "traced"):
            yield holder
            sync(device)
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    holder.trace = Trace.load(path, wall)


class Trace:
    """The traced segment's device activity, launches and host ranges
    (microseconds on the trace's clock)."""

    def __init__(self, events: List[dict], wall_s: float = 0.0):
        self.device_ops = []            # (start, end, name, correlation)
        self.launch_at: Dict[int, float] = {}
        self.ranges: Dict[str, List[tuple]] = defaultdict(list)
        self.host_ops = []              # (start, end, name)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat", ""), float(e["ts"]), \
                float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                self.device_ops.append((ts, ts + dur, e["name"],
                                        args.get("correlation")))
            elif cat in LAUNCH_CATS and "correlation" in args:
                self.launch_at[args["correlation"]] = ts
            elif cat == "user_annotation" and \
                    e["name"].startswith(PREFIX):
                self.ranges[e["name"][len(PREFIX):]].append((ts, ts + dur))
            elif cat == "cpu_op":
                self.host_ops.append((ts, ts + dur, e["name"]))
        self.device_ops.sort()
        for v in self.ranges.values():
            v.sort()
        self.host_ops.sort()
        if self.ranges["traced"]:
            self.t0, self.t1 = self.ranges["traced"][0]
        else:       # no host events: the window from the first operation
            self.t0 = self.device_ops[0][0] if self.device_ops else 0.0
            self.t1 = self.t0 + wall_s * 1e6

    @classmethod
    def load(cls, path: str, wall_s: float = 0.0) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data,
                   wall_s)

    # -- the window ---------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> List[tuple]:
        """The union of the device's activity inside the window."""
        out: List[list] = []
        for s, e, _, _ in self.device_ops:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(iv) for iv in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    # -- attribution --------------------------------------------------------
    def _inside(self, label: str, t: Optional[float]) -> bool:
        if t is None:
            return False
        spans = self.ranges.get(label, [])
        i = bisect.bisect_right(spans, (t, float("inf"))) - 1
        return i >= 0 and spans[i][0] <= t <= spans[i][1]

    def device_us(self, label: Optional[str] = None,
                  name_has: Optional[str] = None) -> float:
        """Device microseconds of the operations launched inside the
        ``label`` ranges (every operation where None) whose name holds
        ``name_has``."""
        total = 0.0
        for s, e, name, corr in self.device_ops:
            if name_has is not None and name_has not in name:
                continue
            if label is not None and not self._inside(
                    label, self.launch_at.get(corr)):
                continue
            total += e - s
        return total

    def count(self, name_has: str) -> int:
        return sum(name_has in name for _, _, name, _ in self.device_ops)

    def _host_label(self, t: Optional[float]) -> str:
        """The innermost benchmark range and host operator open at ``t``."""
        if t is None:
            return "unlaunched"
        rng = "-"
        best = None
        for label, spans in self.ranges.items():
            if label == "traced":
                continue
            i = bisect.bisect_right(spans, (t, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                if best is None or spans[i][0] > best:
                    best, rng = spans[i][0], label
        # the latest-starting operator that holds t is the innermost
        i = bisect.bisect_right(self.host_ops, (t, float("inf"), "")) - 1
        op = "-"
        for j in range(i, max(-1, i - 200), -1):
            s, e, name = self.host_ops[j]
            if s <= t <= e:
                op = name
                break
        return f"{rng}/{op}"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing when the operation after each
        was launched (seconds)."""
        by_name: Dict[str, float] = defaultdict(float)
        for s, e, name, _ in self.device_ops:
            s, e = max(s, self.t0), min(e, self.t1)
            if e > s:
                by_name[name[:160]] += (e - s) / 1e6
        starts = [op[0] for op in self.device_ops]
        gaps: Dict[str, float] = defaultdict(float)
        busy = self.busy_intervals()
        edges = [(self.t0, busy[0][0])] if busy else [(self.t0, self.t1)]
        edges += [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
        if busy:
            edges.append((busy[-1][1], self.t1))
        for g0, g1 in edges:
            if g1 <= g0:
                continue
            j = bisect.bisect_left(starts, g1)
            corr = self.device_ops[j][3] if j < len(starts) else None
            label = (self._host_label(self.launch_at.get(corr))
                     if j < len(starts) else "after the last operation")
            gaps[label] += (g1 - g0) / 1e6

        def top_of(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]

        return {"device_ops": top_of(by_name), "idle_gaps": top_of(gaps)}

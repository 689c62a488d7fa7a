"""One run of one cell: the files a cell names, found by name, the
cell's runner, its metrics, and the result line.

A cell of ``BENCHMARK.json`` names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<mix>.json``);
the mix's ``kind`` names the runner (``runners/<kind>.py``), the
configuration's ``family`` its weights (``weights/<family>.py``), its
mapping onto the port (``adapters/<family>.py``), its plain reference
(``reference/<family>.py``) and its model FLOPs (``work/<family>.py``).
Each metric is read by ``e2e/<name>.py`` or ``layers/<name>.py``, and
the limits of the comparison that decides ``correct`` are in
``limits/<workload>.json``.  A new configuration, mix or metric is a new
file and new entries, with no file edited.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the names a run may not have loaded, compared as whole top-level names
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots and
    dashes)."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    key = f"portbench._{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """What a run of one workload needs, read from BENCHMARK.json and the
    files it names."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench_path: Path = ROOT / "BENCHMARK.json"
              ) -> Cell:
    with open(bench_path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; BENCHMARK.json has "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(bench_path.parent / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    return Cell(name=workload, chips=w["chips"], config=config,
                traffic=load_json("traffic", w["traffic"]),
                limits=load_json("limits", workload),
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, workload)])


@dataclass
class RunRecord:
    """What a runner measured; the metric readers take their numbers from
    it.  Times are seconds on the host's clock."""
    kind: str
    config: dict
    traffic: dict
    setup_s: float = 0.0
    window_s: float = 0.0           # from the window's start to its end
    # serving: one dict a request (due, start, done, seqs, tokens, its
    # model FLOPs; prefill_s in the traced run)
    requests: List[dict] = field(default_factory=list)
    # training: one dict a step (start, done, tokens, its model FLOPs)
    steps: List[dict] = field(default_factory=list)
    memory_peak_bytes: int = 0
    # host syncs counted in the traced run, by range: one count a call
    counts: Dict[str, List[int]] = field(default_factory=dict)
    trace: Any = None               # trace.Trace of the card alone
    host_trace: Any = None          # trace.Trace of the host and the card
    # (name, value, limit) of each number the check compared
    checks: List[tuple] = field(default_factory=list)
    failed: int = 0
    attempted: int = 0
    notes: Dict[str, Any] = field(default_factory=dict)


def read_metrics(cell: Cell, record: RunRecord, trace: bool) -> dict:
    """The cell's end-to-end metrics (``trace`` false) or per-layer
    metrics (true), each by its reader; a reader that finds nothing to
    read returns None and the metric is left out."""
    kind, entries = (("layers", cell.per_layer) if trace
                     else ("e2e", cell.end_to_end))
    out = {}
    for m in entries:
        value = load_module(kind, m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool,
             device, t_start: float,
             program_ctx: Optional[Callable] = None) -> RunRecord:
    """One run of ``cell`` on ``device``; ``program_ctx`` (a context
    manager factory) is entered around the program's set-up and window
    alone, never around the reference: the faults and controls of the
    checks' own tests go in there."""
    runner = load_module("runners", cell.traffic["kind"])
    return runner.run(cell, seed=seed, seconds=seconds, trace=trace,
                      device=device, t_start=t_start,
                      program_ctx=program_ctx)


def correct(record: RunRecord) -> bool:
    return (record.failed == 0 and bool(record.checks)
            and all(v == v and v <= lim for _, v, lim in record.checks))


def result(cell: Cell, record: RunRecord, trace: bool, device_info: dict
           ) -> dict:
    out = {"correct": correct(record), "attempted": record.attempted,
           "failed": record.failed,
           "metrics": read_metrics(cell, record, trace),
           "device": dict(device_info,
                          memory_peak_bytes=record.memory_peak_bytes)}
    if trace and record.trace is not None:
        out["device"].update(busy_s=record.trace.busy_s,
                             window_s=record.trace.window_s)
        out["breakdown"] = {
            "device_ops": record.trace.breakdown()["device_ops"],
            "idle_gaps": (record.host_trace or record.trace).breakdown()[
                "idle_gaps"]}
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in record.checks}
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))

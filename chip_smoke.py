#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on an NVIDIA H100.

Run from the root of a checkout, with one card and no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc``, holds every kernel against its plain PyTorch version on the
card, drives the port's main path (config string -> MemscopeInterface ->
CoreCoordinator -> workload -> kernel -> modeled rungs) at the sizes a
user of the toolkit would call real on this card, checks the results,
and times every kernel beside its bound.  One JSON object per phase goes
to standard output; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failing phase makes the exit code non-zero and withholds that line.
Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device available\n")
    sys.exit(1)

from repro_torch.core import workloads  # noqa: E402
from repro_torch.core.coordinator import (ActivitySpec,  # noqa: E402
                                          CoreCoordinator, ExperimentConfig)
from repro_torch.core.devicetree import H100_SXM  # noqa: E402
from repro_torch.core.interface import (MemscopeInterface,  # noqa: E402
                                        format_results)
from repro_torch.core.pools import PoolManager  # noqa: E402
from repro_torch.kernels import (_build, chase, counts, ref,  # noqa: E402
                                 stream)

DEV = torch.device("cuda")
# published peaks of the H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
PCIE_GBPS = 64.0               # PCIe Gen5 x16, one direction
SECTOR_BYTES = 32              # the least the device memory moves for a load
# main-path sizes
G1, M256, M64, M16, K128 = 1 << 30, 256 << 20, 64 << 20, 16 << 20, 128 << 10
CSRC = "src/repro_torch/kernels/csrc/"
FAILURES: list = []


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    FAILURES.append(msg)
    sys.stderr.write(f"chip_smoke: FAIL {msg}\n")


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, n: int) -> float:
    """Milliseconds per call over ``n`` back-to-back calls after one warm
    call, between two device events."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def rows_of(buffer_bytes: int) -> int:
    """The reference's buffer -> rows rule, restated independently."""
    rows = max(1, buffer_bytes // 512)
    block = 512 if rows >= 512 else rows
    return (rows // block) * block or rows


# ---------------------------------------------------------------------------
# phase 1, 2: device, build
# ---------------------------------------------------------------------------


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.build_all(verbose=True)
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "libraries": {k: os.path.relpath(v, ROOT)
                        for k, v in libs.items()}})


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version, on the card
# ---------------------------------------------------------------------------

READ_RTOL_SMALL = 2e-6   # the reference's own, at <= 1024 rows
# full size: float32 accumulators sum ~250 values each that reach 2.7e8
# (bw_buffer_init's arange), in another order than the float64 yardstick
READ_RTOL_FULL = 1e-5


def uniform(rows: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand((rows, 128), generator=g, dtype=torch.float32).to(DEV)


def case(cases: list, name: str, shape, err: float, tol: float,
         extra=None, keep=None) -> None:
    """Record one comparison; ``keep`` (name -> error and tolerance)
    collects the cases made at the main path's shape."""
    ok = bool(err <= tol) and math.isfinite(err)
    rec = {"name": name, "shape": list(shape), "max_abs_err": err,
           "tol": tol, "ok": ok}
    rec.update(extra or {})
    cases.append(rec)
    if keep is not None and err >= keep.get(name, {}).get("max_abs_err", 0.0):
        keep[name] = {"max_abs_err": err, "tol": tol}
    if not ok:
        fail(f"kernel {name} {list(shape)}: err {err} > tol {tol}")


def rel_err(got: torch.Tensor, x: torch.Tensor, scale: float = 1.0):
    want = float(x.double().sum()) * scale
    err = abs(float(got) - want)
    return err, abs(want)


def phase_kernels(main_rows: int) -> dict:
    """Holds every wrapper against its plain version at a small shape and
    at the main path's; returns name -> its worst error, and the tolerance
    that held, at the latter."""
    cases: list = []
    at_main: dict = {}
    before, _ = counts.snapshot()

    for rows, tol in ((1024, READ_RTOL_SMALL), (main_rows, READ_RTOL_FULL)):
        keep = at_main if rows == main_rows else None
        x = (uniform(rows, 1) if rows == 1024 else
             workloads.bw_buffer_init((rows, 128), torch.float32).to(DEV))
        err, mag = rel_err(stream.read_hbm(x, block_rows=512), x)
        case(cases, "read_hbm", x.shape, err, tol * mag, {"rtol": tol}, keep)

        out = stream.write_hbm(rows, value=2.5, device=DEV)
        err = float((out - ref.write_ref(rows, 2.5, DEV)).abs().max())
        case(cases, "write_hbm", out.shape, err, 0.0, keep=keep)

        seed = torch.full((1, 1), 0.25, dtype=torch.float32, device=DEV)
        out = stream.write_hbm_seeded(seed, rows, value=2.5)
        err = float((out - ref.write_ref(rows, 2.75, DEV)).abs().max())
        case(cases, "write_hbm_seeded", out.shape, err, 0.0, keep=keep)

        out = stream.rmw_hbm(x)
        err = float((out - ref.rmw_ref(x)).abs().max())
        case(cases, "rmw_hbm", x.shape, err, 0.0, {"dtype": "float32"}, keep)
        if out.data_ptr() == x.data_ptr():
            fail("rmw_hbm must write a new buffer")

        out = stream.copy_hbm(x)
        err = float((out - x).abs().max())
        case(cases, "copy_hbm", x.shape, err, 0.0, keep=keep)
        del out, x

    xb = uniform(512, 2).to(torch.bfloat16)
    got, want = stream.rmw_hbm(xb).float(), ref.rmw_ref(xb).float()
    # bf16 keeps 8 bits of mantissa: one rounding of x + 1 is within 2^-8
    case(cases, "rmw_hbm", xb.shape, float((got - want).abs().max()),
         1e-2 * float(want.abs().max()), {"dtype": "bfloat16", "rtol": 1e-2})

    # mixed: the five ratios of the reference's own test, then the main
    # path's split
    for rows, blk, rfs in ((1024, 128, (1.0, 2 / 3, 0.5, 1 / 3, 0.0)),
                           (main_rows, 512, (2 / 3,))):
        x = uniform(rows, 3)
        seed = torch.zeros((1, 1), dtype=torch.float32, device=DEV)
        for rf in rfs:
            s, out = stream.mixed_hbm(x, read_fraction=rf, block_rows=blk,
                                      seed=seed)
            b, n_r, n_w = ref.mixed_split(rows, rf, blk)
            err, mag = rel_err(s, x[:n_r * b])
            if tuple(out.shape) != (n_w * b, 128):
                fail(f"mixed_hbm rf={rf}: written shape {tuple(out.shape)}")
            if n_w and not bool((out == 1.0).all()):
                fail(f"mixed_hbm rf={rf}: written values wrong")
            case(cases, "mixed_hbm", x.shape, err,
                 READ_RTOL_FULL * max(mag, 1.0),
                 {"read_fraction": rf, "rtol": READ_RTOL_FULL},
                 at_main if rows == main_rows else None)
        del x

    # on-chip pair: one SM's tile, the main path's 128K, and a buffer
    # tiled over several CTAs (a ragged last tile)
    for rows in (8, rows_of(K128), 453, 2048 + 8):
        x = uniform(rows, 4)
        for repeats in (1, 8):
            keep = (at_main if rows == rows_of(K128) and repeats == 8
                    else None)
            err, mag = rel_err(stream.read_vmem(x, repeats=repeats), x,
                               repeats)
            case(cases, "read_vmem", x.shape, err, READ_RTOL_FULL * mag,
                 {"repeats": repeats, "rtol": READ_RTOL_FULL}, keep)
            out = stream.write_vmem(rows, repeats=repeats, device=DEV)
            err = float((out - ref.write_vmem_ref(rows, repeats, DEV))
                        .abs().max())
            case(cases, "write_vmem", out.shape, err, 0.0,
                 {"repeats": repeats}, keep)

    # chases: exact
    for n_lines in (2, 16, 64, 257):
        for seed_ in (0, 3):
            host = chase.chain_buffer(n_lines, seed_)
            buf = torch.from_numpy(host).to(DEV)
            for steps in (1, n_lines // 2 or 1, n_lines):
                want = ref.chase_ref(host, steps)
                for name, fn in (("chase_vmem", chase.chase_vmem),
                                 ("chase_hbm", chase.chase_hbm)):
                    got = int(fn(buf, n_steps=steps))
                    case(cases, name, buf.shape, float(abs(got - want)), 0.0,
                         {"seed": seed_, "n_steps": steps})
            if ref.chase_ref(host, n_lines) != 0:
                fail("a full cycle must return to 0")
    # the main path's shapes: `l,hbm,128K` on chip, `m,hbm,256M` past the L2
    for name, fn, n_lines in (("chase_vmem", chase.chase_vmem, rows_of(K128)),
                              ("chase_hbm", chase.chase_hbm, rows_of(M256))):
        host = chase.chain_buffer(n_lines, 0)
        buf = torch.from_numpy(host).to(DEV)
        for steps in (n_lines // 3, n_lines):
            err = float(abs(int(fn(buf, n_steps=steps))
                            - ref.chase_ref(host, steps)))
            case(cases, name, buf.shape, err, 0.0, {"n_steps": steps},
                 at_main)

    launched, _ = counts.snapshot()
    emit({"phase": "kernel_checks", "n_cases": len(cases),
          "n_ok": sum(c["ok"] for c in cases),
          "launches": {k: launched[k] - before[k] for k in launched},
          "cases": cases})
    return at_main


def phase_pinned() -> None:
    """The pointer of a pinned host tensor is read and written by the
    kernels as it is (unified addressing): shown by value, not assumed."""
    x = torch.empty((1024, 128), dtype=torch.float32, pin_memory=True)
    x.copy_(torch.rand((1024, 128)))
    err, mag = rel_err(stream.read_hbm(x), x)
    ok_r = err <= READ_RTOL_SMALL * mag
    out = torch.zeros((1024, 128), dtype=torch.float32, pin_memory=True)
    stream.write_hbm(1024, value=7.0, out=out)
    sync()
    ok_w = bool((out == 7.0).all())
    host = chase.chain_buffer(257, 5)
    buf = torch.empty(host.shape, dtype=torch.int32, pin_memory=True)
    buf.copy_(torch.from_numpy(host))
    ok_c = int(chase.chase_hbm(buf, n_steps=100)) == ref.chase_ref(host, 100)
    emit({"phase": "pinned_host", "read_ok": ok_r, "write_ok": ok_w,
          "chase_ok": ok_c})
    if not (ok_r and ok_w and ok_c):
        fail("pinned host memory is not device-accessible as assumed")


# ---------------------------------------------------------------------------
# phase 4: the main path, through the entry points a user calls
# ---------------------------------------------------------------------------

STRESS = "w,hbm,{}".format(G1)
# (label, main activity, iters, kernels whose launch counter must go up)
EXPERIMENTS = [
    ("r,hbm,1G", f"r,hbm,{G1}", 50, ("read_hbm",)),
    ("s,hbm,1G", f"s,hbm,{G1}", 50, ("read_hbm",)),
    ("w,hbm,1G", f"w,hbm,{G1}", 50, ("write_hbm",)),
    ("y,hbm,1G", f"y,hbm,{G1}", 50, ("write_hbm",)),
    ("x,hbm,1G", f"x,hbm,{G1}", 50, ("rmw_hbm",)),
    ("c,hbm,1G", f"c,hbm,{G1}", 50, ("copy_hbm",)),
    ("b,hbm,1G,rf=2/3", ActivitySpec("b", "hbm", G1, read_fraction=2 / 3),
     50, ("read_hbm", "write_hbm_seeded")),
    ("m,hbm,256M", f"m,hbm,{M256}", 20, ("chase_hbm",)),
    ("t,hbm,256M", f"t,hbm,{M256}", 20, ("chase_hbm",)),
    ("l,hbm,256M", f"l,hbm,{M256}", 20, ("chase_hbm",)),
    ("m,hbm,16M", f"m,hbm,{M16}", 20, ("chase_hbm",)),
    ("r,hbm,128K", f"r,hbm,{K128}", 50, ("read_vmem",)),
    ("w,hbm,128K", f"w,hbm,{K128}", 50, ("write_vmem",)),
    ("l,hbm,128K", f"l,hbm,{K128}", 50, ("chase_vmem",)),
    ("r,vmem,128K", f"r,vmem,{K128}", 50, ("read_vmem",)),
    ("s,host,256M", f"s,host,{M256}", 20, ("read_hbm",)),
    ("y,host,256M", f"y,host,{M256}", 20, ("write_hbm",)),
    ("m,host,64M", f"m,host,{M64}", 20, ("chase_hbm",)),
]
_TWICE = ("x", "c")
_CHASES = ("l", "m", "t")


def expected_accounting(strategy: str, buffer_bytes: int, iters: int):
    rows = rows_of(buffer_bytes)
    if strategy in _CHASES:
        return rows * 512, rows
    return (2 if strategy in _TWICE else 1) * rows * 512 * iters, 0


def phase_main_path() -> dict:
    """Drives every experiment; returns label -> record."""
    coord = CoreCoordinator(PoolManager(H100_SXM, DEV), H100_SXM,
                            backend="cuda", device=DEV)
    iface = MemscopeInterface(coord)
    records = {}
    for label, main, iters, expect in EXPERIMENTS:
        before, _ = counts.snapshot()
        t0 = time.perf_counter()
        if isinstance(main, str):
            iface.write_experiment(f"{main} {STRESS} iters={iters} "
                                   "scenarios=8")
            reply = iface.write_cmd("start")
            res, text = iface.results, iface.read_results()
        else:       # a traffic shape the string grammar cannot spell
            cfg = ExperimentConfig(
                main=main, stress=ActivitySpec("w", "hbm", G1),
                iters=iters, scenarios=8)
            res = coord.run(cfg)
            reply, text = "OK complete", format_results(res)
        sync()
        after, _ = counts.snapshot()
        m = res.scenarios[0].main
        want_bytes, want_tx = expected_accounting(
            m.strategy, m.buffer_bytes, iters)
        rungs = [[s.n_stressors, s.modeled_bw_gbps, s.modeled_lat_ns,
                  s.stress_bw_gbps] for s in res.scenarios]
        rec = {
            "experiment": label, "reply": reply, "iters": iters,
            "bytes_moved": m.bytes_moved, "transactions": m.transactions,
            "accounting_ok": (m.bytes_moved == want_bytes
                              and m.transactions == want_tx),
            "elapsed_ns": m.elapsed_ns, "launch_bound": m.launch_bound,
            "gbps": m.bandwidth_gbps if m.strategy not in _CHASES else None,
            "ns_per_hop": m.latency_ns if m.strategy in _CHASES else None,
            "launches": {k: after[k] - before[k] for k in after
                         if after[k] != before[k]},
            "rungs": rungs, "seconds": round(time.perf_counter() - t0, 2),
        }
        records[label] = rec
        if reply != "OK complete":
            fail(f"{label}: {reply}")
        if not rec["accounting_ok"]:
            fail(f"{label}: bytes_moved/transactions {m.bytes_moved}/"
                 f"{m.transactions}, want {want_bytes}/{want_tx}")
        for k in expect:
            if rec["launches"].get(k, 0) < 1:
                fail(f"{label}: kernel {k} was not launched")
        if not m.elapsed_ns > 0 or not math.isfinite(m.elapsed_ns):
            fail(f"{label}: elapsed_ns {m.elapsed_ns}")
        # the on-chip kernels' results are marked: their time is the launch's
        if m.launch_bound != label.endswith("128K"):
            fail(f"{label}: launch_bound is {m.launch_bound}")
        n_lines = 10 + m.launch_bound
        if len(rungs) != 8 or len(text.splitlines()) != n_lines or not all(
                math.isfinite(v) and v >= 0 for r in rungs for v in r):
            fail(f"{label}: modeled rungs malformed")
        if coord.pools.pool("hbm").allocated or \
                coord.pools.pool("host").allocated:
            fail(f"{label}: pool not released")
    emit({"phase": "main_path", "platform": H100_SXM.name, "backend": "cuda",
          "experiments": list(records.values())})
    return records


def phase_small_reference() -> None:
    """The card against the plain versions on a small input: the same
    experiment through the interface on the card and on the CPU gives the
    same accounting and the same modeled text."""
    out = {}
    for dev in (DEV, torch.device("cpu")):
        iface = MemscopeInterface(CoreCoordinator(
            PoolManager(H100_SXM, dev), H100_SXM, backend="cuda",
            device=dev))
        iface.write_experiment("c,hbm,64K l,hbm,64K iters=2 scenarios=4")
        reply = iface.write_cmd("start")
        m = iface.results.scenarios[0].main
        out[dev.type] = (reply, m.bytes_moved, m.transactions,
                         iface.read_results())
    same = len(set(out.values())) == 1
    emit({"phase": "small_reference", "devices": sorted(out), "same": same})
    if not same:
        fail("card and CPU disagree on a small experiment")


# ---------------------------------------------------------------------------
# phase 5: checks on what the main path measured
# ---------------------------------------------------------------------------


def phase_checks(records: dict, launched: dict, plain: dict) -> None:
    checks = {}
    for label, rec in records.items():
        if rec["gbps"] is None:
            continue
        cap = PCIE_GBPS if ",host," in label else 1.05 * HBM_BYTES_PER_S / 1e9
        # the shared-memory kernels re-walk their tile on chip and are not
        # bounded by the device memory's rate
        if label.endswith("128K"):
            continue
        checks[f"rate_le_cap:{label}"] = rec["gbps"] <= cap

    # The on-chip pair must take longer for more walks of the tile, or the
    # compiler hoisted the re-reads / deleted the re-writes.  Through the
    # wrappers a call costs the host more than 1 or 64 walks cost the card,
    # so the C entry points are launched directly here, back to back.
    x = uniform(rows_of(K128), 5)
    dst = torch.empty_like(x)
    part = torch.empty(1, dtype=torch.float32, device=DEV)
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    c_read = _build.bind("stream", "repro_read_vmem",
                         (vp, vp, ll, i32, i32, vp))
    c_write = _build.bind("stream", "repro_write_vmem",
                          (vp, ll, i32, i32, vp))
    st, n_vec = _build.current_stream(DEV), x.numel() // 4

    def walk_r(r): return lambda: c_read(
        x.data_ptr(), part.data_ptr(), n_vec, n_vec, r, st)

    def walk_w(r): return lambda: c_write(
        dst.data_ptr(), n_vec, n_vec, r, st)
    t_r = {r: time_ms(walk_r(r), 200) for r in (1, 64, 1024)}
    t_w = {r: time_ms(walk_w(r), 200) for r in (1, 64, 1024)}
    checks["read_vmem_grows_1_to_64"] = t_r[64] > 2.0 * t_r[1]
    checks["write_vmem_grows_1_to_64"] = t_w[64] > 2.0 * t_w[1]

    # One hop in shared memory: the slope between a short and a long chase
    # of the same staged chain.  The main path's `l,hbm,128K` makes 256
    # hops a launch, which the launch itself outweighs.
    chain = torch.from_numpy(chase.chain_buffer(rows_of(K128), 0)).to(DEV)
    short, long_ = chain.shape[0], 256 * chain.shape[0]
    t_short = time_ms(lambda: chase.chase_vmem(chain, n_steps=short), 20)
    t_long = time_ms(lambda: chase.chase_vmem(chain, n_steps=long_), 20)
    shared_hop_ns = (t_long - t_short) * 1e6 / (long_ - short)

    hop = {k: records[k]["ns_per_hop"] for k in
           ("m,hbm,256M", "m,hbm,16M", "l,hbm,128K", "m,host,64M",
            "t,hbm,256M", "l,hbm,256M")}
    hop["shared_memory_slope"] = shared_hop_ns
    checks["hop_device_memory_gt_l2"] = hop["m,hbm,256M"] > hop["m,hbm,16M"]
    checks["hop_l2_gt_shared"] = hop["m,hbm,16M"] > shared_hop_ns > 0
    checks["hop_host_gt_device_memory"] = (hop["m,host,64M"]
                                           > hop["m,hbm,256M"])
    checks["every_kernel_launched"] = all(v > 0 for v in launched.values())
    checks["no_plain_version_on_main_path"] = not any(plain.values())
    emit({"phase": "checks", "checks": checks,
          "read_vmem_ms_by_repeats": t_r, "write_vmem_ms_by_repeats": t_w,
          "shared_walk_us_per_repeat": {
              "read": (t_r[1024] - t_r[64]) / 960 * 1e3,
              "write": (t_w[1024] - t_w[64]) / 960 * 1e3},
          "ns_per_hop": hop, "launches": launched, "plain_calls": plain})
    for k, ok in checks.items():
        if not ok:
            fail(f"check {k}")


# ---------------------------------------------------------------------------
# phase 6: each kernel's time at the main path's shape, beside its bound
# ---------------------------------------------------------------------------


def bound(bytes_: float, ops_: float):
    by_bytes, by_ops = bytes_ / HBM_BYTES_PER_S, ops_ / FP32_OPS_PER_S
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def phase_perf(at_main: dict, launched: dict, records: dict) -> list:
    rows = rows_of(G1)
    nbytes = rows * 512
    x = workloads.bw_buffer_init((rows, 128), torch.float32).to(DEV)
    dst = torch.empty_like(x)
    seed = torch.zeros((1, 1), dtype=torch.float32, device=DEV)
    blk, n_r, n_w = ref.mixed_split(rows, 2 / 3, 512)
    small = uniform(rows_of(K128), 6)
    small_dst = torch.empty_like(small)
    chain_small = torch.from_numpy(
        chase.chain_buffer(rows_of(K128), 0)).to(DEV)
    n_big = rows_of(M256)
    chain_host = chase.chain_buffer(n_big, 0)
    chain_big = torch.from_numpy(chain_host).to(DEV)

    def host_ms(fn) -> float:
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    n = 20
    # name -> (source, replaces, kernel, plain, library, bytes, ops, calls)
    table = [
        ("read_hbm", "stream.cu", "src/repro/kernels/stream.py:100",
         lambda: stream.read_hbm(x), lambda: ref.read_ref(x),
         lambda: x.sum(), nbytes, rows * 128, n),
        ("write_hbm", "stream.cu", "src/repro/kernels/stream.py:116",
         lambda: stream.write_hbm(rows, out=dst),
         lambda: ref.write_ref(rows, 1.0, DEV),
         lambda: torch.full((rows, 128), 1.0, device=DEV), nbytes, 0, n),
        ("write_hbm_seeded", "stream.cu", "src/repro/kernels/stream.py:137",
         lambda: stream.write_hbm_seeded(seed, n_w * blk, block_rows=blk,
                                         out=dst[:n_w * blk]),
         lambda: ref.write_ref(n_w * blk, 1.0, DEV) + seed,
         lambda: torch.full((n_w * blk, 128), 1.0, device=DEV),
         n_w * blk * 512 + 4, n_w * blk * 128, n),
        ("rmw_hbm", "stream.cu", "src/repro/kernels/stream.py:151",
         lambda: stream.rmw_hbm(x), lambda: ref.rmw_ref(x),
         lambda: x + 1, 2 * nbytes, rows * 128, n),
        ("copy_hbm", "stream.cu", "src/repro/kernels/stream.py:164",
         lambda: stream.copy_hbm(x), lambda: ref.copy_ref(x),
         lambda: x.clone(), 2 * nbytes, 0, n),
        ("mixed_hbm", "stream.cu", "src/repro/kernels/stream.py:189",
         lambda: stream.mixed_hbm(x, read_fraction=2 / 3, seed=seed),
         lambda: ref.mixed_ref(x, 2 / 3), None, nbytes + 4,
         n_r * blk * 128, n),
        ("read_vmem", "stream.cu", "src/repro/kernels/stream.py:248",
         lambda: stream.read_vmem(small, repeats=8),
         lambda: ref.read_vmem_ref(small, 8), lambda: small.sum() * 8,
         small.numel() * 4, 8 * small.numel(), 10 * n),
        ("write_vmem", "stream.cu", "src/repro/kernels/stream.py:260",
         lambda: stream.write_vmem(small.shape[0], repeats=8,
                                   out=small_dst),
         lambda: ref.write_vmem_ref(small.shape[0], 8, DEV),
         lambda: torch.full(tuple(small.shape), 7.0, device=DEV),
         small.numel() * 4, 0, 10 * n),
        ("chase_vmem", "chase.cu", "src/repro/kernels/chase.py:101",
         lambda: chase.chase_vmem(chain_small,
                                  n_steps=chain_small.shape[0]),
         None, None, chain_small.numel() * 4, chain_small.shape[0], 10 * n),
        # a hop loads 4 bytes, which the memory serves as one 32-byte sector;
        # the byte bound says little here: a chase is bound by the latency
        # of one load, reported as ns_per_hop
        ("chase_hbm", "chase.cu", "src/repro/kernels/chase.py:130",
         lambda: chase.chase_hbm(chain_big, n_steps=n_big),
         None, None, n_big * SECTOR_BYTES, n_big, 2),
    ]
    kernels = []
    for name, src, replaces, kern, plain, lib, bytes_, ops_, calls in table:
        ms = time_ms(kern, calls)
        if plain is not None:
            plain_ms = time_ms(plain, calls)
        else:       # the chases' plain version is a host loop over numpy
            buf = chain_small if name == "chase_vmem" else chain_big
            plain_ms = host_ms(lambda: ref.chase_ref(buf, buf.shape[0]))
        b_ms, b_by = bound(bytes_, ops_)
        rec = {"name": name, "route": "cuda", "source": CSRC + src,
               "replaces": replaces,
               "launches": (launched[name] if name in launched else
                            sum(records["b,hbm,1G,rf=2/3"]["launches"]
                                .values())),
               **at_main[name], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None if lib is None else time_ms(lib, calls)}
        if name.startswith("chase"):
            rec["ns_per_hop"] = ms * 1e6 / ops_
        else:
            rec["gbps"] = bytes_ / ms / 1e6
        kernels.append(rec)
    fn = _build.bind("stream", "repro_empty_launch", (ctypes.c_void_p,))
    stream_ = _build.current_stream(DEV)
    empty_ms = time_ms(lambda: fn(stream_), 1000)
    emit({"phase": "perf", "empty_launch_ms": empty_ms,
          "note": "ms per call over back-to-back calls, device events; "
                  "bound_ms from the published 3.35 TB/s and 67 TFLOP/s "
                  "fp32"})
    return kernels


def main() -> int:
    smi = phase_device()
    phase_build()
    at_main = phase_kernels(rows_of(G1))
    phase_pinned()
    phase_small_reference()

    counts.reset()
    records = phase_main_path()
    launched, plain = counts.snapshot()

    phase_checks(records, launched, plain)
    kernels = phase_perf(at_main, launched, records)
    sync()
    if FAILURES:
        sys.stderr.write("chip_smoke: %d failure(s):\n  %s\n"
                         % (len(FAILURES), "\n  ".join(FAILURES)))
        return 1
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

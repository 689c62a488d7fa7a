#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on an NVIDIA H100.

Run from the root of a checkout, with one card and no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc``, holds every kernel against its plain PyTorch version on the
card, drives the port's four paths at the sizes a user of the toolkit
would call real on this card — one experiment at a time (config string ->
MemscopeInterface -> CoreCoordinator -> workload -> kernel -> modeled
rungs), the characterization loop (characterize / characterize_matrix
/ characterize_surface -> run_matrix -> one member-axis launch per
signature group -> CurveDB -> PlacementAdvisor), the executed
contention ladder (run_matrix on the ``spmd`` backend -> plan -> one
persistent ladder launch per signature group, observer and stressor
engines between barriers -> fence check -> CurveDB), and the kernels
package's attention and triad entry points (``ops.flash_attention`` at the
widths of qwen2-1.5b and gemma3-1b from ``repro_torch.configs``, 32k
tokens, and ``ops.stream_triad`` on 1 GiB) — checks the results, and
times every kernel beside its bound.  One JSON object per phase goes to
standard output; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failing phase makes the exit code non-zero and withholds that line.
Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device available\n")
    sys.exit(1)

from repro_torch import compat  # noqa: E402
from repro_torch.configs import SHAPES as MODEL_SHAPES  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import coordinator as coordinator_mod  # noqa: E402
from repro_torch.core import workloads  # noqa: E402
from repro_torch.core.characterize import (CurveDB,  # noqa: E402
                                           characterize, characterize_matrix,
                                           characterize_surface,
                                           curvedb_from_result)
from repro_torch.core.coordinator import (ActivitySpec,  # noqa: E402
                                          CoreCoordinator, ExperimentConfig)
from repro_torch.core.devicetree import H100_SXM  # noqa: E402
from repro_torch.core.exec import fence as exec_fence  # noqa: E402
from repro_torch.core.exec import plan as exec_plan  # noqa: E402
from repro_torch.core.exec import program as exec_program  # noqa: E402
from repro_torch.core.exec.dispatch import DispatchStats  # noqa: E402
from repro_torch.core.interface import (MemscopeInterface,  # noqa: E402
                                        format_results)
from repro_torch.core.placement import (ContentionSpec,  # noqa: E402
                                        MemObject, PlacementAdvisor,
                                        kv_cache_object, params_object)
from repro_torch.core.pools import PoolManager  # noqa: E402
from repro_torch.core.scenarios import (ObserverSpec,  # noqa: E402
                                        ScenarioSpec, StressorSpec,
                                        TrafficShape)
from repro_torch.kernels import (_build, chase, compute_probe,  # noqa: E402
                                 contention, counts, flash_attention, ops,
                                 ref, stream)

DEV = torch.device("cuda")
# published peaks of the H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12     # dense bf16 on the tensor cores
TF32_TC_OPS_PER_S = 495e12     # dense TF32 on the tensor cores
SMS = 132                      # streaming multiprocessors
# shared memory: 128 bytes a clock on each SM at the 1.98 GHz boost clock,
# over every SM of the card
SMEM_BYTES_PER_S = SMS * 128 * 1.98e9
PCIE_GBPS = 64.0               # PCIe Gen5 x16, one direction
SECTOR_BYTES = 32              # the least the device memory moves for a load
# main-path sizes
G1, M256, M64, M16, K128 = 1 << 30, 256 << 20, 64 << 20, 16 << 20, 128 << 10
PROBE_ITERS = 64               # the probe's chain, as letter `i` runs it
CSRC = "src/repro_torch/kernels/csrc/"
FAILURES: list = []
# the kernels of the executed contention ladder; every other kernel is the
# single-observer paths'
SPMD_KERNELS = ("contention_ladder", "probe_add_one")
# the kernels of the attention and triad entry points
ATTENTION_KERNELS = ("triad_hbm", "flash_attention")
OBSERVER_KERNELS = tuple(k for k in counts.KERNELS
                         if k not in SPMD_KERNELS + ATTENTION_KERNELS)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    FAILURES.append(msg)
    sys.stderr.write(f"chip_smoke: FAIL {msg}\n")


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, n: int) -> float:
    """Milliseconds per call over ``n`` back-to-back calls after one warm
    call, between two device events.  The first event waits behind a hold
    of the stream for twice the host's cost of the ``n`` calls (at most
    50 ms, as ``workloads._timed`` does), so a short kernel is timed on
    the card and not at the rate the host enqueues it."""
    fn()
    sync()
    t0 = time.perf_counter_ns()
    fn()
    hold_ns = min(workloads.HOLD_CAP_NS, workloads.HOLD_PER_CALL
                  * (time.perf_counter_ns() - t0) * n)
    sync()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    stream.hold(hold_ns, DEV)
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

        # the product and the sum rounded apart on both sides: exact
        c = uniform(rows, 7)
        out = stream.triad_hbm(x, c, scalar=3.0)
        err = float((out - ref.triad_ref(x, c, 3.0)).abs().max())
        case(cases, "triad_hbm", x.shape, err, 0.0, keep=keep)
        del out, x, c

    xb = uniform(512, 2).to(torch.bfloat16)
    got, want = stream.rmw_hbm(xb).float(), ref.rmw_ref(xb).float()
    # bf16 keeps 8 bits of mantissa: one rounding of x + 1 is within 2^-8
    case(cases, "rmw_hbm", xb.shape, float((got - want).abs().max()),
         1e-2 * float(want.abs().max()), {"dtype": "bfloat16", "rtol": 1e-2})

    write_cases(cases)
    rmw_cases(cases)
    copy_cases(cases)
    triad_cases(cases)

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

    probe_cases(cases, at_main)
    member_cases(cases, at_main, main_rows)

    launched, _ = counts.snapshot()
    emit({"phase": "kernel_checks", "n_cases": len(cases),
          "n_ok": sum(c["ok"] for c in cases),
          "launches": {k: launched[k] - before[k] for k in launched},
          "cases": cases})
    return at_main


def one_launch(name: str, x: torch.Tensor, call):
    """``call()``'s result, and whether it was one launch of ``name``'s
    kernel with nothing plain, into a new buffer in ``x``'s memory."""
    launches, plain = counts.LAUNCHES[name], counts.PLAIN[name]
    out = call()
    sync()
    launched = (counts.LAUNCHES[name] == launches + 1
                and counts.PLAIN[name] == plain)
    fresh = (out.data_ptr() != x.data_ptr() and out.is_cuda == x.is_cuda
             and out.is_pinned() == x.is_pinned())
    return out, launched, fresh


def pinned(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def write_cases(cases: list) -> None:
    """``write_hbm`` and ``write_hbm_seeded`` exactly their plain versions
    at a value float32 does not hold (1/3; seeded + 0.25, rounded as the
    reference rounds it) at 1, 3 and 513 rows (a short last chunk), into a
    new tensor and into the caller's pinned host buffer; into a row-slice
    of a larger buffer whose guard rows stay untouched; and a seed changed
    on the stream between two calls, which the stored value follows.  Each
    call one launch of the kernel, and nothing plain."""
    def call(seed, rows, out=None):
        name = "write_hbm" if seed is None else "write_hbm_seeded"
        launches, plain = counts.LAUNCHES[name], counts.PLAIN[name]
        got = (stream.write_hbm(rows, value=1 / 3, block_rows=1, device=DEV,
                                out=out) if seed is None else
               stream.write_hbm_seeded(seed, rows, value=1 / 3, block_rows=1,
                                       out=out))
        return got, (counts.LAUNCHES[name] == launches + 1
                     and counts.PLAIN[name] == plain)

    def want(seed, rows):
        return (ref.write_ref(rows, 1 / 3, DEV) if seed is None else
                ref.write_seeded_ref(rows, 1 / 3, seed.to(DEV)))

    def record(seed, shape, err, memory, launched, extra=None):
        name = "write_hbm" if seed is None else "write_hbm_seeded"
        case(cases, name, shape, err, 0.0,
             {"value": "1/3" if seed is None else "1/3 + seed",
              "memory": memory, "launched": launched, **(extra or {})})
        if not launched:
            fail(f"{name} {list(shape)} in {memory} memory: not one launch")

    for seeded in (False, True):
        for rows in (1, 3, 513):
            for memory in ("device", "pinned host"):
                on_host = memory == "pinned host"
                seed = None
                if seeded:
                    seed = torch.full((1, 1), 0.25)
                    seed = pinned(seed) if on_host else seed.to(DEV)
                out = (pinned(torch.full((rows, 128), -1.0)) if on_host
                       else None)
                got, launched = call(seed, rows, out)
                sync()
                if on_host and not (got is out and got.is_pinned()):
                    fail("write into pinned host memory returned another "
                         "tensor")
                err = float((got.to(DEV) - want(seed, rows)).abs().max())
                record(seed, got.shape, err, memory, launched)
        seed = torch.full((1, 1), 0.25, device=DEV) if seeded else None
        big = torch.full((2 + 513 + 7, 128), -1.0, device=DEV)
        got, launched = call(seed, 513, big[2:515])
        sync()
        err = float((big[2:515] - want(seed, 513)).abs().max())
        guard = float((big[:2] != -1.0).sum() + (big[515:] != -1.0).sum())
        record(seed, got.shape, max(err, guard), "device", launched,
               {"out": "row-slice [2:515] of 522 rows",
                "guard_rows_changed": guard})
    # the seed changed on the stream between two calls, no host sync
    seed = torch.zeros((1, 1), device=DEV)
    outs = []
    for s in (0.25, -3.0):
        seed.fill_(s)
        outs.append(call(seed, 513))
    sync()
    for s, (got, launched) in zip((0.25, -3.0), outs):
        err = float((got - want(torch.full((1, 1), s), 513)).abs().max())
        record(seed, got.shape, err, "device", launched,
               {"seed": s, "seed_changed_between_calls": True})


def rmw_cases(cases: list) -> None:
    """``rmw_hbm`` exactly ``x + 1`` (bf16: one rounding of the float32
    sum, as the plain version rounds it) at 1, 3 and 513 rows (a short
    last chunk), on a 3-member stack and on pinned host buffers, f32 and
    bf16; each call one launch of the kernel, and nothing plain, into a
    new buffer in the memory of its input."""
    inputs = []
    for dt in (torch.float32, torch.bfloat16):
        for rows in (1, 3, 513):
            inputs.append(uniform(rows, rows).to(dt))
        inputs.append(uniform(3 * 513, 9).to(dt).reshape(3, 513, 128))
        for rows in (1, 513):
            inputs.append(pinned(uniform(rows, 10 + rows).to(dt).cpu()))
    for x in inputs:
        out, launched, fresh = one_launch(
            "rmw_hbm", x, lambda: stream.rmw_hbm(x, block_rows=1))
        want = x.to(DEV) + 1
        err = float((out.to(DEV).float() - want.float()).abs().max())
        memory = "pinned host" if x.is_pinned() else "device"
        case(cases, "rmw_hbm", x.shape, err, 0.0,
             {"dtype": str(x.dtype).split(".")[1], "memory": memory,
              "launched": launched, "new_buffer": fresh})
        if not (launched and fresh):
            fail(f"rmw_hbm {list(x.shape)} {x.dtype} in {memory} memory: "
                 f"launched {launched}, new buffer in its memory {fresh}")


def copy_cases(cases: list) -> None:
    """``copy_hbm`` bit for bit (the 32-bit words of input and output
    compared, whatever the element type) at 1, 3 and 513 rows (a short
    last chunk), on a 3-member stack and on pinned host buffers at 1 and
    513 rows, in float32, bf16 and int32; each call one launch of the
    kernel, and nothing plain, into a new buffer in the memory of its
    input."""
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        def values(rows: int, seed: int) -> torch.Tensor:
            # int32: values over the whole 2^24 range, not 0 and 1
            x = uniform(rows, seed)
            return (x * (1 << 24)).to(dt) if dt == torch.int32 else x.to(dt)
        inputs = [values(rows, 20 + rows) for rows in (1, 3, 513)]
        inputs.append(values(3 * 513, 21).reshape(3, 513, 128))
        inputs += [pinned(values(rows, 22 + rows).cpu())
                   for rows in (1, 513)]
        for x in inputs:
            out, launched, fresh = one_launch(
                "copy_hbm", x, lambda: stream.copy_hbm(x, block_rows=1))
            got, want = (t.to(DEV).view(torch.int32) for t in (out, x))
            err = float((got != want).sum())
            memory = "pinned host" if x.is_pinned() else "device"
            case(cases, "copy_hbm", x.shape, err, 0.0,
                 {"dtype": str(dt).split(".")[1], "memory": memory,
                  "compared": "32-bit words", "launched": launched,
                  "new_buffer": fresh})
            if not (launched and fresh):
                fail(f"copy_hbm {list(x.shape)} {dt} in {memory} memory: "
                     f"launched {launched}, new buffer in its memory {fresh}")


def triad_cases(cases: list) -> None:
    """``triad_hbm`` exactly ``ref.triad_ref`` at 1, 3 and 513 rows and
    on pinned host b and c at 1 and 513 rows; each call one launch of the
    kernel, and nothing plain, into a new buffer in the memory of its
    inputs."""
    pairs = [(uniform(rows, 30 + rows), uniform(rows, 31 + rows))
             for rows in (1, 3, 513)]
    pairs += [(pinned(uniform(rows, 32 + rows).cpu()),
               pinned(uniform(rows, 33 + rows).cpu())) for rows in (1, 513)]
    for b, c in pairs:
        out, launched, fresh = one_launch(
            "triad_hbm", b,
            lambda: stream.triad_hbm(b, c, scalar=3.0, block_rows=1))
        want = ref.triad_ref(b.to(DEV), c.to(DEV), 3.0)
        err = float((out.to(DEV) - want).abs().max())
        memory = "pinned host" if b.is_pinned() else "device"
        case(cases, "triad_hbm", b.shape, err, 0.0,
             {"memory": memory, "launched": launched, "new_buffer": fresh})
        if not (launched and fresh):
            fail(f"triad_hbm {list(b.shape)} in {memory} memory: launched "
                 f"{launched}, new buffer in its memory {fresh}")


# The probe against its plain version: the kernel's products in 3xTF32
# (22 of float32's 24 bits a term), the plain version's in full float32
# (main() sets torch.backends.cuda.matmul.allow_tf32 False).  Powers of
# 0.5 * I are exact (0.5 splits with lo = 0); on a random operand of
# spectral radius 0.9 each side sums every entry's 128 products in its own
# order and precision, through 64 dependent products: each entry within
# 1e-5 of the largest.
PROBE_RTOL_EXACT = 1e-6
PROBE_TOL_RANDOM = 1e-5


def radius_09(seed: int) -> torch.Tensor:
    """A seeded (128, 128) operand scaled to spectral radius 0.9."""
    a = np.random.default_rng(seed).standard_normal((128, 128))
    a = a / np.abs(np.linalg.eigvals(a)).max() * 0.9
    return torch.from_numpy(a.astype(np.float32)).to(DEV)


def probe_cases(cases: list, at_main: dict) -> None:
    a = torch.eye(128, dtype=torch.float32, device=DEV) * 0.5
    want = ref.mxu_probe_ref(a, 3)
    err = float((compute_probe.mxu_probe(a, iters=3) - want).abs().max())
    case(cases, "mxu_probe", a.shape, err,
         PROBE_RTOL_EXACT * float(want.abs().max()),
         {"iters": 3, "operand": "0.5*I", "rtol": PROBE_RTOL_EXACT})
    for seed_, iters in ((0, 1), (0, PROBE_ITERS), (1, PROBE_ITERS)):
        a = radius_09(seed_)
        want = ref.mxu_probe_ref(a, iters)
        err = float((compute_probe.mxu_probe(a, iters=iters) - want)
                    .abs().max())
        case(cases, "mxu_probe", a.shape, err,
             PROBE_TOL_RANDOM * float(want.abs().max()),
             {"iters": iters, "operand": f"radius 0.9, seed {seed_}",
              "tol_of_max": PROBE_TOL_RANDOM},
             at_main if iters == PROBE_ITERS else None)


def chain_stack(n_lines: int, g: int) -> np.ndarray:
    return np.stack([chase.chain_buffer(n_lines, s) for s in range(g)])


def member_cases(cases: list, at_main: dict, main_rows: int) -> None:
    """The member axis (one launch over a (g, rows, 128) stack) against
    the plain versions, at small shapes for g in 1, 3, 4 and at the
    matrix phase's shapes: 256 MiB members, four to a 1 GiB chunk, and
    two 128 KiB or 256 MiB members for the two-member groups."""
    m256, k128 = rows_of(M256), rows_of(K128)
    shapes = [(g, rows) for g in (1, 3, 4) for rows in (256, 2048 + 8)]
    shapes += [(4, m256), (2, m256), (2, k128)]
    for g, rows in shapes:
        x = torch.rand((g, rows, 128), generator=torch.Generator()
                       .manual_seed(g * rows), dtype=torch.float32).to(DEV)
        want = x.double().sum(dim=(1, 2))
        tol = READ_RTOL_FULL if rows >= m256 else READ_RTOL_SMALL * 5
        extra = {"members": g, "rtol": tol}
        got = stream.read_hbm(x, block_rows=8)
        err = float(((got.double() - want) / want).abs().max())
        case(cases, "read_hbm", x.shape, err, tol, extra)
        if rows <= 2048 + 8:
            got = stream.read_vmem(x, repeats=3)
            err = float(((got.double() - 3 * want) / want / 3).abs().max())
            case(cases, "read_vmem", x.shape, err, tol * 5, extra)
        if g <= 2 or rows < m256:
            err = float((stream.copy_hbm(x, block_rows=8) - x).abs().max())
            case(cases, "copy_hbm", x.shape, err, 0.0, {"members": g})
            err = float((stream.rmw_hbm(x, block_rows=8) - ref.rmw_ref(x))
                        .abs().max())
            case(cases, "rmw_hbm", x.shape, err, 0.0, {"members": g})
            seed = torch.zeros((1, 1), dtype=torch.float32, device=DEV)
            s_, out = stream.mixed_hbm(x, read_fraction=2 / 3, block_rows=8,
                                       seed=seed)
            ws, wout = ref.mixed_ref(x, 2 / 3, block_rows=8)
            if tuple(out.shape) != tuple(wout.shape) or \
                    not bool((out == wout).all()):
                fail(f"mixed_hbm members {g}: written part wrong")
            err = float(((s_.double() - ws.double()) / ws.double())
                        .abs().max())
            case(cases, "mixed_hbm", x.shape, err, tol,
                 {"members": g, "read_fraction": 2 / 3})
        del x
    # chases: exact, every member
    for g, n_lines in [(g, n) for g in (1, 3, 4) for n in (16, 257)] + \
            [(2, k128)]:
        host = chain_stack(n_lines, g)
        buf = torch.from_numpy(host).to(DEV)
        for steps in (1, n_lines // 3, n_lines, 3 * n_lines):
            want = ref.chase_members_ref(host, steps)
            for name, fn in (("chase_vmem", chase.chase_vmem),
                             ("chase_hbm", chase.chase_hbm)):
                got = fn(buf, n_steps=steps).tolist()
                case(cases, name, buf.shape,
                     float(sum(a != b for a, b in zip(got, want))), 0.0,
                     {"members": g, "n_steps": steps})
    host = chain_stack(rows_of(M256), 4)
    buf = torch.from_numpy(host).to(DEV)
    for steps in (host.shape[1] // 3, host.shape[1]):
        got = chase.chase_hbm(buf, n_steps=steps).tolist()
        want = ref.chase_members_ref(host, steps)
        case(cases, "chase_hbm", buf.shape,
             float(sum(a != b for a, b in zip(got, want))), 0.0,
             {"members": 4, "n_steps": steps})


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
# phase 3b: the on-chip pair alone, before the main path
# ---------------------------------------------------------------------------

# walks of the hoisting guard: at the whole-card bound (3.9 ns a walk of
# 128 KiB) 4096 walks cost several empty launches, so a loop the compiler
# hoisted or deleted cannot pass "> 2x one walk"
WALK_GUARD = 4096
WALK_SLOPE_FROM = 64


def phase_on_chip() -> dict:
    """The on-chip pair at the main path's 128 KiB, each kernel launched
    through its C entry point back to back: the direct slope of one walk
    (us, returned by letter, for the main path to hold its own slope
    against), the hoisting guard, one CTA an SM; then through the wrapper:
    one kernel launch a read as the profiler sees the card, and the same
    bits over 10 reads."""
    checks = {}
    x = uniform(rows_of(K128), 5)
    dst = torch.empty_like(x)
    lay = stream.vmem_layout(x.shape[0], stream._sm_count(DEV))
    partials = torch.empty(lay.ctas, dtype=torch.float32, device=DEV)
    res = torch.empty(1, dtype=torch.float32, device=DEV)
    ticket = torch.zeros(1, dtype=torch.int32, device=DEV)
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    c_read = _build.bind("stream", "repro_read_vmem",
                         (vp,) * 4 + (ll, ll) + (i32,) * 3 + (vp,))
    c_write = _build.bind("stream", "repro_write_vmem",
                          (vp, ll, i32, i32, vp))
    st, n_vec = _build.current_stream(DEV), x.numel() // 4
    slice_vec = lay.slice_rows * 32

    def walk_r(r): return lambda: c_read(
        x.data_ptr(), partials.data_ptr(), res.data_ptr(), ticket.data_ptr(),
        n_vec, n_vec, 1, slice_vec, r, st)

    def walk_w(r): return lambda: c_write(
        dst.data_ptr(), n_vec, slice_vec, r, st)
    walks = (1, WALK_SLOPE_FROM, WALK_GUARD)
    t_r = {r: time_ms(walk_r(r), 200) for r in walks}
    t_w = {r: time_ms(walk_w(r), 200) for r in walks}
    checks[f"read_vmem_grows_1_to_{WALK_GUARD}"] = \
        t_r[WALK_GUARD] > 2.0 * t_r[1]
    checks[f"write_vmem_grows_1_to_{WALK_GUARD}"] = \
        t_w[WALK_GUARD] > 2.0 * t_w[1]
    span = WALK_GUARD - WALK_SLOPE_FROM
    walk_us = {"r": (t_r[WALK_GUARD] - t_r[WALK_SLOPE_FROM]) / span * 1e3,
               "w": (t_w[WALK_GUARD] - t_w[WALK_SLOPE_FROM]) / span * 1e3}
    checks["walk_slopes_positive"] = min(walk_us.values()) > 0
    smem = _build.bind("stream", "repro_vmem_smem_bytes", (i32,))(slice_vec)
    # the card's own count of the read's and the write's CTAs that fit on
    # an SM, at the slices of the four on-chip cases
    occ = _build.bind("stream", "repro_vmem_ctas_per_sm", (i32, i32))
    ctas_an_sm = {rows: [occ(w, stream.vmem_layout(
        rows, stream._sm_count(DEV)).slice_rows * 32) for w in (0, 1)]
        for rows in (8, 256, 453, 2048 + 8)}
    checks["one_cta_an_sm"] = all(v == [1, 1] for v in ctas_an_sm.values())

    # one launch a read, and the same bits every read: the 128 KiB buffer
    # and a stack of three 2056-row members
    stack = torch.rand((3, 2048 + 8, 128), generator=torch.Generator()
                       .manual_seed(11), dtype=torch.float32).to(DEV)
    calls = 5
    for buf in (x, stack):
        stream.read_vmem(buf, repeats=8)
    sync()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        for buf in (x, stack):
            for _ in range(calls):
                stream.read_vmem(buf, repeats=8)
        sync()
    on_card = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    checks["read_vmem_one_launch_a_call"] = (
        len(on_card) == 2 * calls
        and all("read_tile_kernel" in n for n in on_card))
    same = {}
    for name, buf in (("128K", x), ("3x2056", stack)):
        got = [stream.read_vmem(buf, repeats=8) for _ in range(10)]
        same[name] = all(torch.equal(got[0], g) for g in got[1:])
    checks["read_vmem_bit_identical_over_10"] = all(same.values())
    emit({"phase": "on_chip", "layout_128K": lay._asdict(),
          "smem_bytes_a_cta": smem, "ctas_an_sm_read_write": ctas_an_sm,
          "read_vmem_ms_by_walks": t_r, "write_vmem_ms_by_walks": t_w,
          "direct_us_per_walk": walk_us,
          "direct_gbps_per_walk": {k: x.numel() * 4 / v / 1e3
                                   for k, v in walk_us.items()},
          "device_events_in_profile": len(on_card),
          "device_event_names": sorted(set(on_card)),
          "bit_identical": same, "checks": checks})
    for k, ok in checks.items():
        if not ok:
            fail(f"on_chip: check {k}")
    return walk_us


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
    ("i,hbm,0", "i,hbm,0", 50, ("mxu_probe",)),
]
_TWICE = ("x", "c")
_CHASES = ("l", "m", "t")
# ns per hop of the staged chain in shared memory, as this script's direct
# slope check (phase_checks) measured it on an H100 80GB HBM3 at 700 W; the
# workload's own slope timing must land within 0.5-2x of it, and of this
# run's direct walk slopes (phase_on_chip) for the reads and writes.
SLOPE_HOP_NS = 14.0


def expected_accounting(strategy: str, buffer_bytes: int, iters: int):
    rows = rows_of(buffer_bytes)
    if strategy == "i":
        return 0, 0
    if strategy in _CHASES:
        return rows * 512, rows
    return (2 if strategy in _TWICE else 1) * rows * 512 * iters, 0


def on_chip_figure(m, walk_us: dict):
    """(what, value, key of the figure it is held to, that figure) of an
    on-chip row: us per walk for the reads and writes, held to
    ``walk_us`` (this run's direct slopes); ns per hop for the chase,
    held to the constant ``SLOPE_HOP_NS``."""
    if m.strategy in _CHASES:
        return ("ns_per_hop", m.latency_ns, "reference_ns_per_hop",
                SLOPE_HOP_NS)
    return ("us_per_walk", m.elapsed_ns / m.iters / 1e3,
            "direct_us_per_walk", walk_us[m.strategy])


def phase_main_path(walk_us: dict) -> dict:
    """Drives every experiment; returns label -> record.  ``walk_us``:
    the direct walk slopes of :func:`phase_on_chip`."""
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
        stream_ = m.strategy not in _CHASES + ("i",)
        rec = {
            "experiment": label, "reply": reply, "iters": iters,
            "bytes_moved": m.bytes_moved, "transactions": m.transactions,
            "accounting_ok": (m.bytes_moved == want_bytes
                              and m.transactions == want_tx),
            "elapsed_ns": m.elapsed_ns, "launch_bound": m.launch_bound,
            "gbps": m.bandwidth_gbps if stream_ else None,
            "ns_per_hop": m.latency_ns if m.strategy in _CHASES else None,
            "launches": {k: after[k] - before[k] for k in after
                         if after[k] != before[k]},
            "rungs": rungs, "seconds": round(time.perf_counter() - t0, 2),
        }
        if m.strategy == "i":
            rec["ms_per_probe"] = m.elapsed_ns / iters / 1e6
        if label.endswith("128K"):
            what, value, held, against = on_chip_figure(m, walk_us)
            rec[what] = value
            rec[held] = against
            if not 0.5 * against <= value <= 2.0 * against:
                fail(f"{label}: {what} {value}, want within 0.5-2x of "
                     f"{held} {against}")
        if label == "r,vmem,128K":
            # the device tree's model of the same read, beside the card's
            rec["modeled_rung0_gbps"] = rungs[0][1]
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
        # the on-chip rows are timed by their slope: none is marked
        if m.launch_bound:
            fail(f"{label}: launch_bound")
        if len(rungs) != 8 or len(text.splitlines()) != 10 or not all(
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
    # and a small matrix through characterize_matrix: the same keys,
    # dispatches, accounting and curves (modeled, so equal to the bit);
    # only the activity that ran differs ("cuda" and "plain")
    small = [ScenarioSpec(f"small.{o}.{st}",
                          ObserverSpec(o, "hbm", (64 << 10,)),
                          (StressorSpec(st, "hbm", 64 << 10),), iters=2,
                          max_stressors=3)
             for o in ("r", "c", "l", "i") for st in ("w", "y")]
    text = []
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for i, dev in enumerate((DEV, torch.device("cpu"))):
            db = characterize_matrix(CoreCoordinator(
                PoolManager(H100_SXM, dev), H100_SXM, backend="cuda",
                device=dev), small)
            path = os.path.join(tmp, f"{i}.json")
            db.save(path)
            with open(path) as f:
                text.append(f.read().replace('"activity": "plain"',
                                             '"activity": "cuda"'))
    same_db = text[0] == text[1]
    emit({"phase": "small_reference", "devices": sorted(out), "same": same,
          "same_curvedb": same_db})
    if not same:
        fail("card and CPU disagree on a small experiment")
    if not same_db:
        fail("card and CPU disagree on a small matrix")


# ---------------------------------------------------------------------------
# phase 5: checks on what the main path measured
# ---------------------------------------------------------------------------


def phase_checks(records: dict, launched: dict, plain: dict) -> None:
    checks = {}
    for label, rec in records.items():
        if rec["gbps"] is None:
            continue
        cap = PCIE_GBPS if ",host," in label else 1.05 * HBM_BYTES_PER_S / 1e9
        # the shared-memory kernels re-walk their slices on chip: bounded
        # by the shared memory of every SM, not by the device memory
        if label.endswith("128K"):
            cap = 1.05 * SMEM_BYTES_PER_S / 1e9
        checks[f"rate_le_cap:{label}"] = rec["gbps"] <= cap
    # the order of the memories: on chip faster than the device memory
    for fast, slow in (("r,hbm,128K", "r,hbm,1G"), ("r,vmem,128K", "r,hbm,1G"),
                       ("w,hbm,128K", "w,hbm,1G")):
        checks[f"faster:{fast}>{slow}"] = \
            records[fast]["gbps"] > records[slow]["gbps"]

    # One hop in shared memory: the slope between a short and a long chase
    # of the same staged chain, here apart from the workload's own slope.
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
    checks["every_kernel_launched"] = all(launched[k] > 0
                                          for k in OBSERVER_KERNELS)
    checks["no_plain_version_on_main_path"] = not any(plain.values())
    emit({"phase": "checks", "checks": checks,
          "ns_per_hop": hop, "launches": launched, "plain_calls": plain})
    for k, ok in checks.items():
        if not ok:
            fail(f"check {k}")


# ---------------------------------------------------------------------------
# phase 6: the characterize -> CurveDB -> placement loop (run_matrix)
# ---------------------------------------------------------------------------

MATRIX_ITERS = 50
# letters whose group is measured over a stacked member axis (streams and
# random chases); every other letter's group shares one measurement
STACKED = ("r", "s", "c", "x", "b", "l", "m")
# the batched per-member figure must be this close to the lone observer's
LONE_REL = 0.15
# turns each of the lone observer and the batched group, taken in
# alternation, for a stream group in pinned host memory: its PCIe rate
# moves between allocations and over time
LONE_TURNS = 3
BATCH_CAP = 1 << 30            # bytes of one stacked chunk, at most


def resolved(strategy: str, shape) -> str:
    kind = getattr(shape, "kind", "steady")
    return {"mixed": "b", "strided": "t"}.get(kind, strategy)


def expected_dispatches(triples, pools) -> int:
    """What observer_groups and the chunk rule imply, the rule restated:
    a stacked group of n members of B bytes each is measured in chunks of
    min(n, cap // B) members, cap = min(BATCH_CAP, the pool's free bytes);
    any other group in one measurement."""
    n = 0
    for (strategy, shape, buf, *_), idxs in \
            exec_plan.observer_groups(triples, pools).items():
        if resolved(strategy, shape) not in STACKED:
            n += 1
            continue
        member = rows_of(buf) * 512
        free = pools.pool(triples[idxs[0]][1].pool).available
        per_chunk = max(1, min(len(idxs), min(BATCH_CAP, max(free, member))
                               // member))
        n += -(-len(idxs) // per_chunk)
    return n


def figure(m):
    """The per-member figure a group reports: GB/s of a stream, ns per
    hop of a chase, ms per call of the compute probe."""
    if m.strategy in _CHASES:
        return "ns_per_hop", m.latency_ns
    if m.strategy == "i":
        return "ms_per_probe", m.elapsed_ns / m.iters / 1e6
    return "gbps", m.bandwidth_gbps


def matrix_specs():
    """Explicit specs on `hbm`, each observer under two stressors, so
    that every signature group has two members."""
    observers = [
        ObserverSpec("c", "hbm", (M256,)),
        ObserverSpec("x", "hbm", (M256,)),
        ObserverSpec("r", "hbm", (M256,), TrafficShape.mixed(2, 1)),
        ObserverSpec("m", "hbm", (M256,), TrafficShape.strided(8)),
        ObserverSpec("r", "hbm", (K128,)),
        ObserverSpec("w", "hbm", (K128,)),
        ObserverSpec("l", "hbm", (K128,)),
        ObserverSpec("i", "hbm", (0,)),
    ]
    stressors = [StressorSpec("w", "hbm", G1), StressorSpec("y", "hbm", G1)]
    return [ScenarioSpec(f"matrix.{i}.{s.strategy}", o, (s,),
                         iters=MATRIX_ITERS)
            for i, o in enumerate(observers) for s in stressors]


def executions(db: CurveDB) -> list:
    out = []
    for surf in db.surfaces.values():
        prov = surf.provenance
        cells = prov.get("cells")
        out += ([c["execution"] for c in cells.values()] if cells
                else [prov["execution"]])
    return out


def round_trips(db: CurveDB, tmp: str, name: str) -> bool:
    a, b = os.path.join(tmp, f"{name}.a.json"), os.path.join(tmp,
                                                              f"{name}.b.json")
    db.save(a)
    CurveDB.load(a).save(b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def placement_objects():
    return [params_object("params", 18 << 30),
            kv_cache_object("kv_cache", 20 << 30, 20 << 30),
            MemObject("activations", 8 << 30, 16 << 30)]


def check_plan(name: str, plan, caps: dict, objects) -> dict:
    used = {p: 0 for p in caps}
    for obj in objects:
        d = plan.decisions.get(obj.name)
        if d is None:
            fail(f"placement {name}: no decision for {obj.name}")
            continue
        used[d.pool] = used.get(d.pool, 0) + obj.size_bytes
    for p, n in used.items():
        if n > caps.get(p, 0):
            fail(f"placement {name}: pool {p} holds {n} B of {caps.get(p)}")
    return {"name": name, "report": plan.report(),
            "pools": {o: d.pool for o, d in plan.decisions.items()},
            "predicted_step_ns": plan.total_predicted_ns()}


def phase_matrix() -> dict:
    """Drives the loop through its entry points.  Returns what the lone
    re-measurement needs: every signature group measured."""
    coord = CoreCoordinator(PoolManager(H100_SXM, DEV), H100_SXM,
                            backend="cuda", device=DEV)
    runs = []            # (call, specs, MatrixResult) of each run_matrix
    groups = []          # one record per measured signature group
    run_matrix, measure_group = coord.run_matrix, coordinator_mod.measure_group

    def recorded_run_matrix(specs, **kw):
        res = run_matrix(specs, **kw)
        runs.append((call, specs, res))
        return res

    def timed_measure_group(strategy, pool, buf, n, iters, **kw):
        t0 = time.perf_counter()
        results, dispatches = measure_group(strategy, pool, buf, n, iters,
                                            **kw)
        sync()
        what, _ = figure(results[0])
        groups.append({
            "call": call, "strategy": strategy, "shape":
            kw.get("shape").tag() if kw.get("shape") is not None else "",
            "pool": pool.node.name, "buffer_bytes": buf, "iters": iters,
            "members": [r.pool for r in results], "dispatches": dispatches,
            what: [figure(r)[1] for r in results],
            "launch_bound": any(r.launch_bound for r in results),
            "seconds": round(time.perf_counter() - t0, 3),
            "_key": (pool.node.name, strategy, kw.get("shape"), buf, iters),
            "_call": (strategy, pool, buf, n, iters, kw)})
        return results, dispatches

    coord.run_matrix = recorded_run_matrix
    coordinator_mod.measure_group = timed_measure_group
    t_phase = time.perf_counter()
    try:
        call = "characterize"
        db = characterize(coord, pools=["hbm", "host"],
                          obs_strategies=("r", "w", "l"),
                          stress_strategies=("r", "w", "y"),
                          iters=MATRIX_ITERS)
        call = "characterize_matrix"
        db_matrix = characterize_matrix(coord, matrix_specs())
        call = "characterize_surface"
        db_surface = characterize_surface(coord, pools=["hbm"],
                                          stress_pools=["hbm"],
                                          iters=MATRIX_ITERS)
    finally:
        coordinator_mod.measure_group = measure_group
        coord.run_matrix = run_matrix
    sync()
    loop_seconds = time.perf_counter() - t_phase

    caps = {"hbm": 80 * 10**9, "host": 64 << 30}
    objects = placement_objects()
    adv = PlacementAdvisor(db, H100_SXM, pools=["hbm", "host"])
    plans = [check_plan("curves, 0 x w on hbm",
                        adv.advise(objects, ContentionSpec(0, "hbm", "w"),
                                   caps), caps, objects),
             check_plan("curves, 7 x y on hbm",
                        adv.advise(objects, ContentionSpec(7, "hbm", "y"),
                                   caps), caps, objects)]
    # the surface database characterizes the hbm observers only
    surf_caps = {"hbm": caps["hbm"]}
    plans.append(check_plan(
        "surface, 3 x b on hbm at rw 0.9",
        PlacementAdvisor(db_surface, H100_SXM, pools=["hbm"]).advise(
            objects, ContentionSpec(3, "hbm", "b", rw_ratio=0.9),
            surf_caps), surf_caps, objects))

    stats, checks = {}, {}
    for call, specs, res in runs:
        triples = [(sp, o, b) for sp in specs for o in sp.observers
                   for b in o.buffers]
        want = expected_dispatches(triples, coord.pools)
        stats[call] = dataclass_dict(res.stats)
        checks[f"dispatches_as_planned:{call}"] = \
            res.stats.measure_dispatches == want
        checks[f"fewer_dispatches_than_ladders:{call}"] = \
            res.stats.measure_dispatches < res.stats.n_ladders
        checks[f"no_group_mixes_hbm_and_host:{call}"] = all(
            len({triples[i][1].pool for i in idxs}) == 1 for idxs in
            exec_plan.observer_groups(triples, coord.pools).values())
        checks[f"accounting:{call}"] = all(
            (run.scenarios[0].main.bytes_moved,
             run.scenarios[0].main.transactions) ==
            expected_accounting(run.scenarios[0].main.strategy,
                                run.buffer_bytes, run.spec.iters)
            for run in res.runs)
        checks[f"no_launch_bound:{call}"] = not any(
            run.scenarios[0].main.launch_bound for run in res.runs)
    dbs = {"characterize": db, "characterize_matrix": db_matrix,
           "characterize_surface": db_surface}
    for name, d in dbs.items():
        checks[f"provenance:{name}"] = all(
            e["backend"] == "cuda" and e["activity"] == "cuda"
            and e["measured_uncontended"] for e in executions(d))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for name, d in dbs.items():
            checks[f"curvedb_round_trip:{name}"] = round_trips(d, tmp, name)
    checks["pools_released"] = not any(p.allocated
                                       for p in coord.pools.pools())
    emit({"phase": "matrix", "platform": H100_SXM.name, "backend": "cuda",
          "iters": MATRIX_ITERS, "seconds": round(loop_seconds, 2),
          "groups": [{k: v for k, v in g.items() if not k.startswith("_")}
                     for g in groups],
          "dispatch_stats": stats,
          "n_ladders": {c: r.stats.n_ladders for c, _, r in runs},
          "n_curves": len(db.surfaces) + len(db_matrix.surfaces),
          "n_surfaces": len(db_surface.surfaces),
          "mlp_hbm": db.mlp("hbm", H100_SXM.line_bytes),
          "placement": plans, "checks": checks})
    for k, ok in checks.items():
        if not ok:
            fail(f"matrix: check {k}")
    return {"coord": coord, "groups": groups}


def phase_lone(matrix: dict) -> None:
    """Each group's per-member figure against the same observer measured
    alone through make_shaped_workload(...).run: the card's counterpart of
    the reference's test_batched_chase_latency_matches_naive.  A stream
    group in pinned host memory is measured again here, in turns with its
    lone observer (``LONE_TURNS`` each, alternating, the lone observer on
    one allocation throughout), and their medians are compared; every
    other group's figure from the matrix phase against one lone run."""
    coord, lone, out, ok = matrix["coord"], {}, [], True
    for g in matrix["groups"]:
        pool, strategy, shape, buf, iters = g["_key"]
        in_turns = ("gbps" in g and coord.pools.pool(pool)
                    .effective_memory_kind() == "pinned_host")
        rec = {"call": g["call"], "pool": pool, "strategy": strategy,
               "shape": g["shape"], "buffer_bytes": buf,
               "members": len(g["members"])}
        if in_turns:
            turns = lone_turns(coord, g)
            what = "gbps"
            alone = statistics.median(turns["alone"])
            batched = [statistics.median(m) for m in
                       zip(*turns["batched"])]
            first = max(abs(v / turns["alone"][0] - 1.0)
                        for v in turns["batched"][0])
            rec.update({"turns": turns, "matrix_gbps": g[what],
                        "first_turn_worst_rel_diff": first})
        else:
            if g["_key"] not in lone:
                wl = workloads.make_shaped_workload(
                    strategy, coord.pools.pool(pool), buf, shape)
                try:
                    lone[g["_key"]] = figure(wl.run(iters))
                finally:
                    wl.release()
            what, alone = lone[g["_key"]]
            batched = g[what]
        worst = max(abs(v / alone - 1.0) for v in batched)
        within = worst <= LONE_REL and not g["launch_bound"]
        ok = ok and within
        rec.update({what: batched, "alone": alone, "worst_rel_diff": worst,
                    "within": within})
        out.append(rec)
    emit({"phase": "batched_vs_alone", "rel_limit": LONE_REL,
          "turns": LONE_TURNS, "groups": out})
    if not ok:
        fail("batched per-member figures differ from the lone observer's")
    if any(p.allocated for p in coord.pools.pools()):
        fail("batched_vs_alone: pool not released")


def lone_turns(coord, g: dict) -> dict:
    """The lone observer's GB/s and the batched group's per-member GB/s,
    ``LONE_TURNS`` each in alternating turns (lone first): the lone
    workload keeps its one allocation, the group is measured as the matrix
    phase measured it, by ``measure_group`` with the same arguments."""
    strategy, pool, buf, n, iters, kw = g["_call"]
    wl = workloads.make_shaped_workload(strategy, pool, buf, kw.get("shape"))
    turns = {"alone": [], "batched": []}
    try:
        for _ in range(LONE_TURNS):
            turns["alone"].append(figure(wl.run(iters))[1])
            results, _ = coordinator_mod.measure_group(strategy, pool, buf,
                                                       n, iters, **kw)
            sync()
            turns["batched"].append([figure(r)[1] for r in results])
    finally:
        wl.release()
    return turns


def dataclass_dict(obj) -> dict:
    return {k: getattr(obj, k) for k in obj.__dataclass_fields__}


# ---------------------------------------------------------------------------
# phase 7: each kernel's time at the main path's shape, beside its bound
# ---------------------------------------------------------------------------


def bound(bytes_: float, ops_: float, ops_per_s: float = FP32_OPS_PER_S):
    by_bytes, by_ops = bytes_ / HBM_BYTES_PER_S, ops_ / ops_per_s
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def phase_perf(at_main: dict, launched: dict, records: dict) -> tuple:
    """``launched``: each kernel's launches over the two paths' runs.
    Returns the kernels' rows and this run's empty launch in ms."""
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
    probe_a = radius_09(0)
    probe_ops = PROBE_ITERS * 2 * 128 ** 3
    # the probe's products as it runs them: three TF32 passes (3xTF32)
    probe_tc_ops = 3 * probe_ops

    def host_ms(fn) -> float:
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    def enqueue_ms(fn, calls: int) -> float:
        """The host's cost of one call: ``calls`` calls enqueued, then
        one synchronise outside the clock."""
        sync()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t = (time.perf_counter() - t0) * 1e3 / calls
        sync()
        return t

    n = 20
    # the kernels launched one CTA a chunk, and their chunk's name
    chunked = {"write_hbm": "write", "write_hbm_seeded": "write",
               "rmw_hbm": "rmw", "copy_hbm": "copy"}
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
         lambda: ref.write_seeded_ref(n_w * blk, 1.0, seed),
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
        # a^65 by 64 dependent products; the library call computes the
        # same power by repeated squaring (7 products), which the probe
        # must not: it is there to keep one SM busy for the whole chain
        ("mxu_probe", "compute_probe.cu",
         "src/repro/kernels/compute_probe.py:32",
         lambda: compute_probe.mxu_probe(probe_a, iters=PROBE_ITERS),
         lambda: ref.mxu_probe_ref(probe_a, PROBE_ITERS),
         lambda: torch.linalg.matrix_power(probe_a, PROBE_ITERS + 1),
         2 * probe_a.numel() * 4, probe_ops, n),
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
               "library_ms": None if lib is None else time_ms(lib, calls),
               "host_enqueue_ms": enqueue_ms(kern, calls)}
        if name.startswith("chase"):
            rec["ns_per_hop"] = ms * 1e6 / ops_
        elif name == "mxu_probe":
            rec["tflops"] = ops_ / ms / 1e9
            # the operations it does: 3 TF32 passes on the tensor cores;
            # the float32 bound and one SM's share beside it
            rec["bound_ms"], rec["bound_by"] = bound(
                bytes_, probe_tc_ops, TF32_TC_OPS_PER_S)
            rec["bound_ms_fp32"] = b_ms
            rec["bound_ms_one_sm"] = bound(
                bytes_, probe_tc_ops, TF32_TC_OPS_PER_S / SMS)[0]
            # per product: the chain's 64 against matrix_power's 7 by
            # repeated squaring (floor(log2 65) + popcount(65) - 1)
            rec["ms_per_product"] = ms / PROBE_ITERS
            rec["library_ms_per_product"] = rec["library_ms"] / 7
        else:
            rec["gbps"] = bytes_ / ms / 1e6
        if name in chunked:
            # one CTA a chunk of this many bytes
            rec["chunk_bytes"] = stream.kernel_chunk_vec(chunked[name]) * 16
        if name in ("read_vmem", "write_vmem"):
            # on chip: 8 walks of the buffer through the shared memory of
            # every SM (bound_ms) or of one SM (bound_ms_one_sm), plus the
            # buffer once in or out of the device memory
            walks = 8 * bytes_
            rec["bound_ms"] = (walks / SMEM_BYTES_PER_S
                               + bytes_ / HBM_BYTES_PER_S) * 1e3
            rec["bound_ms_one_sm"] = (walks / (SMEM_BYTES_PER_S / SMS)
                                      + bytes_ / HBM_BYTES_PER_S) * 1e3
            rec["bound_by"] = "bytes"
        kernels.append(rec)
    fn = _build.bind("stream", "repro_empty_launch", (ctypes.c_void_p,))
    stream_ = _build.current_stream(DEV)
    empty_ms = time_ms(lambda: fn(stream_), 1000)
    emit({"phase": "perf", "empty_launch_ms": empty_ms, "kernels": kernels,
          "note": "ms per call over back-to-back calls, device events, "
                  "behind a hold of the stream; host_enqueue_ms is the "
                  "host's cost of one call of the wrapper; "
                  "bound_ms from the published 3.35 TB/s and 67 TFLOP/s "
                  "fp32, the probe's from 495 TFLOP/s TF32 for its three "
                  "passes, the on-chip pair's from 132 SMs x 128 B a clock "
                  "x 1.98 GHz of shared memory; launches over the main "
                  "path and the matrix phase; float32 products without "
                  "TF32 in the plain versions"})
    return kernels, empty_ms


# ---------------------------------------------------------------------------
# phase 8: the kernel-support probe; phase 9: the ladder kernel against its
# plain version, the fence's negative case, the clock, the empty ladder
# ---------------------------------------------------------------------------

N_ENG = H100_SXM.n_engines
SHAPES = {"b": TrafficShape.mixed(2, 1), "t": TrafficShape.strided(8)}
# the ladder's engine values: float32 sums (r, s, b) within a relative
# tolerance of the plain version's sums, everything else exact
SUM_ROLES = (contention.READ, contention.MIXED)
SKEW_NS = 10_000               # the fence negative's skew between engines
EMPTY_STEPS = 200              # steps of the empty ladder
# the global timer's smallest step, as phase_spmd_kernel_checks saw it; a
# timed rung must last at least MIN_TICKS of them
TIMER = {"tick_ns": 1000}
MIN_TICKS = 100


def probe_sass() -> dict:
    """The global loads and stores of the probe's kernel in its SASS: the
    design is one 16-byte load and one 16-byte store a thread."""
    mem = [w for w in sass_words("contention", "add_one_kernel")
           if w.split(".")[0] in ("LDG", "STG")]
    return {"LDG": sum(w.startswith("LDG") for w in mem),
            "STG": sum(w.startswith("STG") for w in mem),
            "LDG.128": sum(w.startswith("LDG") and ".128" in w for w in mem),
            "STG.128": sum(w.startswith("STG") and ".128" in w for w in mem),
            "opcodes": mem}


def phase_probe() -> tuple:
    """The probe against its plain version, exact; returns its case and
    its SASS counts."""
    x = torch.arange(8 * 128, dtype=torch.float32, device=DEV).reshape(8, 128)
    err = float((contention.probe_add_one(x) - ref.probe_add_one_ref(x))
                .abs().max())
    supported = compat.kernels_supported(DEV)      # raises if it fails
    sass = probe_sass()
    one_each = (sass["LDG"] == sass["LDG.128"] == 1
                and sass["STG"] == sass["STG.128"] == 1)
    emit({"phase": "probe", "kernels_supported": supported,
          "max_abs_err": err, "sass": sass,
          "one_128_bit_load_and_store": one_each})
    if not supported or err != 0.0:
        fail(f"probe: x + 1 off by {err}")
    if not one_each:
        fail(f"probe: SASS has {sass['opcodes']}, want one LDG.E.128 and "
             "one STG.E.128")
    return {"max_abs_err": err, "tol": 0.0}, sass


def ladder_program(rows, roles, subsets=None, samples=1, kind=None):
    """A ladder program built as the dispatcher builds one, with the
    coordinator's geometry: one CTA an SM, sm_count // engines an
    engine."""
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    return exec_program.build_program(
        rows, len(rows[0]), kind=kind, samples=samples, subsets=subsets,
        op_roles=roles, rows_max=max(r[2] for r in roles), device=DEV,
        ctas_per_engine=sms // len(rows[0]), stats=DispatchStats())


def check_ladder(prog, rtol: float, what: str) -> dict:
    """The kernel's engine values against the plain version's on the
    same inputs (the plain version first: the kernel's copy role
    ping-pongs through its operand, with the same values)."""
    want = ref.contention_ladder_ref(
        prog.xf, prog.xi, prog.table, prog.roles, prog.layout.group_of,
        prog.layout.leaders).outs.double().cpu().numpy()
    out = prog.launch().to_cpu()
    got = out.outs.double().numpy()
    codes = prog.roles[prog.table.T, 0]            # (engines, steps)
    tol = np.where(np.isin(codes, SUM_ROLES), rtol * np.abs(want), 0.0)
    err = np.abs(got - want)
    worst = np.unravel_index(np.argmax(err), err.shape)
    fenced = prog.is_fenced(out)
    ok = bool((err <= tol).all()) and fenced
    if not ok:
        fail(f"contention_ladder {what}: err above tol or unfenced")
    # the largest error, and the tolerance of that same engine value
    return {"what": what, "max_abs_err": float(err[worst]),
            "tol": float(tol[worst]), "rtol_sums": rtol, "fenced": fenced,
            "ok": ok}


def ladder_bytes(prog, step: int = 0) -> int:
    """Bytes the roles of one step move: each pass of a stream its rows
    once (copy and rmw twice, the mixed stream its read and written
    rows), a chase one 32-byte sector a hop, the idle spin none."""
    total = 0
    for e in range(prog.table.shape[1]):
        code, rows, n, rd, wr = (int(v) for v in
                                 prog.roles[prog.table[step, e]][:5])
        line = rows * 512
        total += n * {contention.READ: line, contention.SEEDED_WRITE: line,
                      contention.RMW: 2 * line, contention.COPY: 2 * line,
                      contention.MIXED: (rd + wr) * 512,
                      contention.CHASE_GLOBAL: rows * SECTOR_BYTES,
                      contention.CHASE_SHARED: rows * SECTOR_BYTES
                      }.get(code, 0)
    return total


def rung_table(spec: ScenarioSpec, k: int):
    """The one-step table of rung k of ``spec``'s ladder, as the planner
    lays it out (observer on engine 0)."""
    roles, _pools = exec_plan.rung_roles(spec, spec.observers[0],
                                         spec.observers[0].buffers[0], k,
                                         N_ENG)
    return [tuple(roles)], roles


def phase_spmd_kernel_checks() -> dict:
    recs = []
    for letter in "rswyxcblmti":
        for rows in (16, 453, 4096 + 512):
            roles = [(letter, SHAPES.get(letter), rows, 3)] + \
                [("i", None, 1, 3)] * (N_ENG - 1)
            recs.append(check_ladder(ladder_program([tuple(roles)], roles),
                                     READ_RTOL_SMALL,
                                     f"{letter} alone, {rows} rows"))
    # the main path's rung 7 of (b) and of (a)'s chase observer, at full
    # size, and of (d) in pinned host memory
    at_main = []
    for what, spec, kind in (
            ("(b) rung 7", SPEC_B, None),
            ("(a) l under y, rung 7", spec_a("l", "y"), None),
            ("(d) rung 7, pinned host", SPEC_D, "pinned_host")):
        rows, roles = rung_table(spec, N_ENG - 1)
        prog = ladder_program(rows, roles, kind=kind)
        at_main.append(check_ladder(prog, READ_RTOL_FULL, what))
        del prog

    # the fence's negative case: the start wait skipped, engines skewed
    roles = [("r", None, 4096, 2)] * N_ENG
    prog = ladder_program([tuple(roles)], roles, samples=3)
    good = prog.launch().to_cpu()
    bad = prog.launch(skip_start_wait=True, skew_ns=SKEW_NS).to_cpu()
    lag = (bad.arrive.numpy().max(0) - bad.begin.numpy().min(0)).tolist()
    stamps = np.concatenate([good.arrive.numpy().ravel(),
                             good.begin.numpy().ravel(),
                             good.end.numpy().ravel()])
    steps = np.diff(np.unique(stamps))
    tick = int(steps[steps > 0].min())

    # the empty ladder (every role idle, one pass): the barriers' cost
    roles = [("i", None, 1, 1)] * N_ENG
    empty = ladder_program([tuple(roles)], roles, samples=EMPTY_STEPS)
    eo = empty.launch().to_cpu()
    per_step_ns = exec_fence._ns(eo.t1s[0]) - exec_fence._ns(eo.t0s[0])
    empty_ms = time_ms(empty.launch, 5)
    checks = {"every_role_alone": all(r["ok"] for r in recs),
              "main_tables": all(r["ok"] for r in at_main),
              "fenced_with_the_wait": prog.is_fenced(good),
              "refused_without_it": not prog.is_fenced(bad),
              "empty_ladder_fenced": empty.is_fenced(eo)}
    emit({"phase": "spmd_kernel_checks", "n_role_cases": len(recs),
          "n_ok": sum(r["ok"] for r in recs), "main_tables": at_main,
          "fence_negative": {"skew_ns_per_engine": SKEW_NS,
                             "last_arrival_minus_first_begin_ns": lag},
          "globaltimer_smallest_step_ns": tick,
          "empty_ladder": {"steps": EMPTY_STEPS, "launch_ms": empty_ms,
                           "ms_per_step": empty_ms / EMPTY_STEPS,
                           "stamped_step_ns_median":
                               float(np.median(per_step_ns)),
                           "stamped_step_ns_min": int(per_step_ns.min())},
          "checks": checks,
          "failed_cases": [r for r in recs if not r["ok"]]})
    for k, ok in checks.items():
        if not ok:
            fail(f"spmd_kernel_checks: {k}")
    worst = max(at_main, key=lambda r: r["max_abs_err"])
    TIMER["tick_ns"] = tick
    return {"max_abs_err": worst["max_abs_err"], "tol": worst["tol"]}


# ---------------------------------------------------------------------------
# phase 10: the executed contention ladder (backend "spmd")
# ---------------------------------------------------------------------------

SPMD_ITERS_A = 2               # (a): two traversals of a 256 MiB chase
SPMD_ITERS_B = 8               # (b): 8 passes over 256 MiB for the observer
PACK_REL = 0.15                # (c): packed within 15 % of unpacked
RUNG7_CAP = 1.05               # (b): rung 7 may not read above rung 0


def spec_a(obs: str, stress: str) -> ScenarioSpec:
    """One ladder of (a)'s characterize grid, as characterize names it."""
    return ScenarioSpec(f"hbm.{obs}|hbm.{stress}",
                        ObserverSpec(obs, "hbm", (M256,)),
                        (StressorSpec(stress, "hbm", M256),),
                        iters=SPMD_ITERS_A)


SPEC_B = ScenarioSpec("spmd.b", ObserverSpec("r", "hbm", (M256,)),
                      (StressorSpec("w", "hbm", G1),), iters=SPMD_ITERS_B)
SPECS_C = [ScenarioSpec(f"spmd.c.{n}", ObserverSpec("m", "hbm", (M256,)),
                        (StressorSpec("m", "hbm", M256),), iters=1,
                        max_stressors=1) for n in "abcd"]
SPEC_D = ScenarioSpec("spmd.d", ObserverSpec("r", "host", (M64,)),
                      (StressorSpec("w", "host", M256),), iters=4)


def spmd_coord(**kw) -> CoreCoordinator:
    # the default cache: a program holds its operands (24 GiB for (b)'s
    # eight engines at 1 GiB), and the cache evicts by their bytes
    return CoreCoordinator(PoolManager(H100_SXM, DEV), H100_SXM,
                           backend="spmd", device=DEV, **kw)


def spmd_expected(coord, specs, mode: str, pack: bool = True):
    """(host syncs, measured dispatches, executed rungs) the plan implies,
    before any quality-gate re-measurement."""
    triples = [(sp, o, b) for sp in specs for o in sp.observers
               for b in o.buffers]
    rungs = sum(coord._ladder_depth(sp) for sp, _o, _b in triples)
    if mode == "rung":
        return rungs * (1 + coord.spmd_samples), rungs, rungs
    plan = exec_plan.build_plan(triples, coord._spmd_engines(), coord.pools,
                                H100_SXM.n_engines,
                                grouped=mode == "batched")
    if mode == "batched" and pack:
        plan = exec_plan.pack_engine_subsets(plan)
    return len(plan.dispatches), len(plan.dispatches), rungs


def curve(run) -> dict:
    chase_ = run.scenarios[0].main.strategy in _CHASES
    return {"key": run.key, "what": "ns_per_hop" if chase_ else "gbps",
            "rungs": [s.main.latency_ns if chase_ else s.main.bandwidth_gbps
                      for s in run.scenarios],
            "spread_ns": run.execution.get("rung_time_spread_ns"),
            "subset_index": run.execution.get("subset_index"),
            "packed": run.execution.get("packed")}


def spmd_run(name: str, coord, specs, mode: str, checks: dict, **kw):
    """One run_matrix on the spmd backend, with the checks every curve and
    the accounting must pass."""
    t0 = time.perf_counter()
    res = coord.run_matrix(specs, **kw)
    sync()
    seconds = time.perf_counter() - t0
    st = res.stats
    syncs, measures, rungs = spmd_expected(
        coord, specs, mode, coord.spmd_pack == "auto")
    # quality-gate re-measurements, if any, each add one honest host sync
    checks[f"dispatches_as_planned:{name}"] = (
        not (st.faults_injected or st.retried_dispatches
             or st.degraded_ladders)
        and st.host_sync_dispatches == syncs + st.noisy_remeasures
        and st.measure_dispatches == measures and st.spmd_rungs == rungs)
    checks[f"executed_fenced_device_cuda:{name}"] = all(
        r.execution["executed_rungs"] == list(range(len(r.scenarios)))
        and r.execution["fenced"] is True
        and r.execution["timing_source"] == ("host" if mode == "rung"
                                             else "device")
        and r.execution["activity"] == "cuda"
        and all(s.source == "executed" and s.main.elapsed_ns > 0
                for s in r.scenarios)
        for r in res.runs)
    checks[f"rungs_last_{MIN_TICKS}_timer_steps:{name}"] = all(
        s.main.elapsed_ns >= MIN_TICKS * TIMER["tick_ns"]
        for r in res.runs for s in r.scenarios)
    cache = coord._dispatcher.cache
    rec = {"name": name, "mode": mode, "pack": coord.spmd_pack,
           "seconds": round(seconds, 2),
           "cache": {"entries": len(cache.entries),
                     "built": st.programs_built,
                     "resident_bytes": cache.resident("cuda")},
           "dispatch_stats": dataclass_dict(st),
           "planned": {"host_syncs": syncs, "measured": measures,
                       "rungs": rungs},
           "curves": [curve(r) for r in res.runs]}
    return res, rec


def phase_spmd() -> None:
    checks, recs = {}, []
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        # (a) characterize over hbm: r/w/l observers x r/w/y stressors
        coord = spmd_coord()
        t0 = time.perf_counter()
        db = characterize(coord, pools=["hbm"],
                          obs_strategies=("r", "w", "l"),
                          stress_strategies=("r", "w", "y"),
                          iters=SPMD_ITERS_A)
        sync()
        ex = executions(db)
        checks["a:curves"] = len(db.surfaces) == 9
        checks["a:executed_fenced_device_cuda"] = all(
            e["executed_rungs"] == list(range(8)) and e["fenced"] is True
            and e["timing_source"] == "device" and e["activity"] == "cuda"
            for e in ex)
        checks["a:one_launch_per_signature"] = \
            db.meta["host_sync_dispatches"] == \
            9 + db.meta["noisy_remeasures"]
        checks["a:curvedb_round_trip"] = round_trips(db, tmp, "spmd_a")
        cache = coord._dispatcher.cache
        recs.append({"name": "a: characterize hbm r/w/l x r/w/y 256M",
                     "seconds": round(time.perf_counter() - t0, 2),
                     "cache": {"entries": len(cache.entries),
                               "resident_bytes": cache.resident("cuda")},
                     "meta": {k: db.meta[k] for k in (
                         "host_sync_dispatches", "measure_dispatches",
                         "spmd_rungs", "noisy_remeasures")},
                     "curves": [{"key": k.to_string(), "rungs": [
                         p.latency_ns if k.obs_strat == "l"
                         else p.bandwidth_gbps
                         for p in surf.n_axis_points()]}
                         for k, surf in db.surfaces.items()]})
        del coord, db, cache

        # (b) one ladder, three dispatch modes
        b_runs = {}
        for mode in ("batched", "ladder", "rung"):
            coord = spmd_coord(spmd_dispatch=mode)
            res, rec = spmd_run(f"b:{mode}", coord, [SPEC_B], mode, checks)
            recs.append(rec)
            b_runs[mode] = res
            del coord
        bw = [s.main.bandwidth_gbps for s in b_runs["batched"].runs[0]
              .scenarios]
        checks["b:rung7_not_above_rung0"] = bw[-1] <= RUNG7_CAP * bw[0]
        checks["b:curvedb_round_trip"] = round_trips(
            curvedb_from_result(b_runs["batched"], H100_SXM.name,
                                backend="spmd"), tmp, "spmd_b")

        # (c) four shallow ladders packed side by side vs stacked
        packed, rec_p = spmd_run("c:packed", spmd_coord(), SPECS_C,
                                 "batched", checks)
        off, rec_o = spmd_run("c:off", spmd_coord(spmd_pack="off"),
                              SPECS_C, "batched", checks)
        recs += [rec_p, rec_o]
        checks["c:packed_4_subsets_of_2"] = (
            packed.stats.packed_ladders == 4
            and packed.stats.subset_width == 2
            and sorted(r.execution["subset_index"] for r in packed.runs)
            == [0, 1, 2, 3])
        worst = max(abs(a.main.latency_ns / b.main.latency_ns - 1.0)
                    for ra, rb in zip(packed.runs, off.runs)
                    for a, b in zip(ra.scenarios, rb.scenarios))
        checks["c:packed_within_15pct_of_off"] = worst <= PACK_REL
        recs.append({"name": "c: packed vs off", "worst_rel_diff": worst})

        # (d) a host observer under host stressors: pinned operands
        coord = spmd_coord()
        res, rec = spmd_run("d:host", coord, [SPEC_D], "batched", checks)
        recs.append(rec)
        entry = next(iter(coord._spmd_programs.values()))
        checks["d:operands_pinned"] = (
            res.runs[0].execution["operand_memory_kinds"] == ["pinned_host"]
            and entry.xf.is_pinned() and entry.xi.is_pinned()
            and entry.dst.is_pinned())
        del coord, entry
    emit({"phase": "spmd", "platform": H100_SXM.name, "backend": "spmd",
          "n_engines": N_ENG,
          "ctas_per_engine": torch.cuda.get_device_properties(DEV)
          .multi_processor_count // N_ENG,
          "seconds": round(time.perf_counter() - t_phase, 2),
          "runs": recs, "checks": checks})
    for k, ok in checks.items():
        if not ok:
            fail(f"spmd: check {k}")


def spmd_perf(at_spmd: dict, launched: dict, empty_ms: float) -> list:
    """The two new kernels' rows of the ``kernels`` line: the ladder at
    (b)'s rung 7 (one step; all eight engines stream), the probe, whose
    floor is this run's empty launch (``empty_ms``, the perf phase's)."""
    rows, roles = rung_table(SPEC_B, N_ENG - 1)
    prog = ladder_program(rows, roles)
    plain = lambda: ref.contention_ladder_ref(  # noqa: E731
        prog.xf, prog.xi, prog.table, prog.roles, prog.layout.group_of,
        prog.layout.leaders)
    b_ms, b_by = bound(ladder_bytes(prog), 0)
    out = [{"name": "contention_ladder", "route": "cuda",
            "source": CSRC + "contention.cu",
            "replaces": "src/repro/core/exec/program.py:318",
            "launches": launched["contention_ladder"],
            **at_spmd["contention_ladder"], "ms": time_ms(prog.launch, 5),
            "plain_ms": time_ms(plain, 2), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "shape": "(b) rung 7: r 256 MiB x 8 passes + 7 x w 1 GiB x 2 "
                     "passes, 8 engines x 16 CTAs",
            "bytes": ladder_bytes(prog)}]
    del prog
    x = torch.arange(8 * 128, dtype=torch.float32, device=DEV).reshape(8, 128)
    p_ms, p_by = bound(2 * x.numel() * 4, x.numel())
    out.append({"name": "probe_add_one", "route": "cuda",
                "source": CSRC + "contention.cu",
                "replaces": "src/repro/compat.py:129",
                "launches": launched["probe_add_one"],
                **at_spmd["probe_add_one"],
                "ms": time_ms(lambda: contention.probe_add_one(x), 200),
                "plain_ms": time_ms(lambda: ref.probe_add_one_ref(x), 200),
                "bound_ms": p_ms, "bound_by": p_by,
                "library_ms": time_ms(lambda: torch.add(x, 1.0), 200),
                "launch_floor_ms": empty_ms,
                "sass": at_spmd["probe_sass"],
                "note": "launch-bound: 4 KiB in, 4 KiB out; "
                        "launch_floor_ms is this run's empty launch"})
    return out


# ---------------------------------------------------------------------------
# phase 11: the attention and triad entry points — ops.flash_attention at
# the widths of qwen2-1.5b and gemma3-1b over prefill_32k's 32k tokens, and
# ops.stream_triad on 1 GiB
# ---------------------------------------------------------------------------

# prefill_32k's global batch of 32 is cut to 1 for the script's time limit
ATTN_BATCH = 1
# the reference's tolerances against its dense oracle (tests/test_kernels.py)
ATTN_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the full-width bf16 calls are also held elementwise to a limit scaled to
# the values compared, |got - want| <= BF16_RTOL |want| + BF16_FLOOR: one
# bf16 rounding (2^-8..2^-7 of the value) is the most two float32 results
# that agree may differ by once both are rounded; and to a normalised
# error ||got - want|| / ||want|| <= NORM_TOL
BF16_RTOL, BF16_FLOOR, NORM_TOL = 2.0 ** -7, 2.0 ** -12, 1e-2
# q and k drawn at sqrt(3): scores of std 3 whatever the head dim (the
# softmax scale is D^-1/2), so each row's softmax is peaked and a key left
# out of the sum shows in the output; v at 0.5 keeps every output under
# 4, where a bf16 rounding is below ATTN_ATOL's 2e-2
PEAKED_QK, V_SCALE = 3.0 ** 0.5, 0.5
TILING_ATOL = 1e-5
# the local call against the global one at gemma3-1b's widths: the work
# ratio is about 1/32, so an admissible-range loop that works is far below
WINDOW_SHARE_MAX = 1 / 8
# the reference's six CASES: b, h, kvh, s, d, causal, window
FLASH_CASES = [(1, 1, 1, 128, 64, True, 0), (2, 4, 2, 256, 64, True, 0),
               (1, 4, 1, 256, 128, True, 0), (1, 2, 2, 256, 64, False, 0),
               (1, 4, 2, 512, 64, True, 128), (2, 2, 1, 256, 32, True, 64)]
# gemma3's head dim 256 at small size, global and (ragged) local, at the
# peaked scale
D256_CASES = [(1, 4, 1, 256, 256, True, 0), (1, 4, 1, 320, 256, True, 64)]
TILINGS = ((128, 128), (256, 128), (128, 256), (512, 512), (96, 160),
           (200, 200))
# bf16 at the tensor-core kernel's tile edges (128 query rows a CTA; 128
# keys a tile, 64 at D 256), at the peaked scale: b, h, kvh, sq, sk, d,
# causal, window.  Sq 200 and 130; Sk ragged at 320 and 257 (the TMA's zero
# fill); Sq != Sk both ways; D 16 and 32; windows narrower than a tile; rows
# with no key
TC_EDGE_CASES = [
    (1, 4, 2, 200, 200, 128, True, 0), (1, 4, 1, 130, 130, 256, True, 0),
    (1, 2, 2, 320, 320, 64, True, 0), (1, 2, 1, 257, 257, 128, False, 0),
    (1, 4, 2, 200, 328, 128, True, 0), (1, 4, 2, 328, 200, 64, False, 0),
    (1, 4, 2, 192, 192, 16, True, 0), (2, 2, 1, 160, 160, 32, True, 0),
    (1, 2, 1, 384, 384, 256, True, 40), (1, 4, 2, 384, 384, 128, True, 64),
    (1, 2, 1, 200, 16, 32, False, 8)]


def attention_calls():
    """(label, config, causal, window) of the three full-width calls: the
    configurations' own heads, KV heads and head dims."""
    qwen, gemma = get_config("qwen2-1.5b"), get_config("gemma3-1b")
    return [("qwen2-1.5b, causal", qwen, True, 0),
            ("gemma3-1b local, causal + window", gemma, True,
             gemma.sliding_window),
            ("gemma3-1b global, causal", gemma, True, 0)]


def qkv(b, h, kvh, sq, sk, d, dtype, seed=0, scale=0.5, v_scale=None):
    """q, k, v from a seed, made on the card: q and k at ``scale``, v at
    ``v_scale`` (default ``scale``)."""
    out = []
    for i, (shape, sc) in enumerate((((b, h, sq, d), scale),
                                     ((b, kvh, sk, d), scale),
                                     ((b, kvh, sk, d), v_scale or scale))):
        g = torch.Generator(device=DEV).manual_seed(seed + i)
        out.append((torch.randn(shape, generator=g, device=DEV) * sc)
                   .to(dtype))
    return out


def admitted_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the masks admit, positions from 0."""
    qp = np.arange(sq)
    hi = np.minimum(sk, qp + 1) if causal else np.full(sq, sk)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(0, hi - lo).sum())


def diff(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def scaled_errors(got: torch.Tensor, want: torch.Tensor):
    """(the largest |got - want| / (BF16_RTOL |want| + BF16_FLOOR), which
    must be at most 1; ||got - want|| / ||want||)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    worst = float((d / (BF16_RTOL * w.abs() + BF16_FLOOR)).max())
    return worst, float(d.norm() / w.norm())


def window_mask(sq: int, sk: int, window: int) -> torch.Tensor:
    """The (Sq, Sk) bool mask of causal + window, positions from 0."""
    qp = torch.arange(sq, device=DEV)[:, None]
    kp = torch.arange(sk, device=DEV)[None, :]
    return (kp <= qp) & (kp > qp - window)


def attention_small_cases() -> list:
    """The kernel against the dense oracle and the plain version at the
    reference's small shapes: comparisons, not the counted path."""
    cases: list = []
    fa = flash_attention.flash_attention
    for (b, h, kvh, s_, d, causal, window), scales in (
            [(c_, (0.5, None)) for c_ in FLASH_CASES]
            + [(c_, (PEAKED_QK, V_SCALE)) for c_ in D256_CASES]):
        for dtype, tol in ATTN_ATOL.items():
            q, k, v = qkv(b, h, kvh, s_, s_, d, dtype, scale=scales[0],
                          v_scale=scales[1])
            err = diff(fa(q, k, v, causal=causal, window=window),
                       ref.attention_ref(q, k, v, causal=causal,
                                         window=window))
            case(cases, "flash_attention", q.shape, err, tol,
                 {"dtype": str(dtype), "causal": causal, "window": window,
                  "vs": "dense"})
    # the kernel ignores block_q/block_k: the plain version at each tiling
    # against the kernel
    q, k, v = qkv(1, 2, 2, 512, 512, 64, torch.float32, seed=4, scale=0.3)
    base = fa(q, k, v, causal=True)
    for bq, bk in TILINGS:
        err = diff(ref.flash_attention_ref(q, k, v, causal=True,
                                           block_q=bq, block_k=bk), base)
        case(cases, "flash_attention", q.shape, err, TILING_ATOL,
             {"tiling": [bq, bk], "vs": "the kernel, plain at this tiling"})
    # ragged lengths, then Sq != Sk both ways
    for sq, sk, causal, window in ((192, 192, True, 0), (320, 320, True, 64),
                                   (160, 160, False, 0), (200, 328, True, 0),
                                   (328, 200, True, 0)):
        q, k, v = qkv(1, 2, 2, sq, sk, 64, torch.float32, seed=1)
        err = diff(fa(q, k, v, causal=causal, window=window),
                   ref.attention_ref(q, k, v, causal=causal, window=window))
        case(cases, "flash_attention", q.shape, err, ATTN_ATOL[torch.float32],
             {"sk": sk, "causal": causal, "window": window, "vs": "dense"})
    # rows past sk - 1 + window admit no key: 0, as the reference returns
    q, k, v = qkv(1, 2, 1, 64, 16, 32, torch.float32)
    got = fa(q, k, v, causal=False, window=8)
    err = max(diff(got, ref.flash_attention_ref(q, k, v, causal=False,
                                                window=8)),
              float(got[:, :, 16 - 1 + 8:].abs().max()))
    case(cases, "flash_attention", q.shape, err, ATTN_ATOL[torch.float32],
         {"sk": 16, "causal": False, "window": 8,
          "vs": "plain; rows with no key are 0"})
    tc_edge_cases(cases)
    return cases


def tc_edge_cases(cases: list) -> None:
    """The bf16 tensor-core kernel at its tile edges: against the dense
    oracle at 2e-2 (rows with no key: 0, as the plain version), and
    against the FMA kernel on the same inputs within one bf16 rounding."""
    fa = flash_attention
    for b, h, kvh, sq, sk, d, causal, window in TC_EDGE_CASES:
        q, k, v = qkv(b, h, kvh, sq, sk, d, torch.bfloat16, seed=7,
                      scale=PEAKED_QK, v_scale=V_SCALE)
        kw = dict(causal=causal, window=window)
        before = counts.INSTANCES["flash_attention:wgmma_bf16"]
        got = fa.flash_attention(q, k, v, **kw)
        ran_tc = counts.INSTANCES["flash_attention:wgmma_bf16"] == before + 1
        no_key = not causal and sq > sk - 1 + window and window > 0
        if no_key:
            err = max(diff(got, ref.flash_attention_ref(q, k, v, **kw)),
                      float(got[:, :, sk - 1 + window:].abs().max()))
        else:
            err = diff(got, ref.attention_ref(q, k, v, **kw))
        extra = {"dtype": "bfloat16", "sq": sq, "sk": sk, "causal": causal,
                 "window": window, "ran_wgmma_bf16": ran_tc,
                 "vs": "plain; rows with no key are 0" if no_key
                 else "dense"}
        case(cases, "flash_attention", q.shape,
             err if ran_tc else math.inf, ATTN_ATOL[torch.bfloat16], extra)
        worst, _ = scaled_errors(got, fa.run_instance("fma_f32", q, k, v,
                                                      **kw))
        case(cases, "flash_attention", q.shape, worst, 1.0,
             {**extra, "vs": "the fma_f32 kernel, in bf16 roundings "
                             "(2^-7 |want| + 2^-12)"})


def sass_words(library: str, function: str = "") -> list:
    """The words of the built library's SASS, read with the cuobjdump
    beside the nvcc that built it; with ``function``, only those of the
    kernels whose (mangled) name holds it."""
    cuobjdump = os.path.join(os.path.dirname(compat.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass",
                           str(_build.compile_source(library))],
                          capture_output=True, text=True, check=True).stdout
    if function:
        sass = " ".join(f for f in sass.split("Function :")[1:]
                        if function in f.split()[0])
    return sass.split()


def sass_counts(library: str, opcodes) -> dict:
    """How often each opcode stands in the built library's SASS."""
    words = sass_words(library)
    return {op: sum(1 for w in words if w.split(".")[0] == op)
            for op in opcodes}


def library_attention_ms(q, k, v, n: int, mask=None) -> float:
    """The yardstick, which the port never calls: one PyTorch call that
    computes the same attention on the same inputs, timed as the kernels
    are: causal by its flag, or, for a window, under the dense bool
    ``mask`` the caller built beforehand (the library has no window)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if mask is None:
        return time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                    enable_gqa=True), n)
    return time_ms(lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True), n)


def phase_attention() -> list:
    """Drives the path through ``ops.flash_attention`` (three calls at full
    width) and ``ops.stream_triad`` (1 GiB) between a reset and a read of
    the counts; then holds each result against its plain version on the
    same inputs and times both.  Returns the two kernels' rows of the
    ``kernels`` line."""
    small = attention_small_cases()
    seq = MODEL_SHAPES["prefill_32k"].seq_len
    calls = []
    for i, (label, cfg, causal, window) in enumerate(attention_calls()):
        q, k, v = qkv(ATTN_BATCH, cfg.n_heads, cfg.n_kv_heads, seq, seq,
                      cfg.head_dim, torch.bfloat16, seed=10 * i,
                      scale=PEAKED_QK, v_scale=V_SCALE)
        calls.append((label, cfg, dict(causal=causal, window=window),
                      (q, k, v)))
    rows = rows_of(G1)
    b = workloads.bw_buffer_init((rows, 128), torch.float32).to(DEV)
    c = uniform(rows, 8)
    sync()

    counts.reset()
    outs, instances = [], []
    for _, _, kw, t in calls:
        before = dict(counts.INSTANCES)
        outs.append(ops.flash_attention(*t, **kw))
        instances.append([k_.split(":")[1] for k_, n_ in
                          counts.INSTANCES.items() if n_ > before[k_]])
    triad = ops.stream_triad(b, c, scalar=3.0)
    sync()
    launched, plain = counts.snapshot()
    by_instance = dict(counts.INSTANCES)

    checks, recs = {}, []
    for (label, cfg, kw, t), out, ran in zip(calls, outs, instances):
        q = t[0]
        want = ref.flash_attention_ref(*t, **kw)
        err = diff(out, want)
        worst, norm_err = scaled_errors(out, want)
        del want
        pairs = admitted_pairs(seq, seq, kw["causal"], kw["window"])
        ops_ = 4 * cfg.head_dim * cfg.n_heads * ATTN_BATCH * pairs
        # q, k and v read once, the output (q's shape) written once
        bytes_ = sum(x.numel() for x in (q, *t)) * q.element_size()
        b_ms, b_by = bound(bytes_, ops_, BF16_TC_OPS_PER_S)
        fp32_ms, _ = bound(bytes_, ops_)
        ms = time_ms(lambda: ops.flash_attention(*t, **kw), 3)
        # the library's call for a window: a dense (S, S) bool mask, 1 GiB
        # at 32k, built here, outside the timed region
        mask = (window_mask(seq, seq, kw["window"]) if kw["window"]
                else None)
        recs.append({
            "call": label, "config": cfg.name, "batch": ATTN_BATCH,
            "instance": ran[0] if len(ran) == 1 else ran,
            "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim, "seq": seq, "dtype": "bfloat16", **kw,
            "admitted_pairs": pairs, "operations": ops_, "bytes": bytes_,
            "max_abs_err": err, "tol": ATTN_ATOL[torch.bfloat16],
            "scaled_err": worst, "norm_err": norm_err,
            "finite": bool(torch.isfinite(out.float()).all()),
            "shape_ok": tuple(out.shape) == tuple(q.shape)
            and out.dtype == q.dtype,
            "ms": ms,
            "plain_ms": time_ms(lambda: ref.flash_attention_ref(*t, **kw), 1),
            "bound_ms": b_ms, "bound_by": b_by, "bound_ms_fp32": fp32_ms,
            "library_ms": library_attention_ms(*t, 3, mask),
            "library_call": "SDPA, enable_gqa, " + (
                "attn_mask (S, S) bool" if kw["window"] else "is_causal"),
            "tflops": ops_ / ms / 1e9})
        del mask
        checks[f"within_tol:{label}"] = err <= ATTN_ATOL[torch.bfloat16]
        checks[f"within_scaled_tol:{label}"] = worst <= 1.0
        checks[f"within_norm_tol:{label}"] = norm_err <= NORM_TOL
        checks[f"finite_and_shaped:{label}"] = (recs[-1]["finite"]
                                                and recs[-1]["shape_ok"])
        checks[f"instance_wgmma_bf16:{label}"] = ran == ["wgmma_bf16"]
    del outs, calls
    local, glob = recs[1]["ms"], recs[2]["ms"]
    checks["window_at_most_1/8_of_global"] = local <= WINDOW_SHARE_MAX * glob
    triad_err = float((triad - ref.triad_ref(b, c, 3.0)).abs().max())
    checks["triad_exact"] = triad_err == 0.0
    for k in ATTENTION_KERNELS:
        checks[f"launched:{k}"] = launched[k] > 0
        checks[f"no_plain_version:{k}"] = plain[k] == 0
    checks["small_cases"] = all(c_["ok"] for c_ in small)
    # the products on the tensor cores, as the built SASS shows them:
    # HGMMA (wgmma) in the bf16 flash kernel, HMMA (mma.sync) in the probe
    sass = {"flash_attention_tc": sass_counts("flash_attention_tc",
                                              ("HGMMA", "HMMA")),
            "compute_probe": sass_counts("compute_probe",
                                         ("HGMMA", "HMMA"))}
    checks["sass_hgmma:flash_attention_tc"] = \
        sass["flash_attention_tc"]["HGMMA"] > 0
    checks["sass_hmma:compute_probe"] = sass["compute_probe"]["HMMA"] > 0
    emit({"phase": "attention", "n_small_cases": len(small),
          "n_small_ok": sum(c_["ok"] for c_ in small),
          "failed_small_cases": [c_ for c_ in small if not c_["ok"]],
          "calls": recs, "window_over_global": local / glob,
          "launches": {k: launched[k] for k in ATTENTION_KERNELS},
          "launches_by_instance": by_instance, "sass": sass,
          "plain_calls": {k: plain[k] for k in ATTENTION_KERNELS},
          "checks": checks})
    for k_, ok in checks.items():
        if not ok:
            fail(f"attention: check {k_}")

    nbytes = rows * 512
    t_ms, t_by = bound(3 * nbytes, 2 * rows * 128)
    main = recs[0]
    return [
        {"name": "triad_hbm", "route": "cuda", "source": CSRC + "stream.cu",
         "replaces": "src/repro/kernels/stream.py:174",
         "launches": launched["triad_hbm"], "max_abs_err": triad_err,
         "tol": 0.0, "ms": time_ms(lambda: ops.stream_triad(b, c), 20),
         "plain_ms": time_ms(lambda: ref.triad_ref(b, c, 3.0), 20),
         "bound_ms": t_ms, "bound_by": t_by,
         "library_ms": time_ms(lambda: torch.add(b, c, alpha=3.0), 20),
         # design (D): one CTA a chunk of this many bytes of b and of c
         "chunk_bytes": stream.kernel_chunk_vec("triad") * 16,
         "shape": "b, c, out (2097152, 128) f32, 1 GiB each"},
        {"name": "flash_attention", "route": "cuda",
         "source": CSRC + "flash_attention_tc.cu",
         "instances": {"wgmma_bf16": CSRC + "flash_attention_tc.cu",
                       "fma_f32": CSRC + "flash_attention.cu"},
         "launches_by_instance": by_instance,
         "replaces": "src/repro/kernels/flash_attention.py:96",
         "launches": launched["flash_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in recs),
         "tol": ATTN_ATOL[torch.bfloat16],
         **{k_: main[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "bound_ms_fp32")},
         "shape": "the qwen2-1.5b call; every call under calls",
         "calls": [{k_: r[k_] for k_ in (
             "call", "instance", "ms", "plain_ms", "bound_ms", "bound_by",
             "bound_ms_fp32", "library_ms", "library_call", "max_abs_err",
             "scaled_err", "norm_err", "tflops")}
             for r in recs]}]


def main() -> int:
    smi = phase_device()
    phase_build()
    # the plain versions' float32 products in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    at_main = phase_kernels(rows_of(G1))
    phase_pinned()
    phase_small_reference()
    probe_case, sass = phase_probe()
    at_spmd = {"probe_add_one": probe_case, "probe_sass": sass,
               "contention_ladder": phase_spmd_kernel_checks()}

    walk_us = phase_on_chip()

    # the two paths, each run between a reset and a read of the counts
    counts.reset()
    records = phase_main_path(walk_us)
    launched, plain = counts.snapshot()
    counts.reset()
    matrix = phase_matrix()
    m_launched, m_plain = counts.snapshot()
    emit({"phase": "matrix_launches", "launches": m_launched,
          "plain_calls": m_plain})
    for k in OBSERVER_KERNELS:
        if m_launched[k] < 1:
            fail(f"matrix: kernel {k} was not launched")
    if any(m_plain.values()):
        fail("matrix: a plain version ran on the card's path")

    phase_lone(matrix)
    del matrix

    # the executed contention ladder, between a reset and a read of the
    # counts; the probe's cache is cleared first so that the path runs its
    # own probe, as a fresh process does
    compat.kernels_supported.cache_clear()
    counts.reset()
    phase_spmd()
    s_launched, s_plain = counts.snapshot()
    emit({"phase": "spmd_launches", "launches": s_launched,
          "plain_calls": s_plain})
    for k in SPMD_KERNELS:
        if s_launched[k] < 1:
            fail(f"spmd: kernel {k} was not launched")
    if any(s_plain.values()):
        fail("spmd: a plain version ran on the card's path")

    # the attention and triad entry points: the phase resets and reads the
    # counts around its own path
    attention_rows = phase_attention()

    phase_checks(records, launched, plain)
    kernels, empty_ms = phase_perf(at_main, {k: launched[k] + m_launched[k]
                                             for k in launched}, records)
    kernels += spmd_perf(at_spmd, s_launched, empty_ms)
    kernels += attention_rows
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

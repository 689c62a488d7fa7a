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
tokens, and ``ops.stream_triad`` on 1 GiB), and the serving path
(``repro_torch.launch.serve`` at qwen2-1.5b's full width in bf16:
characterize -> KV placement -> prefill through the flash kernel, one
launch a layer -> decode, then the same weights with the cache in pinned
host memory and through a monitored migration), and the moe, ssm and
hybrid families through the same entry point (olmoe-1b-7b and mamba2-370m
at full width and depth, jamba-v0.1-52b at full width over one period of
its pattern: the served logits against one forward, the caches in pinned
host memory, the MoE's and the SSD's shares of the card's time), and the
training path (``repro_torch.launch.train`` at qwen2-1.5b's full width and
depth in bf16: microbatches -> lm.forward with per-layer remat -> the
flash kernel -> chunked cross-entropy -> the hand-written flash backward
kernel on the tensor cores -> AdamW -> the resilient loop), the same
training through the mesh path on one NCCL rank, tensor-parallel
training's pieces at the same width (each rank's head block through the
flash forward and backward, the vocabulary-parallel cross-entropy's
rank-local terms combined as a model group would), the MoE and Mamba-2
families' training split over the model axis (each rank's share of their
layers in turn against the whole layer, forward and backward; the head
blocks of their attention; mamba2-370m's and a cut olmoe-1b-7b's first
train steps on the card), and serving through the
mesh path (``launch.serve`` on a one-rank NCCL group against the same
argv with no group; each tensor-parallel rank's head block through the
flash kernel; GPipe over one decoder layer), and the dry-run
(``repro_torch.launch.dryrun``: every architecture's production train
cell as one rank's call on ``meta`` tensors, and its predicted counts and
peak memory held against the same calls on the card) — checks the
results, and times every kernel beside its bound.  One JSON object per
phase goes to standard output; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failing phase makes the exit code non-zero and withholds that line.
Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device available\n")
    sys.exit(1)

from repro_torch import compat  # noqa: E402
from repro_torch.analysis import cost, roofline  # noqa: E402
from repro_torch.configs.base import ShapeSpec, TrainConfig  # noqa: E402
from repro_torch.configs import SHAPES as MODEL_SHAPES  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.core import coordinator as coordinator_mod  # noqa: E402
from repro_torch.core import workloads  # noqa: E402
from repro_torch.core.characterize import (AXIS_N,  # noqa: E402
                                           ONLINE_QUALIFIER, CurveDB,
                                           Surface, SurfaceAxis, SurfaceKey,
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
from repro_torch.core.search import (SearchSpec,  # noqa: E402
                                     plan_probes, worst_case_search)
from repro_torch.core.scenarios import (ObserverSpec,  # noqa: E402
                                        ScenarioSpec, StressorSpec,
                                        TrafficShape)
from repro_torch.kernels import (_build, chase, compute_probe,  # noqa: E402
                                 contention, counts, flash_attention, ops,
                                 ref, stream)
from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch.data.pipeline import DataLoader  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.parallel.sharding import make_rules  # noqa: E402
from repro_torch.runtime import fault_tolerance  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402
from repro_torch.models import blocks as blocks_mod  # noqa: E402
from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.common import rmsnorm  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.serve.engine import (ServeEngine,  # noqa: E402
                                      choose_kv_pool, make_decode_step,
                                      make_prefill_step, rank_block,
                                      rank_params)
from repro_torch.serve.monitor import (GuardConfig,  # noqa: E402
                                       OnlineRecharacterizer, ServeMonitor,
                                       WatchdogConfig)

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
# the kernel of the training path alone
TRAIN_KERNELS = ("flash_attention_bwd",)
OBSERVER_KERNELS = tuple(k for k in counts.KERNELS
                         if k not in SPMD_KERNELS + ATTENTION_KERNELS
                         + TRAIN_KERNELS)


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
# the surface's uncontended hbm read edge (H100_SXM's fitted model) must
# lie this close to the same run's measured 1 GiB read
EDGE_REL = 0.10
# letters whose group is measured over a stacked member axis (streams and
# random chases); every other letter's group shares one measurement
STACKED = ("r", "s", "c", "x", "b", "l", "m")
# the batched per-member figure must be this close to the lone observer's
LONE_REL = 0.15
# turns each of the lone observer and the batched group, taken in
# alternation, for a stream group in pinned host memory, each turn on
# pinned pages of its own: the PCIe read rate is the allocation's (on an
# H100 80GB HBM3 at 700 W, 256 MiB to 1 GiB allocations of one process
# read at 25.3 to 34.0 GB/s, each steady from turn to turn, as this
# script's batched_vs_alone turns print them), so both sides' medians are
# taken over as many allocations
LONE_TURNS = 5
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


def phase_matrix(read_gbps: float) -> dict:
    """Drives the loop through its entry points.  Returns what the lone
    re-measurement needs: every signature group measured.  ``read_gbps``:
    the main path's 1 GiB ``r`` read of this run, which the surface's
    uncontended ``hbm`` edge (the device tree's model) must lie within
    ``EDGE_REL`` of."""
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
    edge_gbps = roofline.effective_hbm_bw(db_surface, n_stressors=0) / 1e9
    checks["hbm_r_edge_near_main_path_read"] = \
        abs(edge_gbps - read_gbps) <= EDGE_REL * read_gbps
    emit({"phase": "matrix", "platform": H100_SXM.name, "backend": "cuda",
          "hbm_r_edge_gbps": edge_gbps, "main_path_read_gbps": read_gbps,
          "edge_over_read": edge_gbps / read_gbps,
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
    return {"coord": coord, "groups": groups, "db_surface": db_surface}


def phase_lone(matrix: dict) -> None:
    """Each group's per-member figure against the same observer measured
    alone through make_shaped_workload(...).run: the card's counterpart of
    the reference's test_batched_chase_latency_matches_naive.  A stream
    group in pinned host memory is measured again here, in turns with its
    lone observer (``LONE_TURNS`` each, alternating, every turn of either
    on pinned pages no other turn read), and their medians are compared;
    every other group's figure from the matrix phase against one lone
    run."""
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
    ``LONE_TURNS`` each in alternating turns (lone first): each turn a new
    lone workload, the group measured as the matrix phase measured it, by
    ``measure_group`` with the same arguments.  Every turn's buffers are
    held until the last turn, so no turn is handed pages an earlier one
    read (the pinned allocator hands a freed block out again)."""
    strategy, pool, buf, n, iters, kw = g["_call"]
    turns = {"alone": [], "batched": []}
    lone, held, place = [], [], pool.place

    def holding_place(data):
        out = place(data)
        held.append(out)
        return out

    pool.place = holding_place
    try:
        for _ in range(LONE_TURNS):
            lone.append(workloads.make_shaped_workload(strategy, pool, buf,
                                                       kw.get("shape")))
            turns["alone"].append(figure(lone[-1].run(iters))[1])
            results, _ = coordinator_mod.measure_group(strategy, pool, buf,
                                                       n, iters, **kw)
            sync()
            turns["batched"].append([figure(r)[1] for r in results])
    finally:
        del pool.place
        for wl in lone:
            wl.release()
        held.clear()
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
    probe_ops, probe_bytes = compute_probe.work(PROBE_ITERS)
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

    def work(name, elems, repeats=1):
        """The package's count of a stream kernel, as (bytes, ops)."""
        flops, nbytes_ = stream.work(name, elems, repeats=repeats)
        return nbytes_, flops

    # name -> (source, replaces, kernel, plain, library, bytes, ops, calls)
    table = [
        ("read_hbm", "stream.cu", "src/repro/kernels/stream.py:100",
         lambda: stream.read_hbm(x), lambda: ref.read_ref(x),
         lambda: x.sum(), *work("read_hbm", rows * 128), n),
        ("write_hbm", "stream.cu", "src/repro/kernels/stream.py:116",
         lambda: stream.write_hbm(rows, out=dst),
         lambda: ref.write_ref(rows, 1.0, DEV),
         lambda: torch.full((rows, 128), 1.0, device=DEV),
         *work("write_hbm", rows * 128), n),
        ("write_hbm_seeded", "stream.cu", "src/repro/kernels/stream.py:137",
         lambda: stream.write_hbm_seeded(seed, n_w * blk, block_rows=blk,
                                         out=dst[:n_w * blk]),
         lambda: ref.write_seeded_ref(n_w * blk, 1.0, seed),
         lambda: torch.full((n_w * blk, 128), 1.0, device=DEV),
         *work("write_hbm_seeded", n_w * blk * 128), n),
        ("rmw_hbm", "stream.cu", "src/repro/kernels/stream.py:151",
         lambda: stream.rmw_hbm(x), lambda: ref.rmw_ref(x),
         lambda: x + 1, *work("rmw_hbm", rows * 128), n),
        ("copy_hbm", "stream.cu", "src/repro/kernels/stream.py:164",
         lambda: stream.copy_hbm(x), lambda: ref.copy_ref(x),
         lambda: x.clone(), *work("copy_hbm", rows * 128), n),
        ("mixed_hbm", "stream.cu", "src/repro/kernels/stream.py:189",
         lambda: stream.mixed_hbm(x, read_fraction=2 / 3, seed=seed),
         lambda: ref.mixed_ref(x, 2 / 3), None, nbytes + 4,
         n_r * blk * 128, n),
        ("read_vmem", "stream.cu", "src/repro/kernels/stream.py:248",
         lambda: stream.read_vmem(small, repeats=8),
         lambda: ref.read_vmem_ref(small, 8), lambda: small.sum() * 8,
         *work("read_vmem", small.numel(), repeats=8), 10 * n),
        ("write_vmem", "stream.cu", "src/repro/kernels/stream.py:260",
         lambda: stream.write_vmem(small.shape[0], repeats=8,
                                   out=small_dst),
         lambda: ref.write_vmem_ref(small.shape[0], 8, DEV),
         lambda: torch.full(tuple(small.shape), 7.0, device=DEV),
         *work("write_vmem", small.numel()), 10 * n),
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
         probe_bytes, probe_ops, n),
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
SCENARIO_PASSES = 2            # passes of the build_scenario_program rung
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


def ladder_bytes(prog) -> int:
    """Bytes the roles of the program's first step move, as the package
    counts them (``contention.ladder_work``)."""
    return contention.ladder_work(prog.table[:1], prog.roles).bytes


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

    # one rung built as build_scenario_program builds it: an r observer,
    # 3 w stressors, idle engines, at 256 MiB; held to the plain version,
    # to its stamps and to the bytes its roles move
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    main_role = ("r", None, rows_of(M256), SCENARIO_PASSES)
    stress_role = ("w", None, rows_of(M256), SCENARIO_PASSES)
    prog = exec_program.build_scenario_program(
        N_ENG, 3, main_role, stress_role, device=DEV,
        ctas_per_engine=sms // N_ENG)
    scenario = check_ladder(prog, READ_RTOL_FULL,
                            "build_scenario_program: r + 3 w, 256 MiB")
    out = prog.launch().to_cpu()
    # r reads its buffer once a pass; w (rmw) reads and writes it
    want_bytes = SCENARIO_PASSES * M256 * (1 + 2 * 3)
    scenario.update(bytes=ladder_bytes(prog), want_bytes=want_bytes,
                    stamps_fenced=exec_fence.stamps_fenced(out, prog.layout),
                    roles=[int(prog.roles[prog.table[0, e], 0])
                           for e in range(N_ENG)])
    del prog

    # two probe batches as the search launches them, at 256 MiB: arm b's
    # probes of 5 to 7 stressors, one probe a wave over every engine, and
    # arm t/st64's of 1 to 3, two slots a wave; each held to the plain
    # version on the same inputs, fenced, and at the geometry planned
    coord = spmd_coord()
    probe_batches = []
    for label, cands, geometry in SEARCH_CHECK_BATCHES:
        arm = next(a for a in SEARCH_SPEC.arms if a.label() == label)
        planned = plan_probes(coord, SEARCH_SPEC, arm, cands)
        prog = exec_program.build_ladder_entry(
            planned, N_ENG, 1, DispatchStats(), device=DEV,
            ctas_per_engine=sms // N_ENG)
        rec = check_ladder(prog, READ_RTOL_FULL,
                           f"probe batch, arm {label}, 256 MiB")
        rec.update(candidates=cands, waves=planned.waves,
                   subsets=planned.n_subsets, want=geometry,
                   steps=int(prog.table.shape[0]))
        probe_batches.append(rec)
        del prog
    del coord

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
              "scenario_program_exact_and_fenced": (
                  scenario["ok"] and scenario["stamps_fenced"]
                  and scenario["bytes"] == scenario["want_bytes"]
                  and scenario["roles"] == [contention.READ]
                  + [contention.RMW] * 3 + [contention.IDLE] * (N_ENG - 4)),
              "search_probe_batches_exact_and_fenced": all(
                  r["ok"] and (r["waves"], r["subsets"]) == r["want"]
                  and r["steps"] == r["waves"] for r in probe_batches),
              "fenced_with_the_wait": prog.is_fenced(good),
              "refused_without_it": not prog.is_fenced(bad),
              "empty_ladder_fenced": empty.is_fenced(eo)}
    emit({"phase": "spmd_kernel_checks", "n_role_cases": len(recs),
          "n_ok": sum(r["ok"] for r in recs), "main_tables": at_main,
          "scenario_program": scenario, "probe_batches": probe_batches,
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
    worst = max(at_main + [scenario] + probe_batches,
                key=lambda r: r["max_abs_err"])
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


# ---------------------------------------------------------------------------
# phase 11: the worst-case search, every iteration one ladder launch
# ---------------------------------------------------------------------------

# 256 MiB, as the spmd (a) ladders and the matrix's chases: five times the
# L2; six iterations play the four default arms once and exploit twice
SEARCH_SPEC = SearchSpec(pool="hbm", obs_strategies=("r", "l"),
                         buffer_bytes=M256, iters=1, iterations=6, batch=4,
                         max_stressors=7, seed=0)
# the probe batches spmd_kernel_checks holds to the plain version: (arm,
# (n, rw, ir) candidates, (waves, slots a wave)); each candidate runs under
# both observers, so 8 probes: 8 waves of one probe when the widest needs
# all 8 engines, 4 waves of two 4-engine slots when it needs 4
SEARCH_CHECK_BATCHES = (
    ("b", [(7, 0.5, 1.0), (7, 0.25, 0.5), (6, 0.875, 0.75),
           (5, 0.125, 0.25)], (8, 1)),
    ("t/st64", [(3, 0.5, 1.0), (2, 0.5, 0.5), (1, 0.5, 1.0),
                (3, 0.5, 0.25)], (4, 2)))
SEARCH_R_CAP = 1.05 * HBM_BYTES_PER_S / 1e9    # GB/s
SEARCH_LAT_FLOOR = 0.85        # x the lone hop: contention only adds


def phase_search(lone_hop_ns: float) -> dict:
    """``worst_case_search`` on the spmd coordinator at 256 MiB, executed;
    the envelope into a CurveDB, round-tripped, and a pessimistic
    placement over it.  ``lone_hop_ns``: the main path's lone 256 MiB
    hop, which no contended ``l`` probe may undercut by more than 15 %.
    Returns the host syncs the search counted."""
    checks = {}
    t_phase = time.perf_counter()
    coord = spmd_coord()
    activity = coord._resolved_activity()
    t0 = time.perf_counter()
    # the card's activity traced: each iteration's ladder launch, whose
    # device stamps mark where each iteration ended
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        res = worst_case_search(coord, SEARCH_SPEC, execute=True)
        sync()
    search_s = time.perf_counter() - t0
    st = res.stats
    ladders = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and "ladder_kernel" in e.name),
                     key=lambda e: e.time_range.start)
    del prof
    checks["executed_and_fenced"] = res.executed and res.fenced
    checks["activity_cuda"] = activity == "cuda"
    checks["one_launch_an_iteration"] = (
        not (st.faults_injected or st.retried_dispatches
             or st.degraded_ladders)
        and st.host_sync_dispatches
        == SEARCH_SPEC.iterations + st.noisy_remeasures
        and len(ladders) == st.host_sync_dispatches
        and all(t["dead_probes"] == 0 for t in res.trace))
    r_pts = [p for p in res.points if p.obs_strat == "r"]
    l_pts = [p for p in res.points if p.obs_strat == "l"]
    n_probes = SEARCH_SPEC.iterations * SEARCH_SPEC.batch
    checks["every_probe_measured"] = len(r_pts) == len(l_pts) == n_probes
    checks["r_positive_and_below_peak"] = all(
        0 < p.bandwidth_gbps <= SEARCH_R_CAP for p in r_pts)
    worst_l = max(p.latency_ns for p in l_pts) if l_pts else 0.0
    checks["worst_l_not_below_the_lone_hop"] = \
        worst_l >= SEARCH_LAT_FLOOR * lone_hop_ns
    want_keys = {SurfaceKey("hbm", o, "hbm", "b", qualifier="worstcase")
                 for o in SEARCH_SPEC.obs_strategies}
    checks["one_worstcase_surface_per_observer"] = \
        set(res.envelope) == want_keys

    db = CurveDB(platform=H100_SXM.name)
    res.install(db)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        checks["curvedb_round_trip"] = round_trips(db, tmp, "search")
    # the pessimistic advisor at the deepest stressor count both envelopes
    # hold: no query clamps, so every cost came from a worstcase surface
    n_at = int(min(max(s.axes[0].values) for s in res.envelope.values())) \
        if res.envelope else 0
    caps = {"hbm": 80 * 10**9}
    objects = placement_objects()
    adv = PlacementAdvisor(db, H100_SXM, pools=["hbm"], pessimistic=True)
    plan = adv.advise(objects, ContentionSpec(n_at, "hbm", "y"), caps)
    placed = check_plan("search: pessimistic", plan, caps, objects)
    reads = [db.query("hbm", n_at, obs_strat=o, stress_strat="y",
                      qualifier="worstcase")
             for o in SEARCH_SPEC.obs_strategies]
    checks["pessimistic_placement_reads_the_envelope"] = (
        len(plan.decisions) == len(objects)
        and not any(d.extrapolated for d in plan.decisions.values())
        and not any(q.extrapolated for q in reads))

    # an iteration lasts from the end of the last one's launch to the end
    # of its own (its planning, operands and launch); the first, the rest
    # of the search's wall time
    ends = [e.time_range.end / 1e6 for e in ladders]
    iterations, k = [], 0
    for t in res.trace:
        n = t["host_sync_dispatches"]
        mine = ladders[k:k + n]
        arm = next(a for a in SEARCH_SPEC.arms if a.label() == t["arm"])
        planned = plan_probes(coord, SEARCH_SPEC, arm,
                              [tuple(c) for c in t["candidates"]],
                              it=t["iteration"])
        seconds = (ends[k + n - 1] - ends[k - 1] if k and len(ends) >= k + n
                   else None)
        k += n
        iterations.append({
            "iteration": t["iteration"], "arm": t["arm"],
            "probes": t["candidates"], "host_syncs": n,
            "seconds": seconds,
            "launch_ms": [e.time_range.elapsed_us() / 1e3 for e in mine],
            "geometry": {"probes": planned.group, "waves": planned.waves,
                         "subsets": planned.n_subsets},
            "model_gap": t["model_gap"], "reward": t["reward"],
            "dead_probes": t["dead_probes"]})
    if iterations and ends:
        iterations[0]["seconds"] = search_s - (ends[-1] - ends[0])
    envelope = {
        key.to_string(): {"n_stressors": list(surf.axes[0].values),
                          "bandwidth_gbps": surf.bandwidth_gbps,
                          "latency_ns": surf.latency_ns}
        for key, surf in sorted(res.envelope.items())}
    emit({"phase": "search", "platform": H100_SXM.name, "backend": "spmd",
          "spec": {**dataclass_dict(SEARCH_SPEC),
                   "arms": [a.label() for a in SEARCH_SPEC.arms]},
          "activity": activity,
          "lone_hop_ns": lone_hop_ns, "iterations": iterations,
          "worst": {o: res.worst(o).to_dict()
                    for o in SEARCH_SPEC.obs_strategies
                    if any(p.obs_strat == o for p in res.points)},
          "envelope": envelope, "placement": placed,
          "programs_built": st.programs_built,
          "dispatch_stats": dataclass_dict(st),
          "search_seconds": search_s,
          "seconds": time.perf_counter() - t_phase, "checks": checks})
    for k_, ok in checks.items():
        if not ok:
            fail(f"search: check {k_}")
    del coord
    return {"host_syncs": st.host_sync_dispatches}


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


def library_attention_ms(q, k, v, n: int, mask=None, do=None) -> float:
    """The yardstick, which the port never calls: one PyTorch call that
    computes the same attention on the same inputs, timed as the kernels
    are: causal by its flag, or, for a window, under the dense bool
    ``mask`` the caller built beforehand (the library has no window).
    With ``do``, the call's backward at ``do`` alone: the forward runs once
    outside the timed region."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = (dict(is_causal=True) if mask is None else dict(attn_mask=mask))
    if do is None:
        return time_ms(lambda: sdpa(q, k, v, enable_gqa=True, **kw), n)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = sdpa(*leaves, enable_gqa=True, **kw)
    return time_ms(lambda: torch.autograd.grad(out, leaves, do,
                                               retain_graph=True), n)


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
        pairs = flash_attention.admitted_pairs(seq, seq, kw["causal"],
                                               kw["window"])
        # the package's count: 4·D a head and admitted pair; q, k and v
        # read once, the output (q's shape) written once
        ops_, bytes_ = flash_attention.forward_work(*t, **kw)
        # (d) of the roofline: the counter counts the same work
        counted = cost.analyze(ops.flash_attention, *t, **kw).kernels
        checks[f"counter_equals_row:{label}"] = \
            counted == {"flash_attention": [1, ops_, bytes_]}
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
    # HGMMA (wgmma) in the bf16 flash kernels, forward and backward, HMMA
    # (mma.sync) in the probe
    sass = {lib: sass_counts(lib, ("HGMMA", "HMMA"))
            for lib in ("flash_attention_tc", "flash_attention_bwd_tc",
                        "compute_probe")}
    checks["sass_hgmma:flash_attention_tc"] = \
        sass["flash_attention_tc"]["HGMMA"] > 0
    checks["sass_hgmma:flash_attention_bwd_tc"] = \
        sass["flash_attention_bwd_tc"]["HGMMA"] > 0
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

    t_ops, t_bytes = stream.work("triad_hbm", rows * 128)
    t_ms, t_by = bound(t_bytes, t_ops)
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


# ---------------------------------------------------------------------------
# the serving path: repro_torch.launch.serve at qwen2-1.5b's full width
# ---------------------------------------------------------------------------

SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 2048, 32
SERVE_ARGV = ["--arch", "qwen2-1.5b", "--batch", str(SERVE_BATCH),
              "--prompt-len", str(SERVE_PROMPT), "--new-tokens",
              str(SERVE_NEW), "--kv-placement", "auto", "--seed", "0"]
# (d): the load injected into a decode step whose cache is in device
# memory, from the 8th step on: this many times the median step of (c), so
# that the watchdog's band of 2.5 is crossed however the host's speed
# moves the step (its steps spread over 0.5-1.3x their median on the card)
SERVE_DELAY_STEPS = 5


def serve_logits_tol(cfg) -> float:
    """The limit on the last position's logits, kernel path against plain
    path, normalised.  The two attention outputs differ by at most one bf16
    rounding an element; once two bf16 stacks differ at all, their residual
    streams round apart: one rounding a layer for the mixer's update and
    one more where the layer has an FFN, each at most 2^-8 relative, in two
    independent streams, added in quadrature: sqrt(2 * roundings) * 2^-8,
    which is sqrt(n_layers) * 2^-7 where every layer has an FFN (0.0413 at
    qwen2's 28 layers).  tools/bf16_stack_floor.py measures the floor of 28
    such layers on the CPU."""
    roundings = sum(1 + blocks_mod.layer_has_ffn(cfg, i)
                    for i in range(cfg.n_layers))
    return math.sqrt(2 * roundings) * 2.0 ** -8


@contextlib.contextmanager
def plain_flash():
    """``ops.flash_attention`` replaced by its plain version while the
    block runs: the check, not the path, calls ``ref.flash_attention_ref``
    on the card."""
    real = ops.flash_attention

    def plain(q, k, v, *, causal=True, window=0, sm_scale=None,
              block_q=128, block_k=128):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       sm_scale=sm_scale, block_q=block_q,
                                       block_k=block_k)

    ops.flash_attention = plain
    try:
        yield
    finally:
        ops.flash_attention = real


def timed_generate(engine, prompts, **kw):
    """(result, ms of each decode step): the engine's timed loop (an
    ``on_step`` hook makes it synchronise the card every step), each step
    from one hook call to the next, the last to the return."""
    stamps = []
    res = engine.generate(prompts, max_new_tokens=SERVE_NEW,
                          on_step=lambda step, pool: stamps.append(
                              time.perf_counter_ns()), **kw)
    stamps.append(time.perf_counter_ns())
    return res, [(b - a) / 1e6 for a, b in zip(stamps, stamps[1:])]


# the port's flash kernels, forward and backward, by their function names
FLASH_KERNEL_RE = re.compile(
    r"::(flash_tc_kernel|flash_kernel|bwd_rows_kernel|bwd_dkdv_tc_kernel|"
    r"bwd_dq_tc_kernel|bwd_delta_kernel|bwd_dkdv_kernel|bwd_dq_kernel)<")
# traces of the card taken at most where one may have lost records: a
# trace never gains any, but one of 96 marker records went missing in one
# of six mamba2 prefills, and 4 of 8 traces of a qwen2-1.5b training step
# (17 116 kernels) lost 2-79 scattered records, on the H100
TRACES = 5
# part_shares: the small kernels a trace starts with, and the host's wait,
# the card idle, between them and the call (a trace's first records can be
# lost, see part_shares)
TRACE_PADS = 64
TRACE_SETTLE_S = 0.1


def profile_calls(fn, n: int, traces: int = 0) -> dict:
    """``fn`` run ``n`` times under ``torch.profiler`` after one warm call:
    each call's kernels, their device time summed, the six kernels with
    the most of it, and the time of the port's flash kernels, forward and
    backward, wherever they rank.  The trace is taken again until a new
    one counts every kernel as an earlier one did, up to ``traces`` in all
    (default ``TRACES``);
    the numbers are that trace's when two agreed (``whole``), else the
    fullest's (a call whose kernels depend on its data, as an MoE layer's
    do, may never agree), and ``count_diff`` lists the kernels whose counts
    differed (each name's first 120 characters: their counts in trace
    order).  The card's activity alone is traced (the host's op events
    made the trace's processing take minutes); the profiler slows the
    host, so the call's wall time is the caller's, taken without it."""
    fn()
    sync()
    limit, traces = traces or TRACES, []
    for _ in range(limit):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            sync()
        count: dict = {}
        ms: dict = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                count[e.name] = count.get(e.name, 0) + 1
                ms[e.name] = (ms.get(e.name, 0.0)
                              + e.time_range.elapsed_us() / 1e3 / n)
        whole = any(count == c for c, _ in traces)
        traces.append((count, ms))
        if whole:
            break
    count, ms = (traces[-1] if whole else
                 max(traces, key=lambda t: sum(t[0].values())))
    diff: dict = {}
    for name in set().union(*(c for c, _ in traces)):
        seen = [c.get(name, 0) for c, _ in traces]
        if len(set(seen)) > 1:
            key = name[:120]
            diff[key] = [a + b for a, b in
                         zip(diff.get(key, [0] * len(seen)), seen)]
    return {"kernels_a_call": sum(count.values()) / n,
            "device_ms_a_call": sum(ms.values()),
            "traces": len(traces), "whole": whole,
            "kernels_by_trace": [sum(c.values()) / n for c, _ in traces],
            "count_diff": diff,
            "top_device_ms": sorted(ms.items(), key=lambda kv: -kv[1])[:6],
            "flash_device_ms": {k: v for k, v in ms.items()
                                if FLASH_KERNEL_RE.search(k)}}


def serve_monitor():
    """tests/test_serve.py's monitored loop: the offline surfaces put the
    cache in device memory; the stub probe sweep finds device memory
    contended and host memory clean."""
    def flat(bw):
        return Surface(axes=(SurfaceAxis(AXIS_N, (0.0, 8.0)),),
                       bandwidth_gbps=[bw, bw], latency_ns=[100.0, 100.0])

    db = CurveDB(platform="synthetic")
    for pool, bw in (("hbm", 1000.0), ("host", 100.0)):
        for strat in ("r", "l"):
            db.surfaces[SurfaceKey(pool, strat, "hbm", "b")] = flat(bw)

    def refresh(coord, db_, **kw):
        keys = []
        for pool, bw in (("hbm", 2.0), ("host", 1000.0)):
            for strat in ("r", "l"):
                key = SurfaceKey(pool, strat, "hbm", "b",
                                 qualifier=ONLINE_QUALIFIER)
                db_.surfaces[key] = flat(bw)
                keys.append(key)
        return keys, {"stub": True}

    class StubCoord:
        backend = "simulate"

    adv = ServeMonitor.online_advisor(db, H100_SXM, pools=["hbm", "host"])
    rechar = OnlineRecharacterizer(StubCoord(), db, pools=["hbm", "host"],
                                   refresh=refresh)
    return adv, ServeMonitor(
        adv, rechar,
        watchdog=WatchdogConfig(band=2.5, rearm=1.5, sustain=3, warmup=4,
                                cooldown=64),
        guard=GuardConfig(min_gain_frac=0.1, cooldown_steps=64,
                          verify_steps=3, regress_band=3.0),
        capacities={"hbm": 1 << 34, "host": 1 << 34})


def phase_serve(smi: str) -> dict:
    """(a) ``repro_torch.launch.serve`` at qwen2-1.5b's full width, bf16,
    random weights from a seed, between a reset and a read of the counts:
    one flash launch a layer on ``wgmma_bf16``, no plain version, 32 tokens
    a sequence in the vocabulary, the KV cache in the advisor's pool.
    (b) On the same weights and prompts, layer 0's attention and the last
    position's logits against the same prefill with the plain version.
    (c) The cache in pinned host memory: the same tokens, decode ms a step
    for both placements, the bytes each step moves over PCIe.  (d) The
    monitored loop: a migration from device to host memory mid-decode, the
    same tokens.  Returns the flash kernel's serve launches and its time
    at the serve call's shape."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    checks = {}
    max_len = SERVE_PROMPT + SERVE_NEW

    # (a) the entry point
    counts.reset()
    run = serve_cli.run(SERVE_ARGV)
    sync()
    launched, plain = counts.snapshot()
    by_instance = dict(counts.INSTANCES)
    cfg, engine, res, prompts = run.cfg, run.engine, run.result, run.prompts
    params, toks = engine.params, run.result.tokens
    advised = choose_kv_pool(cfg, SERVE_BATCH, max_len,
                             advisor=engine.advisor, scfg=engine.scfg,
                             pool_mgr=engine.pool_mgr)
    checks["a:full_width_bf16"] = (
        (cfg.name, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
         cfg.head_dim, cfg.d_ff, cfg.vocab_size, params["embed"].dtype) ==
        ("qwen2-1.5b", 28, 1536, 12, 2, 128, 8960, 151936, torch.bfloat16))
    checks["a:flash_once_a_layer"] = \
        launched["flash_attention"] == cfg.n_layers
    checks["a:flash_on_wgmma_bf16"] = \
        by_instance["flash_attention:wgmma_bf16"] == cfg.n_layers
    checks["a:no_plain_version"] = not any(plain.values())
    checks["a:tokens_shaped"] = tuple(toks.shape) == (SERVE_BATCH, SERVE_NEW)
    checks["a:tokens_in_vocab"] = bool(
        ((toks >= 0) & (toks < cfg.vocab_size)).all())
    checks["a:kv_pool_is_the_advisors"] = res.kv_pool == advised

    # (b) prefill against the plain version, on the same weights and prompts
    layer0 = {name: {k: t[0] for k, t in grp.items()} if isinstance(grp, dict)
              else grp[0] for name, grp in params["scan"]["p0"].items()}
    h = rmsnorm(lm.embed_tokens(params, prompts, cfg), layer0["ln1"],
                cfg.norm_eps)
    q, k, v = attention.project_qkv(
        layer0["attn"], h, cfg=cfg, layer_idx=0,
        positions=torch.arange(SERVE_PROMPT, device=DEV))
    akw = dict(window=attention.layer_window(cfg, 0),
               scale=cfg.head_dim ** -0.5)
    got = attention.prefill_attention(q, k, v, **akw)
    with plain_flash():
        want = attention.prefill_attention(q, k, v, **akw)
    l0_err = diff(got, want)
    l0_worst, l0_norm = scaled_errors(got, want)
    del got, want
    checks["b:layer0_one_bf16_rounding"] = l0_worst <= 1.0
    prefill = make_prefill_step(cfg, engine.rules, max_len=max_len)
    _, lg = prefill(params, prompts)
    with plain_flash():
        _, lw = prefill(params, prompts)
    logits_norm = float((lg - lw).norm() / lw.norm())
    logits_tol = serve_logits_tol(cfg)
    checks["b:logits_finite"] = bool(torch.isfinite(lg).all())
    checks["b:logits_within_norm_tol"] = logits_norm <= logits_tol
    argmax_equal = int((lg.argmax(-1) == lw.argmax(-1)).sum())
    del lg, lw
    prefill_ms = time_ms(lambda: prefill(params, prompts), 3)
    with plain_flash():
        prefill_plain_ms = time_ms(lambda: prefill(params, prompts), 1)
    # one layer's flash call at this shape, as the model makes it
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    fkw = dict(causal=True, sm_scale=akw["scale"])
    f_ops, f_bytes = flash_attention.forward_work(qt, kt, vt, causal=True,
                                                  window=0)
    f_bound, f_by = bound(f_bytes, f_ops, BF16_TC_OPS_PER_S)
    f_ms = time_ms(lambda: ops.flash_attention(qt, kt, vt, **fkw), 20)
    call = {"shape": f"q {tuple(qt.shape)}, k, v {tuple(kt.shape)} "
                     f"{str(qt.dtype)[6:]}, causal (one serve prefill layer)",
            "ms": f_ms,
            "plain_ms": time_ms(
                lambda: ref.flash_attention_ref(qt, kt, vt, **fkw), 3),
            "bound_ms": f_bound, "bound_by": f_by,
            "library_ms": library_attention_ms(qt, kt, vt, 20),
            "tflops": f_ops / f_ms / 1e9}
    # q, k, v into (B, H, S, D) and the output back, each read and written
    # once, in every layer
    copy_bytes = cfg.n_layers * 2 * f_bytes
    del q, k, v, qt, kt, vt, h

    # where a prefill's and a decode step's device time goes, and how much
    # of the step the card is busy
    prof_prefill = profile_calls(lambda: prefill(params, prompts), 1)
    decode = make_decode_step(cfg, engine.rules)
    caches, _ = prefill(params, prompts)
    tok = toks[:, :1].contiguous()
    prof_decode = profile_calls(
        lambda: decode(params, caches, tok, SERVE_PROMPT), 2)
    # the roofline's counts of the same two calls
    roof_prefill = count_call(prefill, params, prompts)
    roof_decode = count_call(decode, params, caches, tok, SERVE_PROMPT)
    del caches

    # (c) the cache in device memory and in pinned host memory, timed loop
    hbm_res, hbm_steps = timed_generate(engine, prompts)
    host_engine = ServeEngine(cfg, params, engine.rules,
                              ServeConfig(kv_placement="host"),
                              advisor=engine.advisor,
                              pool_mgr=engine.pool_mgr)
    pinned_steps, real_decode = [], host_engine._decode

    def spy(p, caches, tok, pos):
        pinned_steps.append(all(t.is_pinned() for t in lm.leaves(caches)))
        return real_decode(p, caches, tok, pos)

    host_engine._decode = spy
    host_res, host_steps = timed_generate(host_engine, prompts)
    n_steps = SERVE_NEW - 1
    checks["c:hbm_timed_tokens_equal_a"] = torch.equal(hbm_res.tokens, toks)
    checks["c:host_pool"] = host_res.kv_pool == "host"
    checks["c:cache_pinned_every_step"] = pinned_steps == [True] * n_steps
    checks["c:host_tokens_equal_a"] = torch.equal(host_res.tokens, toks)
    checks["c:pcie_reads_the_whole_cache_a_step"] = \
        host_res.host_read_bytes == n_steps * run.kv_bytes
    checks["c:hbm_moves_nothing_over_pcie"] = (
        hbm_res.host_read_bytes == hbm_res.host_written_bytes == 0)

    # (d) the monitored loop: drift, one probe sweep, one migration
    adv, mon = serve_monitor()
    m_engine = ServeEngine(cfg, params, engine.rules, ServeConfig(),
                           advisor=adv, monitor=mon, pool_mgr=engine.pool_mgr)

    delay_s = SERVE_DELAY_STEPS * statistics.median(hbm_steps) / 1e3

    def contention(step, pool):
        if pool == "hbm" and step - SERVE_PROMPT >= 8:
            time.sleep(delay_s)

    m_res = m_engine.generate(prompts, max_new_tokens=SERVE_NEW,
                              on_step=contention)
    migs = [m.to_dict() for m in m_res.migrations]
    checks["d:ended_in_host_memory"] = m_res.kv_pool == "host"
    checks["d:one_drift_event"] = len(m_res.drift_events) == 1
    checks["d:one_probe_sweep"] = m_res.probe_sweeps == 1
    checks["d:one_migration_kept"] = (
        len(migs) == 1 and not migs[0]["rolled_back"]
        and (migs[0]["from_pool"], migs[0]["to_pool"]) == ("hbm", "host"))
    checks["d:tokens_equal_a"] = torch.equal(m_res.tokens, toks)
    checks["profiler_saw_the_card"] = (prof_prefill["kernels_a_call"] > 0
                                       and prof_decode["kernels_a_call"] > 0)
    sync()

    hbm_ms, host_ms = (statistics.median(hbm_steps),
                       statistics.median(host_steps))
    prof_prefill["device_busy_share"] = \
        prof_prefill["device_ms_a_call"] / prefill_ms
    prof_decode["device_busy_share"] = prof_decode["device_ms_a_call"] / hbm_ms
    roofline_line(f"{cfg.name} serve prefill", cfg, SERVE_PREFILL_SHAPE,
                  roof_prefill, prefill_ms, SERVE_BATCH)
    roofline_line(f"{cfg.name} serve decode", cfg, SERVE_DECODE_SHAPE,
                  roof_decode, hbm_ms, SERVE_BATCH)
    emit({"phase": "serve", "card": smi, "argv": SERVE_ARGV,
          "config": cfg.name, "n_params": sum(
              t.numel() for t in lm.leaves(params)),
          "kv_pool": res.kv_pool, "kv_cache_bytes": run.kv_bytes,
          "generate_s": run.seconds,
          "tokens_per_s": toks.numel() / run.seconds,
          "decode_tokens_per_s": SERVE_BATCH / (hbm_ms / 1e3),
          "prefill_ms": prefill_ms, "prefill_plain_ms": prefill_plain_ms,
          "decode_ms_per_step": {"hbm": hbm_ms, "host": host_ms},
          "decode_ms_steps": {"hbm": hbm_steps, "host": host_steps},
          "pcie_bytes_per_step": {
              "read": host_res.host_read_bytes / n_steps,
              "written": host_res.host_written_bytes / n_steps},
          "transposed_copy_bytes_per_prefill": copy_bytes,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "profile": {"prefill": prof_prefill, "decode_step": prof_decode},
          "launches": launched, "launches_by_instance": by_instance,
          "plain_calls": plain,
          "layer0": {"max_abs_err": l0_err, "scaled_err": l0_worst,
                     "norm_err": l0_norm},
          "logits": {"norm_err": logits_norm, "tol": logits_tol,
                     "argmax_equal": argmax_equal},
          "injected_delay_s": delay_s, "migrations": migs,
          "drift_events": [e.to_dict() for e in m_res.drift_events],
          "tokens_sample": toks[0, :16].tolist(),
          "seconds": time.perf_counter() - t_phase, "checks": checks})
    for k_, ok in checks.items():
        if not ok:
            fail(f"serve: check {k_}")
    return {"launches": launched["flash_attention"], "call": call}


# ---------------------------------------------------------------------------
# the moe, ssm and hybrid families served at full width
# ---------------------------------------------------------------------------

# (run, config, layers served): olmoe and mamba2 as published; jamba cut to
# one period of its published pattern (8 of 32 layers: 52 B parameters are
# 104 GB in bf16, more than the card's 80 GB)
FAMILY_RUNS = (("moe", "olmoe-1b-7b", None), ("ssm", "mamba2-370m", None),
               ("hybrid", "jamba-v0.1-52b", 8))
# the published widths: (name, layers, d_model, heads, kv heads, head dim,
# d_ff, vocab, (experts, top-k, expert d_ff), (d_state, d_conv, expand,
# ssm head dim, groups, chunk), parameter dtype)
FAMILY_WIDTHS = {
    "moe": ("olmoe-1b-7b", 16, 2048, 16, 16, 128, 0, 50304, (64, 8, 1024),
            None, torch.bfloat16),
    "ssm": ("mamba2-370m", 48, 1024, 0, 0, 0, 0, 50280, None,
            (128, 4, 2, 64, 1, 256), torch.bfloat16),
    "hybrid": ("jamba-v0.1-52b", 8, 4096, 32, 8, 128, 14336, 65536,
               (16, 2, 14336), (16, 4, 2, 64, 1, 256), torch.bfloat16),
}
FAMILY_PEAK_LIMIT = {"moe": 30e9}   # bytes: no (g, e, cap, d) buffer
# (b): at least this share of the (row, MoE layer) expert choices of the
# oracle's own router equal the served path's.  A choice flips where two
# experts are nearly tied: the two paths' residual streams differ by up to
# the logits' limit (about 3 % normalised at the last layer), which moves a
# router logit of order 1 by about 0.03, against a spacing of about 0.08
# between the 8th and 9th of 64 (0.3 between the 2nd and 3rd of 16), so at
# most about 40 % of the choices at the deepest layer, and the difference
# grows with depth from none at the first: about 20 % over all layers.  A
# wrong routing agrees almost never.  Read on the H100 at 700 W: 95.1 %
# (olmoe-1b-7b) and 97.3 % (jamba-v0.1-52b, 8 layers).
ROUTING_AGREE_MIN = 0.8


def width_tuple(cfg, params) -> tuple:
    moe, ssm = cfg.moe, cfg.ssm
    return (cfg.name, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size,
            moe and (moe.n_experts, moe.top_k, moe.d_ff_expert),
            ssm and (ssm.d_state, ssm.d_conv, ssm.expand, ssm.head_dim,
                     ssm.n_groups, ssm.chunk),
            params["embed"].dtype)


def part_shares(fn, parts) -> dict:
    """Device time of ``fn`` by part, from one ``torch.profiler`` trace of
    the card: each ``(module, name, label)`` function is wrapped so that a
    marker kernel (``torch.cuda._sleep(1)``, one ``spin_kernel``) runs
    before and after every call, and each kernel between a pair is the
    part's that the host recorded for that call.  A trace that lacks a
    marker's record is taken again, up to ``TRACES`` in all; the
    shares are the last trace's, and ``markers_seen`` says whether it was
    whole.  Late in this script a trace loses its first 31 kernel records
    (on an H100 80GB HBM3 at 700 W: of a mamba2 prefill, its first 30
    kernels and its first marker, in every trace; in a fresh process
    none): each trace therefore starts with ``TRACE_PADS`` small kernels
    of its own, waits ``TRACE_SETTLE_S`` on the host, the card idle, and
    only then runs the call; the pads, the kernels before that idle gap,
    are left out."""
    order: list = []
    saved = []
    for module, name, label in parts:
        real = getattr(module, name)
        saved.append((module, name, real))

        def marked(*a, _real=real, _label=label, **kw):
            order.append(_label)
            torch.cuda._sleep(1)
            out = _real(*a, **kw)
            torch.cuda._sleep(1)
            return out

        setattr(module, name, marked)
    by_trace = []
    pad = torch.zeros(1, device=DEV)
    try:
        fn()
        sync()
        for traces in range(1, TRACES + 1):
            order.clear()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(TRACE_PADS):
                    pad.add_(1.0)
                sync()
                time.sleep(TRACE_SETTLE_S)
                fn()
                sync()
            events = sorted(
                (e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
            # the call starts after the one idle gap among the first events
            gap_us = TRACE_SETTLE_S / 2 * 1e6
            first = next((i for i in range(1, min(len(events),
                                                   TRACE_PADS + 1))
                          if events[i].time_range.start
                          - events[i - 1].time_range.end > gap_us), 0)
            events = events[first:]
            at = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
            markers = len(at)
            by_trace.append([markers, len(events), at[:1], first])
            if markers == 2 * len(order):
                break
    finally:
        for module, name, real in saved:
            setattr(module, name, real)
    labels = [label for _, _, label in parts]
    ms = dict.fromkeys(labels, 0.0)
    total, inside, seen = 0.0, None, 0
    for e in events:
        if "spin_kernel" in e.name:
            inside = None if inside else order[seen // 2]
            seen += 1
            continue
        t = e.time_range.elapsed_us() / 1e3
        total += t
        if inside:
            ms[inside] += t
    return {"device_ms": total, "markers_seen": markers,
            "markers_expected": 2 * len(order), "traces": traces,
            # each trace's markers, kernels, its first marker's place and
            # the pads seen
            "by_trace": by_trace,
            "parts": {label: {"calls": order.count(label),
                              "device_ms": ms[label],
                              "share": ms[label] / total if total else None}
                      for label in labels if label in order}}


@contextlib.contextmanager
def routing(record: list, pinned=None):
    """``moe.route`` wrapped: each call's expert choices go into
    ``record``; with ``pinned`` (one (g, n, k) tensor a call, in call
    order) the choices are replaced by those, the gates taken from the
    call's own probabilities and renormalised."""
    real = moe_mod.route
    calls = iter(pinned or ())

    def route(params, xg, k):
        logits, probs, gates, ids = real(params, xg, k)
        record.append(ids)
        if pinned is None:
            return logits, probs, gates, ids
        want = next(calls)
        gates = torch.gather(probs, -1, want)
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        return logits, probs, gates, want

    moe_mod.route = route
    try:
        yield
    finally:
        moe_mod.route = real


def host_syncs(fn) -> dict:
    """Synchronisations of the host with the card while ``fn`` runs, as
    PyTorch's sync debug mode reports them (``.tolist()``, ``.item()``, a
    copy into host memory that waits), with the lines they came from."""
    sync()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sync()
    where: dict = {}
    for w in seen:
        if "synchroniz" in str(w.message):
            at = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            where[at] = where.get(at, 0) + 1
    return {"count": sum(where.values()), "where": where}


def family_run(arch: str, n_layers) -> tuple:
    """(a) of one family between a reset and a read of the counts:
    ``launch.serve.run`` on the published config, or, where its depth is
    cut, ``launch.serve.serve`` on the cut config with the same arguments.
    Returns the run, the command line (None for a cut config), the counts
    and the launches by instance."""
    argv = ["--arch", arch] + SERVE_ARGV[2:]
    counts.reset()
    if n_layers is None:
        run = serve_cli.run(argv)
    else:
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        run = serve_cli.serve(cfg, serve_cli.parser().parse_args(argv))
        argv = None
    sync()
    return run, argv, counts.snapshot(), dict(counts.INSTANCES)


def layer_params(cfg, params, i: int) -> tuple:
    """Layer ``i``'s parameters and the index ``lm.forward`` gives its
    block (its place in the period, or ``i`` in the tail)."""
    plan = blocks_mod.make_plan(cfg)
    if i < plan.n_full * plan.period:
        p = i % plan.period
        return lm._index(params["scan"][f"p{p}"], i // plan.period), p
    j = next(j for j in range(plan.n_tail) if plan.tail_layer_idx(j) == i)
    return params["tail"][f"t{j}"], i


def flash_against_plain(cfg, engine, prompts, max_len: int) -> dict:
    """(b) of ``serve`` at this family's head layout, on the served weights
    and prompts: the first attention layer's prefill attention (its q, k, v
    projected from the embedded prompts) against the same call with the
    plain version, at most one bf16 rounding an element; and the prefill's
    last-position logits against the same prefill with the plain version,
    its experts pinned to the kernel path's choices (an expert choice that
    flips at a near tie is no rounding), within :func:`serve_logits_tol`."""
    params = engine.params
    i0 = next(i for i in range(cfg.n_layers) if cfg.layer_kind(i) == "attn")
    lp, idx = layer_params(cfg, params, i0)
    h = rmsnorm(lm.embed_tokens(params, prompts, cfg), lp["ln1"],
                cfg.norm_eps)
    q, k, v = attention.project_qkv(
        lp["attn"], h, cfg=cfg, layer_idx=idx,
        positions=torch.arange(prompts.shape[1], device=DEV))
    akw = dict(window=attention.layer_window(cfg, idx),
               scale=cfg.head_dim ** -0.5)
    got = attention.prefill_attention(q, k, v, **akw)
    with plain_flash():
        want = attention.prefill_attention(q, k, v, **akw)
    worst, norm = scaled_errors(got, want)
    out = {"layer": i0, "q_shape": list(q.shape), "kv_shape": list(k.shape),
           "max_abs_err": diff(got, want), "scaled_err": worst,
           "norm_err": norm}
    del q, k, v, h, got, want
    prefill = make_prefill_step(cfg, engine.rules, max_len=max_len)
    ids: list = []
    with routing(ids):
        _, lg = prefill(params, prompts)
    with plain_flash(), routing([], ids or None):
        _, lw = prefill(params, prompts)
    out["logits"] = {"norm_err": float((lg - lw).norm() / lw.norm()),
                     "tol": serve_logits_tol(cfg),
                     "finite": bool(torch.isfinite(lg).all()),
                     "argmax_equal": int((lg.argmax(-1) == lw.argmax(-1))
                                         .sum())}
    return out


def teacher_forced(cfg, engine, prompts, toks, max_len: int) -> dict:
    """(b): the served logits, replayed step by step through the caches
    with (a)'s tokens, against one prefill-mode forward over prompt +
    generated tokens whose experts are pinned to the served choices (and
    the same forward unpinned, reported)."""
    params, n_new = engine.params, toks.shape[1]
    prefill = make_prefill_step(cfg, engine.rules, max_len=max_len)
    decode = make_decode_step(cfg, engine.rules)
    served_ids: list = []
    with routing(served_ids):
        caches, lg = prefill(params, prompts)
        served = [lg]
        for i in range(n_new - 1):
            caches, lg = decode(params, caches, toks[:, i:i + 1],
                                SERVE_PROMPT + i)
            served.append(lg)
    del caches
    served = torch.stack(served, dim=1)                 # (B, T, V)
    replay_equal = torch.equal(served.argmax(-1), toks)
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    # each MoE layer's served choices over the whole sequence
    per_layer = [torch.cat([served_ids[t * n_moe + j]
                            for t in range(n_new)], dim=1)
                 for j in range(n_moe)]
    del served_ids
    seq = torch.cat([prompts, toks[:, :-1]], dim=1)
    rows = slice(SERVE_PROMPT - 1, SERVE_PROMPT - 1 + n_new)

    def forced(pinned):
        own: list = []
        with routing(own, pinned):
            h, _, _ = lm.forward(params, seq, cfg=cfg, mode="prefill")
        logits = lm.unembed_logits(params, h[:, rows], cfg)
        agree = [(a[:, rows].sort(-1).values == p[:, rows].sort(-1).values
                  ).all(-1) for a, p in zip(own, per_layer)]
        return logits, agree

    want, agree = forced(per_layer or None)
    unpinned, _ = forced(None)
    # The limit on the normalised difference.  Per layer the two paths
    # differ by roundings only: the mixer's output (the flash kernel over
    # 2048 keys against 2079, or plain decode attention against the kernel;
    # the Mamba step against the chunked scan, both float32, then one bf16
    # rounding) and the FFN's or the experts' (bf16 products over other row
    # counts, the same sums in another order: one rounding; the gates, from
    # each stream's own router, move with the stream).  That is
    # serve_logits_tol's case: a rounding for the mixer and one for the FFN
    # where the layer has one, in two streams: sqrt(n_layers)·2^-7 with
    # every layer's FFN (0.0313 at olmoe's 16 layers, 0.0221 at jamba's 8),
    # sqrt(2·48)·2^-8 = 0.0383 at mamba2's 48, which have none.
    tol = serve_logits_tol(cfg)
    norm_err = float((served - want).norm() / want.norm())
    row_err = ((served - want).norm(dim=-1) / want.norm(dim=-1)).flatten()
    out = {"norm_err": norm_err, "tol": tol,
           "row_err_max": float(row_err.max()),
           "norm_err_unpinned": float((served - unpinned).norm()
                                      / unpinned.norm()),
           "greedy_agree_share": float(
               (served.argmax(-1) == want.argmax(-1)).float().mean()),
           "greedy_agree_share_unpinned": float(
               (served.argmax(-1) == unpinned.argmax(-1)).float().mean()),
           "routing_agree_share": (float(torch.stack(agree).float().mean())
                                   if agree else None),
           "rows": int(row_err.numel()),
           "finite": bool(torch.isfinite(served).all()),
           "replay_tokens_equal_a": replay_equal}
    return out


def family_placement(cfg, engine, prompts, toks, kv_bytes: int) -> dict:
    """(c): the cache in device memory and in pinned host memory, the timed
    loop; every cache tensor pinned at every step and the same tensor from
    step to step, and still pinned after the loop."""
    hbm_res, hbm_steps = timed_generate(engine, prompts)
    host_engine = ServeEngine(cfg, engine.params, engine.rules,
                              ServeConfig(kv_placement="host"),
                              advisor=engine.advisor,
                              pool_mgr=engine.pool_mgr)
    seen, real_decode = [], host_engine._decode

    def spy(p, caches, tok, pos):
        seen.append((caches, [(t.is_pinned(), t.data_ptr())
                              for t in lm.leaves(caches)]))
        return real_decode(p, caches, tok, pos)

    host_engine._decode = spy
    host_res, host_steps = timed_generate(host_engine, prompts)
    sync()
    n_steps = SERVE_NEW - 1
    last = seen[-1][0]
    state = sum(t.numel() * t.element_size()
                for name, t in lm.named_leaves(last)
                if name in ("ssm", "conv"))
    slots = sum(t.numel() * t.element_size() // t.shape[-3]
                for name, t in lm.named_leaves(last) if name in ("k", "v"))
    checks = {
        "c:hbm_timed_tokens_equal_a": torch.equal(hbm_res.tokens, toks),
        "c:host_pool": host_res.kv_pool == "host",
        "c:host_tokens_equal_a": torch.equal(host_res.tokens, toks),
        "c:cache_pinned_every_step": all(
            all(p for p, _ in leaves) for _, leaves in seen)
        and len(seen) == n_steps,
        "c:same_tensors_every_step": all(
            [ptr for _, ptr in leaves] == [ptr for _, ptr in seen[0][1]]
            for _, leaves in seen),
        "c:cache_pinned_after_the_loop": all(
            t.is_pinned() for t in lm.leaves(last)),
        "c:pcie_reads_the_whole_cache_a_step":
            host_res.host_read_bytes == n_steps * kv_bytes,
        "c:pcie_writes_state_whole_and_slots":
            host_res.host_written_bytes == n_steps * (state + slots),
        "c:hbm_moves_nothing_over_pcie":
            hbm_res.host_read_bytes == hbm_res.host_written_bytes == 0}
    del seen, last, host_engine
    return {"hbm_steps": hbm_steps, "host_steps": host_steps,
            "pcie_bytes_per_step": {
                "read": host_res.host_read_bytes / n_steps,
                "written": host_res.host_written_bytes / n_steps},
            "state_bytes": state, "checks": checks}


def family_profile(cfg, engine, prompts, toks, max_len: int,
                   step_ms: float) -> dict:
    """(d): one prefill and one decode step under ``torch.profiler``, the
    host's syncs of each, the prefill's peak memory, and the shares of the
    device time that the MoE layers and the SSD scan take in a prefill and
    a step (:func:`part_shares`)."""
    params = engine.params
    prefill = make_prefill_step(cfg, engine.rules, max_len=max_len)
    decode = make_decode_step(cfg, engine.rules)
    sync()
    torch.cuda.reset_peak_memory_stats()
    prefill_ms = time_ms(lambda: prefill(params, prompts), 3)
    peak = torch.cuda.max_memory_allocated()
    prof = {"prefill": profile_calls(lambda: prefill(params, prompts), 1)}
    prof["prefill"]["device_busy_share"] = \
        prof["prefill"]["device_ms_a_call"] / prefill_ms
    caches, _ = prefill(params, prompts)
    tok = toks[:, :1].contiguous()
    step = lambda: decode(params, caches, tok, SERVE_PROMPT)  # noqa: E731
    prof["decode_step"] = profile_calls(step, 2)
    prof["decode_step"]["device_busy_share"] = \
        prof["decode_step"]["device_ms_a_call"] / step_ms
    syncs = {"prefill": host_syncs(lambda: prefill(params, prompts)),
             "decode_step": host_syncs(step)}
    # the roofline's counts of the same two calls
    roof = {"prefill": count_call(prefill, params, prompts),
            "decode_step": count_call(decode, params, caches, tok,
                                      SERVE_PROMPT)}

    shares = {
        "prefill": part_shares(lambda: prefill(params, prompts), (
            (blocks_mod, "moe_apply", "moe"),
            (mamba_mod, "ssd_chunked", "ssd"))),
        "decode_step": part_shares(step, (
            (blocks_mod, "moe_apply", "moe"),
            (mamba_mod, "ssd_step", "ssd")))}
    del caches
    sync()
    return {"prefill_ms": prefill_ms, "prefill_peak_bytes": peak,
            "profile": prof, "host_syncs": syncs, "device_shares": shares,
            "roofline": roof}


# ---------------------------------------------------------------------------
# the families' layers split over a model axis: each rank's share on the
# served weights, its blocks cut by the engine's own function, the ranks'
# partials summed here as the all-reduces would sum them
# ---------------------------------------------------------------------------

# the model axes: each divides olmoe's 64 experts and 16 KV heads, mamba2's
# 32 SSM heads, jamba's 16 experts, 128 SSM heads and 8 KV heads
SPLIT_TP = (2, 4, 8)
# (c): the configurations at full depth whose rank bytes are counted, and
# their model axes
SPLIT_BYTES = (("jamba-v0.1-52b", (4, 8)), ("phi3.5-moe-42b-a6.6b", (4, 8)))
# (d): the model axis whose ranks' MoE shares are timed
SPLIT_TIME_TP = 4


def split_rules(cfg, tp: int):
    from repro_torch.launch.mesh import Mesh
    return make_rules(cfg, Mesh(("data", "model"), (1, tp)),
                      global_batch=SERVE_BATCH, shape_kind="decode")


def rank_layer(cfg, rules, lp, sub: str, r: int) -> dict:
    """Rank ``r``'s blocks of one layer's ``sub`` ("moe", "ssm") by the
    engine's :func:`rank_block` (the layer's leaves are unstacked, so
    their path is a tail layer's)."""
    coords = {"data": 0, "model": r}
    return {k: rank_block(cfg, rules, f"tail/t0/{sub}/{k}", v, coords)
            for k, v in lp[sub].items()}


def split_errors(parts, want, carried=None) -> dict:
    """The ranks' partials summed in float32 against the whole layer's
    output: the largest |sum - want| / (BF16_RTOL sum|partial| + carried +
    BWD_BF16_FLOOR max|want|), at most 1 (each partial and the whole one
    bf16 rounding; with |want| alone a sum of rounded partials fails by
    construction, as ``train_tp``'s (b) shows; ``carried``: what the inputs
    of the last product, where they differ from the whole's, carry into
    it), the largest |sum - want|, bit-equality, finiteness."""
    total = torch.zeros(want.shape, dtype=torch.float32, device=want.device)
    mag = torch.zeros_like(total)
    for p in parts:
        total += p.float()
        mag += p.float().abs()
    if carried is not None:
        mag += carried / BF16_RTOL
    wf = want.float()
    d = (total - wf).abs()
    scaled = d / (BF16_RTOL * mag + BWD_BF16_FLOOR * float(wf.abs().max()))
    return {"scaled_err": float(scaled.max()), "max_abs_err": float(d.max()),
            "over_limit": int((scaled > 1).sum()),
            "bit_equal": torch.equal(total.to(want.dtype), want),
            "finite": bool(torch.isfinite(total).all())}


def within_a_rounding(got, want) -> bool:
    """``got`` (bf16) within one bf16 rounding of ``want`` in norm:
    ||got - want|| <= 2^-8 ||want||.  Elementwise a GEMM output can move
    by more than a step where its terms cancel, when cuBLAS sums them in
    another order; a block cut from the wrong columns or heads moves by
    about ||want||."""
    g, w = got.float(), want.float()
    return float((g - w).norm()) <= 2.0 ** -8 * float(w.norm())


@contextlib.contextmanager
def expert_segments(record: list):
    """``moe._expert_ffn`` wrapped: each expert GEMM segment's rows go
    into ``record``."""
    real = moe_mod._expert_ffn

    def ffn(seg, *a):
        record.append(int(seg.shape[0]))
        return real(seg, *a)

    moe_mod._expert_ffn = ffn
    try:
        yield
    finally:
        moe_mod._expert_ffn = real


def moe_split_check(cfg, lp, inputs: dict) -> dict:
    """(a) one MoE layer, whole and as each rank of every model axis of
    ``SPLIT_TP`` runs it (``moe_apply`` with ``collectives.rank_view``: its
    ``E/tp`` experts, every token routed), at each input of ``inputs``
    (the prefill's and a decode step's): the partials' sum within
    :func:`split_errors`' limit, and the ranks' expert GEMM segments and
    rows adding up to the whole layer's."""
    out = {}
    e = cfg.moe.n_experts
    for label, x in inputs.items():
        segs: list = []
        with expert_segments(segs):
            want, _ = moe_mod.moe_apply(lp["moe"], x, cfg, dropless=True)
        rec = {"whole_segments": len(segs), "whole_rows": sum(segs)}
        for tp in SPLIT_TP:
            rules = split_rules(cfg, tp)
            parts, rsegs, rrows, experts = [], [], [], []
            for r in range(tp):
                loc = rank_layer(cfg, rules, lp, "moe", r)
                experts.append(int(loc["we_in"].shape[0]))
                seen: list = []
                with expert_segments(seen):
                    y, _ = moe_mod.moe_apply(
                        loc, x, cfg, dropless=True,
                        tp=collectives.rank_view(rules, r))
                parts.append(y)
                rsegs.append(len(seen))
                rrows.append(sum(seen))
                del loc
            rec[f"tp{tp}"] = dict(split_errors(parts, want),
                                  experts_a_rank=experts, segments=rsegs,
                                  rows=rrows,
                                  experts_ok=experts == [e // tp] * tp,
                                  segments_add_up=(sum(rsegs)
                                                   == len(segs)),
                                  rows_add_up=sum(rrows) == sum(segs))
            del parts
        out[label] = rec
        del want
    return out


def mamba_split_check(cfg, lp, h, h1) -> dict:
    """(a) one Mamba layer: the whole prefill at ``h`` and the whole decode
    step at ``h1`` from its cache, then each rank of every model axis of
    ``SPLIT_TP``: ``mamba.mamba_mix`` on its blocks, the float32 sums of
    squares summed over the ranks (the first all-reduce), ``mamba_out``
    given the total, the partials summed (the second) within
    :func:`split_errors`' limit.  The decode step starts from the whole
    prefill's state and conv cache cut by the channel map
    (``mamba.head_columns``); its new state and conv tail must be
    bit-equal to the whole step's rows of the rank's heads and channels.
    The prefill's are reported, and whether each rank's projection
    (``x @`` its ``w_zxbcdt`` columns) is bit-equal to the whole
    projection's columns."""
    want, cache = mamba_mod.mamba_layer(lp["ssm"], h, cfg=cfg,
                                        mode="prefill")
    want1, cache1 = mamba_mod.mamba_layer(lp["ssm"], h1, cfg=cfg,
                                          mode="decode", cache=cache)
    nh = cfg.ssm.n_heads(cfg.d_model)
    out = {}
    for tp in SPLIT_TP:
        rules = split_rules(cfg, tp)
        locs = [rank_layer(cfg, rules, lp, "ssm", r) for r in range(tp)]
        views = [collectives.rank_view(rules, r) for r in range(tp)]
        cols = [mamba_mod.head_columns(cfg, tp, r) for r in range(tp)]
        rec = {"heads_a_rank": [c["heads"] for c in cols],
               "conv_channels_a_rank": [sum(b - a for a, b in c["conv"])
                                        for c in cols]}
        for label, x, cache_in, new_whole, y_whole in (
                ("prefill", h, None, cache, want),
                ("decode", h1, cache, cache1, want1)):
            mixed = []
            for r in range(tp):
                c0, n = cols[r]["head0"], cols[r]["heads"]
                cr = None
                if cache_in is not None:
                    cr = {"ssm": cache_in["ssm"][:, c0:c0 + n],
                          "conv": mamba_mod.take_columns(cache_in["conv"],
                                                         cols[r]["conv"])}
                mixed.append(mamba_mod.mamba_mix(locs[r], x, cfg=cfg,
                                                 mode=label, cache=cr,
                                                 tp=views[r]))
            sumsq = mixed[0][1]
            for m in mixed[1:]:
                sumsq = sumsq + m[1]
            parts = [mamba_mod.mamba_out(locs[r], mixed[r][0], sumsq, cfg)
                     for r in range(tp)]
            st_eq, conv_eq, st_err, proj_eq = True, True, 0.0, True
            hist_eq = True
            proj_diff = gated_diff = norm_diff = 0
            proj_near = norm_near = True
            proj = torch.einsum("bsd,de->bse", x, lp["ssm"]["w_zxbcdt"])
            g_whole, ss_whole, _ = mamba_mod.mamba_mix(
                lp["ssm"], x, cfg=cfg, mode=label, cache=cache_in)
            yn_whole = mamba_mod.mamba_norm(lp["ssm"], g_whole, ss_whole, cfg)
            carried = torch.zeros(y_whole.shape, dtype=torch.float32,
                                  device=DEV)
            hp = cfg.ssm.head_dim
            for r in range(tp):
                c0, n = cols[r]["head0"], cols[r]["heads"]
                pr = torch.einsum("bsd,de->bse", x, locs[r]["w_zxbcdt"])
                pw = mamba_mod.take_columns(proj, cols[r]["proj"])
                proj_eq &= torch.equal(pr, pw)
                proj_diff += int((pr != pw).sum())
                proj_near &= within_a_rounding(pr, pw)
                cut = slice(c0 * hp, (c0 + n) * hp)
                gated_diff += int((mixed[r][0] != g_whole[..., cut]).sum())
                # the normalised block's elements that round to another
                # bf16 value than the whole's (the sum of squares summed in
                # another order, or a projection of other bits), carried
                # into the output product exactly
                yn = mamba_mod.mamba_norm(locs[r], mixed[r][0], sumsq, cfg)
                norm_diff += int((yn != yn_whole[..., cut]).sum())
                norm_near &= within_a_rounding(yn, yn_whole[..., cut])
                carried += (yn.float() - yn_whole[..., cut].float()).abs() @ \
                    locs[r]["w_ssm_out"].float().abs()
                del pr, pw, yn
                new = mixed[r][2]
                ws = new_whole["ssm"][:, c0:c0 + n]
                wc = mamba_mod.take_columns(new_whole["conv"],
                                            cols[r]["conv"])
                st_eq &= torch.equal(new["ssm"], ws)
                conv_eq &= torch.equal(new["conv"], wc)
                # the tail's rows before the new token's: the cache's cut
                hist_eq &= torch.equal(new["conv"][:, :-x.shape[1]],
                                       wc[:, :-x.shape[1]])
                st_err = max(st_err, diff(new["ssm"], ws))
            rec[label] = dict(split_errors(parts, y_whole, carried),
                              plain_limit=split_errors(parts, y_whole),
                              state_bit_equal=st_eq, conv_bit_equal=conv_eq,
                              conv_history_bit_equal=hist_eq,
                              state_max_abs_err=st_err,
                              projection_bit_equal=proj_eq,
                              projection_differing=proj_diff,
                              projection_within_a_rounding=proj_near,
                              gated_differing=gated_diff,
                              normalised_differing=norm_diff,
                              normalised_within_a_rounding=norm_near,
                              sumsq_max_rel_err=float(
                                  ((sumsq - ss_whole).abs()
                                   / ss_whole.abs()).max()))
            del mixed, parts, proj, g_whole, ss_whole, yn_whole, carried
        rec["heads_ok"] = rec["heads_a_rank"] == [nh // tp] * tp
        out[f"tp{tp}"] = rec
        del locs
    del want, cache, want1, cache1
    return out


def split_heads_check(cfg, params, prompts) -> dict:
    """(b) the first attention layer's q, k, v of the serve prefill cut as
    the ranks of every model axis of ``SPLIT_TP`` cut them
    (:func:`head_blocks`): kernel #12 on each rank's block bit-equal to its
    head slice of the whole call."""
    i0 = next(i for i in range(cfg.n_layers) if cfg.layer_kind(i) == "attn")
    lp, idx = layer_params(cfg, params, i0)
    h = rmsnorm(lm.embed_tokens(params, prompts, cfg), lp["ln1"],
                cfg.norm_eps)
    q, k, v = attention.project_qkv(
        lp["attn"], h, cfg=cfg, layer_idx=idx,
        positions=torch.arange(prompts.shape[1], device=DEV))
    akw = dict(window=attention.layer_window(cfg, idx),
               scale=cfg.head_dim ** -0.5)
    whole = attention.prefill_attention(q, k, v, **akw)
    recs = []
    for tp in SPLIT_TP:
        mode, ranks = head_blocks(cfg, tp)
        for i, (h0, hl, kv_heads) in enumerate(ranks):
            got = attention.prefill_attention(
                q[:, :, h0:h0 + hl], k[:, :, kv_heads], v[:, :, kv_heads],
                **akw)
            recs.append({"tp": tp, "mode": mode, "rank": i,
                         "q_heads": [h0, h0 + hl], "kv_heads": kv_heads,
                         "bit_equal": torch.equal(
                             got, whole[:, :, h0:h0 + hl])})
            del got
    del q, k, v, whole, h
    return {"layer": i0, "blocks": recs,
            "every_block_bit_equal": (len(recs) == sum(SPLIT_TP) and all(
                b["bit_equal"] for b in recs))}


def split_times(cfg, lp, h) -> dict:
    """(d) printed, not checked: the whole MoE layer at the prefill input
    and each rank's share of it at a model axis of ``SPLIT_TIME_TP``."""
    rules = split_rules(cfg, SPLIT_TIME_TP)
    out = {"whole_ms": time_ms(
        lambda: moe_mod.moe_apply(lp["moe"], h, cfg, dropless=True), 3)}
    ranks = []
    for r in range(SPLIT_TIME_TP):
        loc = rank_layer(cfg, rules, lp, "moe", r)
        view = collectives.rank_view(rules, r)
        ranks.append(time_ms(lambda: moe_mod.moe_apply(
            loc, h, cfg, dropless=True, tp=view), 3))
        del loc
    out["rank_ms"] = ranks
    out["slowest_rank_over_whole"] = max(ranks) / out["whole_ms"]
    return out


def family_splits(cfg, engine, prompts, toks) -> tuple:
    """The new part of ``serve_families`` on the served engine: (a) the
    first MoE and the first Mamba layer split over every model axis of
    ``SPLIT_TP`` at the serve prefill's input (4 x 2048: the embedded
    prompts under the layer's norm) and at one decode step's (the first
    served token's), (b) #12 on each rank's head block, (d) the MoE
    shares' times.  Returns (record, checks, #12's launches)."""
    params = engine.params
    rec, checks, scaled = {}, {}, []
    x = lm.embed_tokens(params, prompts, cfg)
    x1 = lm.embed_tokens(params, toks[:, :1], cfg)
    i_moe = next((i for i in range(cfg.n_layers) if cfg.layer_is_moe(i)),
                 None)
    i_ssm = next((i for i in range(cfg.n_layers)
                  if cfg.layer_kind(i) == "ssm"), None)
    if i_moe is not None:
        lp, _ = layer_params(cfg, params, i_moe)
        h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        h1 = rmsnorm(x1, lp["ln2"], cfg.norm_eps)
        m = moe_split_check(cfg, lp, {"prefill": h, "decode": h1})
        rec["moe"] = dict(layer=i_moe, **m)
        for label, r in m.items():
            for tp in SPLIT_TP:
                t = r[f"tp{tp}"]
                scaled.append(t["scaled_err"])
                checks[f"a:moe_{label}_tp{tp}_within_limit"] = \
                    t["finite"] and t["scaled_err"] <= 1.0
                checks[f"a:moe_{label}_tp{tp}_segments_add_up"] = \
                    t["segments_add_up"] and t["rows_add_up"]
                checks[f"a:moe_{label}_tp{tp}_experts_a_rank"] = \
                    t["experts_ok"]
        rec["times"] = split_times(cfg, lp, h)
        del h, h1
    if i_ssm is not None:
        lp, _ = layer_params(cfg, params, i_ssm)
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        h1 = rmsnorm(x1, lp["ln1"], cfg.norm_eps)
        m = mamba_split_check(cfg, lp, h, h1)
        rec["mamba"] = dict(layer=i_ssm, **m)
        for tp in SPLIT_TP:
            t = m[f"tp{tp}"]
            checks[f"a:mamba_tp{tp}_heads_a_rank"] = t["heads_ok"]
            for label in ("prefill", "decode"):
                u = t[label]
                scaled.append(u["scaled_err"])
                checks[f"a:mamba_{label}_tp{tp}_within_limit"] = \
                    u["finite"] and u["scaled_err"] <= 1.0
                checks[f"a:mamba_{label}_tp{tp}_inputs_within_a_rounding"] \
                    = (u["projection_within_a_rounding"]
                       and u["normalised_within_a_rounding"])
            # cuBLAS may take another kernel for a rank's narrower
            # projection; where it gives the whole GEMM's bits, the new
            # state and conv tail are the whole step's bits
            u = t["decode"]
            checks[f"a:mamba_decode_tp{tp}_state_bit_equal"] = \
                not u["projection_bit_equal"] or (u["state_bit_equal"]
                                                  and u["conv_bit_equal"])
            checks[f"a:mamba_decode_tp{tp}_conv_history_bit_equal"] = \
                u["conv_history_bit_equal"]
        del h, h1
    del x, x1
    launches = 0
    if cfg.n_heads:
        counts.reset()
        rec["heads"] = split_heads_check(cfg, params, prompts)
        sync()
        launched, plain = counts.snapshot()
        launches = launched["flash_attention"]
        checks["b:every_block_bit_equal"] = \
            rec["heads"]["every_block_bit_equal"]
        checks["b:one_launch_a_block_and_the_whole"] = \
            launches == sum(SPLIT_TP) + 1 and not any(plain.values())
    rec["largest_scaled_err"] = max(scaled) if scaled else None
    return rec, checks, launches


def split_bytes(smi: str) -> dict:
    """(c) the bytes a rank holds on (1, tp) for the configurations of
    ``SPLIT_BYTES`` at full depth, from ``meta`` structs (nothing is
    allocated): its parameter blocks (the engine's :func:`rank_params`)
    and its serve caches (``lm.rank_cache_struct``, batch 4 x 2048 + 32,
    bf16), beside the whole model's and the card's memory; a rank's
    parameters at most whole/tp plus the leaves the rules replicate and
    the B/C columns every rank holds."""
    total = torch.cuda.get_device_properties(0).total_memory
    rows, checks = [], {}
    for arch, tps in SPLIT_BYTES:
        cfg = get_config(arch)
        struct = lm.param_struct(cfg)
        nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
        whole = sum(nbytes(t) for t in lm.leaves(struct))
        cache_whole = sum(nbytes(t) for t in lm.leaves(lm.cache_struct(
            cfg, SERVE_BATCH, SERVE_PROMPT + SERVE_NEW)))
        for tp in tps:
            rules = split_rules(cfg, tp)
            specs = dict(tree_mod.flatten_with_path(
                lm.param_specs(rules, struct)))
            replicated = 0
            for p, t in tree_mod.flatten_with_path(struct):
                if not collectives.spec_axes(specs[p]):
                    replicated += nbytes(t)
                elif p.split("/")[-1] in ("w_zxbcdt", "conv_w", "conv_b"):
                    replicated += (nbytes(t) // t.shape[-1] * 2
                                   * cfg.ssm.d_state * cfg.ssm.n_groups)
            ranks = [sum(nbytes(t) for t in lm.leaves(rank_params(
                cfg, rules, struct, {"data": 0, "model": r})))
                for r in range(tp)]
            cache = sum(nbytes(t) for t in lm.leaves(lm.rank_cache_struct(
                cfg, SERVE_BATCH, SERVE_PROMPT + SERVE_NEW, torch.bfloat16,
                rules)))
            row = {"config": cfg.name, "mesh": [1, tp],
                   "whole_param_bytes": whole,
                   "whole_cache_bytes": cache_whole,
                   "rank_param_bytes": ranks, "rank_cache_bytes": cache,
                   "replicated_bytes": replicated,
                   "rank_total_over_card": (max(ranks) + cache) / total,
                   "whole_total_over_card": (whole + cache_whole) / total,
                   "card_bytes": total}
            rows.append(row)
            checks[f"c:{cfg.name}_tp{tp}_within_share"] = \
                max(ranks) <= whole / tp + replicated
            checks[f"c:{cfg.name}_tp{tp}_fits_the_card"] = \
                max(ranks) + cache < total
        del struct
    return {"phase": "serve_experts_bytes", "card": smi, "rows": rows,
            "checks": checks}


def phase_serve_families(smi: str) -> int:
    """The moe, ssm and hybrid families through ``launch.serve.run`` at full
    width in bf16, random weights from seed 0, batch 4 x prompt 2048 + 32
    new tokens, as ``serve``: olmoe-1b-7b (16 layers), mamba2-370m (48),
    jamba-v0.1-52b cut to one period (8).  For each: (a) the widths, one
    ``wgmma_bf16`` flash launch an attention layer of the prefill, no plain
    version, the tokens, the advisor's pool; (b) the served logits against
    one prefill-mode forward (:func:`teacher_forced`); (c) the cache in
    pinned host memory (:func:`family_placement`); (d) the profile, host
    syncs, device shares and peak memory (:func:`family_profile`); then
    the served weights' MoE and Mamba layers split over model axes of 2, 4
    and 8 (:func:`family_splits`), and after the runs the bytes a rank
    holds (:func:`split_bytes`).  Returns the flash kernel's launches over
    the three runs, and those of the split part's head blocks."""
    t_phase = time.perf_counter()
    max_len = SERVE_PROMPT + SERVE_NEW
    flash_launches = split_launches = 0
    for kind, arch, n_layers in FAMILY_RUNS:
        t_run = time.perf_counter()
        checks = {}
        run, argv, (launched, plain), by_instance = family_run(arch,
                                                               n_layers)
        cfg, engine, res = run.cfg, run.engine, run.result
        prompts, toks, params = run.prompts, res.tokens, engine.params
        n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
        n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
        advised = choose_kv_pool(cfg, SERVE_BATCH, max_len,
                                 advisor=engine.advisor, scfg=engine.scfg,
                                 pool_mgr=engine.pool_mgr)
        checks["a:full_width_bf16"] = \
            width_tuple(cfg, params) == FAMILY_WIDTHS[kind]
        checks["a:flash_once_an_attention_layer"] = \
            launched["flash_attention"] == n_attn
        checks["a:flash_on_wgmma_bf16"] = \
            by_instance["flash_attention:wgmma_bf16"] == n_attn
        checks["a:no_plain_version"] = not any(plain.values())
        checks["a:tokens_shaped"] = \
            tuple(toks.shape) == (SERVE_BATCH, SERVE_NEW)
        checks["a:tokens_in_vocab"] = bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all())
        checks["a:kv_pool_is_the_advisors"] = res.kv_pool == advised
        flash_launches += launched["flash_attention"]

        flash = None
        if n_attn:
            flash = flash_against_plain(cfg, engine, prompts, max_len)
            checks["b:first_attention_layer_one_bf16_rounding"] = \
                flash["scaled_err"] <= 1.0
            checks["b:flash_logits_finite"] = flash["logits"]["finite"]
            checks["b:flash_logits_within_norm_tol"] = \
                flash["logits"]["norm_err"] <= flash["logits"]["tol"]
        forced = teacher_forced(cfg, engine, prompts, toks, max_len)
        checks["b:logits_finite"] = forced["finite"]
        checks["b:replay_tokens_equal_a"] = forced["replay_tokens_equal_a"]
        checks["b:logits_within_norm_tol"] = \
            forced["norm_err"] <= forced["tol"]
        if forced["routing_agree_share"] is not None:
            checks["b:routing_mostly_agrees"] = \
                forced["routing_agree_share"] >= ROUTING_AGREE_MIN

        placed = family_placement(cfg, engine, prompts, toks, run.kv_bytes)
        checks.update(placed.pop("checks"))
        hbm_ms = statistics.median(placed["hbm_steps"])
        host_ms = statistics.median(placed["host_steps"])

        prof = family_profile(cfg, engine, prompts, toks, max_len, hbm_ms)
        roof = prof.pop("roofline")
        roofline_line(f"{cfg.name} serve prefill", cfg, SERVE_PREFILL_SHAPE,
                      roof["prefill"], prof["prefill_ms"], SERVE_BATCH)
        roofline_line(f"{cfg.name} serve decode", cfg, SERVE_DECODE_SHAPE,
                      roof["decode_step"], hbm_ms, SERVE_BATCH)
        checks["d:profiler_saw_the_card"] = all(
            p["kernels_a_call"] > 0 for p in prof["profile"].values())
        # one sync a MoE layer (its segment sizes), none elsewhere
        checks["d:decode_syncs_one_a_moe_layer"] = \
            prof["host_syncs"]["decode_step"]["count"] == n_moe
        checks["d:every_part_call_marked"] = all(
            sh["markers_seen"] == sh["markers_expected"]
            for sh in prof["device_shares"].values())
        if kind in FAMILY_PEAK_LIMIT:
            checks["d:prefill_peak_below_limit"] = \
                prof["prefill_peak_bytes"] < FAMILY_PEAK_LIMIT[kind]

        # the layers split over model axes of 2, 4 and 8 on these weights
        t_split = time.perf_counter()
        split, split_checks, launches = family_splits(cfg, engine, prompts,
                                                      toks)
        split_launches += launches
        emit({"phase": "serve_experts", "run": kind, "card": smi,
              "config": cfg.name, "model_axes": list(SPLIT_TP), **split,
              "flash_launches": launches, "checks": split_checks,
              "seconds": time.perf_counter() - t_split})
        for k_, ok in split_checks.items():
            if not ok:
                fail(f"serve_experts {kind}: check {k_}")
        del split

        emit({"phase": "serve_families", "run": kind, "card": smi,
              "argv": argv, "n_layers_cut_from": (
                  get_config(arch).n_layers if n_layers else None),
              "config": cfg.name, "widths": [str(w) for w in
                                             width_tuple(cfg, params)],
              "n_params": sum(t.numel() for t in lm.leaves(params)),
              "attention_layers": n_attn,
              "moe_layers": n_moe,
              "kv_pool": res.kv_pool, "kv_cache_bytes": run.kv_bytes,
              "generate_s": run.seconds,
              "tokens_per_s": toks.numel() / run.seconds,
              "decode_tokens_per_s": SERVE_BATCH / (hbm_ms / 1e3),
              "prefill_ms": prof["prefill_ms"],
              "decode_ms_per_step": {"hbm": hbm_ms, "host": host_ms},
              "decode_ms_steps": {"hbm": placed["hbm_steps"],
                                  "host": placed["host_steps"]},
              "pcie_bytes_per_step": placed["pcie_bytes_per_step"],
              "state_bytes": placed["state_bytes"],
              "prefill_peak_bytes": prof["prefill_peak_bytes"],
              "peak_limit_bytes": FAMILY_PEAK_LIMIT.get(kind),
              "host_syncs": prof["host_syncs"],
              "device_shares": prof["device_shares"],
              "profile": prof["profile"],
              "launches": launched, "launches_by_instance": by_instance,
              "plain_calls": plain, "flash_against_plain": flash,
              "teacher_forced": forced,
              "routing_agree_min": ROUTING_AGREE_MIN,
              "tokens_sample": toks[0, :16].tolist(),
              "seconds": time.perf_counter() - t_run, "checks": checks})
        for k_, ok in checks.items():
            if not ok:
                fail(f"serve_families {kind}: check {k_}")
        del run, engine, params, res, prompts, toks, prof, placed, forced
        gc.collect()
        torch.cuda.empty_cache()
    sizes = split_bytes(smi)
    emit(sizes)
    for k_, ok in sizes["checks"].items():
        if not ok:
            fail(f"serve_experts bytes: check {k_}")
    emit({"phase": "serve_families_done",
          "seconds": time.perf_counter() - t_phase})
    return flash_launches, split_launches


# ---------------------------------------------------------------------------
# phase 14: training — the flash backward kernel against its plain version,
# then repro_torch.launch.train at qwen2-1.5b's full width and depth
# ---------------------------------------------------------------------------

# (a) the backward kernel's cases: label, b, h, kvh, sq, sk, d, causal,
# window, dtype.  The train shape (train_4k's sequence, the batch cut to
# 2 a microbatch), gemma3-1b's local layer at its width, then float32,
# ragged, Sq != Sk and rows with no key at small sizes
BWD_CASES = [
    ("qwen2-1.5b train, causal", 2, 12, 2, 4096, 4096, 128, True, 0,
     torch.bfloat16),
    ("gemma3-1b local, window 512", 2, 4, 1, 4096, 4096, 256, True, 512,
     torch.bfloat16),
    ("f32 causal GQA", 1, 4, 2, 512, 512, 64, True, 0, torch.float32),
    ("f32 window D 256", 1, 4, 1, 320, 320, 256, True, 64, torch.float32),
    ("ragged bf16", 1, 4, 2, 200, 200, 128, True, 0, torch.bfloat16),
    ("ragged f32 D 16", 2, 2, 1, 77, 77, 16, True, 0, torch.float32),
    ("Sq < Sk bf16", 1, 4, 2, 200, 328, 128, True, 0, torch.bfloat16),
    ("Sq > Sk f32 D 32", 1, 4, 2, 328, 200, 32, False, 0, torch.float32),
    ("rows with no key f32", 1, 2, 1, 200, 16, 32, False, 8, torch.float32),
    ("rows with no key bf16", 1, 2, 1, 200, 16, 64, False, 8,
     torch.bfloat16),
]
# limits, stated before the run: float32 gradients within 1e-5 of the
# largest |grad| of the plain version on the same inputs (the sums are
# grouped differently); bf16 gradients against the float32 oracle (the
# plain backward on the same bf16 values upcast) elementwise within
# BF16_RTOL |want| + BF16_GRAD_FLOOR max|want|: the kernel computes in
# float32 as the oracle does and rounds once to bf16 (at most 2^-9 of the
# value, the limit 2^-7), the floor for elements that cancel to near zero
BWD_F32_REL = 1e-5
BWD_BF16_FLOOR = 2.0 ** -12
# the products the tensor-core backward executes a head and admitted pair,
# against the 10 * D counted: the scores twice, p and ds as two bf16 terms
# (csrc/flash_attention_bwd_tc.cu); at D 256 both warpgroups compute the
# scores of a step
BWD_TC_EXECUTED_PER_D = {16: 20, 32: 20, 64: 20, 128: 20, 256: 28}
# the forward kernels' log-sum-exp against the plain version's: values of
# order 1-10, the tensor-core kernel summing in exp2 and the plain version
# in exp, float32 either way; +inf on exactly the same rows
LSE_ATOL = 1e-3


def grad_errors(got, want, dtype) -> dict:
    """The three gradients against ``want``: float32 by max |diff| over
    max |want|; bf16 by the scaled error of :data:`BWD_BF16_FLOOR`."""
    out = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        gf, wf = g.float(), w.float()
        d_ = (gf - wf).abs()
        top = float(wf.abs().max())
        rec = {"max_abs_err": float(d_.max()), "max_abs_want": top,
               "rel_to_max": float(d_.max()) / top if top else float(d_.max()),
               "finite": bool(torch.isfinite(gf).all())}
        if dtype == torch.bfloat16:
            rec["scaled_err"] = float((d_ / (BF16_RTOL * wf.abs()
                                             + BWD_BF16_FLOOR * top)).max())
        out[name] = rec
    return out


def bwd_case(label, b, h, kvh, sq, sk, d, causal, window, dtype, seed,
             timed: bool) -> dict:
    """One backward case: the forward kernel's output and log-sum-exp,
    then the backward kernel of ``BWD_INSTANCE[dtype]`` (twice: the same
    bits), its plain version and the float32 oracle on the same inputs; a
    bf16 case also runs the FMA kernel built for bf16 (``fma_bf16``) and
    holds the tensor-core kernel against it; timings where ``timed``."""
    kw = dict(causal=causal, window=window)
    q, k, v = qkv(b, h, kvh, sq, sk, d, dtype, seed=seed, scale=PEAKED_QK,
                  v_scale=V_SCALE)
    g = torch.Generator(device=DEV).manual_seed(seed + 5)
    do = torch.randn(q.shape, generator=g, device=DEV).to(dtype)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=DEV)
    o = flash_attention._launch_forward(flash_attention.INSTANCE[dtype],
                                        q, k, v, sm_scale=None, lse=lse,
                                        **kw)
    # the forward's log-sum-exp against the plain version's
    _, lse_plain = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    finite = torch.isfinite(lse_plain)
    lse_err = float((lse - lse_plain)[finite].abs().max()) if bool(
        finite.any()) else 0.0
    lse_inf_same = bool(torch.equal(torch.isinf(lse), ~finite))
    instance = flash_attention.BWD_INSTANCE[dtype]
    key = f"flash_attention_bwd:{instance}"
    before = counts.LAUNCHES["flash_attention_bwd"], counts.INSTANCES[key]
    got = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    launched = counts.LAUNCHES["flash_attention_bwd"] - before[0]
    launched_instance = counts.INSTANCES[key] - before[1]
    deterministic = all(torch.equal(x, y) for x, y in zip(got, again))
    del again
    plain = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    rec = {"case": label, "shape_q": [b, h, sq, d], "kv": [b, kvh, sk, d],
           "dtype": str(dtype).split(".")[1], **kw, "instance": instance,
           "launches": launched, "launches_of_instance": launched_instance,
           "deterministic": deterministic,
           "lse_max_abs_err": lse_err, "lse_inf_rows_agree": lse_inf_same}
    fma = None
    if dtype == torch.float32:
        rec["vs_plain"] = grad_errors(got, plain, dtype)
        rec["ok"] = all(e["rel_to_max"] <= BWD_F32_REL and e["finite"]
                        for e in rec["vs_plain"].values())
    else:
        oracle = ref.flash_attention_bwd_ref(
            *(t.float() for t in (q, k, v, o)), lse, do.float(), **kw)
        fma = flash_attention.run_bwd_instance("fma_bf16", q, k, v, o, lse,
                                               do, **kw)
        rec["vs_f32_oracle"] = grad_errors(got, oracle, dtype)
        rec["vs_fma_bf16"] = grad_errors(got, fma, dtype)
        rec["fma_bf16_vs_f32_oracle"] = grad_errors(fma, oracle, dtype)
        rec["plain_vs_f32_oracle"] = grad_errors(plain, oracle, dtype)
        del oracle
        rec["ok"] = all(e["scaled_err"] <= 1.0 and e["finite"]
                        for part in ("vs_f32_oracle", "vs_fma_bf16",
                                     "fma_bf16_vs_f32_oracle")
                        for e in rec[part].values())
    # rows with no admitted key: their dq is exactly 0
    no_key = torch.isinf(lse)
    if bool(no_key.any()):
        rec["no_key_rows"] = int(no_key.sum())
        rec["no_key_dq_zero"] = bool((got[0].float().abs().amax(-1)
                                      [no_key] == 0).all())
        rec["ok"] = rec["ok"] and rec["no_key_dq_zero"]
    rec["ok"] = bool(rec["ok"] and deterministic and launched == 2
                     and launched_instance == 2
                     and lse_inf_same and lse_err <= LSE_ATOL)
    if timed:
        pairs = flash_attention.admitted_pairs(sq, sk, causal, window)
        # the package's count: 10·D a head and admitted pair; q, k, v, o,
        # do and the log-sum-exp read once, dq, dk and dv written once
        ops_, bytes_ = flash_attention.backward_work(q, k, v, **kw)
        ops_exec = BWD_TC_EXECUTED_PER_D[d] * d * h * b * pairs
        # (d) of the roofline: the counter counts the same work
        counted = cost.analyze(flash_attention.flash_attention_bwd, q, k, v,
                               o, lse, do, **kw).kernels
        rec["counter_equals_row"] = \
            counted == {"flash_attention_bwd": [1, ops_, bytes_]}
        rec["ok"] = rec["ok"] and rec["counter_equals_row"]
        b_ms, b_by = bound(bytes_, ops_, BF16_TC_OPS_PER_S)
        exec_ms, _ = bound(bytes_, ops_exec, BF16_TC_OPS_PER_S)
        fp32_ms, _ = bound(bytes_, ops_)
        ms = time_ms(lambda: flash_attention.flash_attention_bwd(
            q, k, v, o, lse, do, **kw), 5)
        rec.update({
            "admitted_pairs": pairs, "operations": ops_,
            "operations_executed": ops_exec, "bytes": bytes_,
            "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_executed": exec_ms, "bound_ms_fp32": fp32_ms,
            "tflops": ops_ / ms / 1e9,
            "ms_fma_bf16": time_ms(lambda: flash_attention.run_bwd_instance(
                "fma_bf16", q, k, v, o, lse, do, **kw), 3),
            "plain_ms": time_ms(lambda: ref.flash_attention_bwd_ref(
                q, k, v, o, lse, do, **kw), 1),
            "library_ms": library_attention_ms(
                q, k, v, 5, window_mask(sq, sk, window) if window else None,
                do=do),
            "library_call": "backward of SDPA, enable_gqa, " + (
                "attn_mask (S, S) bool" if window else "is_causal")})
        rec["tflops_fma_bf16"] = ops_ / rec["ms_fma_bf16"] / 1e9
    del got, plain, fma, q, k, v, o, do, lse
    return rec


def bwd_spills() -> dict:
    """ptxas' report of the tensor-core backward's kernels (every build
    leaves it beside the library): registers and spills a kernel and
    head dim, and whether the D 128 kernels spill nothing."""
    report = _build.ptxas_report("flash_attention_bwd_tc")
    kernels = {}
    for name, r in report.items():
        for kern in ("bwd_dkdv_tc_kernel", "bwd_dq_tc_kernel",
                     "bwd_rows_kernel"):
            if kern in name:
                d = name.split(kern + "ILi")[1].split("E")[0]
                kernels[f"{kern}<{d}>"] = r
    d128 = [r for k_, r in kernels.items() if k_.endswith("<128>")
            and "rows" not in k_]
    return {"kernels": kernels,
            "d128_no_spills": len(d128) == 2 and all(
                r.get("spill_stores") == 0 and r.get("spill_loads") == 0
                for r in d128)}


def phase_train_kernel() -> dict:
    """(a) of the ``train`` phase: the backward kernel against its plain
    version and the float32 oracle on the card, at the train shape, at
    gemma3-1b's local layer and at the small edge cases (bf16 also against
    the FMA kernel built for bf16); the forward's log-sum-exp against the
    plain version's; ptxas' registers and spills.  Launches here are
    checks, not the path.  Returns the kernel's row of the ``kernels``
    line (its launches filled in by the caller)."""
    t0 = time.perf_counter()
    recs = [bwd_case(*c, seed=20 + i, timed=i < 2)
            for i, c in enumerate(BWD_CASES)]
    for r in recs:
        if not r["ok"]:
            fail(f"train: backward case {r['case']}")
    spills = bwd_spills()
    if not spills["d128_no_spills"]:
        fail("train: the D 128 backward kernels spill registers")
    emit({"phase": "train_kernel", "cases": recs,
          "f32_rel_limit": BWD_F32_REL, "bf16_rtol": BF16_RTOL,
          "bf16_floor_of_max": BWD_BF16_FLOOR, "ptxas": spills,
          "seconds": time.perf_counter() - t0})
    main = recs[0]
    worst = max(max(e["max_abs_err"] for e in
                    (r.get("vs_plain") or r["vs_f32_oracle"]).values())
                for r in recs)
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": CSRC + "flash_attention_bwd_tc.cu",
            "source_f32": CSRC + "flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:96 (its "
                        "gradient; the reference differentiates jnp at "
                        "src/repro/models/attention.py:328-360)",
            "launches": 0, "max_abs_err": worst,
            **{k_: main[k_] for k_ in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "bound_ms_executed",
                                       "bound_ms_fp32", "library_ms",
                                       "tflops", "ms_fma_bf16")},
            "shape": "the qwen2-1.5b train call; every call under calls",
            "calls": [{k_: r[k_] for k_ in (
                "case", "ms", "ms_fma_bf16", "plain_ms", "bound_ms",
                "bound_by", "bound_ms_executed", "library_ms",
                "library_call", "tflops", "tflops_fma_bf16")}
                for r in recs if "ms" in r]}


# (b)-(e): repro_torch.launch.train at qwen2-1.5b's full width and depth,
# bf16, random weights and synthetic tokens from seed 0: train_4k's
# sequence of 4096 tokens, its global batch of 256 cut to 4 (2
# microbatches of 2) for one card and the time limit, remat by layer
TRAIN_STEPS, TRAIN_BATCH, TRAIN_MB = 6, 4, 2
TRAIN_SEQ = MODEL_SHAPES["train_4k"].seq_len
TRAIN_ARGV = ["--arch", "qwen2-1.5b", "--steps", str(TRAIN_STEPS),
              "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
              "--microbatches", str(TRAIN_MB), "--remat", "layer",
              "--seed", "0", "--no-checkpoint"]
# (b): step 0's loss within this many nats of ln V (random weights: the
# logits have a std of about 0.02 sqrt(d_model) = 0.78, which adds about
# 0.3 to ln V)
TRAIN_LOSS0_TOL = 1.0
# (d): the same batch, this many steps at this peak rate (warmup 1, then
# the cosine), must lower the loss by more than this many nats
OVERFIT_STEPS, OVERFIT_LR, OVERFIT_DROP = 8, 1e-3, 1.0
# (e): the drill at reduced width, on the card
DRILL_ARGV = ["--arch", "qwen2-1.5b", "--reduced", "--steps", "6",
              "--batch", "8", "--seq", "64", "--microbatches", "2",
              "--lr", "3e-3", "--checkpoint-every", "2", "--seed", "0",
              "--no-advice"]
DRILL_AT = 3
# (e): where two uninterrupted runs are not bit-equal, the drilled run's
# parameters must be within this normalised distance of one
DRILL_NORM_TOL = 1e-6


def train_grads_tol(cfg) -> float:
    """(c)'s limit on the normalised distance between the gradients with
    the kernels and with the plain flash: serve's count of roundings (one
    a layer for the mixer, one more for an FFN, in two streams), once for
    the forward and once more for the backward, which runs back through
    every layer: sqrt(2 * 2 * roundings) * 2^-8 (0.0585 at 28 layers)."""
    roundings = sum(1 + blocks_mod.layer_has_ffn(cfg, i)
                    for i in range(cfg.n_layers))
    return math.sqrt(4 * roundings) * 2.0 ** -8


class PlainFlashFn(torch.autograd.Function):
    """The plain flash forward (with its log-sum-exp) and the plain
    backward, on whatever device the tensors are: the check's, never the
    path's."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale, block_q, block_k):
        kw = dict(causal=causal, window=window, sm_scale=sm_scale,
                  block_q=block_q, block_k=block_k)
        out, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        grads = ref.flash_attention_bwd_ref(q, k, v, out, lse,
                                            do.contiguous(), **ctx.kw)
        return (*grads, None, None, None, None, None)


@contextlib.contextmanager
def plain_flash_train():
    """``ops.flash_attention`` replaced by :class:`PlainFlashFn` while the
    block runs, as :func:`plain_flash` does for the forward alone."""
    real = ops.flash_attention

    def plain(q, k, v, *, causal=True, window=0, sm_scale=None,
              block_q=128, block_k=128):
        return PlainFlashFn.apply(q, k, v, causal, window, sm_scale,
                                  block_q, block_k)

    ops.flash_attention = plain
    try:
        yield
    finally:
        ops.flash_attention = real


def loss_and_grads(loss_fn, params, tokens, labels):
    """One microbatch's loss and gradients (in the parameters' dtype), as
    the train step takes them."""
    flat = [p.detach().requires_grad_() for p in tree_mod.leaves(params)]
    with torch.enable_grad():
        loss, _ = loss_fn(tree_mod.unflatten_like(params, flat), tokens,
                          labels, None)
        gs = torch.autograd.grad(loss, flat)
    return loss.detach(), gs


def normalised_distance(got, want) -> tuple:
    """(||got - want|| / ||want|| over every leaf, the worst leaf's)."""
    num = den = 0.0
    worst = 0.0
    for g, w in zip(got, want):
        d2 = float((g.float() - w.float()).square().sum())
        w2 = float(w.float().square().sum())
        num, den = num + d2, den + w2
        if w2:
            worst = max(worst, math.sqrt(d2 / w2))
    return math.sqrt(num / den), worst


def drill_runs(tmp: str) -> dict:
    """(e): the drilled run and two uninterrupted ones at reduced width."""
    runs = {}
    for name, extra in (("drilled", ["--inject-fault-at", str(DRILL_AT)]),
                        ("clean", []), ("clean_again", [])):
        d = os.path.join(tmp, name)
        runs[name] = train_cli.run(DRILL_ARGV + ["--ckpt-dir", d] + extra,
                                   verbose=False)
    leaves = {k: tree_mod.leaves(r.state["params"]) for k, r in runs.items()}
    deterministic = all(torch.equal(a, b) for a, b in
                        zip(leaves["clean"], leaves["clean_again"]))
    equal = all(torch.equal(a, b) for a, b in
                zip(leaves["drilled"], leaves["clean"]))
    dist, _ = normalised_distance(leaves["drilled"], leaves["clean"])
    r = runs["drilled"].result
    return {"argv": DRILL_ARGV, "drill_at": DRILL_AT,
            "restarts": r.restarts, "faults_injected": r.faults_injected,
            "final_step": r.final_step,
            "device": str(runs["drilled"].device),
            "steps_recorded": len(r.metrics_history),
            "clean_runs_bit_equal": deterministic,
            "drilled_bit_equal_clean": equal, "normalised_distance": dist,
            "tol_if_not_deterministic": DRILL_NORM_TOL,
            "losses": [m["loss"] for m in r.metrics_history]}


def phase_train(smi: str, bwd_row: dict) -> int:
    """(b) ``repro_torch.launch.train`` at qwen2-1.5b's full width and
    depth between a reset and a read of the counts: every loss and grad
    norm finite, step 0's loss near ln V, two forward launches (the
    recompute) and one backward launch a layer and microbatch, the
    forwards and the backwards on ``wgmma_bf16``, no plain version; the
    step's ms, tokens a second, kernels, busy share, host syncs and peak
    memory.  (c) One microbatch's loss and gradients against the same
    under the plain flash forward and backward.  (d) The same batch for
    ``OVERFIT_STEPS`` steps: the loss falls.  (e) The resilient loop's
    drill at reduced width.
    Fills ``bwd_row``'s launches from (b); returns the forward kernel's
    launches in (b)."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    checks = {}

    # (b) the entry point
    counts.reset()
    t0 = time.perf_counter()
    run = train_cli.run(TRAIN_ARGV, verbose=False)
    sync()
    entry_s = time.perf_counter() - t0
    launched, plain = counts.snapshot()
    by_instance = dict(counts.INSTANCES)
    peak = torch.cuda.max_memory_allocated()
    cfg, state, hist = run.cfg, run.state, run.result.metrics_history
    params = state["params"]
    layers = cfg.n_layers
    fwd_want = 2 * layers * TRAIN_MB * TRAIN_STEPS
    bwd_want = layers * TRAIN_MB * TRAIN_STEPS
    losses = [m["loss"] for m in hist]
    gnorms = [m["grad_norm"] for m in hist]
    checks["b:full_width_bf16"] = (
        (cfg.name, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
         cfg.head_dim, cfg.d_ff, cfg.vocab_size, params["embed"].dtype) ==
        ("qwen2-1.5b", 28, 1536, 12, 2, 128, 8960, 151936, torch.bfloat16))
    checks["b:steps_run"] = (run.result.final_step == TRAIN_STEPS
                             and len(hist) == TRAIN_STEPS)
    checks["b:losses_and_grad_norms_finite"] = all(
        math.isfinite(x) for x in losses + gnorms)
    checks["b:step0_loss_near_ln_v"] = \
        abs(losses[0] - math.log(cfg.vocab_size)) <= TRAIN_LOSS0_TOL
    checks["b:forward_twice_a_layer_and_microbatch"] = \
        launched["flash_attention"] == fwd_want
    checks["b:forward_on_wgmma_bf16"] = \
        by_instance["flash_attention:wgmma_bf16"] == fwd_want
    checks["b:backward_once_a_layer_and_microbatch"] = \
        launched["flash_attention_bwd"] == bwd_want
    checks["b:backward_bf16"] = \
        by_instance["flash_attention_bwd:wgmma_bf16"] == bwd_want
    checks["b:no_plain_version"] = not any(plain.values())
    bwd_row["launches"] = launched["flash_attention_bwd"]
    bwd_row["launches_by_path"] = {"train": launched["flash_attention_bwd"]}

    step_s = run.step_seconds
    step_ms = statistics.median(step_s[1:]) * 1e3
    step_fn = step_mod.make_train_step(cfg, run.rules, run.tcfg,
                                       microbatches=TRAIN_MB)
    loader = DataLoader(cfg, run.shape, device=DEV, seed=0)
    batch = loader.device_batch(0)

    def one_step():
        return step_fn(state, batch.tokens, batch.labels)

    prof = profile_calls(one_step, 1)
    syncs = host_syncs(lambda: fault_tolerance._scalars(one_step()[1]))
    roofline_line(f"{cfg.name} train step", cfg, TRAIN_SHAPE,
                  count_call(step_fn, state, batch.tokens, batch.labels),
                  step_ms, TRAIN_BATCH * TRAIN_SEQ)
    checks["b:profiler_saw_the_card"] = prof["kernels_a_call"] > 0
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ

    # (c) one microbatch with the kernels against the plain flash
    loss_fn = step_mod.make_loss_fn(cfg, run.rules, run.tcfg)
    tok = batch.tokens.reshape(TRAIN_BATCH // TRAIN_MB, TRAIN_MB, -1)[:, 0]
    lab = batch.labels.reshape(TRAIN_BATCH // TRAIN_MB, TRAIN_MB, -1)[:, 0]
    lk, gk = loss_and_grads(loss_fn, params, tok, lab)
    with plain_flash_train():
        lp, gp = loss_and_grads(loss_fn, params, tok, lab)
    grad_dist, worst_leaf = normalised_distance(gk, gp)
    grads_finite = all(bool(torch.isfinite(g).all()) for g in gk)
    del gk, gp
    tol_c = train_grads_tol(cfg)
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    checks["c:grads_finite"] = grads_finite
    checks["c:grads_within_norm_tol"] = grad_dist <= tol_c
    checks["c:loss_within_norm_tol"] = loss_rel <= serve_logits_tol(cfg)

    # (d) the same batch, repeated, from fresh moments
    with torch.no_grad():
        for t in (tree_mod.leaves(state["opt"].m)
                  + tree_mod.leaves(state["opt"].v)):
            t.zero_()
        state["opt"].step.zero_()
    tcfg_d = dataclasses.replace(run.tcfg, learning_rate=OVERFIT_LR,
                                 warmup_steps=1, total_steps=OVERFIT_STEPS)
    step_d = step_mod.make_train_step(cfg, run.rules, tcfg_d,
                                      microbatches=TRAIN_MB)
    t0 = time.perf_counter()
    over = [step_d(state, batch.tokens, batch.labels)[1]["loss"]
            for _ in range(OVERFIT_STEPS)]
    over = torch.stack(over).tolist()
    over_s = time.perf_counter() - t0
    checks["d:losses_finite"] = all(math.isfinite(x) for x in over)
    checks["d:loss_falls"] = over[0] - over[-1] > OVERFIT_DROP
    del run, state, params, loader, batch, step_fn, step_d
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the drill, at reduced width on the card
    with tempfile.TemporaryDirectory() as tmp:
        drill = drill_runs(tmp)
    checks["e:one_restart"] = (drill["restarts"] == 1
                               and drill["faults_injected"] == 1)
    checks["e:ran_to_the_end_on_the_card"] = (
        drill["final_step"] == 6 and drill["device"].startswith("cuda"))
    checks["e:params_equal_uninterrupted"] = (
        drill["drilled_bit_equal_clean"] if drill["clean_runs_bit_equal"]
        else drill["normalised_distance"] <= DRILL_NORM_TOL)

    emit({"phase": "train", "card": smi, "argv": TRAIN_ARGV,
          "config": cfg.name, "n_params": cfg.n_params(),
          "seq": TRAIN_SEQ, "batch": TRAIN_BATCH, "microbatches": TRAIN_MB,
          "batch_cut_from": MODEL_SHAPES["train_4k"].global_batch,
          "entry_seconds": entry_s, "loop_seconds": float(sum(step_s)),
          "step_ms_median": step_ms,
          "step_ms": [x * 1e3 for x in step_s],
          "tokens_per_s": tokens_per_step / (step_ms / 1e3),
          "losses": losses, "grad_norms": gnorms,
          "ln_vocab": math.log(cfg.vocab_size),
          "launches": launched, "launches_by_instance": by_instance,
          "plain_calls": plain,
          "want_launches": {"flash_attention": fwd_want,
                            "flash_attention_bwd": bwd_want},
          "profile_one_step": prof,
          "busy_share": prof["device_ms_a_call"] / step_ms,
          "host_syncs_a_step": syncs, "peak_bytes": peak,
          "c": {"loss_kernels": float(lk), "loss_plain": float(lp),
                "loss_rel": loss_rel, "loss_tol": serve_logits_tol(cfg),
                "grad_norm_dist": grad_dist, "worst_leaf_dist": worst_leaf,
                "tol": tol_c},
          "d": {"losses": over, "lr": OVERFIT_LR, "drop": over[0] - over[-1],
                "min_drop": OVERFIT_DROP, "seconds": over_s},
          "e": drill, "checks": checks,
          "seconds": time.perf_counter() - t_phase})
    for k_, ok in checks.items():
        if not ok:
            fail(f"train: check {k_}")
    return launched["flash_attention"]


# ---------------------------------------------------------------------------
# the distributed phase: the mesh path of launch/train over NCCL, world 1
# ---------------------------------------------------------------------------

DIST_STEPS = 3
DIST_ARGV = ["--arch", "qwen2-1.5b", "--steps", str(DIST_STEPS),
             "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
             "--microbatches", str(TRAIN_MB), "--remat", "layer",
             "--seed", "0", "--no-checkpoint", "--no-advice",
             "--data", "1", "--model", "1"]
# (a): the mesh path's losses and parameters beside the one-device step's
# (the same arithmetic on one rank; one bf16 rounding allowed a leaf,
# relative to the leaf's largest element)
DIST_LOSS_REL = 1e-5
DIST_LEAF_REL = 2.0 ** -8


# (c): the metrics a step all-reduces over the batch group: ce_loss,
# tokens, loss, and with experts moe_aux and moe_drop_frac
DIST_METRICS = 3
DIST_MOE_METRICS = 5


def planned_collectives(rules, tcfg, params_struct) -> list:
    """(c)'s oracle: the collectives one train step on ``rules.mesh``
    must run, as its specs imply them, in launch order, ``[kind, operand
    bytes, group size]`` a call (the operand as ``analysis.cost`` counts
    it: an all-gather's input, an all-reduce's tensor).  Each parameter
    gathered over its spec's axes; over the batch axes each float32
    gradient block all-reduced (after its int8 scale's MAX with
    ``int8_ef``), then the metrics; the sums of squares all-reduced once
    a set of moment axes; each updated block gathered over the axes
    ZeRO-1 adds.  One card holds a (1,1) mesh only; the split step's
    plan on a model axis of more than one rank is held on the CPU
    (``tests/test_torch_distribution.py``)."""
    from repro_torch.parallel import collectives
    mesh = rules.mesh
    specs = step_mod.state_specs(rules.cfg, rules, tcfg, params_struct)
    flat = tree_mod.leaves(params_struct)
    pspecs = tree_mod.leaves(specs["params"])
    mspecs = tree_mod.leaves(specs["opt"].m)

    def axes(named):
        return tuple(a for a in mesh.axis_names if a in named)

    def size(ax):
        return math.prod(mesh.axis_sizes[a] for a in ax)

    def nbytes(p, spec, itemsize):
        return math.prod(collectives.block_shape(tuple(p.shape), spec,
                                                 mesh)) * itemsize

    calls = []
    for p, ps in zip(flat, pspecs):
        ax = axes(collectives.spec_axes(ps))
        if ax:
            calls.append(["all-gather", nbytes(p, ps, p.element_size()),
                          size(ax)])
    batch = axes(rules.batch)
    if batch:
        for p, ps in zip(flat, pspecs):
            if tcfg.grad_compression == "int8_ef":
                calls.append(["all-reduce", 4, size(batch)])
            calls.append(["all-reduce", nbytes(p, ps, 4), size(batch)])
        n = DIST_MOE_METRICS if rules.cfg.moe is not None else DIST_METRICS
        calls.append(["all-reduce", 4 * n, size(batch)])
    keys = [axes(collectives.spec_axes(ms)) for ms in mspecs]
    for key in dict.fromkeys(k for k in keys if k):
        calls.append(["all-reduce", 4 * keys.count(key), size(key)])
    for p, ps, ms in zip(flat, pspecs, mspecs):
        ax = axes(collectives.spec_axes(
            collectives.relative_spec(ps, ms, p.dim())))
        if ax:
            calls.append(["all-gather", nbytes(p, ms, p.element_size()),
                          size(ax)])
    return calls


@contextlib.contextmanager
def counted_gathers():
    """Counts the calls of ``collectives.gather`` (a leaf rebuilt whole
    from its blocks) while the block runs: ``{"calls": n}``."""
    from repro_torch.parallel import collectives
    seen = {"calls": 0}
    real = collectives.gather

    def gather(*a, **k):
        seen["calls"] += 1
        return real(*a, **k)

    collectives.gather = gather
    try:
        yield seen
    finally:
        collectives.gather = real


def phase_distributed(smi: str) -> dict:
    """qwen2-1.5b at full width and depth through ``launch.train``'s mesh
    path: one process group (``nccl``, rank 0, world 1, a file store in a
    temporary directory, destroyed in a ``finally``; no subprocess), the
    (1, 1) mesh bound to it, ZeRO-1 on, ``train``'s shape and settings,
    ``DIST_STEPS`` steps from the same seed, state and batches as a
    one-device run of the same launcher before the group exists.  (a) the
    losses within ``DIST_LOSS_REL`` and every parameter leaf within one
    bf16 rounding of the one-device run's, and how many are bit-equal;
    the step body of every mesh, which at a model axis of 1 splits
    nothing and rebuilds no leaf whole (``collectives.gather`` not
    called);
    (b) ``compressed_psum`` over the NCCL group on one step's float32
    gradients, leaf by leaf, bit-equal to ``compress_decompress``; (c)
    the collectives ``analysis.cost`` counts in one sharded step equal,
    in order, kind and bytes, those the specs imply
    (:func:`planned_collectives`), and a ``roofline`` line with its
    collective term; (d) ``elastic_remesh`` (1,1) -> (1,1) through the
    host gives the state back bit-equal; (e) rows 12 and 12b launched in
    the mesh run, their plain versions not.  Returns the mesh run's
    launches of both kernels."""
    from repro_torch.launch.mesh import describe
    from repro_torch.parallel import collectives, compression
    from repro_torch.runtime.fault_tolerance import elastic_remesh
    t_phase = time.perf_counter()
    checks = {}

    # the one-device run of today's step, before any process group
    if collectives.initialized():
        fail("distributed: a process group existed before the phase")
    one = train_cli.run(DIST_ARGV, verbose=False)
    sync()
    one_losses = [m["loss"] for m in one.result.metrics_history]
    one_params = [t.to("cpu") for t in tree_mod.leaves(one.state["params"])]
    one_step_ms = statistics.median(one.step_seconds[1:]) * 1e3
    checks["one_device_mesh_unbound"] = not one.mesh.bound
    del one
    gc.collect()
    torch.cuda.empty_cache()

    store_dir = tempfile.mkdtemp(prefix="repro_dist_")
    created = False
    try:
        created = collectives.setup("nccl", rank=0, world_size=1,
                                    store_path=os.path.join(store_dir,
                                                            "store"))
        torch.cuda.reset_peak_memory_stats()
        counts.reset()
        t0 = time.perf_counter()
        with counted_gathers() as gathers:
            run = train_cli.run(DIST_ARGV, verbose=False)
            sync()
        entry_s = time.perf_counter() - t0
        launched, plain = counts.snapshot()
        by_instance = dict(counts.INSTANCES)
        peak = torch.cuda.max_memory_allocated()
        cfg, state, mesh = run.cfg, run.state, run.mesh
        layers = cfg.n_layers
        fwd_want = 2 * layers * TRAIN_MB * DIST_STEPS
        bwd_want = layers * TRAIN_MB * DIST_STEPS
        checks["group_nccl_world_1"] = (
            torch.distributed.get_backend() == "nccl"
            and torch.distributed.get_world_size() == 1)
        checks["mesh_bound_1x1"] = (mesh.bound and mesh.rank == 0 and
                                    describe(mesh) == "data=1xmodel=1")
        checks["zero1_on"] = run.tcfg.zero1 and run.shardings is not None
        # the step body of every mesh: at a model axis of 1 it splits
        # nothing and gathers no leaf whole (collectives.gather not called)
        checks["a:model_axis_none"] = \
            step_mod.model_split(run.cfg, run.rules) == "none"
        checks["a:no_whole_leaf_gather"] = gathers["calls"] == 0
        checks["full_width_bf16"] = (
            (cfg.n_layers, cfg.d_model, cfg.vocab_size,
             state["params"]["embed"].dtype)
            == (28, 1536, 151936, torch.bfloat16))

        # (a) the losses and the parameters beside the one-device run's
        losses = [m["loss"] for m in run.result.metrics_history]
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(losses, one_losses)) if losses else math.inf
        checks["a:steps_run"] = len(losses) == len(one_losses) == DIST_STEPS
        checks["a:losses_within_1e-5_rel"] = loss_rel <= DIST_LOSS_REL
        leaf_rel, bit_equal = [], 0
        for t, o in zip(tree_mod.leaves(state["params"]), one_params):
            t = t.to("cpu")
            bit_equal += int(torch.equal(t, o))
            scale = float(o.float().abs().max())
            leaf_rel.append(float((t.float() - o.float()).abs().max())
                            / max(scale, 1e-30))
        checks["a:leaves_within_one_bf16_rounding"] = \
            len(leaf_rel) == len(one_params) and \
            max(leaf_rel) <= DIST_LEAF_REL
        del one_params

        step_ms = statistics.median(run.step_seconds[1:]) * 1e3
        step_fn = step_mod.make_train_step(cfg, run.rules, run.tcfg,
                                           microbatches=TRAIN_MB)
        loader = DataLoader(cfg, run.shape, device=DEV, seed=0)
        batch = loader.device_batch(0)

        # (b) compressed_psum over the NCCL group = compress_decompress
        grads_fn = step_mod.make_grads_fn(cfg, run.rules, run.tcfg,
                                          microbatches=TRAIN_MB)
        _, grads = grads_fn(state["params"], batch.tokens, batch.labels)
        psum_equal, n_leaves = 0, len(grads)
        group = collectives.axis_group(mesh, run.rules.batch).group
        while grads:
            g = {"g": grads.pop(0)}
            e = {"g": torch.zeros_like(g["g"])}
            m1, e1 = compression.compressed_psum(g, e, group)
            m2, e2 = compression.compress_decompress(g, e)
            psum_equal += int(torch.equal(m1["g"], m2["g"])
                              and torch.equal(e1["g"], e2["g"]))
            del g, e, m1, e1, m2, e2
        checks["b:compressed_psum_equals_compress_decompress"] = \
            psum_equal == n_leaves
        del grads
        gc.collect()
        torch.cuda.empty_cache()

        # (d) elastic_remesh (1,1) -> (1,1) through the host
        t0 = time.perf_counter()
        again = elastic_remesh(state, run.shardings, shardings=run.shardings)
        remesh_s = time.perf_counter() - t0
        remesh_equal = all(
            torch.equal(a, b) and a.device == b.device and
            a.data_ptr() != b.data_ptr()
            for a, b in zip(tree_mod.leaves(again), tree_mod.leaves(state)))
        checks["d:remesh_bit_equal"] = remesh_equal and \
            len(tree_mod.leaves(again)) == len(tree_mod.leaves(state))
        del again
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the collectives one sharded step runs, counted
        counted = count_call(step_fn, state, batch.tokens, batch.labels)
        c = counted[0]
        want = planned_collectives(
            run.rules, run.tcfg, step_mod.state_struct(cfg, run.tcfg)["params"])
        got = [[o.kind, o.bytes_per_call, o.group_size]
               for o in c.collectives]
        checks["c:collectives_as_the_specs_imply"] = got == want
        checks["c:collective_bytes"] = \
            c.collective_bytes == sum(n for _, n, _ in want)
        roofline_line(f"{cfg.name} train step on a 1x1 mesh (nccl)", cfg,
                      TRAIN_SHAPE, counted, step_ms,
                      TRAIN_BATCH * TRAIN_SEQ)

        # (e) the kernels of the path
        checks["e:forward_twice_a_layer_and_microbatch"] = \
            launched["flash_attention"] == fwd_want
        checks["e:forward_on_wgmma_bf16"] = \
            by_instance["flash_attention:wgmma_bf16"] == fwd_want
        checks["e:backward_once_a_layer_and_microbatch"] = \
            launched["flash_attention_bwd"] == bwd_want
        checks["e:backward_on_wgmma_bf16"] = \
            by_instance["flash_attention_bwd:wgmma_bf16"] == bwd_want
        checks["e:no_plain_version"] = not any(plain.values())
        del run, state, loader, batch, step_fn, counted, c
    finally:
        if created:
            collectives.teardown()
        shutil.rmtree(store_dir, ignore_errors=True)
    checks["group_destroyed"] = not collectives.initialized()
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "distributed", "card": smi, "argv": DIST_ARGV,
          "backend": "nccl", "world_size": 1, "mesh": "data=1xmodel=1",
          "entry_seconds": entry_s,
          "losses": losses, "one_device_losses": one_losses,
          "gather_calls": gathers["calls"],
          "loss_rel_max": loss_rel, "leaf_rel_max": max(leaf_rel),
          "leaves": len(leaf_rel), "leaves_bit_equal": bit_equal,
          "psum_leaves_bit_equal": psum_equal,
          "collectives": got, "collectives_planned": want,
          "collective_bytes": sum(n for _, n, _ in want),
          "remesh_seconds": remesh_s,
          "step_ms_median": step_ms, "one_device_step_ms_median": one_step_ms,
          "step_over_one_device": step_ms / one_step_ms,
          "peak_bytes": peak, "launches": launched,
          "launches_by_instance": by_instance, "plain_calls": plain,
          "want_launches": {"flash_attention": fwd_want,
                            "flash_attention_bwd": bwd_want},
          "checks": checks, "seconds": time.perf_counter() - t_phase})
    for k_, ok in checks.items():
        if not ok:
            fail(f"distributed: check {k_}")
    return {"flash_attention": launched["flash_attention"],
            "flash_attention_bwd": launched["flash_attention_bwd"]}


# ---------------------------------------------------------------------------
# tensor-parallel training: each rank's head block through #12 and #12b,
# and the vocabulary-parallel cross-entropy, at qwen2-1.5b's full width
# ---------------------------------------------------------------------------

# (b): the model axes whose ranks' head blocks run, as serve_mesh's (b):
# "head" at 2 (6 q heads, 1 KV head a rank), "seq" + q_heads_tp at 4 (3, 1)
TP_ATTN_SEED = 60
# (c): the loss within this share of chunked_ce's; the gradients within
# this share of their largest element (float32 either way)
TP_CE_LOSS_REL = 1e-5
TP_CE_GRAD_REL = 1e-4
TP_CE_BLOCKS = (2, 4)


def head_block_check(cfg, tps=None) -> tuple:
    """(b): q (B, H, S, D) and k, v (B, KV, S, D) of ``cfg``'s widths
    (qwen2-1.5b: 12 and 2 heads of 128) at the train microbatch
    (B = ``TRAIN_BATCH // TRAIN_MB``, S = ``TRAIN_SEQ``), bf16, causal,
    from a seed; #12 with the log-sum-exp and #12b on one seeded ``do``,
    whole, then on each rank's head block of every model axis of ``tps``
    (default ``MESH_TP``, 2 and 4; ``head_blocks``, the rules' cut and
    ``attention.kv_heads_of``).
    Each block's output, log-sum-exp and dq bit-equal to the whole call's
    slices; dk and dv summed over the ranks that read each KV head against
    the whole call's: |sum - want| <= BF16_RTOL sum|term| +
    BWD_BF16_FLOOR max|want|, the 12b cases' limit with each rank's
    rounded term counted (where one rank reads a KV head, exactly the 12b
    limit), and whether they are bit-equal.  Returns (records, the
    blocks' launches of #12 and #12b, timings)."""
    b, s_ = TRAIN_BATCH // TRAIN_MB, TRAIN_SEQ
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bf = torch.bfloat16
    q, k, v = qkv(b, h, kvh, s_, s_, d, bf, seed=TP_ATTN_SEED,
                  scale=PEAKED_QK, v_scale=V_SCALE)
    g = torch.Generator(device=DEV).manual_seed(TP_ATTN_SEED + 5)
    do = torch.randn(q.shape, generator=g, device=DEV).to(bf)
    inst = flash_attention.INSTANCE[bf]
    tps = MESH_TP if tps is None else tps

    def fwd_bwd(q_, k_, v_, do_):
        lse_ = torch.empty(q_.shape[:3], dtype=torch.float32, device=DEV)
        o_ = flash_attention._launch_forward(inst, q_, k_, v_, causal=True,
                                             window=0, sm_scale=None,
                                             lse=lse_)
        return (o_, lse_) + tuple(flash_attention.flash_attention_bwd(
            q_, k_, v_, o_, lse_, do_, causal=True))

    o, lse, dq, dk, dv = fwd_bwd(q, k, v, do)
    counts.reset()
    recs, sums = [], []
    for tp in tps:
        mode, ranks = head_blocks(cfg, tp)
        acc = {n: torch.zeros(t.shape, dtype=torch.float32, device=DEV)
               for n, t in (("dk", dk), ("dv", dv), ("mag_k", dk),
                            ("mag_v", dv))}
        for i, (h0, hl, kv_heads) in enumerate(ranks):
            idx = torch.tensor(kv_heads, device=DEV)
            ob, lseb, dqb, dkb, dvb = fwd_bwd(
                q[:, h0:h0 + hl].contiguous(), k[:, kv_heads].contiguous(),
                v[:, kv_heads].contiguous(),
                do[:, h0:h0 + hl].contiguous())
            for n, t in (("dk", dkb), ("dv", dvb)):
                acc[n].index_add_(1, idx, t.float())
                acc["mag_" + n[1]].index_add_(1, idx, t.float().abs())
            recs.append({
                "tp": tp, "mode": mode, "rank": i, "q_heads": [h0, h0 + hl],
                "kv_heads": kv_heads,
                "o_bit_equal": torch.equal(ob, o[:, h0:h0 + hl]),
                "lse_bit_equal": torch.equal(lseb, lse[:, h0:h0 + hl]),
                "dq_bit_equal": torch.equal(dqb, dq[:, h0:h0 + hl])})
            del ob, lseb, dqb, dkb, dvb
        rec = {"tp": tp, "mode": mode}
        for n, want in (("dk", dk), ("dv", dv)):
            wf = want.float()
            err = (acc[n] - wf).abs() / (
                BF16_RTOL * acc["mag_" + n[1]]
                + BWD_BF16_FLOOR * float(wf.abs().max()))
            rec[n + "_scaled_err"] = float(err.max())
            rec[n + "_bit_equal"] = torch.equal(acc[n], wf)
            rec[n + "_max_abs_err"] = float((acc[n] - wf).abs().max())
        sums.append(rec)
        del acc
    sync()
    launched, plain = counts.snapshot()
    # the whole call and rank 0's block of each model axis, timed
    times = {"whole_fwd_bwd_ms": time_ms(lambda: fwd_bwd(q, k, v, do), 3)}
    for tp in tps:
        h0, hl, kv_heads = head_blocks(cfg, tp)[1][0]
        qb, kb, vb, dob = (q[:, h0:h0 + hl].contiguous(),
                           k[:, kv_heads].contiguous(),
                           v[:, kv_heads].contiguous(),
                           do[:, h0:h0 + hl].contiguous())
        times[f"block_fwd_bwd_ms_tp{tp}"] = time_ms(
            lambda: fwd_bwd(qb, kb, vb, dob), 3)
    del q, k, v, do, o, lse, dq, dk, dv
    return recs, sums, launched, plain, times


def vocab_ce_check(cfg) -> dict:
    """(c): the tied embedding at full width (``padded_vocab`` x
    ``d_model``, the model's init from a seed) cut into 2 and 4 row blocks,
    a seeded bf16 hidden of the train microbatch taken to float32, labels
    from a seed with each row's last masked (-1).  Each chunk (the
    launcher's ``loss_chunk``): ``step.vocab_ce_terms`` once a block, the
    terms combined as the group would (a MAX of the maxima, a SUM of the
    rescaled sums and of the label logits), ``step.vocab_ce_grads`` once a
    block; against ``step.chunked_ce`` on the whole vocabulary and its
    autograd gradients: the loss within ``TP_CE_LOSS_REL``, the hidden's
    gradient (the blocks' shares summed) and each block's gradient within
    ``TP_CE_GRAD_REL`` of the largest element."""
    from repro_torch.models.common import embed_init
    b, s_, dm = TRAIN_BATCH // TRAIN_MB, TRAIN_SEQ, cfg.d_model
    chunk = min(1024, s_)
    gen = torch.Generator(device=DEV).manual_seed(TP_ATTN_SEED + 10)
    w = embed_init(gen, (cfg.padded_vocab, dm), torch.bfloat16,
                   n_rows=cfg.vocab_size).float()
    h = (torch.randn((b, s_, dm), generator=gen, device=DEV)
         .to(torch.bfloat16).float())
    y = torch.randint(0, cfg.vocab_size, (b, s_), generator=gen, device=DEV)
    y[:, -1] = -1
    wr, hr = w.clone().requires_grad_(), h.clone().requires_grad_()
    sync()
    t0 = time.perf_counter()
    loss, _ = step_mod.chunked_ce({"embed": wr}, hr, y, cfg=cfg, chunk=chunk)
    loss.backward()
    sync()
    whole_s = time.perf_counter() - t0
    want_loss = float(loss.detach())
    want_dh, want_dw = hr.grad, wr.grad
    del wr, hr, loss
    out = {"chunked_ce_loss": want_loss, "chunked_ce_seconds": whole_s,
           "chunk": chunk, "blocks": {}}
    one = torch.ones((), device=DEV)
    for n in TP_CE_BLOCKS:
        rows = cfg.padded_vocab // n
        blocks = [w[i * rows:(i + 1) * rows] for i in range(n)]
        loss = torch.zeros((), device=DEV)
        dh = torch.zeros_like(h)
        dws = [torch.zeros_like(blk) for blk in blocks]
        sync()
        t0 = time.perf_counter()
        for a in range(0, s_, chunk):
            hc, yc = h[:, a:a + chunk], y[:, a:a + chunk]
            terms = [step_mod.vocab_ce_terms(hc, yc, blk, i * rows)
                     for i, blk in enumerate(blocks)]
            m = torch.stack([t_[0] for t_ in terms]).amax(0)
            ssum = sum(t_[1] * torch.exp(t_[0] - m) for t_ in terms)
            ll = sum(t_[2] for t_ in terms)
            lse = m + torch.log(ssum)
            loss += torch.where(yc >= 0, lse - ll, 0.0).sum()
            del terms
            for i, blk in enumerate(blocks):
                dhi, dwi = step_mod.vocab_ce_grads(hc, yc, blk, i * rows,
                                                   lse, one)
                dh[:, a:a + chunk] += dhi
                dws[i] += dwi
                del dhi, dwi
        sync()
        sec = time.perf_counter() - t0
        top_w = [float(want_dw[i * rows:(i + 1) * rows].abs().max())
                 for i in range(n)]
        out["blocks"][n] = {
            "loss": float(loss),
            "loss_rel": abs(float(loss) - want_loss) / abs(want_loss),
            "dh_rel_to_max": float((dh - want_dh).abs().max())
            / float(want_dh.abs().max()),
            "dw_rel_to_block_max": [
                float((dws[i] - want_dw[i * rows:(i + 1) * rows]).abs().max())
                / max(top_w[i], 1e-30) for i in range(n)],
            "seconds": sec}
        del dh, dws
    del w, h, want_dh, want_dw
    return out


def phase_train_tp(smi: str) -> dict:
    """Tensor-parallel training's pieces on the card, at qwen2-1.5b's full
    width (one card cannot hold a model group of two NCCL ranks; the gloo
    tests of ``tests/test_torch_train_tp.py`` hold the multi-rank step's
    arithmetic): (b) each rank's head block through #12 and #12b
    (:func:`head_block_check`), no plain version; (c) the
    vocabulary-parallel cross-entropy's rank-local terms and gradients
    (:func:`vocab_ce_check`).  Returns the blocks' launches."""
    t_phase = time.perf_counter()
    cfg = get_config("qwen2-1.5b")
    checks = {}
    recs, sums, launched, plain, times = head_block_check(cfg)
    n_blocks = sum(MESH_TP)
    checks["b:modes"] = [r["mode"] for r in sums] == ["head",
                                                      "seq+q_heads_tp"]
    checks["b:block_heads"] = [(r["q_heads"][1] - r["q_heads"][0],
                                len(r["kv_heads"])) for r in recs] == \
        [(6, 1)] * 2 + [(3, 1)] * 4
    checks["b:o_lse_dq_bit_equal"] = len(recs) == n_blocks and all(
        r["o_bit_equal"] and r["lse_bit_equal"] and r["dq_bit_equal"]
        for r in recs)
    checks["b:dk_dv_within_tol"] = all(
        r["dk_scaled_err"] <= 1.0 and r["dv_scaled_err"] <= 1.0
        for r in sums)
    checks["b:forward_once_a_block"] = \
        launched["flash_attention"] == n_blocks
    checks["b:backward_once_a_block"] = \
        launched["flash_attention_bwd"] == n_blocks
    checks["b:no_plain_version"] = not any(plain.values())
    gc.collect()
    torch.cuda.empty_cache()
    ce = vocab_ce_check(cfg)
    for n, r in ce["blocks"].items():
        checks[f"c:loss_within_1e-5_rel_{n}_blocks"] = \
            r["loss_rel"] <= TP_CE_LOSS_REL
        checks[f"c:hidden_grad_within_1e-4_{n}_blocks"] = \
            r["dh_rel_to_max"] <= TP_CE_GRAD_REL
        checks[f"c:block_grads_within_1e-4_{n}_blocks"] = \
            len(r["dw_rel_to_block_max"]) == n and \
            max(r["dw_rel_to_block_max"]) <= TP_CE_GRAD_REL
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train_tp", "card": smi,
          "shape_q": [TRAIN_BATCH // TRAIN_MB, cfg.n_heads, TRAIN_SEQ,
                      cfg.head_dim],
          "head_blocks": recs, "kv_sums": sums, "times": times,
          "launches": launched, "plain_calls": plain, "vocab_ce": ce,
          "checks": checks, "seconds": time.perf_counter() - t_phase})
    for k_, ok in checks.items():
        if not ok:
            fail(f"train_tp: check {k_}")
    return {"flash_attention": launched["flash_attention"],
            "flash_attention_bwd": launched["flash_attention_bwd"]}


# ---------------------------------------------------------------------------
# training the MoE and Mamba-2 families split over "model": each rank's
# share of their layers in turn (one card, no group), #12 and #12b on each
# rank's head block of their attention layers, and the families' first
# train steps on the card
# ---------------------------------------------------------------------------

# (a), (d): the layers, at full width in bf16 from seeded weights, in train
# mode (capacity) at the train microbatch (2 x train_4k's 4096 tokens)
TX_LAYERS = (("olmoe-1b-7b", "moe"), ("jamba-v0.1-52b", "moe"),
             ("mamba2-370m", "ssm"), ("jamba-v0.1-52b", "ssm"))
TX_SEED = 70
# (a): a gradient's partials summed within this normalised distance of
# the whole layer's gradient: one bf16 rounding on each side (2^-8 each).
# Elementwise, split_errors' limit holds the output; a bf16 gradient sums
# terms that cancel (a token's k experts' rows, the router's part), so the
# whole layer's own gradient is off its float32 recomputation by more than
# that limit, and its elementwise terms are reported, not checked
TX_GRAD_NORM = 2.0 ** -7
# (b): the configurations whose attention layers train on head blocks
TX_HEADS = ("olmoe-1b-7b", "jamba-v0.1-52b")
# (c): mamba2-370m at full size through the launcher, as TRAIN_ARGV but
# for 3 steps; olmoe-1b-7b cut to 4 of its 16 layers through the step
TX_STEPS = 3
TX_MAMBA_ARGV = (["--arch", "mamba2-370m", "--steps", str(TX_STEPS)]
                 + TRAIN_ARGV[4:])
TX_OLMOE_LAYERS = 4
# (c): traces of a step at most (an MoE step's kernels depend on its
# routing, so two traces rarely agree and ``TRACES`` would take five)
TX_TRACES = 2


def tx_rules(cfg, tp: int):
    from repro_torch.launch.mesh import Mesh
    return make_rules(cfg, Mesh(("data", "model"), (1, tp)),
                      global_batch=TRAIN_BATCH, shape_kind="train")


def tx_block(rules, sub: str, name: str, leaf, r: int):
    """Rank ``r``'s spec block of one layer's leaf, as the train state
    holds it (``lm.param_spec``; the layer's leaves are unstacked, so
    their path is a tail layer's)."""
    spec = lm.param_spec(rules, f"tail/t0/{sub}/{name}", leaf.shape)
    return leaf[collectives.block_slices(tuple(leaf.shape), spec,
                                         rules.mesh,
                                         {"data": 0, "model": r})]


def tx_layer(cfg, sub: str, seed: int) -> tuple:
    """A layer's weights from ``seed`` (the model's own init, bf16 on the
    card), a seeded input (2, 4096, d_model) and upstream gradient."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    init = moe_mod.moe_init if sub == "moe" else mamba_mod.mamba_init
    lp = init(gen, cfg, torch.bfloat16)
    shape = (TRAIN_BATCH // TRAIN_MB, TRAIN_SEQ, cfg.d_model)
    x = torch.randn(shape, generator=gen, device=DEV).to(torch.bfloat16)
    dy = torch.randn(shape, generator=gen, device=DEV).to(torch.bfloat16)
    return lp, x, dy


def tx_leaves(d: dict) -> dict:
    return {k: v.detach().clone().requires_grad_() for k, v in d.items()}


def tx_whole(cfg, sub: str, lp, x, dy) -> tuple:
    """The whole layer's forward and backward: (output, gradients of x and
    of every leaf, the MoE's aux and expert segments)."""
    w, xw = tx_leaves(lp), x.detach().clone().requires_grad_()
    segs: list = []
    aux = None
    with expert_segments(segs):
        if sub == "moe":
            y, aux = moe_mod.moe_apply(w, xw, cfg, dropless=False)
            loss = ((y.float() * dy.float()).sum() + aux["moe_aux_loss"]
                    + aux["moe_z_loss"])
        else:
            y, _ = mamba_mod.mamba_layer(w, xw, cfg=cfg, mode="train")
            loss = (y.float() * dy.float()).sum()
    loss.backward()
    grads = {"x": xw.grad, **{k: v.grad for k, v in w.items()}}
    return y.detach(), grads, aux, segs


def tx_rank_leaves(cfg, rules, sub: str, lp, r: int) -> dict:
    """Rank ``r``'s leaves as the split train step hands them to the
    layer: spec blocks, but a Mamba layer's ``w_zxbcdt``, ``conv_w`` and
    ``conv_b`` whole (the layer takes its head-aligned columns); each a
    leaf of its own, so that its gradient is the rank's."""
    out = {}
    for k, v in lp.items():
        if sub == "ssm" and k in step_mod.HEAD_ALIGNED:
            out[k] = v
        else:
            out[k] = tx_block(rules, sub, k, v, r)
    return tx_leaves(out)


def tx_split_forward(cfg, sub: str, locs, xs, views):
    """Every rank's share of the layer in one autograd graph: (the ranks'
    partial outputs, the loss's aux term, each rank's aux, each rank's
    expert segments).  A Mamba layer's ranks' sums of squares are added
    before ``mamba_out`` (the group's first sum); a MoE's aux losses,
    the same on every rank, enter once."""
    parts, auxes, segs = [], [], []
    if sub == "moe":
        for loc, x_, v in zip(locs, xs, views):
            seen: list = []
            with expert_segments(seen):
                y, a = moe_mod.moe_apply(loc, x_, cfg, dropless=False, tp=v)
            parts.append(y)
            auxes.append(a)
            segs.append(seen)
        return parts, auxes[0]["moe_aux_loss"] + auxes[0]["moe_z_loss"], \
            auxes, segs
    mixed = [mamba_mod.mamba_mix(mamba_mod.rank_columns(loc, cfg, v), x_,
                                 cfg=cfg, mode="train", tp=v)
             for loc, x_, v in zip(locs, xs, views)]
    sumsq = mixed[0][1]
    for m in mixed[1:]:
        sumsq = sumsq + m[1]
    parts = [mamba_mod.mamba_out(loc, m[0], sumsq, cfg)
             for loc, m in zip(locs, mixed)]
    return parts, 0.0, auxes, segs


def tx_carried(cfg, lp, locs, xs, views):
    """What the Mamba ranks' normalised blocks, where their bf16 values
    differ from the whole layer's (the sum of squares summed in another
    order), carry into the output (``mamba_split_check``'s term)."""
    with torch.no_grad():
        g_whole, ss_whole, _ = mamba_mod.mamba_mix(lp, xs[0], cfg=cfg,
                                                   mode="train")
        yn_whole = mamba_mod.mamba_norm(lp, g_whole, ss_whole, cfg)
        mixed = [mamba_mod.mamba_mix(mamba_mod.rank_columns(loc, cfg, v),
                                     x_, cfg=cfg, mode="train", tp=v)
                 for loc, x_, v in zip(locs, xs, views)]
        sumsq = sum(m[1] for m in mixed)
        hp = cfg.ssm.head_dim
        carried = None
        for loc, m, v in zip(locs, mixed, views):
            cols = mamba_mod.head_columns(cfg, v.size, v.index)
            cut = slice(cols["head0"] * hp,
                        (cols["head0"] + cols["heads"]) * hp)
            yn = mamba_mod.mamba_norm(loc, m[0], sumsq, cfg)
            term = (yn.float() - yn_whole[..., cut].float()).abs() @ \
                loc["w_ssm_out"].float().abs()
            carried = term if carried is None else carried + term
        return carried


def tx_grad_errors(parts, want) -> dict:
    """A gradient's partials summed against the whole layer's:
    :func:`split_errors`' elementwise terms (reported) and the normalised
    distance ||sum - want|| / ||want||, which the check holds to
    ``TX_GRAD_NORM``."""
    rec = split_errors(parts, want)
    total = sum(p.float() for p in parts)
    wf = want.float()
    den = float(wf.norm())
    rec["norm_dist"] = float((total - wf).norm()) / den if den else (
        0.0 if float(total.norm()) == 0.0 else math.inf)
    return rec


def tx_split_check(cfg, sub: str, lp, x, dy) -> dict:
    """(a) one layer, whole and split over every model axis of
    ``SPLIT_TP``, forward and backward: the partials' sum, the gradient
    of x (each rank's share of it summed, as the *f* at the layer's input
    sums it), each spec block's gradient against its slice of the whole
    gradient (the router's, whole on every rank, summed over the ranks,
    as the gates' *f* sums its combine part), the three Mamba leaves'
    whole-shaped gradients summed over the ranks (B/C columns included),
    each within :func:`split_errors`' limit; the MoE's drops bit-equal and
    the ranks' expert segments and rows adding up to the whole's kept
    ones; (d)'s times at ``SPLIT_TIME_TP``."""
    want_y, want, aux, segs = tx_whole(cfg, sub, lp, x, dy)
    rec = {"leaves": {k: list(v.shape) for k, v in lp.items()}}
    if sub == "moe":
        rec.update(whole_segments=len(segs), whole_rows=sum(segs),
                   drop_frac=float(aux["moe_drop_frac"]))
    dyf = dy.float()
    for tp in SPLIT_TP:
        rules = tx_rules(cfg, tp)
        views = [collectives.rank_view(rules, r) for r in range(tp)]
        locs = [tx_rank_leaves(cfg, rules, sub, lp, r) for r in range(tp)]
        xs = [x.detach().clone().requires_grad_() for _ in range(tp)]
        parts, extra, auxes, rsegs = tx_split_forward(cfg, sub, locs, xs,
                                                      views)
        loss = extra
        for p in parts:
            loss = loss + (p.float() * dyf).sum()
        loss.backward()
        carried = (tx_carried(cfg, lp, locs, xs, views) if sub == "ssm"
                   else None)
        errs = {"y": split_errors([p.detach() for p in parts], want_y,
                                  carried),
                "x": tx_grad_errors([x_.grad for x_ in xs], want["x"])}
        for k, v in lp.items():
            if k == "router" or (sub == "ssm" and
                                 k in step_mod.HEAD_ALIGNED):
                errs[k] = tx_grad_errors([loc[k].grad for loc in locs],
                                         want[k])
                continue
            per = [tx_grad_errors([loc[k].grad],
                                  tx_block(rules, sub, k, want[k], r))
                   for r, loc in enumerate(locs)]
            errs[k] = {"scaled_err": max(e["scaled_err"] for e in per),
                       "max_abs_err": max(e["max_abs_err"] for e in per),
                       "over_limit": sum(e["over_limit"] for e in per),
                       "bit_equal": all(e["bit_equal"] for e in per),
                       "finite": all(e["finite"] for e in per),
                       "norm_dist": max(e["norm_dist"] for e in per),
                       "block_shape": list(locs[0][k].shape)}
        grads = [e for k, e in errs.items() if k != "y"]
        t = {"errors": errs,
             "y_scaled_err": errs["y"]["scaled_err"],
             "largest_grad_norm_dist": max(e["norm_dist"] for e in grads),
             "largest_grad_scaled_err": max(e["scaled_err"] for e in grads),
             "within_limit": (errs["y"]["finite"]
                              and errs["y"]["scaled_err"] <= 1.0
                              and all(e["finite"]
                                      and e["norm_dist"] <= TX_GRAD_NORM
                                      for e in grads))}
        if sub == "moe":
            t.update(drop_fracs=[float(a["moe_drop_frac"]) for a in auxes],
                     drops_bit_equal=all(
                         torch.equal(a["moe_drop_frac"],
                                     aux["moe_drop_frac"]) for a in auxes),
                     experts_a_rank=[int(loc["we_in"].shape[0])
                                     for loc in locs],
                     rows=[sum(s_) for s_ in rsegs],
                     segments_add_up=sum(len(s_) for s_ in rsegs)
                     == len(segs),
                     rows_add_up=sum(sum(s_) for s_ in rsegs) == sum(segs))
        else:
            t["heads_a_rank"] = [mamba_mod.head_columns(cfg, tp, r)["heads"]
                                 for r in range(tp)]
        rec[f"tp{tp}"] = t
        del locs, xs, parts, loss, carried
    del want_y, want
    rec["times"] = tx_times(cfg, sub, lp, x, dy)
    return rec


def tx_times(cfg, sub: str, lp, x, dy) -> dict:
    """(d) printed, not checked: the whole layer's forward and backward,
    and each rank's share of it at a model axis of ``SPLIT_TIME_TP`` (a
    Mamba rank's own sum of squares standing for the group's)."""
    def fwd_bwd(leaves, view=None):
        w = tx_leaves(leaves)

        def call():
            for v in w.values():
                v.grad = None
            xw = x.detach().requires_grad_()
            if sub == "moe":
                y, a = moe_mod.moe_apply(w, xw, cfg, dropless=False,
                                         tp=view)
                loss = a["moe_aux_loss"] + a["moe_z_loss"]
            else:
                y, _ = mamba_mod.mamba_layer(w, xw, cfg=cfg, mode="train",
                                             tp=view)
                loss = 0.0
            (loss + (y.float() * dy.float()).sum()).backward()
        return call

    rules = tx_rules(cfg, SPLIT_TIME_TP)
    out = {"whole_ms": time_ms(fwd_bwd(lp), 3)}
    ranks = []
    for r in range(SPLIT_TIME_TP):
        view = collectives.rank_view(rules, r)
        loc = {k: (v if sub == "ssm" and k in step_mod.HEAD_ALIGNED
                   else tx_block(rules, sub, k, v, r))
               for k, v in lp.items()}
        ranks.append(time_ms(fwd_bwd(loc, view), 3))
    out["rank_ms"] = ranks
    out["slowest_rank_over_whole"] = max(ranks) / out["whole_ms"]
    return out


def tx_train_olmoe(smi: str) -> tuple:
    """(c) olmoe-1b-7b cut to ``TX_OLMOE_LAYERS`` layers through
    ``train.step.make_train_step`` at the launcher's settings for
    TRAIN_ARGV (bf16, remat by layer, 2 microbatches of 2 x 4096),
    ``TX_STEPS`` steps between a reset and a read of the counts.
    Returns (record, checks, the counts)."""
    argv = ["--arch", "olmoe-1b-7b", "--steps", str(TX_STEPS)] + \
        TRAIN_ARGV[4:]
    _, mesh, shape, _, tcfg = train_cli.build(
        train_cli.parser().parse_args(argv))
    whole_cfg = get_config("olmoe-1b-7b")
    cfg = dataclasses.replace(whole_cfg, n_layers=TX_OLMOE_LAYERS)
    rules = make_rules(cfg, mesh, global_batch=TRAIN_BATCH,
                       shape_kind="train")
    torch.cuda.reset_peak_memory_stats()
    state = step_mod.init_state(
        cfg, tcfg, torch.Generator(device=DEV).manual_seed(tcfg.seed))
    loader = DataLoader(cfg, shape, mesh=mesh, device=DEV, seed=tcfg.seed)
    step_fn = step_mod.make_train_step(cfg, rules, tcfg,
                                       microbatches=tcfg.microbatches)
    hist, step_s = [], []
    counts.reset()
    for i in range(TX_STEPS):
        batch = loader.device_batch(i)
        sync()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch.tokens, batch.labels)
        hist.append(fault_tolerance._scalars(metrics))
        sync()
        step_s.append(time.perf_counter() - t0)
    launched, plain = counts.snapshot()
    by_instance = dict(counts.INSTANCES)
    peak = torch.cuda.max_memory_allocated()
    batch = loader.device_batch(0)

    def one_step():
        return step_fn(state, batch.tokens, batch.labels)

    prof = profile_calls(one_step, 1, traces=TX_TRACES)
    syncs = host_syncs(lambda: fault_tolerance._scalars(one_step()[1]))
    step_ms = statistics.median(step_s[1:]) * 1e3
    roofline_line(f"{cfg.name} ({TX_OLMOE_LAYERS} of "
                  f"{whole_cfg.n_layers} layers) train step", cfg,
                  TRAIN_SHAPE, count_call(step_fn, state, batch.tokens,
                                          batch.labels),
                  step_ms, TRAIN_BATCH * TRAIN_SEQ)
    mb = tcfg.microbatches
    rec = {"config": cfg.name, "argv_settings": argv,
           "n_layers": TX_OLMOE_LAYERS,
           "n_layers_cut_from": whole_cfg.n_layers,
           "n_params": sum(t.numel() for t in tree_mod.leaves(
               state["params"])),
           "step_ms": [x * 1e3 for x in step_s], "step_ms_median": step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
           "losses": [m["loss"] for m in hist],
           "grad_norms": [m["grad_norm"] for m in hist],
           "moe_drop_fracs": [m["moe_drop_frac"] for m in hist],
           "launches": launched, "launches_by_instance": by_instance,
           "plain_calls": plain, "profile_one_step": prof,
           "busy_share": prof["device_ms_a_call"] / step_ms,
           "host_syncs_a_step": syncs, "peak_bytes": peak}
    fwd_want = 2 * TX_OLMOE_LAYERS * mb * TX_STEPS
    checks = tx_step_checks(cfg, rec)
    checks["c:olmoe_flash_forward_twice_a_layer_and_microbatch"] = (
        launched["flash_attention"] == fwd_want
        and by_instance["flash_attention:wgmma_bf16"] == fwd_want)
    checks["c:olmoe_flash_backward_once_a_layer_and_microbatch"] = (
        launched["flash_attention_bwd"] == fwd_want // 2
        and by_instance["flash_attention_bwd:wgmma_bf16"] == fwd_want // 2)
    checks["c:olmoe_no_plain_version"] = not any(plain.values())
    del state, loader, step_fn, batch
    return rec, checks, launched


def tx_step_checks(cfg, rec: dict) -> dict:
    """(c)'s checks of one family's steps: every loss and grad norm
    finite, step 0's loss within ``TRAIN_LOSS0_TOL`` of ln V."""
    name = cfg.name.split("-")[0]
    return {f"c:{name}_losses_and_grad_norms_finite": all(
        math.isfinite(v) for v in rec["losses"] + rec["grad_norms"]),
        f"c:{name}_step0_loss_near_ln_v":
            abs(rec["losses"][0] - math.log(cfg.vocab_size))
            <= TRAIN_LOSS0_TOL,
        f"c:{name}_steps_run": len(rec["losses"]) == TX_STEPS}


def tx_train_mamba(smi: str) -> tuple:
    """(c) mamba2-370m at full size through ``launch.train.run``
    (``TX_MAMBA_ARGV``) between a reset and a read of the counts.
    Returns (record, checks)."""
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    t0 = time.perf_counter()
    run = train_cli.run(TX_MAMBA_ARGV, verbose=False)
    sync()
    entry_s = time.perf_counter() - t0
    launched, plain = counts.snapshot()
    peak = torch.cuda.max_memory_allocated()
    cfg, state, hist = run.cfg, run.state, run.result.metrics_history
    step_s = run.step_seconds
    step_ms = statistics.median(step_s[1:]) * 1e3
    step_fn = step_mod.make_train_step(cfg, run.rules, run.tcfg,
                                       microbatches=TRAIN_MB)
    batch = DataLoader(cfg, run.shape, device=DEV, seed=0).device_batch(0)

    def one_step():
        return step_fn(state, batch.tokens, batch.labels)

    prof = profile_calls(one_step, 1, traces=TX_TRACES)
    syncs = host_syncs(lambda: fault_tolerance._scalars(one_step()[1]))
    roofline_line(f"{cfg.name} train step", cfg, TRAIN_SHAPE,
                  count_call(step_fn, state, batch.tokens, batch.labels),
                  step_ms, TRAIN_BATCH * TRAIN_SEQ)
    rec = {"config": cfg.name, "argv": TX_MAMBA_ARGV,
           "n_params": cfg.n_params(), "n_layers": cfg.n_layers,
           "entry_seconds": entry_s,
           "step_ms": [x * 1e3 for x in step_s], "step_ms_median": step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
           "losses": [m["loss"] for m in hist],
           "grad_norms": [m["grad_norm"] for m in hist],
           "launches": launched, "plain_calls": plain,
           "profile_one_step": prof,
           "busy_share": prof["device_ms_a_call"] / step_ms,
           "host_syncs_a_step": syncs, "peak_bytes": peak}
    checks = tx_step_checks(cfg, rec)
    checks["c:mamba2_on_the_card"] = str(run.device).startswith("cuda")
    checks["c:mamba2_no_plain_version"] = not any(plain.values())
    del run, state, step_fn, batch
    return rec, checks


def phase_train_experts(smi: str) -> dict:
    """Training the MoE and Mamba-2 families split over "model", on one
    card (one card carries one rank, so each rank's share runs in turn
    through ``collectives.rank_view`` with no group; the gloo tests of
    ``tests/test_torch_train_experts.py`` hold the collectives): (a) the
    first MoE layer of olmoe-1b-7b and jamba-v0.1-52b and the first Mamba
    layer of mamba2-370m and jamba, split over model axes of 2, 4 and 8
    against the whole layer, forward and backward
    (:func:`tx_split_check`); (b) #12 and #12b on each rank's head block
    of olmoe's and jamba's attention at those axes
    (:func:`head_block_check`); (c) the families' first train steps at
    full width: mamba2-370m through the launcher, olmoe-1b-7b cut to 4
    layers through the step; (d) the split layers' times.  Returns the
    launches of #12 and #12b in (b) and (c)."""
    t_phase = time.perf_counter()
    checks, layers = {}, []
    for arch, sub in TX_LAYERS:
        cfg = get_config(arch)
        lp, x, dy = tx_layer(cfg, sub, TX_SEED + len(layers))
        rec = tx_split_check(cfg, sub, lp, x, dy)
        name = f"{arch.split('-')[0]}_{sub}"
        for tp in SPLIT_TP:
            t = rec[f"tp{tp}"]
            checks[f"a:{name}_tp{tp}_within_limit"] = t["within_limit"]
            if sub == "moe":
                checks[f"a:{name}_tp{tp}_drops_bit_equal"] = \
                    t["drops_bit_equal"]
                checks[f"a:{name}_tp{tp}_segments_add_up"] = \
                    t["segments_add_up"] and t["rows_add_up"]
                checks[f"a:{name}_tp{tp}_experts_a_rank"] = \
                    t["experts_a_rank"] == [cfg.moe.n_experts // tp] * tp
            else:
                checks[f"a:{name}_tp{tp}_heads_a_rank"] = \
                    t["heads_a_rank"] == \
                    [cfg.ssm.n_heads(cfg.d_model) // tp] * tp
        layers.append({"config": arch, "layer": sub, **rec})
        del lp, x, dy
        gc.collect()
        torch.cuda.empty_cache()
    t_a = time.perf_counter() - t_phase

    heads, launches = [], {"flash_attention": 0, "flash_attention_bwd": 0}
    for arch in TX_HEADS:
        cfg = get_config(arch)
        recs, sums, launched, plain, times = head_block_check(cfg, SPLIT_TP)
        n_blocks = sum(SPLIT_TP)
        name = arch.split("-")[0]
        checks[f"b:{name}_head_mode"] = all(r["mode"] == "head"
                                            for r in sums)
        checks[f"b:{name}_o_lse_dq_bit_equal"] = len(recs) == n_blocks and \
            all(r["o_bit_equal"] and r["lse_bit_equal"] and r["dq_bit_equal"]
                for r in recs)
        checks[f"b:{name}_dk_dv_within_tol"] = all(
            r["dk_scaled_err"] <= 1.0 and r["dv_scaled_err"] <= 1.0
            for r in sums)
        checks[f"b:{name}_forward_once_a_block"] = \
            launched["flash_attention"] == n_blocks
        checks[f"b:{name}_backward_once_a_block"] = \
            launched["flash_attention_bwd"] == n_blocks
        checks[f"b:{name}_no_plain_version"] = not any(plain.values())
        for k in launches:
            launches[k] += launched[k]
        heads.append({"config": arch, "blocks": recs, "kv_sums": sums,
                      "times": times, "launches": launched})
    gc.collect()
    torch.cuda.empty_cache()

    t_b = time.perf_counter() - t_phase - t_a
    t0 = time.perf_counter()
    mamba_rec, c = tx_train_mamba(smi)
    mamba_rec["seconds"] = time.perf_counter() - t0
    checks.update(c)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    olmoe_rec, c, launched = tx_train_olmoe(smi)
    olmoe_rec["seconds"] = time.perf_counter() - t0
    checks.update(c)
    for k in launches:
        launches[k] += launched[k]
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train_experts", "card": smi,
          "model_axes": list(SPLIT_TP),
          "shape": [TRAIN_BATCH // TRAIN_MB, TRAIN_SEQ],
          "layers": layers, "heads": heads,
          "train": {"mamba2": mamba_rec, "olmoe": olmoe_rec},
          "largest_y_scaled_err": max(
              layer[f"tp{tp}"]["y_scaled_err"] for layer in layers
              for tp in SPLIT_TP),
          "largest_grad_norm_dist": max(
              layer[f"tp{tp}"]["largest_grad_norm_dist"] for layer in layers
              for tp in SPLIT_TP),
          "grad_norm_limit": TX_GRAD_NORM,
          "launches": launches, "checks": checks, "seconds_a": t_a,
          "seconds_b": t_b,
          "seconds": time.perf_counter() - t_phase})
    for k_, ok in checks.items():
        if not ok:
            fail(f"train_experts: check {k_}")
    return launches


# ---------------------------------------------------------------------------
# serving on a mesh: launch.serve's mesh path over NCCL (world 1), each
# tensor-parallel rank's head block on the card, GPipe's stage body
# ---------------------------------------------------------------------------

# serve's argv on a (1, 1) mesh: bound to the group where one exists
MESH_SERVE_ARGV = SERVE_ARGV + ["--data", "1", "--model", "1"]
# the model axes whose ranks' head blocks (b) runs: "head" mode at 2 (6 q
# heads and 1 KV head a rank), "seq" with q_heads_tp at 4 (3 and 1)
MESH_TP = (2, 4)
GPIPE_MICRO = 4
MESH_TURNS = 3                 # (a): unbound, mesh, unbound, mesh, ...
# the calls that would move data between ranks
DIST_CALLS = ("all_reduce", "all_gather_into_tensor", "broadcast", "isend",
              "irecv", "send", "recv", "batch_isend_irecv")


@contextlib.contextmanager
def dist_calls():
    """Counts the ``torch.distributed`` calls made while the block runs
    (name -> calls)."""
    seen: dict = {}
    real = {n: getattr(torch.distributed, n) for n in DIST_CALLS}

    def counted(name):
        def call(*a, **k):
            seen[name] = seen.get(name, 0) + 1
            return real[name](*a, **k)
        return call

    for n in DIST_CALLS:
        setattr(torch.distributed, n, counted(n))
    try:
        yield seen
    finally:
        for n, f in real.items():
            setattr(torch.distributed, n, f)


def head_blocks(cfg, tp: int) -> tuple:
    """(mode, [(first q head, q heads, KV heads) of each rank]) of layer 0
    on a (1, ``tp``) mesh, as the rules cut it: "head" mode a rank's block
    of KV heads, "seq" mode the KV heads its q heads read
    (``attention.kv_heads_of``, the model's own map)."""
    from repro_torch.launch.mesh import Mesh
    rules = make_rules(cfg, Mesh(("data", "model"), (1, tp)),
                       global_batch=SERVE_BATCH, shape_kind="decode")
    h, kv = cfg.n_heads, cfg.n_kv_heads
    hl, out = h // tp, []
    for i in range(tp):
        if rules.attn_mode == "head":
            heads = list(range(i * kv // tp, (i + 1) * kv // tp))
        else:
            heads = attention.kv_heads_of(i * hl, hl, h, kv)
        out.append((i * hl, hl, heads))
    mode = rules.attn_mode + ("+q_heads_tp" if rules.q_heads_tp else "")
    return mode, out


def phase_serve_mesh(smi: str) -> int:
    """(a) ``launch.serve`` at ``serve``'s argv plus ``--data 1 --model
    1``, first with no process group (an unbound one-device mesh), then on
    one NCCL group of one rank (a file store in a temporary directory,
    destroyed in a ``finally``) through the mesh path: the greedy tokens
    and the last logits bit-equal, one ``wgmma_bf16`` flash launch a layer
    and no plain version, no ``torch.distributed`` call in a generate or a
    prefill (every collective of one rank skipped); prefill ms and decode
    ms a step of both engines, timed in ``MESH_TURNS`` turns (unbound,
    mesh, unbound, mesh, ...), their ratios, and each run's peak memory
    above what was allocated before it.  (b) Layer 0's q, k, v of the
    serve prefill cut as the ranks of a model axis of 2 ("head" mode) and
    4 ("seq" with ``q_heads_tp``) cut them: kernel #12 on each rank's
    block bit-equal to its head slice of the whole call.  (c)
    ``make_gpipe`` on a one-stage ``"stage"`` mesh of the group, its stage
    one qwen2-1.5b decoder layer in prefill mode at the serve shape in
    ``GPIPE_MICRO`` microbatches, bit-equal to ``reference_pipeline``, no
    ``torch.distributed`` call.  Returns (a)'s flash launches."""
    from repro_torch.launch.mesh import Mesh, describe
    from repro_torch.parallel import collectives, pipeline
    t_phase = time.perf_counter()
    checks = {}
    max_len = SERVE_PROMPT + SERVE_NEW

    if collectives.initialized():
        fail("serve_mesh: a process group existed before the phase")
    # each run's peak is taken above what was allocated before it
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    one = serve_cli.run(MESH_SERVE_ARGV)
    sync()
    peak = {"one": torch.cuda.max_memory_allocated() - base}
    checks["a:one_device_mesh_unbound"] = not one.mesh.bound

    store_dir = tempfile.mkdtemp(prefix="repro_serve_mesh_")
    created = False
    try:
        created = collectives.setup("nccl", rank=0, world_size=1,
                                    store_path=os.path.join(store_dir,
                                                            "store"))
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counts.reset()
        run = serve_cli.run(MESH_SERVE_ARGV)
        sync()
        launched, plain = counts.snapshot()
        by_instance = dict(counts.INSTANCES)
        peak["mesh"] = torch.cuda.max_memory_allocated() - base
        cfg, engine, prompts = run.cfg, run.engine, run.prompts
        checks["a:group_nccl_world_1"] = (
            torch.distributed.get_backend() == "nccl"
            and torch.distributed.get_world_size() == 1)
        checks["a:mesh_bound_1x1"] = (run.mesh.bound and run.mesh.rank == 0
                                      and describe(run.mesh)
                                      == "data=1xmodel=1")
        checks["a:full_width_bf16"] = (
            (cfg.name, cfg.n_layers, cfg.d_model, cfg.n_heads,
             cfg.n_kv_heads, engine.params["embed"].dtype)
            == ("qwen2-1.5b", 28, 1536, 12, 2, torch.bfloat16))
        checks["a:no_context_at_one_rank"] = \
            collectives.tensor_parallel(engine.rules) is None
        checks["a:tokens_bit_equal"] = torch.equal(
            run.result.tokens.cpu(), one.result.tokens.cpu())
        checks["a:last_logits_bit_equal"] = torch.equal(
            run.result.logits.cpu(), one.result.logits.cpu())
        checks["a:kv_pool_equal"] = run.result.kv_pool == one.result.kv_pool
        checks["a:flash_once_a_layer"] = \
            launched["flash_attention"] == cfg.n_layers
        checks["a:flash_on_wgmma_bf16"] = \
            by_instance["flash_attention:wgmma_bf16"] == cfg.n_layers
        checks["a:no_plain_version"] = not any(plain.values())

        # the two engines timed in turns: prefill, then a timed generate;
        # a decode step is host-bound and spreads, so every turn's steps
        # are pooled
        steps = {"one": one.engine, "mesh": engine}
        prefill_ms = {k: [] for k in steps}
        decode_ms = {k: [] for k in steps}
        timed_tokens_equal, calls = True, {}
        for turn in range(MESH_TURNS):
            for name, e in steps.items():
                prefill = make_prefill_step(cfg, e.rules, max_len=max_len)
                with dist_calls() as seen:
                    prefill_ms[name].append(time_ms(
                        lambda: prefill(e.params, prompts), 3))
                    res, ms = timed_generate(e, prompts)
                calls[name] = dict(seen)
                decode_ms[name].append(ms)
                timed_tokens_equal &= torch.equal(res.tokens,
                                                  one.result.tokens)
                del res
        checks["a:timed_tokens_equal"] = timed_tokens_equal
        checks["a:no_collective_at_one_rank"] = not calls["mesh"]
        pre = {k: statistics.median(v) for k, v in prefill_ms.items()}
        dec = {k: statistics.median([m for t in v for m in t])
               for k, v in decode_ms.items()}

        # (b) each rank's head block through kernel #12
        params = engine.params
        lp, idx = layer_params(cfg, params, 0)
        h = rmsnorm(lm.embed_tokens(params, prompts, cfg), lp["ln1"],
                    cfg.norm_eps)
        q, k, v = attention.project_qkv(
            lp["attn"], h, cfg=cfg, layer_idx=idx,
            positions=torch.arange(SERVE_PROMPT, device=DEV))
        akw = dict(window=attention.layer_window(cfg, idx),
                   scale=cfg.head_dim ** -0.5)
        whole = attention.prefill_attention(q, k, v, **akw)
        blocks = []
        for tp in MESH_TP:
            mode, ranks = head_blocks(cfg, tp)
            for i, (h0, hl, kv_heads) in enumerate(ranks):
                got = attention.prefill_attention(
                    q[:, :, h0:h0 + hl], k[:, :, kv_heads],
                    v[:, :, kv_heads], **akw)
                want = whole[:, :, h0:h0 + hl]
                blocks.append({"tp": tp, "mode": mode, "rank": i,
                               "q_heads": [h0, h0 + hl],
                               "kv_heads": kv_heads,
                               "bit_equal": torch.equal(got, want),
                               "max_abs_err": diff(got, want)})
        checks["b:every_block_bit_equal"] = (
            len(blocks) == sum(MESH_TP)
            and all(b["bit_equal"] for b in blocks))
        checks["b:modes"] = [head_blocks(cfg, tp)[0] for tp in MESH_TP] == \
            ["head", "seq+q_heads_tp"]
        checks["b:block_heads"] = [(b["q_heads"][1] - b["q_heads"][0],
                                    len(b["kv_heads"])) for b in blocks] == \
            [(6, 1)] * 2 + [(3, 1)] * 4
        del q, k, v, whole, got, want

        # (c) GPipe on a one-stage mesh of the group, one decoder layer a
        # stage, the serve prefill's hidden states in microbatches
        smesh = collectives.bind(Mesh(("stage",), (1,)))
        stage_params = tree_mod.tree_map(lambda t: t[0:1],
                                         params["scan"]["p0"])
        x = lm.embed_tokens(params, prompts, cfg)
        x_micro = x.reshape(GPIPE_MICRO, SERVE_BATCH // GPIPE_MICRO,
                            *x.shape[1:])

        def apply_stage(p, xm):
            return blocks_mod.layer_apply(p, xm, cfg=cfg, layer_idx=0,
                                          mode="prefill",
                                          max_len=max_len)[0]

        counts.reset()
        with dist_calls() as seen:
            y = pipeline.make_gpipe(smesh, apply_stage,
                                    n_micro=GPIPE_MICRO)(stage_params,
                                                         x_micro)
        sync()
        g_launched, g_plain = counts.snapshot()
        gpipe_calls = dict(seen)
        y_ref = pipeline.reference_pipeline(apply_stage, stage_params,
                                            x_micro)
        checks["c:gpipe_bit_equal"] = torch.equal(y, y_ref)
        checks["c:gpipe_finite"] = bool(torch.isfinite(y).all())
        checks["c:gpipe_no_collective"] = not gpipe_calls
        checks["c:flash_once_a_microbatch"] = (
            g_launched["flash_attention"] == GPIPE_MICRO
            and not any(g_plain.values()))
        gpipe_err = diff(y, y_ref)
        tokens_sample = run.result.tokens[0, :16].tolist()
        del y, y_ref, x, x_micro, stage_params, run, engine, params
    finally:
        if created:
            collectives.teardown()
        shutil.rmtree(store_dir, ignore_errors=True)
    checks["group_destroyed"] = not collectives.initialized()
    del one
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "serve_mesh", "card": smi, "argv": MESH_SERVE_ARGV,
          "backend": "nccl", "world_size": 1, "mesh": "data=1xmodel=1",
          "prefill_ms": pre, "prefill_ms_turns": prefill_ms,
          "prefill_mesh_over_one": pre["mesh"] / pre["one"],
          "decode_ms_per_step": dec,
          "decode_ms_turn_medians": {k: [statistics.median(t) for t in v]
                                     for k, v in decode_ms.items()},
          "decode_mesh_over_one": dec["mesh"] / dec["one"],
          "peak_bytes_above_base": peak,
          "peak_mesh_over_one": peak["mesh"] / peak["one"],
          "dist_calls": calls, "launches": launched,
          "launches_by_instance": by_instance, "plain_calls": plain,
          "head_blocks": blocks,
          "gpipe": {"n_micro": GPIPE_MICRO, "max_abs_err": gpipe_err,
                    "launches": g_launched["flash_attention"],
                    "dist_calls": gpipe_calls},
          "tokens_sample": tokens_sample, "checks": checks,
          "seconds": time.perf_counter() - t_phase})
    for k_, ok in checks.items():
        if not ok:
            fail(f"serve_mesh: check {k_}")
    return launched["flash_attention"]


# ---------------------------------------------------------------------------
# the dry-run: every architecture's production cell as one rank's call on
# ``meta`` tensors (repro_torch.launch.dryrun), and its predictions held
# against the card
# ---------------------------------------------------------------------------

# (a): every architecture's train_4k on the 16x16 mesh, rank 0, each cell
# in a process of its own (one ``fake`` group a process), this many at once
DRY_SHAPE, DRY_MESH, DRY_PARALLEL = "train_4k", "pod", 4
DRY_CELL_LIMIT = 600           # seconds for one cell's process
# (b), (c): the card's peak within this share of the predicted one
DRY_PEAK_REL = 0.10
# (c): and less cuBLAS's workspaces (the child makes them at its first
# GEMMs; (b)'s process holds them before its start) within this share:
# what is left is the allocator's rounding and the temporaries inside an
# operation, which a dispatch mode does not see
DRY_PEAK_LESS_WS_REL = 0.02
# (c): the production cell whose rank share runs on the card, and the one
# taken instead where (a) predicts more than this share of the card
DRY_CARD_CELL = ("qwen2-1.5b", "train_4k")
DRY_CARD_ALT = ("qwen2-1.5b", "prefill_32k")
DRY_CARD_SHARE = 0.90
# the counts a dry-run predicts and the card must count alike
DRY_COUNTS = ("hlo_flops", "hlo_bytes", "movement_bytes", "kernels",
              "collective_ops")
# (c): one rank's call on the card, in a process of its own: the cell as
# the dry-run builds it (rank 0 on the production mesh, the ``fake``
# group), its blocks seeded from a torch.Generator on the card; the
# record, the card's peak above the process's start, the launches and one
# more step's device ms on the last line
DRY_CHILD = r'''
import json, sys
import torch
from repro_torch import tree
from repro_torch.configs import SHAPES, get_config
from repro_torch.kernels import counts
from repro_torch.launch import dryrun
from repro_torch.parallel import collectives
arch, shape_name = sys.argv[1], sys.argv[2]
cfg, shape = get_config(arch), SHAPES[shape_name]
dev = torch.device("cuda")
fn, args, meta = dryrun.lower_cell(arch, shape_name)
gen = torch.Generator(dev).manual_seed(0)
def seeded(t):
    if not isinstance(t, torch.Tensor):
        return t
    if t.is_floating_point():
        return torch.empty(t.shape, dtype=t.dtype, device=dev).normal_(
            0.0, 0.02, generator=gen)
    if t.dim() == 0:
        return torch.zeros((), dtype=t.dtype, device=dev)
    return torch.randint(0, cfg.vocab_size, t.shape, dtype=t.dtype,
                         device=dev, generator=gen)
def zeroed(t):
    return torch.zeros(t.shape, dtype=t.dtype, device=dev)
def on_card(a):
    # a train state as init_state makes it: seeded parameters, the
    # moments, the step and an error state zero
    if isinstance(a, dict) and "opt" in a:
        return {k: tree.tree_map(seeded if k == "params" else zeroed, v)
                for k, v in a.items()}
    return tree.tree_map(seeded, a) if isinstance(a, dict) else seeded(a)
torch.cuda.synchronize()
base = torch.cuda.memory_allocated()
card = tuple(on_card(a) for a in args)
del args
torch.cuda.synchronize()
arg_bytes = torch.cuda.memory_allocated() - base
torch.cuda.reset_peak_memory_stats()
counts.reset()
rec = dryrun.analyze_cell(fn, card, meta, cfg, shape)
torch.cuda.synchronize()
peak = torch.cuda.max_memory_allocated() - base
launched, plain = counts.snapshot()
instances = dict(counts.INSTANCES)
start = torch.cuda.Event(enable_timing=True)
stop = torch.cuda.Event(enable_timing=True)
start.record()
fn(*card)
stop.record()
stop.synchronize()
# what the steps left allocated beyond the arguments, and the part of it
# that is cuBLAS's workspaces (one a thread and stream, made at its first
# GEMM, which a process that has run a GEMM before holds already)
resident = torch.cuda.memory_allocated() - base - arg_bytes
torch._C._cuda_clearCublasWorkspaces()
workspaces = resident - (torch.cuda.memory_allocated() - base - arg_bytes)
collectives.teardown()
print("DRY_CARD " + json.dumps({
    "record": rec, "peak": peak, "launches": launched, "plain": plain,
    "instances": instances, "step_ms": start.elapsed_time(stop),
    "arg_bytes": arg_bytes, "resident": resident,
    "cublas_workspaces": workspaces}))
'''


def dry_cells(cells, out: str) -> dict:
    """Runs ``python -m repro_torch.launch.dryrun`` for each (arch, shape,
    mesh) of ``cells``, ``DRY_PARALLEL`` at once, with the package on
    their path and no card visible (the dry-run needs none); ->
    {(arch, shape): (its record or None, its seconds, its log's last
    lines)}."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    pending, running, done = list(cells), {}, {}
    while pending or running:
        while pending and len(running) < DRY_PARALLEL:
            arch, shape, mesh = pending.pop(0)
            log = tempfile.TemporaryFile(mode="w+")
            p = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--mesh", mesh,
                 "--out", out], env=env, cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT)
            running[(arch, shape)] = (p, log, mesh, time.perf_counter())
        time.sleep(0.2)
        for key, (p, log, mesh, t0) in list(running.items()):
            if p.poll() is None and time.perf_counter() - t0 < DRY_CELL_LIMIT:
                continue
            if p.poll() is None:
                p.kill()
                p.wait()
            log.seek(0)
            tail = log.read().splitlines()[-4:]
            log.close()
            path = os.path.join(out, f"{key[0]}_{key[1]}_{mesh}.json")
            rec = (json.load(open(path)) if p.returncode == 0
                   and os.path.exists(path) else None)
            done[key] = (rec, time.perf_counter() - t0, tail)
            del running[key]
    return done


def dry_versus_card(kind: str) -> dict:
    """(b): qwen2-1.5b at full size, no mesh, the dry-run's call on
    ``meta`` and then on the card (random weights from a seed): ``train``
    one step of 4 x 4096 in 2 microbatches with remat; ``prefill`` the
    serve prefill of 4 x 2048.  The counts equal, the predicted peak
    within ``DRY_PEAK_REL`` of the card's ``max_memory_allocated`` above
    the arguments' start, #12 and #12b launched on ``wgmma_bf16`` only."""
    from repro_torch.launch import dryrun
    cfg = get_config("qwen2-1.5b")
    if kind == "train":
        shape = TRAIN_SHAPE
        tcfg = TrainConfig(microbatches=TRAIN_MB,
                           loss_chunk=min(1024, TRAIN_SEQ), remat="layer")
        rules = make_rules(cfg, make_host_mesh(1, 1),
                           global_batch=TRAIN_BATCH)
        fn = step_mod.make_train_step(cfg, rules, tcfg,
                                      microbatches=TRAIN_MB)
        rows = (TRAIN_BATCH, TRAIN_SEQ)

        def arguments(dev, gen):
            state = (step_mod.state_struct(cfg, tcfg) if gen is None else
                     step_mod.init_state(cfg, tcfg, gen))
            return (state, *(torch.randint(0, cfg.vocab_size, rows,
                                           dtype=torch.int32, device=dev)
                             for _ in range(2)), None)
        want = {"flash_attention": 2 * cfg.n_layers * TRAIN_MB,
                "flash_attention_bwd": cfg.n_layers * TRAIN_MB}
    else:
        shape = SERVE_PREFILL_SHAPE
        rules = make_rules(cfg, make_host_mesh(1, 1),
                           global_batch=SERVE_BATCH, shape_kind="prefill")
        fn = make_prefill_step(cfg, rules, max_len=SERVE_PROMPT)
        rows = (SERVE_BATCH, SERVE_PROMPT)

        def arguments(dev, gen):
            params = (lm.param_struct(cfg) if gen is None else
                      lm.init_params(cfg, gen))
            return (params, torch.randint(0, cfg.vocab_size, rows,
                                          dtype=torch.int32, device=dev),
                    None)
        want = {"flash_attention": cfg.n_layers, "flash_attention_bwd": 0}
    info = {"arch": cfg.name, "shape": shape.name, "mesh": "1 x H100",
            "n_devices": 1}
    # the dry-run: no launch, no plain call, the kernels modelled
    before = counts.snapshot()
    modelled = dict(counts.MODELLED)
    t0 = time.perf_counter()
    meta_args = arguments(torch.device("meta"), None)
    predicted = dryrun.analyze_cell(fn, meta_args, info, cfg, shape)
    meta_s = time.perf_counter() - t0
    after_meta = counts.snapshot()
    del meta_args
    modelled = {k: counts.MODELLED[k] - modelled[k] for k in modelled
                if counts.MODELLED[k] > modelled[k]}
    # the card: the same call, its peak above the arguments' start
    gc.collect()
    torch.cuda.empty_cache()
    sync()
    base = torch.cuda.memory_allocated()
    args = arguments(DEV, torch.Generator(DEV).manual_seed(0))
    sync()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    t0 = time.perf_counter()
    measured = dryrun.analyze_cell(fn, args, info, cfg, shape)
    sync()
    card_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launched, plain = counts.snapshot()
    instances = {k: v for k, v in counts.INSTANCES.items() if v}
    del args
    gc.collect()
    torch.cuda.empty_cache()
    pred = predicted["bytes_per_device"]
    checks = {f"{k}_equal": predicted[k] == measured[k] for k in DRY_COUNTS}
    checks.update(
        meta_launched_nothing=before == after_meta,
        modelled_both=(set(modelled) == {f"{k}:wgmma_bf16" for k, n in
                                         want.items() if n}),
        peak_within=abs(pred - peak) <= DRY_PEAK_REL * peak,
        tracker_equal=(measured["bytes_per_device"] == pred),
        launches=all(launched[k] == n for k, n in want.items()),
        wgmma_only=all(instances.get(f"{k}:wgmma_bf16", 0) == n
                       for k, n in want.items()),
        no_plain=not any(plain.values()))
    return {"kind": kind, "shape": dataclasses.asdict(shape),
            "predicted_peak_bytes": pred, "card_peak_bytes": peak,
            "card_tracker_bytes": measured["bytes_per_device"],
            "peak_gap": (pred - peak) / peak,
            "memory_analysis": predicted["memory_analysis"],
            "counts": {k: predicted[k] for k in DRY_COUNTS},
            "card_counts": {k: measured[k] for k in DRY_COUNTS},
            "t_compute_ms": predicted["t_compute"] * 1e3,
            "t_memory_ms": predicted["t_memory"] * 1e3,
            "modelled": modelled, "launches": launched,
            "instances": instances, "meta_s": meta_s, "card_s": card_s,
            "checks": checks}


def dry_card_cell(arch: str, shape: str) -> dict:
    """(c): the child's result for ``arch``/``shape`` (``DRY_CHILD``)."""
    proc = subprocess.run(
        [sys.executable, "-c", DRY_CHILD, arch, shape], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=DRY_CELL_LIMIT)
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("DRY_CARD ")), None)
    if proc.returncode != 0 or line is None:
        raise RuntimeError(f"dryrun (c): the child exited {proc.returncode}"
                           f": {proc.stderr[-2000:]}")
    return json.loads(line[len("DRY_CARD "):])


def phase_dryrun(smi: str) -> dict:
    """(a) every architecture's ``train_4k`` on the 16x16 mesh as rank 0's
    call on ``meta`` (``python -m repro_torch.launch.dryrun``, no card);
    (b) the dry-run of qwen2-1.5b's train step and prefill at full size
    against the same calls on the card; (c) a production cell's rank share
    on the card under the ``fake`` group against (a)'s record.  Returns
    the launches of #12 and #12b on the card ((b) and (c)); the calls
    modelled on ``meta`` are no launches."""
    from repro_torch.configs import ALL_ARCHS
    from repro_torch.launch import dryrun
    t_phase = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    checks = {}
    out = tempfile.mkdtemp(prefix="dryrun_")
    try:
        # (a)
        t0 = time.perf_counter()
        done = dry_cells([(a, DRY_SHAPE, DRY_MESH) for a in ALL_ARCHS], out)
        a_seconds = time.perf_counter() - t0
        keys = dryrun.RECORD_KEYS + dryrun.TRAIN_KEYS
        cells = []
        for arch in ALL_ARCHS:
            rec, secs, tail = done[(arch, DRY_SHAPE)]
            cfg = get_config(arch)
            attn = any(cfg.layer_kind(i) == "attn"
                       for i in range(cfg.n_layers))
            row = {"arch": arch, "seconds": secs, "log": tail}
            ok = rec is not None
            if ok:
                flash = {"flash_attention", "flash_attention_bwd"}
                ok = (all(k in rec for k in keys)
                      and all(rec[k] > 0 for k in (
                          "hlo_flops", "hlo_bytes", "bytes_per_device",
                          "collective_bytes"))
                      and rec["bottleneck"] in ("compute", "memory",
                                                "collective")
                      and (flash <= set(rec["kernels"]) if attn
                           else not rec["kernels"]))
                row.update(
                    mesh=rec["mesh"], gb=rec["bytes_per_device"] / 1e9,
                    card_gb=total / 1e9,
                    share_of_card=rec["bytes_per_device"] / total,
                    hlo_flops=rec["hlo_flops"], hlo_bytes=rec["hlo_bytes"],
                    collective_bytes=rec["collective_bytes"],
                    t_compute_ms=rec["t_compute"] * 1e3,
                    t_memory_ms=rec["t_memory"] * 1e3,
                    t_collective_ms=rec["t_collective"] * 1e3,
                    bottleneck=rec["bottleneck"],
                    kernels={k: v[0] for k, v in rec["kernels"].items()})
            row["ok"] = ok
            checks[f"a_{arch}"] = ok
            cells.append(row)
            print(f"dryrun (a) {arch} {DRY_SHAPE} {DRY_MESH}: "
                  f"{secs:.1f} s, " + (f"{row['gb']:.2f} GB a device of "
                                       f"{total / 1e9:.2f}" if rec else
                                       "no record") + f"  [{smi}]",
                  flush=True)
        # (b)
        t0 = time.perf_counter()
        versus = {kind: dry_versus_card(kind) for kind in ("train",
                                                           "prefill")}
        b_seconds = time.perf_counter() - t0
        for kind, v in versus.items():
            for k, ok in v["checks"].items():
                checks[f"b_{kind}_{k}"] = ok
            print(f"dryrun (b) {kind}: predicted "
                  f"{v['predicted_peak_bytes'] / 1e9:.3f} GB, card "
                  f"{v['card_peak_bytes'] / 1e9:.3f} GB, gap "
                  f"{100 * v['peak_gap']:+.2f} %  [{smi}]", flush=True)
        # the backward's scratch as the library sizes it
        scratch = _build.bind("flash_attention_bwd_tc",
                              "repro_flash_attention_bwd_tc_scratch",
                              (ctypes.c_int,) * 3, ctypes.c_longlong)
        checks["b_scratch_as_the_library"] = all(
            scratch(b, h, s) == flash_attention.bwd_scratch_floats(
                "wgmma_bf16", b, h, s)
            for b, h, s in ((1, 1, 1), (2, 12, 4096), (3, 5, 129),
                            (1, 8, 32768)))
        # (c)
        t0 = time.perf_counter()
        arch, shape = DRY_CARD_CELL
        rec_a = done[(arch, shape)][0]
        swapped = (rec_a is not None
                   and rec_a["bytes_per_device"] > DRY_CARD_SHARE * total)
        if swapped:
            arch, shape = DRY_CARD_ALT
            rec_a = dry_cells([(arch, shape, DRY_MESH)], out)[(arch,
                                                              shape)][0]
        card = dry_card_cell(arch, shape)
        c_seconds = time.perf_counter() - t0
        rec_c = card["record"]
        want_c = {k: rec_a[k] for k in DRY_COUNTS} if rec_a else {}
        for k in DRY_COUNTS:
            checks[f"c_{k}_equal"] = rec_a is not None and \
                rec_c[k] == want_c[k]
        pred = rec_a["bytes_per_device"] if rec_a else 0
        checks["c_peak_within"] = abs(pred - card["peak"]) <= \
            DRY_PEAK_REL * card["peak"]
        less_ws = card["peak"] - card["cublas_workspaces"]
        checks["c_peak_less_workspaces_within"] = abs(pred - less_ws) <= \
            DRY_PEAK_LESS_WS_REL * card["peak"]
        flash_c = {k: card["launches"][k] for k in ("flash_attention",
                                                    "flash_attention_bwd")}
        checks["c_launched"] = all(flash_c[k] > 0 for k in flash_c
                                   if shape.startswith("train")
                                   or k == "flash_attention")
        checks["c_wgmma_only"] = all(
            card["instances"].get(f"{k}:wgmma_bf16", 0) == n
            for k, n in flash_c.items())
        checks["c_no_plain"] = not any(card["plain"].values())
        gaps = [100 * (pred - x) / card["peak"] for x in (card["peak"],
                                                           less_ws)]
        print(f"dryrun (c) {arch} {shape} rank 0 of {rec_c['mesh']}: "
              f"predicted {pred / 1e9:.3f} GB, card "
              f"{card['peak'] / 1e9:.3f} GB ({gaps[0]:+.2f} %), less "
              f"cuBLAS's workspaces {less_ws / 1e9:.3f} GB "
              f"({gaps[1]:+.2f} %); one step "
              f"{card['step_ms']:.1f} ms on the card, t_compute "
              f"{rec_c['t_compute'] * 1e3:.1f} ms, t_memory "
              f"{rec_c['t_memory'] * 1e3:.1f} ms  [{smi}]", flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    launches = {k: sum(v["launches"][k] for v in versus.values())
                + flash_c[k] for k in ("flash_attention",
                                       "flash_attention_bwd")}
    emit({"phase": "dryrun", "card": smi, "card_bytes": total,
          "a": {"shape": DRY_SHAPE, "mesh": DRY_MESH, "rank": 0,
                "device": "meta", "parallel": DRY_PARALLEL,
                "seconds": a_seconds, "cells": cells},
          "b": {"seconds": b_seconds, **versus},
          "c": {"arch": arch, "shape": shape, "swapped_for_memory": swapped,
                "values": "not checked: the fake group's collectives move "
                          "no data",
                "predicted_peak_bytes": pred, "card_peak_bytes":
                card["peak"], "peak_gap": (pred - card["peak"])
                / card["peak"], "card_arg_bytes": card["arg_bytes"],
                "cublas_workspace_bytes": card["cublas_workspaces"],
                "resident_after_bytes": card["resident"],
                "peak_gap_less_workspaces": (pred - less_ws) / card["peak"],
                "step_ms": card["step_ms"],
                "t_compute_ms": rec_c["t_compute"] * 1e3,
                "t_memory_ms": rec_c["t_memory"] * 1e3,
                "t_collective_ms": rec_c["t_collective"] * 1e3,
                "counts": {k: rec_c[k] for k in DRY_COUNTS
                           if k != "collective_ops"},
                "collective_by_kind": rec_c["collective_by_kind"],
                "launches": flash_c, "seconds": c_seconds},
          "launches": launches, "checks": checks,
          "seconds": time.perf_counter() - t_phase})
    for k_, ok in checks.items():
        if not ok:
            fail(f"dryrun: check {k_}")
    return launches


# ---------------------------------------------------------------------------
# the roofline of every model path: the cost counter's count of the calls
# that serve, serve_families and train time, beside their measured times
# ---------------------------------------------------------------------------

# the served and trained shapes, as roofline.model_flops reads them
SERVE_PREFILL_SHAPE = ShapeSpec("serve_prefill", SERVE_PROMPT, SERVE_BATCH,
                                "prefill")
SERVE_DECODE_SHAPE = ShapeSpec("serve_decode", SERVE_PROMPT + SERVE_NEW,
                               SERVE_BATCH, "decode")
TRAIN_SHAPE = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
# (b): a path measured faster than this share of its bound means the
# count is short
ROOF_MIN = 0.95
# (c): the reduced() qwen2-1.5b counted on both devices: batch, sequence
SAME_B, SAME_S = 2, 128
# the matrix phase's surface CurveDB (set by main), the lines, the
# counting passes' seconds
ROOF = {"db": None, "lines": [], "seconds": 0.0}


def count_call(fn, *args) -> tuple:
    """(the counter's Cost of one ``fn(*args)``, its seconds)."""
    sync()
    t0 = time.perf_counter()
    c = cost.analyze(fn, *args)
    sync()
    return c, time.perf_counter() - t0


def skipped_products(cfg, shape, logits_tokens: int) -> tuple:
    """(a): the FLOPs of ``model_flops`` that the path runs no product
    for, and why.  ``n_active_params`` counts the input embedding, which
    is a gather when untied (2·V·d a token, 6·V·d in training), and the
    unembedding at every token, where a prefill makes the logits of the
    last position alone (``logits_tokens`` a call)."""
    per = 6.0 if shape.kind == "train" else 2.0
    tokens = shape.global_batch if shape.kind == "decode" else shape.tokens
    c = cfg.param_counts()
    parts = {}
    if not cfg.tie_embeddings:
        parts["input embedding, a gather"] = per * c["embed"] * tokens
    if logits_tokens < tokens:
        parts[f"logits at {logits_tokens} of {tokens} tokens"] = \
            per * (c["unembed"] or c["embed"]) * (tokens - logits_tokens)
    return sum(parts.values()), parts


def roofline_line(path: str, cfg, shape, counted: tuple, measured_ms: float,
                  logits_tokens: int) -> None:
    """One path's line: the RooflineTerms of its count (``count_call``),
    the movement bytes, the shape, the memory term at the datasheet's
    rate and at the CurveDB's effective rate, the measured ms, measured /
    t_bound and the MFU; checks (a) and (b)."""
    c, seconds = counted
    terms = roofline.compute_terms(c, cfg=cfg, shape=shape,
                                   mesh_desc="1 x H100", n_devices=1)
    skipped, why = skipped_products(cfg, shape, logits_tokens)
    floor = terms.model_flops - skipped
    eff_bw = roofline.effective_hbm_bw(
        ROOF["db"], n_stressors=0, rw_ratio=roofline.workload_rw_mix(shape))
    measured_s = measured_ms / 1e3
    checks = {"a:useful_ratio_positive": terms.useful_ratio > 0,
              "a:no_product_missed": c.flops >= floor,
              "b:not_faster_than_roofline":
                  measured_s >= ROOF_MIN * terms.t_bound,
              "b:not_faster_than_surface_rate":
                  measured_s >= ROOF_MIN * c.bytes / eff_bw}
    ops_ = sorted(c.ops.items(), key=lambda kv: -kv[1][2])
    line = {"phase": "roofline", "path": path, "config": cfg.name,
            "n_layers": cfg.n_layers, **dataclasses.asdict(terms),
            "bottleneck": terms.bottleneck, "t_bound": terms.t_bound,
            "roofline_fraction": terms.roofline_fraction,
            "movement_bytes": c.movement_bytes,
            "shape": dataclasses.asdict(shape),
            "t_memory_datasheet": c.bytes / roofline.HBM_BW,
            "effective_hbm_bw": eff_bw,
            "t_memory_effective": c.bytes / eff_bw,
            "measured_ms": measured_ms,
            "measured_over_bound": measured_s / terms.t_bound,
            "mfu": terms.model_flops / (measured_s * roofline.PEAK_FLOPS),
            "skipped_flops": skipped, "skipped_by_term": why,
            "counted_over_floor": c.flops / floor,
            "kernels": c.kernels, "top_ops_by_bytes": ops_[:8],
            "top_ops_by_flops": sorted(c.ops.items(),
                                       key=lambda kv: -kv[1][1])[:4],
            "count_seconds": seconds, "checks": checks}
    if terms.useful_ratio > 1:
        line["above_1"] = ("model_flops counts %.6g FLOPs that the path runs "
                           "no product for: %s" % (skipped, ", ".join(why)))
    emit(line)
    ROOF["seconds"] += seconds
    ROOF["lines"].append({k: line[k] for k in (
        "path", "bottleneck", "t_bound", "measured_ms",
        "measured_over_bound", "mfu", "useful_ratio")})
    for k_, ok in checks.items():
        if not ok:
            fail(f"roofline {path}: check {k_}")


def roofline_same_count() -> None:
    """(c): a ``reduced()`` qwen2-1.5b in bf16, its prefill and one train
    step (two microbatches, remat by layer), counted once on CPU tensors
    and once on the card in this process: equal flops and bytes, so the
    card's path hides no operation from the counter.  Lists the aten
    operations and kernels whose counts differ."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    tcfg = TrainConfig(total_steps=10, warmup_steps=2, loss_chunk=64,
                       microbatches=2)
    rules = make_rules(cfg, make_host_mesh(1, 1), global_batch=SAME_B)
    raw = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            (SAME_B, SAME_S + 1))
    counted = {}
    for where, dev in (("cpu", torch.device("cpu")), ("card", DEV)):
        state = step_mod.init_state(
            cfg, tcfg, torch.Generator(device=dev).manual_seed(0))
        tokens = torch.from_numpy(raw[:, :-1]).long().to(dev)
        labels = torch.from_numpy(raw[:, 1:]).long().to(dev)
        prefill = make_prefill_step(cfg, rules, max_len=SAME_S + 8)
        step = step_mod.make_train_step(cfg, rules, tcfg, microbatches=2)
        counted[where] = {
            "prefill": cost.analyze(prefill, state["params"], tokens),
            "train_step": cost.analyze(step, state, tokens, labels)}
    checks, calls = {}, {}
    for call in ("prefill", "train_step"):
        a, b = counted["cpu"][call], counted["card"][call]
        differ = {name: (a.ops.get(name), b.ops.get(name))
                  for name in set(a.ops) | set(b.ops)
                  if a.ops.get(name) != b.ops.get(name)}
        if a.kernels != b.kernels:
            differ["kernels"] = (a.kernels, b.kernels)
        calls[call] = {"cpu": [a.flops, a.bytes], "card": [b.flops, b.bytes],
                       "movement_bytes": [a.movement_bytes,
                                          b.movement_bytes],
                       "kernels": b.kernels, "differ": differ}
        checks[f"c:same_flops:{call}"] = a.flops == b.flops
        checks[f"c:same_bytes:{call}"] = a.bytes == b.bytes
    seconds = time.perf_counter() - t0
    ROOF["seconds"] += seconds
    emit({"phase": "roofline_same_count", "config": cfg.name,
          "batch": SAME_B, "seq": SAME_S, "dtype": "bfloat16",
          "calls": calls, "checks": checks, "seconds": seconds})
    for k_, ok in checks.items():
        if not ok:
            fail(f"roofline: check {k_}")


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
    matrix = phase_matrix(records["r,hbm,1G"]["gbps"])
    m_launched, m_plain = counts.snapshot()
    emit({"phase": "matrix_launches", "launches": m_launched,
          "plain_calls": m_plain})
    for k in OBSERVER_KERNELS:
        if m_launched[k] < 1:
            fail(f"matrix: kernel {k} was not launched")
    if any(m_plain.values()):
        fail("matrix: a plain version ran on the card's path")

    phase_lone(matrix)
    ROOF["db"] = matrix["db_surface"]
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

    # the worst-case search: one ladder launch an iteration, between a
    # reset and a read of the counts, its own probe as in a fresh process
    compat.kernels_supported.cache_clear()
    counts.reset()
    search = phase_search(records["l,hbm,256M"]["ns_per_hop"])
    q_launched, q_plain = counts.snapshot()
    emit({"phase": "search_launches", "launches": q_launched,
          "plain_calls": q_plain})
    if q_launched["contention_ladder"] != search["host_syncs"]:
        fail(f"search: {q_launched['contention_ladder']} ladder launches "
             f"for {search['host_syncs']} host syncs")
    if any(q_plain.values()):
        fail("search: a plain version ran on the card's path")

    # the attention and triad entry points: the phase resets and reads the
    # counts around its own path
    attention_rows = phase_attention()
    # the serving path: the phase resets and reads the counts around (a)
    serve = phase_serve(smi)
    gc.collect()
    torch.cuda.empty_cache()
    # the moe, ssm and hybrid families: each run between a reset and a read
    families, split_launches = phase_serve_families(smi)
    gc.collect()
    torch.cuda.empty_cache()
    # training: the backward kernel's checks, then the entry point, which
    # the phase runs between a reset and a read of the counts
    bwd_row = phase_train_kernel()
    train_fwd = phase_train(smi, bwd_row)
    gc.collect()
    torch.cuda.empty_cache()
    # the mesh path over NCCL (world 1): the phase resets and reads the
    # counts around its mesh run
    dist_launches = phase_distributed(smi)
    bwd_row["launches_by_path"]["distributed"] = \
        dist_launches["flash_attention_bwd"]
    bwd_row["launches"] += dist_launches["flash_attention_bwd"]
    gc.collect()
    torch.cuda.empty_cache()
    # tensor-parallel training's pieces: each rank's head block through
    # #12 and #12b, the vocabulary-parallel cross-entropy
    tp_launches = phase_train_tp(smi)
    bwd_row["launches_by_path"]["train_tp"] = \
        tp_launches["flash_attention_bwd"]
    bwd_row["launches"] += tp_launches["flash_attention_bwd"]
    gc.collect()
    torch.cuda.empty_cache()
    # the MoE and Mamba families' training split over "model": each
    # rank's share in turn, the head blocks, the families' first steps
    tx_launches = phase_train_experts(smi)
    bwd_row["launches_by_path"]["train_experts"] = \
        tx_launches["flash_attention_bwd"]
    bwd_row["launches"] += tx_launches["flash_attention_bwd"]
    gc.collect()
    torch.cuda.empty_cache()
    # serving on a mesh over NCCL (world 1): the phase resets and reads the
    # counts around its mesh run
    mesh_launches = phase_serve_mesh(smi)
    gc.collect()
    torch.cuda.empty_cache()
    # the dry-run: the production cells on ``meta`` (no launch), then its
    # predictions against the card, whose launches the phase counts
    dry_launches = phase_dryrun(smi)
    bwd_row["launches_by_path"]["dryrun"] = \
        dry_launches["flash_attention_bwd"]
    bwd_row["launches"] += dry_launches["flash_attention_bwd"]
    # the roofline: (c), then every path's line (printed in its phase)
    roofline_same_count()
    emit({"phase": "roofline_done", "card": smi, "paths": ROOF["lines"],
          "seconds": ROOF["seconds"]})
    flash_row = attention_rows[1]
    flash_row["launches_by_path"] = {"attention": flash_row["launches"],
                                     "serve": serve["launches"],
                                     "serve_families": families,
                                     "serve_experts": split_launches,
                                     "train": train_fwd,
                                     "distributed":
                                         dist_launches["flash_attention"],
                                     "train_tp":
                                         tp_launches["flash_attention"],
                                     "train_experts":
                                         tx_launches["flash_attention"],
                                     "serve_mesh": mesh_launches,
                                     "dryrun":
                                         dry_launches["flash_attention"]}
    flash_row["launches"] += (serve["launches"] + families
                              + split_launches + train_fwd
                              + dist_launches["flash_attention"]
                              + tp_launches["flash_attention"]
                              + tx_launches["flash_attention"]
                              + mesh_launches
                              + dry_launches["flash_attention"])
    flash_row["serve_call"] = serve["call"]

    phase_checks(records, launched, plain)
    kernels, empty_ms = phase_perf(at_main, {k: launched[k] + m_launched[k]
                                             for k in launched}, records)
    ladder_rows = spmd_perf(at_spmd, s_launched, empty_ms)
    ladder_rows[0]["launches_by_path"] = {
        "spmd": s_launched["contention_ladder"],
        "search": q_launched["contention_ladder"]}
    ladder_rows[0]["launches"] += q_launched["contention_ladder"]
    kernels += ladder_rows
    kernels += attention_rows
    kernels.append(bwd_row)
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

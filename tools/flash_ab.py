"""Time two or more versions of a bf16 flash-attention kernel on one card.

Each ``--variant name=DIR`` names a directory holding the kernel's
source: ``flash_attention_tc.cu`` (the forward), or with ``--backward``
``flash_attention_bwd_tc.cu`` (the backward), beside the ``flash_tc.cuh``
both include.  Every variant is built with the repo's nvcc flags and
``-Xptxas -v`` (its registers and spills a kernel are printed), checked
once on each call, then the calls run in turns: within a round the
variants go in one order, in the next round in the reverse order, so that
a drift of the card's clocks or power falls on all of them alike.  A
round times ``--reps`` back-to-back calls with CUDA events; the result is
the median over rounds.

The forward's calls are the chip check's three full-width ones
(qwen2-1.5b causal, gemma3-1b local and global, 32768 tokens, batch 1),
each checked against the plain version.  The backward's are the chip
check's two timed ones (qwen2-1.5b's train shape, q (2, 12, 4096, 128),
causal; gemma3-1b's local layer, q (2, 4, 4096, 256), window 512), each
checked against the float32 oracle (the plain backward of the same bf16
values upcast) by the chip check's limit, at most one bf16 rounding:
|got - want| <= 2^-7 |want| + 2^-12 max |want|; one more pass a variant
under ``torch.profiler`` splits the call's device time by kernel (rows,
dk/dv, dq).  Both draw the peaked inputs of ``chip_smoke.py``.

To compare a commit's kernel with the working tree's::

    mkdir -p build/ab/old
    git archive <commit> src/repro_torch/kernels/csrc \\
        | tar -x --strip-components=4 -C build/ab/old
    python tools/flash_ab.py --variant old=build/ab/old \\
        --variant new=src/repro_torch/kernels/csrc [--backward]

Another design is compared the same way: copy the sources into a
directory, edit the copy, and name it as a variant.

It needs a card and nvcc, prints the card's name and power limit, one
JSON object as its last line, and writes the same object to ``--out``
when given.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import compat  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.kernels import _build, flash_attention, ref  # noqa: E402

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PEAKED_QK, V_SCALE = 3.0 ** 0.5, 0.5    # as chip_smoke.py draws them
# source, entry point and the kernels ptxas reports, by direction
FORWARD = ("flash_attention_tc", "repro_flash_attention_tc",
           ("flash_tc_kernel",))
BACKWARD = ("flash_attention_bwd_tc", "repro_flash_attention_bwd_tc",
            ("bwd_rows_kernel", "bwd_dkdv_tc_kernel", "bwd_dq_tc_kernel"))
BWD_CALLS = (("qwen2-1.5b train, causal", 2, 12, 2, 4096, 128, 0),
             ("gemma3-1b local, window 512", 2, 4, 1, 4096, 256, 512))


def build(name: str, src_dir: Path, kind, out_dir: Path):
    """The variant's library and ptxas' report of each kernel by D."""
    source, _, kernels = kind
    src = src_dir / f"{source}.cu"
    tag = hashlib.sha256(src.read_bytes() + b"".join(
        p.read_bytes() for p in sorted(src_dir.glob("*.cuh")))
        + " ".join(_build.NVCC_FLAGS).encode())
    out = out_dir / f"lib{source}-{name}-{tag.hexdigest()[:12]}.so"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmd = [compat.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
           str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    report = {}
    for kernel, r in _build.parse_ptxas(proc.stderr).items():
        for short in kernels:
            if short + "ILi" in kernel:
                d = kernel.split(short + "ILi")[1].split("E")[0]
                report[f"{short}<{d}>"] = r
    return out, report


def round_robin(run, names, rounds: int, reps: int):
    """{name: [ms a call, one per round]}, the order reversed each round."""
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            run(name)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                run(name)
            e1.record()
            e1.synchronize()
            times[name].append(e0.elapsed_time(e1) / reps)
    return times


def forward_calls(libs, dev, stream, args):
    fns = {}
    for name, path in libs.items():
        fn = getattr(ctypes.CDLL(str(path)), FORWARD[1])
        fn.argtypes = [_VP] * 5 + [_I] * 9 + [_F, _VP]
        fn.restype = _I
        fns[name] = fn
    seq = SHAPES["prefill_32k"].seq_len
    qwen, gemma = get_config("qwen2-1.5b"), get_config("gemma3-1b")
    for i, (label, cfg, window) in enumerate((
            ("qwen2-1.5b, causal", qwen, 0),
            ("gemma3-1b local", gemma, gemma.sliding_window),
            ("gemma3-1b global", gemma, 0))):
        t = []
        for j, (heads, sc) in enumerate(((cfg.n_heads, PEAKED_QK),
                                         (cfg.n_kv_heads, PEAKED_QK),
                                         (cfg.n_kv_heads, V_SCALE))):
            g = torch.Generator(device=dev).manual_seed(10 * i + j)
            t.append((torch.randn((1, heads, seq, cfg.head_dim),
                                  generator=g, device=dev) * sc)
                     .to(torch.bfloat16))
        q, k, v = t
        b, h, sq, d = q.shape
        out = torch.empty_like(q)

        def run(name):
            # no log-sum-exp: the forward as the server calls it
            code = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), None, 1, b, h, k.shape[1], sq,
                             k.shape[2], d, 1, window, d ** -0.5, stream)
            if code:
                raise RuntimeError(f"{name}: launch failed, CUDA error "
                                   f"{code}")

        want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        errs = {}
        for name in fns:
            run(name)
            torch.cuda.synchronize()
            errs[name] = float((out.float() - want.float()).abs().max())
        del want
        times = round_robin(run, list(fns), args.rounds, args.reps)
        yield label, {name: {"ms": statistics.median(t), "ms_all": t,
                             "max_abs_err": errs[name]}
                      for name, t in times.items()}


def scaled_error(got, want) -> float:
    g, w = got.float(), want.float()
    top = float(w.abs().max())
    return float(((g - w).abs() / (2.0 ** -7 * w.abs() + 2.0 ** -12 * top))
                 .max())


def backward_calls(libs, dev, stream, args):
    fns = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, BACKWARD[1])
        fn.argtypes = [_VP] * 10 + [_I] * 9 + [_F, _VP]
        fn.restype = _I
        scratch = getattr(lib, BACKWARD[1] + "_scratch")
        scratch.argtypes = [_I] * 3
        scratch.restype = ctypes.c_longlong
        fns[name] = fn, scratch
    for i, (label, b, h, kvh, s, d, window) in enumerate(BWD_CALLS):
        t = []
        for j, (heads, sc) in enumerate(((h, PEAKED_QK), (kvh, PEAKED_QK),
                                         (kvh, V_SCALE), (h, 1.0))):
            g = torch.Generator(device=dev).manual_seed(10 * i + j)
            t.append((torch.randn((b, heads, s, d), generator=g,
                                  device=dev) * sc).to(torch.bfloat16))
        q, k, v, do = t
        lse = torch.empty((b, h, s), dtype=torch.float32, device=dev)
        o = flash_attention._launch_forward("wgmma_bf16", q, k, v,
                                            causal=True, window=window,
                                            sm_scale=None, lse=lse)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        scratch = {n: torch.empty(int(sc(b, h, s)), dtype=torch.float32,
                                  device=dev)
                   for n, (_, sc) in fns.items()}

        def run(name):
            code = fns[name][0](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), scratch[name].data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), 1, b, h, kvh,
                s, s, d, 1, window, d ** -0.5, stream)
            if code:
                raise RuntimeError(f"{name}: launch failed, CUDA error "
                                   f"{code}")

        want = ref.flash_attention_bwd_ref(
            *(x.float() for x in (q, k, v, o)), lse, do.float(),
            causal=True, window=window)
        errs = {}
        for name in fns:
            run(name)
            torch.cuda.synchronize()
            errs[name] = [scaled_error(g, w)
                          for g, w in zip((dq, dk, dv), want)]
        del want
        times = round_robin(run, list(fns), args.rounds, args.reps)
        split = {}
        for name in fns:
            run(name)
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
                for _ in range(args.reps):
                    run(name)
                torch.cuda.synchronize()
            by = {}
            for e in p.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    key = next((short for short in BACKWARD[2]
                                if short in e.name), e.name)
                    by[key] = (by.get(key, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / args.reps)
            split[name] = by
        yield label, {name: {"ms": statistics.median(t), "ms_all": t,
                             "scaled_err_dq_dk_dv": errs[name],
                             "device_ms_by_kernel": split[name]}
                      for name, t in times.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", required=True,
                    help="name=DIR holding the kernel's source")
    ap.add_argument("--backward", action="store_true",
                    help="compare flash_attention_bwd_tc.cu versions")
    ap.add_argument("--rounds", type=int, default=None,
                    help="default 4 (forward), 6 (backward)")
    ap.add_argument("--reps", type=int, default=None,
                    help="default 3 (forward), 5 (backward)")
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.rounds is None:
        args.rounds = 6 if args.backward else 4
    if args.reps is None:
        args.reps = 5 if args.backward else 3
    if not torch.cuda.is_available():
        sys.stderr.write("flash_ab: no CUDA device\n")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    kind = BACKWARD if args.backward else FORWARD
    variants = [(n, Path(d)) for n, d in
                (v.split("=", 1) for v in args.variant)]
    out_dir = _build.build_dir().parent / "ab"
    with ThreadPoolExecutor(len(variants)) as ex:
        built = list(ex.map(lambda v: build(v[0], v[1], kind, out_dir),
                            variants))
    libs = {n: path for (n, _), (path, _) in zip(variants, built)}
    result = {"device": smi, "torch": torch.__version__,
              "kernel": kind[0],
              "variants": {n: str(d) for n, d in variants},
              "ptxas": {n: r for (n, _), (_, r) in zip(variants, built)},
              "calls": {}}
    for n, r in result["ptxas"].items():
        print(n, json.dumps(r), flush=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    calls = backward_calls if args.backward else forward_calls
    for label, by_name in calls(libs, dev, stream, args):
        result["calls"][label] = by_name
        print(label, {n: round(r["ms"], 4) for n, r in by_name.items()},
              flush=True)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

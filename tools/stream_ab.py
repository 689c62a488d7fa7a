"""Time two or more versions of the stream kernels side by side on one card.

Each ``--variant name=DIR`` names a directory holding a ``stream.cu`` (and
the headers it includes).  Every variant is built with the repo's nvcc
flags, then ``read_hbm``, ``write_hbm``, ``rmw_hbm`` (f32) and ``copy_hbm``
run on the same buffer in turns: within a round the variants go in one
order, in the next round in the reverse order, so that a drift of the
card's clocks or power falls on all of them alike.  Each launch is timed
with CUDA events; a round keeps the median of ``--reps`` launches, and
the result is the median over rounds with each variant's time relative
to the first variant's in the same round.

The on-chip pair, ``read_vmem`` and ``write_vmem``, runs in the same
rounds on a 128 KiB buffer (the main path's) at 8 and 2048 walks, each
call as its wrapper makes it: a ``stream.cu`` of before the spread design
(one SM's tile, the partials summed by a second kernel) is called as
that wrapper called it.  A call is too short to
time alone, so ``--reps`` calls run back to back behind a hold of the
stream, between two events; the slope between the walk counts gives the
time of one walk.  ``--vmem-layout ROWSxTHREADS`` (repeatable) runs the
spread design of each variant at that slice and thread count too, as a
variant of its own (``name@ROWSxTHREADS``) built with
``-DREPRO_VMEM_THREADS=THREADS``, to pick the layout.

To compare a commit's kernels with the working tree's::

    mkdir -p build/ab/old
    git archive <commit> src/repro_torch/kernels/csrc \\
        | tar -x --strip-components=4 -C build/ab/old
    python tools/stream_ab.py --variant old=build/ab/old \\
        --variant new=src/repro_torch/kernels/csrc

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
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import compat  # noqa: E402
from repro_torch.kernels import _build, stream as _stream  # noqa: E402

KERNELS = ("read_hbm", "write_hbm", "rmw_hbm", "copy_hbm")
VMEM_KERNELS = ("read_vmem", "write_vmem")
VMEM_ROWS = 256     # 128 KiB, the main path's on-chip buffer
WALKS = (8, 2048)
CTAS_PER_SM = 8     # the grid rule of kernels/stream.py
_VP, _LL, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_float)


def build(name: str, src_dir: Path, out_dir: Path,
          defines: tuple = ()) -> Path:
    src = src_dir / "stream.cu"
    blob = src.read_bytes() + b"".join(
        p.read_bytes() for p in sorted(src_dir.glob("*.cuh")))
    flags = [*_build.NVCC_FLAGS, *defines]
    tag = hashlib.sha256(blob + " ".join(flags).encode())
    out = out_dir / f"libstream-{name}-{tag.hexdigest()[:12]}.so"
    if not out.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        cmd = [compat.nvcc_path(), *flags, "-o", str(out), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return out


class Variant:
    def __init__(self, name: str, lib_path: Path, sms: int):
        self.name = name
        lib = ctypes.CDLL(str(lib_path))
        self.threads = lib.repro_stream_threads()
        self.sms = sms
        self.fns = {}
        for fn, args in (
                ("repro_read_hbm", (_VP, _VP, _LL, _LL, _I, _I, _VP)),
                ("repro_write_hbm", (_VP, _LL, _F, _VP, _I, _VP)),
                ("repro_rmw_hbm_f32", (_VP, _VP, _LL, _I, _VP)),
                ("repro_copy_hbm", (_VP, _VP, _LL, _I, _VP))):
            f = getattr(lib, fn)
            f.argtypes, f.restype = list(args), ctypes.c_int
            self.fns[fn] = f
        # the spread design exports the shared memory a CTA asks for; the
        # one-SM design before it does not
        self.spread = hasattr(lib, "repro_vmem_smem_bytes")
        vmem_args = (
            (("repro_read_vmem", (_VP,) * 4 + (_LL, _LL) + (_I,) * 3
              + (_VP,)),
             ("repro_write_vmem", (_VP, _LL, _I, _I, _VP)))
            if self.spread else
            (("repro_read_vmem", (_VP, _VP, _LL, _LL, _I, _I, _I, _VP)),
             ("repro_write_vmem", (_VP, _LL, _I, _I, _VP))))
        for fn, args in vmem_args + (("repro_hold", (_LL, _VP)),):
            f = getattr(lib, fn)
            f.argtypes, f.restype = list(args), ctypes.c_int
            self.fns[fn] = f

    def grid(self, n_vec: int) -> int:
        return max(1, min(-(-n_vec // self.threads), self.sms * CTAS_PER_SM))

    def launch(self, kernel: str, x, out, partials, stream: int) -> None:
        n_vec = x.numel() // 4
        g = self.grid(n_vec)
        if kernel == "read_hbm":
            rc = self.fns["repro_read_hbm"](x.data_ptr(), partials.data_ptr(),
                                            n_vec, n_vec, 1, g, stream)
        elif kernel == "write_hbm":
            rc = self.fns["repro_write_hbm"](out.data_ptr(), n_vec, 1.0, None,
                                             g, stream)
        elif kernel == "rmw_hbm":
            rc = self.fns["repro_rmw_hbm_f32"](x.data_ptr(), out.data_ptr(),
                                               n_vec, g, stream)
        else:
            rc = self.fns["repro_copy_hbm"](x.data_ptr(), out.data_ptr(),
                                            n_vec, g, stream)
        if rc:
            raise RuntimeError(f"{self.name} {kernel}: CUDA error {rc}")


class VmemCall:
    """The on-chip pair of one variant, called as its wrapper calls it:
    the spread design at ``layout`` (the wrapper's own when None), the
    one-SM design with its tile of at most ``SMEM_TILE_ROWS`` rows and
    the partials summed by ``torch``."""

    def __init__(self, v: Variant, layout=None):
        self.v = v
        self.layout = layout
        self.name = v.name

    def call(self, kernel: str, x, out, ticket, repeats: int, stream: int):
        v, rows = self.v, x.shape[0]
        n_vec = x.numel() // 4
        if v.spread:
            lay = self.layout or _stream.vmem_layout(rows, v.sms)
            slice_vec = lay.slice_rows * 32
            if kernel == "read_vmem":
                partials = torch.empty(lay.ctas, device=x.device)
                res = torch.empty(1, device=x.device)
                rc = v.fns["repro_read_vmem"](
                    x.data_ptr(), partials.data_ptr(), res.data_ptr(),
                    ticket.data_ptr(), n_vec, n_vec, 1, slice_vec,
                    repeats, stream)
            else:
                res = out
                rc = v.fns["repro_write_vmem"](out.data_ptr(), n_vec,
                                               slice_vec, repeats, stream)
        else:
            tile_vec = min(rows, _stream.SMEM_TILE_ROWS) * 32
            if kernel == "read_vmem":
                partials = torch.empty(-(-n_vec // tile_vec),
                                       device=x.device)
                rc = v.fns["repro_read_vmem"](
                    x.data_ptr(), partials.data_ptr(), n_vec, n_vec, 1,
                    tile_vec, repeats, stream)
                res = partials.sum()
            else:
                res = out
                rc = v.fns["repro_write_vmem"](out.data_ptr(), n_vec,
                                               tile_vec, repeats, stream)
        if rc:
            raise RuntimeError(f"{self.name} {kernel}: CUDA error {rc}")
        return res


def batch_ms(c: VmemCall, kernel: str, x, out, ticket, repeats: int,
             stream: int, reps: int) -> float:
    """ms a call over ``reps`` calls back to back, behind a hold of the
    stream for twice the host's cost of enqueueing them."""
    def run():
        return c.call(kernel, x, out, ticket, repeats, stream)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    run()
    hold_ns = min(50_000_000, 2 * (time.perf_counter_ns() - t0) * reps)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    c.v.fns["repro_hold"](hold_ns, stream)
    a.record()
    for _ in range(reps):
        run()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def check_vmem(calls, x, out, ticket, stream: int) -> dict:
    """Every on-chip variant at 8 walks: the read within 1e-5 of the
    float64 sum, every written element exactly 7."""
    want = 8 * float(x.double().sum())
    errs = {}
    for c in calls:
        got = float(c.call("read_vmem", x, out, ticket, 8, stream))
        rel = abs(got - want) / abs(want)
        c.call("write_vmem", x, out, ticket, 8, stream)
        if rel > 1e-5 or not bool((out == 7.0).all()):
            raise RuntimeError(f"{c.name}: read_vmem rel err {rel}, "
                               f"write_vmem {bool((out == 7.0).all())}")
        errs[c.name] = rel
    return errs


def layout_arg(text: str, rows: int):
    """(the layout, the nvcc define of its thread count) of ROWSxTHREADS."""
    slice_rows, threads = (int(t) for t in text.lower().split("x"))
    return (_stream.VmemLayout(-(-rows // slice_rows), slice_rows),
            f"-DREPRO_VMEM_THREADS={threads}")


def time_ms(v: Variant, kernel: str, x, out, partials, stream: int,
            reps: int) -> float:
    for _ in range(2):
        v.launch(kernel, x, out, partials, stream)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        v.launch(kernel, x, out, partials, stream)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check(variants, x, out, partials, stream: int) -> dict:
    """Every variant's results: the read's sum against float64, rmw and
    copy exactly, the write's value exactly."""
    want = float(x.double().sum())
    errs = {}
    for v in variants:
        partials.zero_()
        v.launch("read_hbm", x, out, partials, stream)
        got = float(partials[:v.grid(x.numel() // 4)].double().sum())
        rel = abs(got - want) / abs(want)
        v.launch("rmw_hbm", x, out, partials, stream)
        rmw_ok = bool(torch.equal(out, x + 1))
        v.launch("copy_hbm", x, out, partials, stream)
        copy_ok = bool(torch.equal(out, x))
        v.launch("write_hbm", x, out, partials, stream)
        write_ok = bool((out == 1.0).all())
        if rel > 1e-5 or not (rmw_ok and copy_ok and write_ok):
            raise RuntimeError(f"{v.name}: read rel err {rel}, rmw {rmw_ok},"
                               f" copy {copy_ok}, write {write_ok}")
        errs[v.name] = rel
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", required=True,
                    help="name=DIR with DIR/stream.cu; two or more")
    ap.add_argument("--mib", type=int, default=1024,
                    help="buffer size in MiB (default 1024)")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--vmem-layout", action="append", default=[],
                    help="ROWSxTHREADS: also run the spread design at "
                         "this slice and thread count")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stream_ab: no CUDA device", file=sys.stderr)
        return 1
    pairs = [s.split("=", 1) for s in args.variant]
    if len(pairs) < 2 or any(len(p) != 2 for p in pairs):
        ap.error("give two or more --variant name=DIR")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out_dir = ROOT / "build" / "stream_ab"
    # each --vmem-layout of each spread variant is a build of its own
    spread = [(n, d) for n, d in pairs
              if b"repro_vmem_smem_bytes" in (Path(d) / "stream.cu")
              .read_bytes()]
    layouts = {t: layout_arg(t, VMEM_ROWS) for t in args.vmem_layout}
    jobs = [(n, d, ()) for n, d in pairs] + [
        (f"{n}@{t}", d, (layouts[t][1],)) for n, d in spread
        for t in args.vmem_layout]
    with ThreadPoolExecutor(len(jobs)) as ex:
        libs = list(ex.map(lambda j: build(j[0], Path(j[1]), out_dir, j[2]),
                           jobs))
    built = [Variant(n, lib, sms) for (n, _d, _f), lib in zip(jobs, libs)]
    variants = built[:len(pairs)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    rows = args.mib * (1 << 20) // 512
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((rows, 128), generator=gen, device=dev)
    out = torch.empty_like(x)
    partials = torch.zeros(sms * CTAS_PER_SM, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    errs = check(variants, x, out, partials, stream)
    vx = torch.rand((VMEM_ROWS, 128), generator=gen, device=dev)
    vout = torch.empty_like(vx)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    calls = [VmemCall(v) for v in variants]
    calls += [VmemCall(v, layouts[v.name.split("@", 1)[1]][0])
              for v in built[len(pairs):]]
    vmem_errs = check_vmem(calls, vx, vout, ticket, stream)
    vkeys = [f"{k}@{w}" for k in VMEM_KERNELS for w in WALKS]
    per = {v.name: {k: [] for k in KERNELS} for v in variants}
    vper = {c.name: {k: [] for k in vkeys} for c in calls}
    for r in range(args.rounds):
        order = variants if r % 2 == 0 else variants[::-1]
        for k in KERNELS:
            for v in order:
                per[v.name][k].append(time_ms(v, k, x, out, partials,
                                              stream, args.reps))
        for k in VMEM_KERNELS:
            for w in WALKS:
                for c in (calls if r % 2 == 0 else calls[::-1]):
                    vper[c.name][f"{k}@{w}"].append(batch_ms(
                        c, k, vx, vout, ticket, w, stream, args.reps))
    base = variants[0].name
    nbytes = {"read_hbm": x.nbytes, "write_hbm": x.nbytes,
              "rmw_hbm": 2 * x.nbytes, "copy_hbm": 2 * x.nbytes}
    result = {"card": smi, "mib": args.mib, "rounds": args.rounds,
              "reps": args.reps, "read_rel_err": errs, "kernels": {},
              "vmem_rows": VMEM_ROWS, "vmem_rel_err": vmem_errs,
              "vmem": {}}
    for k in KERNELS:
        rk = {}
        for v in variants:
            ms = per[v.name][k]
            ratio = [a / b for a, b in zip(ms, per[base][k])]
            rk[v.name] = {"ms": statistics.median(ms),
                          "ms_min": min(ms), "ms_max": max(ms),
                          "gb_s": nbytes[k] / statistics.median(ms) / 1e6,
                          f"vs_{base}": statistics.median(ratio)}
        result["kernels"][k] = rk
    walk_bytes = vx.numel() * 4
    for c in calls:
        rec = {k: statistics.median(vper[c.name][k]) for k in vkeys}
        for k in VMEM_KERNELS:
            lo, hi = (statistics.median(vper[c.name][f"{k}@{w}"])
                      for w in WALKS)
            us = (hi - lo) / (WALKS[1] - WALKS[0]) * 1e3
            rec[f"{k}_us_per_walk"] = us
            rec[f"{k}_gb_s_by_slope"] = walk_bytes / us / 1e3
        result["vmem"][c.name] = rec
    line = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time two or more versions of the stream kernels side by side on one card.

Each ``--variant name=DIR`` names a directory holding a ``stream.cu`` (and
the headers it includes).  Every variant is built with the repo's nvcc
flags, then ``read_hbm``, ``write_hbm``, ``rmw_hbm`` (f32, and bf16 as
``rmw_hbm_bf16``) and ``copy_hbm`` run on buffers of the same bytes,
``write_hbm_seeded`` on the rows of letter ``b``'s write half (a third of
them: 1/3 GiB at the default 1 GiB, into a row-slice of the write's
buffer), and ``triad_hbm`` on three such buffers (b and c in, the result
out), in turns: within a round the variants go in one order, in the next
round in the reverse order, so that a drift of the card's clocks or power
falls on all of them alike.  ``--reps`` calls run back to back behind a
hold of the stream (twice the host's cost of enqueueing them), between two
CUDA events, so the card and not the host sets the pace; the result is the
median over rounds of the ms a call, with each variant's time relative to
the first variant's in the same round.

Each variant's writes, ``rmw_hbm``, ``copy_hbm`` and ``triad_hbm`` are
called as its own wrapper calls them (rmw, copy and triad into a new
tensor): a kernel whose ``stream.cu`` exports
``repro_<kernel>_chunk_bytes`` (one chunk a CTA) with
``kernels/stream.py:chunk_grid`` over the chunk that the library reports,
one from before it (design (A), a grid stride) with the grid rule of that
wrapper.  ``--write-build``, ``--rmw-build``, ``--copy-build`` and
``--triad-build LABEL=FLAGS`` (repeatable) rebuild each variant whose
kernel is chunked with the nvcc defines FLAGS (comma-separated, e.g.
``-DREPRO_COPY_CHUNK_KIB=16,-DREPRO_COPY_THREADS=512``) as a variant of its
own (``name@LABEL``), to pick the chunk and the threads.
``--library`` times the PyTorch calls that compute the same functions in
the same rounds, as the variant ``library``: ``torch.full`` for both
writes, ``x + 1`` for both rmw dtypes, ``x.clone()`` for the copy and
``torch.add(b, c, alpha=3)`` for the triad (yardsticks only; the port
never calls them), and records each call's launch (kernel, grid, block)
as ``torch.profiler`` sees it.  ``--kernels`` times only the kernels it
names.

The on-chip pair, ``read_vmem`` and ``write_vmem``, runs in the same
rounds on a 128 KiB buffer (the main path's) at 8 and 2048 walks, each
call as its wrapper makes it: a ``stream.cu`` of before the spread design
(one SM's tile, the partials summed by a second kernel) is called as
that wrapper called it.  The slope between the walk counts gives the
time of one walk.  ``--vmem-layout ROWSxTHREADS`` (repeatable) runs the
spread design of each variant at that slice and thread count too, as a
variant of its own (``name@ROWSxTHREADS``) built with
``-DREPRO_VMEM_THREADS=THREADS``, to pick the layout.

To compare a commit's kernels with the working tree's::

    mkdir -p build/ab/old
    git archive <commit> src/repro_torch/kernels/csrc \\
        | tar -x --strip-components=4 -C build/ab/old
    python tools/stream_ab.py --variant old=build/ab/old \\
        --variant new=src/repro_torch/kernels/csrc --library

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
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import compat  # noqa: E402
from repro_torch.core import workloads  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import stream as _stream  # noqa: E402

KERNELS = ("read_hbm", "write_hbm", "write_hbm_seeded", "rmw_hbm",
           "rmw_hbm_bf16", "copy_hbm", "triad_hbm")
# the kernels the PyTorch yardsticks stand beside, and the call
LIBRARY = {"write_hbm": "torch.full", "write_hbm_seeded": "torch.full",
           "rmw_hbm": "x + 1", "rmw_hbm_bf16": "x + 1",
           "copy_hbm": "x.clone()", "triad_hbm": "torch.add(b, c, alpha=3)"}
# the chunked kernels (one chunk a CTA), each told apart from its grid-
# stride design (A) by its exported chunk size
BULK = ("write", "rmw", "copy", "triad")
VMEM_KERNELS = ("read_vmem", "write_vmem")
VMEM_ROWS = 256     # 128 KiB, the main path's on-chip buffer
WALKS = (8, 2048)
CTAS_PER_SM = 8     # the grid rule of kernels/stream.py's design (A)
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


def _bind(lib, fn: str, args) -> "ctypes._CFuncPtr":
    f = getattr(lib, fn)
    f.argtypes, f.restype = list(args), ctypes.c_int
    return f


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
                ("repro_copy_hbm", (_VP, _VP, _LL, _I, _VP)),
                ("repro_triad_hbm", (_VP, _VP, _VP, _LL, _F, _I, _VP))):
            self.fns[fn] = _bind(lib, fn, args)
        # a chunked kernel's chunk in 16-byte units, by kernel; a kernel
        # from before its chunked design has none
        self.chunk_vec = {
            k: getattr(lib, f"repro_{k}_chunk_bytes")() // 16 for k in BULK
            if hasattr(lib, f"repro_{k}_chunk_bytes")}
        # design (D) exports one rmw entry; design (A) before it a
        # grid-stride entry a dtype
        if "rmw" in self.chunk_vec:
            self.fns["repro_rmw_hbm"] = _bind(
                lib, "repro_rmw_hbm", (_VP, _VP, _LL, _I, _I, _VP))
        else:
            for fn in ("repro_rmw_hbm_f32", "repro_rmw_hbm_bf16"):
                self.fns[fn] = _bind(lib, fn, (_VP, _VP, _LL, _I, _VP))
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
            self.fns[fn] = _bind(lib, fn, args)

    def grid(self, n_vec: int) -> int:
        return max(1, min(-(-n_vec // self.threads), self.sms * CTAS_PER_SM))

    def bulk_grid(self, kernel: str, n_vec: int) -> int:
        """The grid of ``kernel`` ("write", "rmw", "copy" or "triad") as
        the variant's wrapper makes it: the chunk rule, or the grid
        stride's."""
        if kernel in self.chunk_vec:
            return _stream.chunk_grid(n_vec, self.chunk_vec[kernel])
        return self.grid(n_vec)

    def rmw(self, x, stream: int):
        """x + 1 into a new tensor, as the variant's wrapper calls it."""
        out = torch.empty_like(x)
        n_vec = x.numel() * x.element_size() // 16
        bf16 = int(x.dtype == torch.bfloat16)
        if "rmw" in self.chunk_vec:
            rc = self.fns["repro_rmw_hbm"](
                x.data_ptr(), out.data_ptr(), n_vec,
                self.bulk_grid("rmw", n_vec), bf16, stream)
        else:
            fn = self.fns["repro_rmw_hbm_bf16" if bf16 else
                          "repro_rmw_hbm_f32"]
            rc = fn(x.data_ptr(), out.data_ptr(), n_vec, self.grid(n_vec),
                    stream)
        if rc:
            raise RuntimeError(f"{self.name} rmw: CUDA error {rc}")
        return out

    def launch(self, kernel: str, b: dict, stream: int):
        """One call of ``kernel``; rmw, copy and triad return their new
        tensor."""
        x, out = b["x"], b["out"]
        n_vec = x.numel() // 4
        g = self.grid(n_vec)
        if kernel == "read_hbm":
            rc = self.fns["repro_read_hbm"](x.data_ptr(),
                                            b["partials"].data_ptr(),
                                            n_vec, n_vec, 1, g, stream)
        elif kernel == "write_hbm":
            rc = self.fns["repro_write_hbm"](
                out.data_ptr(), n_vec, 1.0, None,
                self.bulk_grid("write", n_vec), stream)
        elif kernel == "write_hbm_seeded":
            n_s = b["seeded_rows"] * 32
            rc = self.fns["repro_write_hbm"](
                out.data_ptr(), n_s, b["value"], b["seed"].data_ptr(),
                self.bulk_grid("write", n_s), stream)
        elif kernel.startswith("rmw_hbm"):
            return self.rmw(b["xb"] if kernel.endswith("bf16") else x,
                            stream)
        elif kernel == "copy_hbm":
            res = torch.empty_like(x)
            rc = self.fns["repro_copy_hbm"](
                x.data_ptr(), res.data_ptr(), n_vec,
                self.bulk_grid("copy", n_vec), stream)
        else:
            res = torch.empty_like(x)
            rc = self.fns["repro_triad_hbm"](
                x.data_ptr(), b["c"].data_ptr(), res.data_ptr(), n_vec, 3.0,
                self.bulk_grid("triad", n_vec), stream)
        if rc:
            raise RuntimeError(f"{self.name} {kernel}: CUDA error {rc}")
        return res if kernel in ("copy_hbm", "triad_hbm") else None


def library_call(kernel: str, b: dict):
    if kernel.startswith("write"):
        rows = (b["seeded_rows"] if kernel.endswith("seeded")
                else b["x"].shape[0])
        return torch.full((rows, 128), 1.0, device=b["x"].device)
    x = b["xb"] if kernel.endswith("bf16") else b["x"]
    if kernel == "triad_hbm":
        return torch.add(x, b["c"], alpha=3)
    return x.clone() if kernel == "copy_hbm" else x + 1


def launch_layout(fn) -> list:
    """The kernels one call of ``fn`` launches, as ``torch.profiler`` sees
    the card: name, grid and block of each."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    return [{"name": e["name"], "grid": e.get("args", {}).get("grid"),
             "block": e.get("args", {}).get("block")}
            for e in events if e.get("cat") == "kernel"]


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


def held_ms(run, hold, stream: int, reps: int) -> float:
    """ms a call over ``reps`` calls of ``run`` back to back, behind a
    ``hold`` of the stream for twice the host's cost of enqueueing them
    (at most ``workloads.HOLD_CAP_NS``)."""
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    run()
    hold_ns = min(workloads.HOLD_CAP_NS, workloads.HOLD_PER_CALL
                  * (time.perf_counter_ns() - t0) * reps)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    hold(hold_ns, stream)
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


def check(variants, b: dict, stream: int) -> dict:
    """Every variant's results: the read's sum against float64, rmw (both
    dtypes), copy and triad exactly, the write's value exactly, and the
    seeded write's ``1/3 + 0.25`` (float32 rounding) exactly into its
    row-slice, with no store past it."""
    x, out = b["x"], b["out"]
    want = float(x.double().sum())
    want_b = b["xb"] + 1      # one rounding of the float32 sum, as the kernel
    errs = {}
    for v in variants:
        b["partials"].zero_()
        v.launch("read_hbm", b, stream)
        got = float(b["partials"][:v.grid(x.numel() // 4)].double().sum())
        rel = abs(got - want) / abs(want)
        bad = []
        for k in ("rmw_hbm", "rmw_hbm_bf16"):
            got = v.launch(k, b, stream)
            if not torch.equal(got, want_b if k.endswith("bf16") else x + 1):
                bad.append(k)
        if not torch.equal(v.launch("copy_hbm", b, stream), x):
            bad.append("copy_hbm")
        # the product and the sum rounded apart, as the kernel rounds them
        if not torch.equal(v.launch("triad_hbm", b, stream),
                           x + 3.0 * b["c"]):
            bad.append("triad_hbm")
        v.launch("write_hbm", b, stream)
        if not bool((out == 1.0).all()):
            bad.append("write_hbm")
        b["seed"].fill_(0.25)
        b["value"] = 1 / 3
        v.launch("write_hbm_seeded", b, stream)
        n_s = b["seeded_rows"]
        want_s = ref.write_seeded_ref(n_s, 1 / 3, b["seed"])
        if not (torch.equal(out[:n_s], want_s)
                and bool((out[n_s:] == 1.0).all())):
            bad.append("write_hbm_seeded")
        b["seed"].zero_()
        b["value"] = 1.0
        if rel > 1e-5 or bad:
            raise RuntimeError(f"{v.name}: read rel err {rel}, wrong: {bad}")
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
    ap.add_argument("--library", action="store_true",
                    help="also time torch.full, x + 1, x.clone() and "
                         "torch.add(b, c, alpha=3) in the same rounds")
    ap.add_argument("--kernels", default=",".join(KERNELS + VMEM_KERNELS),
                    help="comma-separated kernels to time (default all)")
    for kind in BULK:
        ap.add_argument(f"--{kind}-build", action="append", default=[],
                        help=f"LABEL=FLAGS: also run each variant whose "
                             f"{kind} is chunked, rebuilt with these "
                             "comma-separated nvcc defines")
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
    builds = {k: [t.split("=", 1) for t in getattr(args, f"{k}_build")]
              for k in BULK}
    if any(len(t) != 2 for b in builds.values() for t in b):
        ap.error("--write-build, --rmw-build, --copy-build and "
                 "--triad-build want LABEL=FLAGS")
    timed = args.kernels.split(",")
    if not set(timed) <= set(KERNELS + VMEM_KERNELS):
        ap.error(f"--kernels: choose from {KERNELS + VMEM_KERNELS}")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out_dir = ROOT / "build" / "stream_ab"

    def exports(d: str, symbol: bytes) -> bool:
        return symbol in (Path(d) / "stream.cu").read_bytes()

    # each --vmem-layout of each spread variant, and each --<kernel>-build
    # of each variant whose kernel is chunked, is a build of its own
    layouts = {t: layout_arg(t, VMEM_ROWS) for t in args.vmem_layout}
    vjobs = [(f"{n}@{t}", d, (layouts[t][1],)) for n, d in pairs
             if exports(d, b"repro_vmem_smem_bytes")
             for t in args.vmem_layout]
    rjobs = [(f"{n}@{label}", d, tuple(f for f in flags.split(",") if f))
             for kind in BULK for n, d in pairs
             if exports(d, f"repro_{kind}_chunk_bytes".encode())
             for label, flags in builds[kind]]
    jobs = [(n, d, ()) for n, d in pairs] + rjobs + vjobs
    with ThreadPoolExecutor(len(jobs)) as ex:
        libs = list(ex.map(lambda j: build(j[0], Path(j[1]), out_dir, j[2]),
                           jobs))
    built = [Variant(n, lib, sms) for (n, _d, _f), lib in zip(jobs, libs)]
    variants = built[:len(pairs) + len(rjobs)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    rows = args.mib * (1 << 20) // 512
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((rows, 128), generator=gen, device=dev)
    bufs = {"x": x, "out": torch.empty_like(x),
            "c": torch.rand((rows, 128), generator=gen, device=dev),
            # bf16 of the same bytes: twice the elements
            "xb": torch.rand((2 * rows, 128), generator=gen,
                             device=dev).to(torch.bfloat16),
            "partials": torch.zeros(sms * CTAS_PER_SM, device=dev),
            # letter b's write half: the rows of its mixed split at 2/3
            "seeded_rows": ref.mixed_split(rows, 2 / 3, 512)[2] * 512,
            "seed": torch.zeros((1, 1), device=dev), "value": 1.0}
    stream = torch.cuda.current_stream(dev).cuda_stream
    errs = check(variants, bufs, stream)
    vx = torch.rand((VMEM_ROWS, 128), generator=gen, device=dev)
    vout = torch.empty_like(vx)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    calls = [VmemCall(v) for v in variants[:len(pairs)]]
    calls += [VmemCall(v, layouts[v.name.split("@", 1)[1]][0])
              for v in built[len(variants):]]
    vmem_errs = check_vmem(calls, vx, vout, ticket, stream)
    vkeys = [f"{k}@{w}" for k in VMEM_KERNELS for w in WALKS]
    hold = variants[0].fns["repro_hold"]
    # the library yardsticks take their turn among the variants
    entries = variants + (["library"] if args.library else [])
    per = {getattr(e, "name", e): {k: [] for k in KERNELS} for e in entries}
    vper = {c.name: {k: [] for k in vkeys} for c in calls}
    for r in range(args.rounds):
        order = entries if r % 2 == 0 else entries[::-1]
        for k in (k for k in KERNELS if k in timed):
            for e in order:
                if e == "library":
                    if k in LIBRARY:
                        per[e][k].append(held_ms(
                            lambda: library_call(k, bufs), hold, stream,
                            args.reps))
                else:
                    per[e.name][k].append(held_ms(
                        lambda: e.launch(k, bufs, stream), e.fns["repro_hold"],
                        stream, args.reps))
        for k in (k for k in VMEM_KERNELS if k in timed):
            for w in WALKS:
                for c in (calls if r % 2 == 0 else calls[::-1]):
                    vper[c.name][f"{k}@{w}"].append(held_ms(
                        lambda: c.call(k, vx, vout, ticket, w, stream),
                        c.v.fns["repro_hold"], stream, args.reps))
    base = variants[0].name
    nbytes = {k: {"read_hbm": 1, "write_hbm": 1, "triad_hbm": 3}.get(k, 2)
              * x.nbytes for k in KERNELS}
    nbytes["write_hbm_seeded"] = bufs["seeded_rows"] * 512
    result = {"card": smi, "mib": args.mib, "rounds": args.rounds,
              "reps": args.reps, "read_rel_err": errs, "kernels": {},
              "library_calls": LIBRARY if args.library else {},
              "library_launches": (
                  {k: launch_layout(lambda: library_call(k, bufs))
                   for k in LIBRARY if k in timed} if args.library else {}),
              "builds": {k: dict(b) for k, b in builds.items()},
              "chunk_bytes": {v.name: {k: c * 16
                                       for k, c in v.chunk_vec.items()}
                              for v in variants},
              "seeded_rows": bufs["seeded_rows"],
              "vmem_rows": VMEM_ROWS, "vmem_rel_err": vmem_errs,
              "vmem": {}}
    for k in KERNELS:
        rk = {}
        for name, times in per.items():
            ms = times[k]
            if not ms:
                continue
            rec = {"ms": statistics.median(ms), "ms_min": min(ms),
                   "ms_max": max(ms),
                   "gb_s": nbytes[k] / statistics.median(ms) / 1e6}
            if per[base][k]:
                rec[f"vs_{base}"] = statistics.median(
                    [a / b for a, b in zip(ms, per[base][k])])
            rk[name] = rec
        result["kernels"][k] = rk
    walk_bytes = vx.numel() * 4
    for c in calls:
        rec = {k: statistics.median(vper[c.name][k]) for k in vkeys
               if vper[c.name][k]}
        for k in (k for k in VMEM_KERNELS if k in timed):
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

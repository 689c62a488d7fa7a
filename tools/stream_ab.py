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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import compat  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

KERNELS = ("read_hbm", "write_hbm", "rmw_hbm", "copy_hbm")
CTAS_PER_SM = 8     # the grid rule of kernels/stream.py
_VP, _LL, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_float)


def build(name: str, src_dir: Path, out_dir: Path) -> Path:
    src = src_dir / "stream.cu"
    blob = src.read_bytes() + b"".join(
        p.read_bytes() for p in sorted(src_dir.glob("*.cuh")))
    tag = hashlib.sha256(blob + " ".join(_build.NVCC_FLAGS).encode())
    out = out_dir / f"libstream-{name}-{tag.hexdigest()[:12]}.so"
    if not out.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        cmd = [compat.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
               str(src)]
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
    with ThreadPoolExecutor(len(pairs)) as ex:
        libs = list(ex.map(lambda p: build(p[0], Path(p[1]), out_dir),
                           pairs))
    variants = [Variant(n, lib, sms) for (n, _d), lib in zip(pairs, libs)]
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
    per = {v.name: {k: [] for k in KERNELS} for v in variants}
    for r in range(args.rounds):
        order = variants if r % 2 == 0 else variants[::-1]
        for k in KERNELS:
            for v in order:
                per[v.name][k].append(time_ms(v, k, x, out, partials,
                                              stream, args.reps))
    base = variants[0].name
    nbytes = {"read_hbm": x.nbytes, "write_hbm": x.nbytes,
              "rmw_hbm": 2 * x.nbytes, "copy_hbm": 2 * x.nbytes}
    result = {"card": smi, "mib": args.mib, "rounds": args.rounds,
              "reps": args.reps, "read_rel_err": errs, "kernels": {}}
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
    line = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

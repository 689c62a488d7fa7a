"""Time two or more versions of the bf16 flash-attention kernel on one card.

Each ``--variant name=DIR`` names a directory holding a
``flash_attention_tc.cu``.  Every variant is built with the repo's nvcc
flags and ``-Xptxas -v`` (its registers and spills per head dim are
printed), checked once against the plain version on each call, then the
chip check's three full-width calls (qwen2-1.5b causal, gemma3-1b local
and global, bf16, 32768 tokens, batch 1, the peaked inputs of
``chip_smoke.py``) run in turns: within a round the variants go in one
order, in the next round in the reverse order, so that a drift of the
card's clocks or power falls on all of them alike.  A round times
``--reps`` back-to-back calls with CUDA events; the result is the median
over rounds.

To compare a commit's kernel with the working tree's::

    mkdir -p build/ab/old
    git archive <commit> src/repro_torch/kernels/csrc \\
        | tar -x --strip-components=4 -C build/ab/old
    python tools/flash_ab.py --variant old=build/ab/old \\
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
import re
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
from repro_torch.kernels import _build, ref  # noqa: E402

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PEAKED_QK, V_SCALE = 3.0 ** 0.5, 0.5    # as chip_smoke.py draws them


def build(name: str, src_dir: Path, out_dir: Path):
    """The variant's library and ptxas' (registers, spill bytes) by D."""
    src = src_dir / "flash_attention_tc.cu"
    tag = hashlib.sha256(src.read_bytes()
                         + " ".join(_build.NVCC_FLAGS).encode())
    out = out_dir / f"libflash-{name}-{tag.hexdigest()[:12]}.so"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmd = [compat.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
           str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    regs, d = {}, None
    for line in proc.stderr.splitlines():
        m = re.search(r"flash_tc_kernelILi(\d+)E", line)
        if m and "Compiling entry" in line:
            d = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and d is not None:
            regs.setdefault(d, {})["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and d is not None:
            regs.setdefault(d, {})["registers"] = int(m.group(1))
    return out, regs


def bind(path: Path):
    fn = ctypes.CDLL(str(path)).repro_flash_attention_tc
    fn.argtypes = [_VP] * 4 + [_I] * 9 + [_F, _VP]
    fn.restype = _I
    return fn


def calls(dev):
    """(label, q, k, v, causal, window) of the chip check's three calls."""
    seq = SHAPES["prefill_32k"].seq_len
    qwen, gemma = get_config("qwen2-1.5b"), get_config("gemma3-1b")
    out = []
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
        out.append((label, *t, True, window))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", required=True,
                    help="name=DIR holding flash_attention_tc.cu")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("flash_ab: no CUDA device\n")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    variants = [v.split("=", 1) for v in args.variant]
    out_dir = _build.build_dir().parent / "ab"
    with ThreadPoolExecutor(len(variants)) as ex:
        built = list(ex.map(lambda v: build(v[0], Path(v[1]), out_dir),
                            variants))
    fns = {name: bind(path) for (name, _), (path, _) in zip(variants, built)}
    regs = {name: r for (name, _), (_, r) in zip(variants, built)}
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    result = {"device": smi, "registers": regs, "calls": {}}
    for label, q, k, v, causal, window in calls(dev):
        b, h, sq, d = q.shape
        out = torch.empty_like(q)

        def run(fn):
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), 1, b, h, k.shape[1], sq, k.shape[2],
                      d, int(causal), window, d ** -0.5, stream)
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")

        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window)
        errs = {}
        for name, fn in fns.items():
            run(fn)
            torch.cuda.synchronize()
            errs[name] = float((out.float() - want.float()).abs().max())
        del want
        times = {name: [] for name in fns}
        order = list(fns)
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                run(fns[name])
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(args.reps):
                    run(fns[name])
                e1.record()
                e1.synchronize()
                times[name].append(e0.elapsed_time(e1) / args.reps)
        result["calls"][label] = {
            name: {"ms": statistics.median(t), "ms_all": t,
                   "max_abs_err": errs[name]} for name, t in times.items()}
        print(label, {n: round(statistics.median(t), 4)
                      for n, t in times.items()}, flush=True)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Sequential bandwidth microbenchmark kernels (the paper's r/w/s/x/y/c/b).

The wrappers of ``csrc/stream.cu``.  On the ZCU102 the paper's
distinction is cacheable vs. non-cacheable *instructions*; on this card
it is **which kernel runs**:

* ``*_hbm``  — a grid-stride stream over the whole buffer: every byte
  travels between the buffer's memory and the SMs exactly once.
* ``*_vmem`` — each CTA keeps its tile of the buffer in shared memory
  and walks it ``repeats`` times: after one load (or before one store)
  the traffic stays on chip.

A wrapper launches its kernel for a CUDA tensor, or for a pinned host
tensor when a card is present (the kernel then streams over PCIe).  Only
an ordinary CPU tensor (``device="cpu"`` where there is no input) takes
the plain version in :mod:`repro_torch.kernels.ref`.  Nothing falls
back: a build or launch that fails raises.

``block_rows`` is kept in every signature so that call sites port from
the JAX package unchanged; it must divide the rows, as there, but it no
longer shapes the launch.  Only :func:`mixed_hbm` uses it, for its split.

Buffers are (rows, 128) float32: one 512-byte row is one "line".
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.compat import resolve_device
from repro_torch.kernels import _build, counts, ref

LANE = 128
DEFAULT_BLOCK_ROWS = 512  # 512*128*4B = 256 KiB per block

CTAS_PER_SM = 8           # grid-stride streams: a few CTAs on each SM
# Largest tile one CTA keeps in shared memory: what a block can use, less
# one line for the reduction's static scratch.  453 whole lines.
SMEM_TILE_ROWS = (_build.SMEM_PER_BLOCK_BYTES - 512) // (LANE * 4)

_VP, _LL, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_float)


def _grid_blocks(n_rows: int, block_rows: int) -> int:
    if block_rows < 1 or n_rows % block_rows:
        raise ValueError(f"rows {n_rows} not a multiple of block_rows "
                         f"{block_rows}")
    return n_rows // block_rows


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _stream_threads() -> int:
    return _build.library("stream").repro_stream_threads()


def _stream_grid(n_vec: int, device: torch.device) -> int:
    return max(1, min(-(-n_vec // _stream_threads()),
                      _sm_count(device) * CTAS_PER_SM))


def _launch(fn: str, argtypes, *args) -> None:
    code = _build.bind("stream", fn, argtypes)(*args)
    _build.check_launch("stream", fn, code)


def _destination(shape_rows: int, device, out: Optional[torch.Tensor],
                 what: str) -> torch.Tensor:
    """The store stream's destination: the caller's ``out`` (a pool's
    buffer), or a new tensor on ``device``."""
    if out is None:
        if shape_rows < 1:
            raise ValueError(f"{what}: need at least one row")
        return torch.empty((shape_rows, LANE), dtype=torch.float32,
                           device=resolve_device(device))
    _build.check_buffer(out, dtypes=(torch.float32,), what=what)
    if out.shape[0] != shape_rows:
        raise ValueError(f"{what}: out has {out.shape[0]} rows, "
                         f"want {shape_rows}")
    return out


# ---------------------------------------------------------------------------
# Streaming variants
# ---------------------------------------------------------------------------


def read_hbm(x: torch.Tensor, *,
             block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """Sum x by streaming every byte of it once. x: (R, 128) f32.

    Replaces ``repro/kernels/stream.py:read_hbm``.  Bound by bytes: R*512
    read once.  Design (B): a grid-stride loop of 16-byte loads, four
    float32 accumulators a thread, one partial a CTA into a scratch
    tensor; the partials are summed outside the kernel, as the TPU
    version sums its per-block partials.  The summation order differs
    from the reference's block order, so results agree to float32
    rounding, not bit for bit."""
    _build.check_buffer(x, dtypes=(torch.float32,), what="read_hbm")
    _grid_blocks(x.shape[0], block_rows)
    if not _build.launches_kernel(x):
        counts.PLAIN["read_hbm"] += 1
        return ref.read_ref(x)
    dev = _build.compute_device(x)
    n_vec = x.numel() // 4
    grid = _stream_grid(n_vec, dev)
    partials = torch.empty(grid, dtype=torch.float32, device=dev)
    _launch("repro_read_hbm", (_VP, _VP, _LL, _I, _VP),
            x.data_ptr(), partials.data_ptr(), n_vec, grid,
            _build.current_stream(dev))
    counts.LAUNCHES["read_hbm"] += 1
    return partials.sum()


def _write(name: str, seed: Optional[torch.Tensor], shape_rows: int,
           value: float, block_rows: int, device,
           out: Optional[torch.Tensor]) -> torch.Tensor:
    _grid_blocks(shape_rows, block_rows)
    dst = _destination(shape_rows, device, out, name)
    if seed is not None and (_build.launches_kernel(seed)
                             != _build.launches_kernel(dst)):
        raise ValueError(f"{name}: seed and destination must both be "
                         "reachable from the card, or both on the CPU")
    if not _build.launches_kernel(dst):
        counts.PLAIN[name] += 1
        fill = value if seed is None else value + float(seed.reshape(-1)[0])
        return dst.copy_(ref.write_ref(shape_rows, fill))
    dev = _build.compute_device(dst)
    n_vec = dst.numel() // 4
    _launch("repro_write_hbm", (_VP, _LL, _F, _VP, _I, _VP),
            dst.data_ptr(), n_vec, float(value),
            None if seed is None else seed.data_ptr(),
            _stream_grid(n_vec, dev), _build.current_stream(dev))
    counts.LAUNCHES[name] += 1
    return dst


def write_hbm(shape_rows: int, *, value: float = 1.0,
              block_rows: int = DEFAULT_BLOCK_ROWS, device="cuda",
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write-streaming (y): pure stores, destination never read.

    Replaces ``repro/kernels/stream.py:write_hbm``.  Bound by bytes:
    rows*512 written once.  Design (A): grid-stride 16-byte stores.  The
    destination is ``out`` when the caller owns one (a pool's buffer, in
    device or pinned host memory), else a new tensor on ``device``; it is
    returned either way, so the stores are never dead."""
    return _write("write_hbm", None, shape_rows, value, block_rows, device,
                  out)


def write_hbm_seeded(seed: torch.Tensor, shape_rows: int, *,
                     value: float = 1.0,
                     block_rows: int = DEFAULT_BLOCK_ROWS,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write-streaming (y) with a dataflow anchor: identical store
    traffic to :func:`write_hbm`, but the stored value is ``value +
    seed[0, 0]`` for the (1, 1) f32 ``seed`` operand, read in the kernel.

    Replaces ``repro/kernels/stream.py:write_hbm_seeded``; it is one
    template parameter of the write kernel.  The destination lives where
    ``seed`` lives unless ``out`` is given."""
    if seed.dtype != torch.float32 or seed.numel() != 1:
        raise ValueError("write_hbm_seeded: seed must be one float32")
    return _write("write_hbm_seeded", seed, shape_rows, value, block_rows,
                  seed.device, out)


def rmw_hbm(x: torch.Tensor, *,
            block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """Write-allocate (x): every line read, modified (+1), and written
    to a NEW buffer, as the reference's ``pallas_call`` does.

    Replaces ``repro/kernels/stream.py:rmw_hbm``.  Bound by bytes: each
    line read once and written once.  Design (A).  f32 and bf16."""
    _build.check_buffer(x, dtypes=(torch.float32, torch.bfloat16),
                        what="rmw_hbm")
    _grid_blocks(x.shape[0], block_rows)
    if not _build.launches_kernel(x):
        counts.PLAIN["rmw_hbm"] += 1
        return ref.rmw_ref(x)
    dev = _build.compute_device(x)
    out = _build.empty_like_placed(x)
    n_vec = x.numel() * x.element_size() // 16
    fn = ("repro_rmw_hbm_f32" if x.dtype == torch.float32
          else "repro_rmw_hbm_bf16")
    _launch(fn, (_VP, _VP, _LL, _I, _VP), x.data_ptr(), out.data_ptr(),
            n_vec, _stream_grid(n_vec, dev), _build.current_stream(dev))
    counts.LAUNCHES["rmw_hbm"] += 1
    return out


def copy_hbm(x: torch.Tensor, *,
             block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """Copy stream (c): read every line, write it to a second buffer.

    Replaces ``repro/kernels/stream.py:copy_hbm``.  Bound by bytes: each
    line read once and written once.  Design (A)."""
    _build.check_buffer(x, dtypes=(torch.float32, torch.bfloat16,
                                   torch.int32), what="copy_hbm")
    _grid_blocks(x.shape[0], block_rows)
    if not _build.launches_kernel(x):
        counts.PLAIN["copy_hbm"] += 1
        return ref.copy_ref(x)
    dev = _build.compute_device(x)
    out = _build.empty_like_placed(x)
    n_vec = x.numel() * x.element_size() // 16
    _launch("repro_copy_hbm", (_VP, _VP, _LL, _I, _VP), x.data_ptr(),
            out.data_ptr(), n_vec, _stream_grid(n_vec, dev),
            _build.current_stream(dev))
    counts.LAUNCHES["copy_hbm"] += 1
    return out


def mixed_hbm(x: torch.Tensor, *, read_fraction: float,
              value: float = 1.0, block_rows: int = DEFAULT_BLOCK_ROWS,
              seed: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixed read/write stream: ``read_fraction`` of the blocks are
    sum-reduced (pure read traffic), the rest are written (pure store
    traffic) — nothing else touches memory, so the realized read:write
    line ratio IS the configured one.  Interleave order is irrelevant
    to a bandwidth mix, so the split is by row range.

    Returns (read_sum, written): read_sum keeps the read traffic live;
    written is the store destination, ``((n - n_r) * block, 128)``, in
    the same memory as ``x``.  The block rule is
    :func:`repro_torch.kernels.ref.mixed_split`.

    No kernel of its own, as in the reference: :func:`read_hbm` over the
    first ``n_r`` blocks, :func:`write_hbm` (``write_hbm_seeded`` when a
    (1, 1) f32 ``seed`` is given) over the rest."""
    _build.check_buffer(x, dtypes=(torch.float32,), what="mixed_hbm")
    block_rows, n_r, n_w = ref.mixed_split(x.shape[0], read_fraction,
                                           block_rows)
    on_card = _build.launches_kernel(x)
    acc_dev = _build.compute_device(x) if on_card else x.device
    acc = torch.zeros((), dtype=torch.float32, device=acc_dev)
    out = torch.zeros((0, LANE), dtype=torch.float32, device=acc_dev)
    if n_r:
        acc = read_hbm(x[:n_r * block_rows], block_rows=block_rows)
    if n_w:
        dst = _build.empty_like_placed(x, (n_w * block_rows, LANE))
        if seed is not None:
            out = write_hbm_seeded(seed, n_w * block_rows, value=value,
                                   block_rows=block_rows, out=dst)
        else:
            out = write_hbm(n_w * block_rows, value=value,
                            block_rows=block_rows, out=dst)
    return acc, out


# ---------------------------------------------------------------------------
# On-chip residency pair (cacheable analog)
# ---------------------------------------------------------------------------


def _tile_rows(rows: int) -> int:
    """Rows a CTA keeps in shared memory: the whole buffer when it fits
    one SM, else tiles of ``SMEM_TILE_ROWS`` over as many CTAs."""
    return min(rows, SMEM_TILE_ROWS)


def read_vmem(x: torch.Tensor, *, repeats: int = 16) -> torch.Tensor:
    """Re-read an on-chip copy of the buffer ``repeats`` times (one load
    from the buffer's memory); returns ``sum(x) * repeats``.

    Replaces ``repro/kernels/stream.py:read_vmem``.  Bound by bytes
    (R*512 read once) for the card, by shared-memory bandwidth for what
    it is built to time.  Design (C): each CTA loads its tile into
    dynamic shared memory once, then sums it ``repeats`` times; a
    compiler barrier in the loop keeps the re-reads from being hoisted."""
    _build.check_buffer(x, dtypes=(torch.float32,), what="read_vmem")
    if repeats < 1:
        raise ValueError("read_vmem: repeats must be >= 1")
    if not _build.launches_kernel(x):
        counts.PLAIN["read_vmem"] += 1
        return ref.read_vmem_ref(x, repeats)
    dev = _build.compute_device(x)
    tile_rows = _tile_rows(x.shape[0])
    n_ctas = -(-x.shape[0] // tile_rows)
    partials = torch.empty(n_ctas, dtype=torch.float32, device=dev)
    _launch("repro_read_vmem", (_VP, _VP, _LL, _I, _I, _VP),
            x.data_ptr(), partials.data_ptr(), x.numel() // 4,
            tile_rows * (LANE // 4), repeats, _build.current_stream(dev))
    counts.LAUNCHES["read_vmem"] += 1
    return partials.sum()


def write_vmem(shape_rows: int, *, repeats: int = 16, device="cuda",
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Re-write an on-chip buffer ``repeats`` times with ``float(i)``,
    then store it once: every element ends as ``repeats - 1``.

    Replaces ``repro/kernels/stream.py:write_vmem``.  Bound by bytes
    (rows*512 written once) for the card, by shared-memory bandwidth for
    what it is built to time.  Design (C), with the same compiler
    barrier so that no repeated store is deleted.  Destination as in
    :func:`write_hbm`."""
    if repeats < 1:
        raise ValueError("write_vmem: repeats must be >= 1")
    dst = _destination(shape_rows, device, out, "write_vmem")
    if not _build.launches_kernel(dst):
        counts.PLAIN["write_vmem"] += 1
        return dst.copy_(ref.write_vmem_ref(shape_rows, repeats))
    dev = _build.compute_device(dst)
    _launch("repro_write_vmem", (_VP, _LL, _I, _I, _VP),
            dst.data_ptr(), dst.numel() // 4,
            _tile_rows(shape_rows) * (LANE // 4), repeats,
            _build.current_stream(dev))
    counts.LAUNCHES["write_vmem"] += 1
    return dst

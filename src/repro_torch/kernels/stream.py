"""Sequential bandwidth microbenchmark kernels (the paper's r/w/s/x/y/c/b,
and the STREAM triad).

The wrappers of ``csrc/stream.cu``.  On the ZCU102 the paper's
distinction is cacheable vs. non-cacheable *instructions*; on this card
it is **which kernel runs**:

* ``*_hbm``  — a stream over the whole buffer (a grid stride for the
  read; one chunk a CTA for the writes, rmw, copy and triad): every byte
  travels between the buffer's memory and the SMs exactly once.
* ``*_vmem`` — the buffer is spread over the shared memory of up to
  every SM, and each CTA walks its slice ``repeats`` times: after one
  load (or before one store) the traffic stays on chip.

A wrapper launches its kernel for a CUDA tensor, or for a pinned host
tensor when a card is present (the kernel then streams over PCIe).  Only
an ordinary CPU tensor (``device="cpu"`` where there is no input) takes
the plain version in :mod:`repro_torch.kernels.ref`.  Nothing falls
back: a build or launch that fails raises.

``block_rows`` is kept in every signature so that call sites port from
the JAX package unchanged; it must divide the rows, as there, but it no
longer shapes the launch.  Only :func:`mixed_hbm` uses it, for its split.

Buffers are (rows, 128) float32: one 512-byte row is one "line".  The
reads, copy, rmw, the mixed stream and the on-chip read also take a
(g, rows, 128) stack of g members, the port of the reference's
``jax.vmap`` over a leading member axis, in one launch (two for the mixed
stream): a result per member, computed as for each member alone.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.compat import resolve_device
from repro_torch.kernels import _build, counts, ref

LANE = 128
DEFAULT_BLOCK_ROWS = 512  # 512*128*4B = 256 KiB per block

CTAS_PER_SM = 8           # the grid-stride read: a few CTAs on each SM
# Largest tile one CTA keeps in shared memory: what a block can use, less
# one line for the reduction's static scratch.  453 whole lines.
SMEM_TILE_ROWS = (_build.SMEM_PER_BLOCK_BYTES - 512) // (LANE * 4)
# The on-chip pair's slices (vmem_layout): at least this many rows a CTA,
# chosen by tools/stream_ab.py's layout sweep on an H100.
VMEM_MIN_SLICE_ROWS = 2

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
    """Sum x by streaming every byte of it once. x: (R, 128) f32, or a
    (g, R, 128) stack whose members may lie apart; then one sum a member.

    Replaces ``repro/kernels/stream.py:read_hbm``.  Bound by bytes: R*512
    read once (a member).  Design (B): a grid-stride loop of 16-byte
    loads, four float32 accumulators a thread, one partial a CTA into a
    scratch tensor; the partials are summed outside the kernel, as the
    TPU version sums its per-block partials.  A stack is one launch whose
    grid spreads every member's blocks over the card.  The summation
    order differs from the reference's block order, so results agree to
    float32 rounding, not bit for bit."""
    _build.check_buffer(x, dtypes=(torch.float32,), what="read_hbm",
                        members=True)
    g, rows, stride = _build.member_layout(x)
    _grid_blocks(rows, block_rows)
    if not _build.launches_kernel(x):
        counts.PLAIN["read_hbm"] += 1
        return ref.read_ref(x)
    dev = _build.compute_device(x)
    n_vec = rows * LANE // 4
    grid = max(1, _stream_grid(n_vec * g, dev) // g)
    partials = torch.empty((g, grid), dtype=torch.float32, device=dev)
    _launch("repro_read_hbm", (_VP, _VP, _LL, _LL, _I, _I, _VP),
            x.data_ptr(), partials.data_ptr(), n_vec, stride // 4, g, grid,
            _build.current_stream(dev))
    counts.LAUNCHES["read_hbm"] += 1
    return partials.sum(dim=-1) if x.dim() == 3 else partials.sum()


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
        return dst.copy_(ref.write_ref(shape_rows, value) if seed is None
                         else ref.write_seeded_ref(shape_rows, value, seed))
    dev = _build.compute_device(dst)
    n_vec = dst.numel() // 4
    _launch("repro_write_hbm", (_VP, _LL, _F, _VP, _I, _VP),
            dst.data_ptr(), n_vec, float(value),
            None if seed is None else seed.data_ptr(),
            chunk_grid(n_vec, kernel_chunk_vec("write")),
            _build.current_stream(dev))
    counts.LAUNCHES[name] += 1
    return dst


def write_hbm(shape_rows: int, *, value: float = 1.0,
              block_rows: int = DEFAULT_BLOCK_ROWS, device="cuda",
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write-streaming (y): pure stores, destination never read.

    Replaces ``repro/kernels/stream.py:write_hbm``.  Bound by bytes:
    rows*512 written once.  Design (E): one CTA an 8 KiB chunk
    (:func:`chunk_grid`), its threads' 16-byte stores blockDim apart inside
    it, so the CTAs on the card at any moment store into one window of the
    buffer; no byte past the last row is stored.  The destination is
    ``out`` when the caller owns one (a pool's buffer or a row-slice of
    one, in device or pinned host memory, which the stores reach over
    PCIe), else a new tensor on ``device``; it is returned either way, so
    the stores are never dead."""
    return _write("write_hbm", None, shape_rows, value, block_rows, device,
                  out)


def write_hbm_seeded(seed: torch.Tensor, shape_rows: int, *,
                     value: float = 1.0,
                     block_rows: int = DEFAULT_BLOCK_ROWS,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write-streaming (y) with a dataflow anchor: identical store
    traffic to :func:`write_hbm`, but the stored value is ``value +
    seed[0, 0]`` for the (1, 1) f32 ``seed`` operand, read in the kernel
    on the device, once a CTA.  ``value`` is rounded to float32 and the
    seed added in float32, as the reference's ``full_like(value) + seed``
    (:func:`repro_torch.kernels.ref.write_seeded_ref`).

    Replaces ``repro/kernels/stream.py:write_hbm_seeded``; it is one
    template parameter of the write kernel.  The destination lives where
    ``seed`` lives unless ``out`` is given."""
    if seed.dtype != torch.float32 or seed.numel() != 1:
        raise ValueError("write_hbm_seeded: seed must be one float32")
    return _write("write_hbm_seeded", seed, shape_rows, value, block_rows,
                  seed.device, out)


def _elementwise(x: torch.Tensor, dtypes, block_rows: int, what: str):
    """Checks for copy and rmw: a (rows, 128) buffer or a contiguous
    (g, rows, 128) stack, which they stream as one (g*rows, 128) buffer."""
    _build.check_buffer(x, dtypes=dtypes, what=what, members=True)
    if not x.is_contiguous():
        raise ValueError(f"{what}: a stack must be contiguous")
    _grid_blocks(x.shape[-2], block_rows)


def chunk_grid(n_vec: int, chunk_vec: int) -> int:
    """CTAs of the write, rmw, copy and triad kernels: one a chunk of
    ``chunk_vec`` 16-byte units of each input (of the output, for the
    write), the last chunk short (:func:`chunk_range`)."""
    if n_vec < 1 or chunk_vec < 1:
        raise ValueError(f"chunk_grid: n_vec {n_vec}, chunk_vec {chunk_vec}")
    return -(-n_vec // chunk_vec)


def chunk_range(b: int, n_vec: int, chunk_vec: int) -> Tuple[int, int]:
    """The units [begin, end) of each input and of the output that CTA
    ``b`` of a chunked kernel reads and writes: the rule ``csrc/stream.cu``
    applies, restated."""
    begin = b * chunk_vec
    return begin, min(begin + chunk_vec, n_vec)


@functools.lru_cache(maxsize=None)
def kernel_chunk_vec(kernel: str) -> int:
    """The 16-byte units of a chunk of ``kernel``'s output ("write"), or
    of one input of ``kernel`` ("rmw", "copy" or "triad"), as the built
    library reports it."""
    lib = _build.library("stream")
    return getattr(lib, f"repro_{kernel}_chunk_bytes")() // 16


def rmw_hbm(x: torch.Tensor, *,
            block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """Write-allocate (x): every line read, modified (+1), and written
    to a NEW buffer, as the reference's ``pallas_call`` does.

    Replaces ``repro/kernels/stream.py:rmw_hbm``.  Bound by bytes: each
    line read once and written once.  Design (D): one CTA a 10 KiB chunk
    (:func:`chunk_grid`), which one TMA bulk copy brings into shared memory
    and one takes back, so the CTAs on the card at any moment sweep one
    window of the buffer.  f32 and bf16 (one rounding).  A stack of
    members is one stream over all of them.  The output lies where ``x``
    does: on its card, or in pinned host memory, which the bulk copies
    read and write over PCIe."""
    _elementwise(x, (torch.float32, torch.bfloat16), block_rows, "rmw_hbm")
    if not _build.launches_kernel(x):
        counts.PLAIN["rmw_hbm"] += 1
        return ref.rmw_ref(x)
    dev = _build.compute_device(x)
    out = _build.empty_like_placed(x)
    n_vec = x.numel() * x.element_size() // 16
    _launch("repro_rmw_hbm", (_VP, _VP, _LL, _I, _I, _VP),
            x.data_ptr(), out.data_ptr(), n_vec,
            chunk_grid(n_vec, kernel_chunk_vec("rmw")),
            int(x.dtype == torch.bfloat16), _build.current_stream(dev))
    counts.LAUNCHES["rmw_hbm"] += 1
    return out


def copy_hbm(x: torch.Tensor, *,
             block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """Copy stream (c): read every line, write it to a NEW buffer, bit for
    bit (float32, bf16 or int32: bytes to the kernel).

    Replaces ``repro/kernels/stream.py:copy_hbm``.  Bound by bytes: each
    line read once and written once.  Design (D), as :func:`rmw_hbm`:
    one CTA of one warp a 9 KiB chunk (:func:`chunk_grid`), one TMA bulk
    copy in and one out, with no pass of the threads over it; four CTAs
    an SM.  A stack of members is one stream over all of them.  The output lies where ``x`` does: on its
    card, or in pinned host memory (over PCIe)."""
    _elementwise(x, (torch.float32, torch.bfloat16, torch.int32),
                 block_rows, "copy_hbm")
    if not _build.launches_kernel(x):
        counts.PLAIN["copy_hbm"] += 1
        return ref.copy_ref(x)
    dev = _build.compute_device(x)
    out = _build.empty_like_placed(x)
    n_vec = x.numel() * x.element_size() // 16
    _launch("repro_copy_hbm", (_VP, _VP, _LL, _I, _VP), x.data_ptr(),
            out.data_ptr(), n_vec,
            chunk_grid(n_vec, kernel_chunk_vec("copy")),
            _build.current_stream(dev))
    counts.LAUNCHES["copy_hbm"] += 1
    return out


def triad_hbm(b: torch.Tensor, c: torch.Tensor, *, scalar: float = 3.0,
              block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """STREAM triad: ``b + scalar * c`` into a new buffer.

    Replaces ``repro/kernels/stream.py:triad_hbm``.  Bound by bytes: each
    line of ``b`` and ``c`` read once, each line of the result written
    once.  Design (D): one CTA a 10 KiB chunk of each operand
    (:func:`chunk_grid`), both brought into shared memory by two TMA bulk
    copies on one barrier, the result written back by one; the product
    and the sum are rounded apart (no fused multiply-add), so the kernel
    agrees with the plain version exactly.  ``b`` and ``c`` are
    (rows, 128) float32 of one shape in one memory: on the card, or
    pinned host memory (over PCIe), where the result lies too."""
    for t, what in ((b, "triad_hbm: b"), (c, "triad_hbm: c")):
        _build.check_buffer(t, dtypes=(torch.float32,), what=what)
    if b.shape != c.shape:
        raise ValueError(f"triad_hbm: b {tuple(b.shape)} and c "
                         f"{tuple(c.shape)} differ")
    _grid_blocks(b.shape[0], block_rows)
    if b.device != c.device or b.is_pinned() != c.is_pinned():
        raise ValueError("triad_hbm: b and c must lie in the same memory")
    if not _build.launches_kernel(b):
        counts.PLAIN["triad_hbm"] += 1
        return ref.triad_ref(b, c, scalar)
    dev = _build.compute_device(b)
    out = _build.empty_like_placed(b)
    n_vec = b.numel() // 4
    _launch("repro_triad_hbm", (_VP, _VP, _VP, _LL, _F, _I, _VP),
            b.data_ptr(), c.data_ptr(), out.data_ptr(), n_vec, float(scalar),
            chunk_grid(n_vec, kernel_chunk_vec("triad")),
            _build.current_stream(dev))
    counts.LAUNCHES["triad_hbm"] += 1
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
    :func:`repro_torch.kernels.ref.mixed_split`; a (g, rows, 128) stack
    applies it to each member and returns (g,) sums and a
    (g, (n - n_r) * block, 128) destination.

    No kernel of its own, as in the reference: :func:`read_hbm` over the
    first ``n_r`` blocks, :func:`write_hbm` (``write_hbm_seeded`` when a
    (1, 1) f32 ``seed`` is given) over the rest."""
    _build.check_buffer(x, dtypes=(torch.float32,), what="mixed_hbm",
                        members=True)
    lead = tuple(x.shape[:-2])
    block_rows, n_r, n_w = ref.mixed_split(x.shape[-2], read_fraction,
                                           block_rows)
    dev = _build.compute_device(x) if _build.launches_kernel(x) else x.device
    if n_r:
        acc = read_hbm(x[..., :n_r * block_rows, :], block_rows=block_rows)
    else:
        acc = torch.zeros(lead, dtype=torch.float32, device=dev)
    if not n_w:
        return acc, torch.zeros((*lead, 0, LANE), dtype=torch.float32,
                                device=dev)
    out = _build.empty_like_placed(x, (*lead, n_w * block_rows, LANE))
    flat_rows = out.numel() // LANE
    flat = out.view(flat_rows, LANE)
    if seed is not None:
        write_hbm_seeded(seed, flat_rows, value=value, block_rows=block_rows,
                         out=flat)
    else:
        write_hbm(flat_rows, value=value, block_rows=block_rows, out=flat)
    return acc, out


# ---------------------------------------------------------------------------
# On-chip residency pair (cacheable analog)
# ---------------------------------------------------------------------------


class VmemLayout(NamedTuple):
    """The on-chip pair's launch: ``ctas`` CTAs, CTA b holding rows
    [b * slice_rows, min(rows, (b + 1) * slice_rows)) in its shared
    memory."""
    ctas: int
    slice_rows: int


def vmem_layout(rows: int, sm_count: int) -> VmemLayout:
    """Spread ``rows`` over the shared memory of up to ``sm_count`` SMs,
    one CTA an SM, at least ``VMEM_MIN_SLICE_ROWS`` rows a CTA (a smaller
    slice is walked at the loop's latency, not the shared memory's rate).
    A buffer larger than ``sm_count`` tiles of ``SMEM_TILE_ROWS`` takes as
    many CTAs of that tile as it needs."""
    if rows < 1 or sm_count < 1:
        raise ValueError(f"vmem_layout: rows {rows}, sm_count {sm_count}")
    slice_rows = min(rows, SMEM_TILE_ROWS,
                     max(VMEM_MIN_SLICE_ROWS, -(-rows // sm_count)))
    return VmemLayout(-(-rows // slice_rows), slice_rows)


# The ticket of each (card, stream): the read's last CTA finds out that it
# is last by it and sets it back to 0, so launches in one stream share it
# and launches in two streams never do.
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _ticket(dev: torch.device, stream_: int) -> torch.Tensor:
    key = (dev.index, stream_)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return t


def read_vmem(x: torch.Tensor, *, repeats: int = 16) -> torch.Tensor:
    """Re-read an on-chip copy of the buffer ``repeats`` times (one load
    from the buffer's memory); returns ``sum(x) * repeats``, one a member
    for a (g, rows, 128) stack.

    Replaces ``repro/kernels/stream.py:read_vmem``.  Bound by the shared
    memory of the SMs it spans (``repeats`` x R*512 bytes), plus R*512
    read once from the buffer's memory.  Design (C): the rows are spread
    over up to every SM (:func:`vmem_layout`); each CTA loads its slice
    into dynamic shared memory once, then sums it ``repeats`` times with
    several walks in flight; a compiler barrier at each walk keeps the
    re-reads from being hoisted.  The last CTA to finish sums the
    partials in a fixed order: one launch a call, the same bits every
    call.  The members of a stack run back to back in each CTA, so the
    launch takes the sum of their walks."""
    _build.check_buffer(x, dtypes=(torch.float32,), what="read_vmem",
                        members=True)
    if repeats < 1:
        raise ValueError("read_vmem: repeats must be >= 1")
    if not _build.launches_kernel(x):
        counts.PLAIN["read_vmem"] += 1
        return ref.read_vmem_ref(x, repeats)
    dev = _build.compute_device(x)
    g, rows, stride = _build.member_layout(x)
    lay = vmem_layout(rows, _sm_count(dev))
    partials = torch.empty((g, lay.ctas), dtype=torch.float32, device=dev)
    out = torch.empty(g, dtype=torch.float32, device=dev)
    st = _build.current_stream(dev)
    _launch("repro_read_vmem",
            (_VP, _VP, _VP, _VP, _LL, _LL, _I, _I, _I, _VP),
            x.data_ptr(), partials.data_ptr(), out.data_ptr(),
            _ticket(dev, st).data_ptr(), rows * LANE // 4, stride // 4, g,
            lay.slice_rows * (LANE // 4), repeats, st)
    counts.LAUNCHES["read_vmem"] += 1
    return out if x.dim() == 3 else out[0]


def write_vmem(shape_rows: int, *, repeats: int = 16, device="cuda",
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Re-write an on-chip buffer ``repeats`` times with ``float(i)``,
    then store it once: every element ends as ``repeats - 1``.

    Replaces ``repro/kernels/stream.py:write_vmem``.  Bound by the shared
    memory of the SMs it spans (``repeats`` x rows*512 bytes), plus
    rows*512 written once to the destination.  Design (C), spread over
    the SMs as :func:`read_vmem` is, with the same compiler barrier so
    that no repeated store is deleted.  Destination as in
    :func:`write_hbm`."""
    if repeats < 1:
        raise ValueError("write_vmem: repeats must be >= 1")
    dst = _destination(shape_rows, device, out, "write_vmem")
    if not _build.launches_kernel(dst):
        counts.PLAIN["write_vmem"] += 1
        return dst.copy_(ref.write_vmem_ref(shape_rows, repeats))
    dev = _build.compute_device(dst)
    lay = vmem_layout(shape_rows, _sm_count(dev))
    _launch("repro_write_vmem", (_VP, _LL, _I, _I, _VP),
            dst.data_ptr(), dst.numel() // 4, lay.slice_rows * (LANE // 4),
            repeats, _build.current_stream(dev))
    counts.LAUNCHES["write_vmem"] += 1
    return dst


def hold(ns: int, device) -> None:
    """Keep the current stream of the card ``device`` busy for ``ns``
    nanoseconds (one thread sleeping on the global timer).  Work enqueued
    behind it then runs back to back however slowly the host enqueued
    it.  A timing aid, not the port of a TPU kernel; it counts nothing."""
    dev = torch.device(device)
    _launch("repro_hold", (_LL, _VP), int(ns), _build.current_stream(dev))

"""The call-site names the workload library uses for the kernels.

The JAX package's ``ops`` wraps each kernel in ``jit`` and picks
interpret mode off-TPU; PyTorch runs eagerly and a CUDA kernel has no
interpret mode, so these are the kernels under their call-site names.
"""
from __future__ import annotations

from repro_torch.kernels import chase as _chase
from repro_torch.kernels import compute_probe as _probe
from repro_torch.kernels import contention as _contention
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import stream as _stream

# --- stream ------------------------------------------------------------------


def stream_read(x, *, block_rows: int = 512):
    return _stream.read_hbm(x, block_rows=block_rows)


def stream_write(*, rows: int, block_rows: int = 512, device="cuda",
                 out=None):
    return _stream.write_hbm(rows, block_rows=block_rows, device=device,
                             out=out)


def stream_rmw(x, *, block_rows: int = 512):
    return _stream.rmw_hbm(x, block_rows=block_rows)


def stream_write_seeded(seed, *, rows: int, block_rows: int = 512, out=None):
    return _stream.write_hbm_seeded(seed, rows, block_rows=block_rows,
                                    out=out)


def stream_copy(x, *, block_rows: int = 512):
    return _stream.copy_hbm(x, block_rows=block_rows)


def stream_triad(b, c, *, scalar: float = 3.0, block_rows: int = 512):
    return _stream.triad_hbm(b, c, scalar=scalar, block_rows=block_rows)


def stream_mixed(x, *, read_fraction: float, block_rows: int = 512,
                 seed=None):
    return _stream.mixed_hbm(x, read_fraction=read_fraction,
                             block_rows=block_rows, seed=seed)


def hold_stream(ns: int, device):
    return _stream.hold(ns, device)


def vmem_read(x, *, repeats: int = 16):
    return _stream.read_vmem(x, repeats=repeats)


def vmem_write(*, rows: int, repeats: int = 16, device="cuda", out=None):
    return _stream.write_vmem(rows, repeats=repeats, device=device, out=out)


# --- chase -------------------------------------------------------------------

chase_vmem = _chase.chase_vmem
chase_hbm = _chase.chase_hbm

make_chain = _chase.make_chain
chain_buffer = _chase.chain_buffer
make_strided_chain = _chase.make_strided_chain
strided_chain_buffer = _chase.strided_chain_buffer


# --- compute probe -------------------------------------------------------------


def mxu_probe(a, *, iters: int = 64):
    return _probe.mxu_probe(a, iters=iters)


# --- contention ladder and kernel-support probe --------------------------

contention_ladder = _contention.contention_ladder
probe_add_one = _contention.probe_add_one


# --- flash attention -----------------------------------------------------------


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    sm_scale=None, block_q: int = 128, block_k: int = 128):
    return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                  sm_scale=sm_scale, block_q=block_q,
                                  block_k=block_k)

"""Plain PyTorch versions of every kernel (what the CPU runs, and what
the CUDA kernels are held against on the card).

The reads, the on-chip read and the chases take a leading member axis
too, as their kernels do: a (g, rows, 128) stack gives one result per
member, what ``jax.vmap`` of the reference kernel gives.  Copy and rmw are
elementwise and take any leading axes as they are."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

# --- stream ----------------------------------------------------------------


def read_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dim=(-2, -1), dtype=torch.float32)


def write_ref(shape_rows: int, value: float = 1.0,
              device="cpu") -> torch.Tensor:
    return torch.full((shape_rows, 128), value, dtype=torch.float32,
                      device=device)


def rmw_ref(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def copy_ref(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def read_vmem_ref(x: torch.Tensor, repeats: int) -> torch.Tensor:
    return read_ref(x) * repeats


def write_vmem_ref(shape_rows: int, repeats: int,
                   device="cpu") -> torch.Tensor:
    return torch.full((shape_rows, 128), float(repeats - 1),
                      dtype=torch.float32, device=device)


def mixed_split(rows: int, read_fraction: float,
                block_rows: int) -> Tuple[int, int, int]:
    """The mixed stream's block rule: ``(block_rows, n_read, n_written)``.

    The ratio is realized at whole-block granularity.  When the buffer
    holds fewer than 8 blocks at the requested block size, the block
    shrinks to the largest divisor of ``rows`` that gives >= 8 blocks, so
    a small buffer cannot silently degenerate to a pure read or write;
    an extreme but genuine mix keeps >= 1 block of each kind."""
    if not 0.0 <= read_fraction <= 1.0:
        raise ValueError(f"read_fraction {read_fraction} not in [0, 1]")
    if 0.0 < read_fraction < 1.0 and rows // block_rows < 8:
        block_rows = next(b for b in range(max(1, rows // 8), 0, -1)
                          if rows % b == 0)
    if rows % block_rows:
        raise ValueError(f"rows {rows} not a multiple of block_rows "
                         f"{block_rows}")
    n = rows // block_rows
    n_r = max(0, min(n, int(round(n * read_fraction))))
    if 0.0 < read_fraction < 1.0 and n >= 2:
        n_r = max(1, min(n - 1, n_r))
    return block_rows, n_r, n - n_r


def mixed_ref(x: torch.Tensor, read_fraction: float, value: float = 1.0,
              block_rows: int = 512,
              seed: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block rule applied to each member of ``x``'s leading axes."""
    blk, n_r, n_w = mixed_split(x.shape[-2], read_fraction, block_rows)
    return (read_ref(x[..., :n_r * blk, :]),
            torch.full((*x.shape[:-2], n_w * blk, 128), value + seed,
                       dtype=torch.float32, device=x.device))


# --- chase -----------------------------------------------------------------


def chase_ref(buf, n_steps: int) -> int:
    idx = 0
    nxt = (buf[:, 0].detach().cpu().numpy() if isinstance(buf, torch.Tensor)
           else np.asarray(buf)[:, 0])
    for _ in range(n_steps):
        idx = int(nxt[idx])
    return idx


def chase_members_ref(bufs, n_steps: int) -> List[int]:
    """The final index of each member of a (g, n_lines, 128) stack."""
    return [chase_ref(b, n_steps) for b in bufs]


# --- compute probe ----------------------------------------------------------


def mxu_probe_ref(a: torch.Tensor, iters: int) -> torch.Tensor:
    """a^(iters+1) by ``iters`` dependent products, as the reference's
    oracle computes it.  On the card the caller decides whether float32
    products may use TF32 (``torch.backends.cuda.matmul.allow_tf32``)."""
    out = a.to(torch.float32)
    for _ in range(iters):
        out = out @ a.to(torch.float32)
    return out

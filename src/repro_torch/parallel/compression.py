"""int8 error-feedback gradient compression, the one-device part.

The port of ``repro/parallel/compression.py``'s quantizer: gradients are
quantized to int8 with a per-leaf float32 scale, and the quantization
error is carried to the next step (error feedback), so the scheme stays
unbiased over time.  ``torch.round`` rounds half to even, as
``jnp.round`` does, so the int8 values and the new error equal the
reference's bit for bit on the same inputs.

:func:`compressed_psum` is the compressed all-reduce over a process group
(the reference's runs over a named mesh axis under ``shard_map``): the
``MAX`` all-reduce of each leaf's scale, every rank quantized against
it, the int8 values summed exactly as int32.  On one rank it computes
what :func:`compress_decompress` does, bit for bit.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree

Params = Any
INT8_MAX = 127.0


def init_error_state(params: Params) -> Params:
    return tree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def _q_leaf(g: torch.Tensor, err: torch.Tensor):
    gf = g.to(torch.float32) + err
    scale = torch.max(torch.abs(gf)) / INT8_MAX + 1e-12
    q = torch.clamp(torch.round(gf / scale), -INT8_MAX, INT8_MAX
                    ).to(torch.int8)
    new_err = gf - q.to(torch.float32) * scale
    return q, scale, new_err


def ef_quantize(grads: Params, err: Params
                ) -> Tuple[Params, Params, Params]:
    """-> (int8 grads, float32 scales, new error state)."""
    out = [_q_leaf(g, e) for g, e in zip(tree.leaves(grads),
                                         tree.leaves(err))]
    return tuple(tree.unflatten_like(grads, [o[i] for o in out])
                 for i in range(3))


def ef_dequantize(q: Params, scales: Params) -> Params:
    return tree.tree_map(lambda qq, ss: qq.to(torch.float32) * ss, q, scales)


def compress_decompress(grads: Params, err: Params
                        ) -> Tuple[Params, Params]:
    """Quantize + dequantize with error feedback: what the gradients look
    like after a compressed exchange, and the new error state."""
    q, s, new_err = ef_quantize(grads, err)
    return ef_dequantize(q, s), new_err


# ---------------------------------------------------------------------------
# Compressed all-reduce over a process group
# ---------------------------------------------------------------------------


def compressed_psum(grads: Params, err: Params, group
                    ) -> Tuple[Params, Params]:
    """All-reduce int8 payloads over ``group`` (a process group).

    Summing int8 and rescaling is consistent only when every rank uses
    one scale, so each leaf's scale is the ``MAX`` all-reduce of the
    ranks' own first (a scalar), and every rank quantizes against it; the
    int8 values are summed exactly as int32 (no overflow for groups under
    2^24 / 127 ranks).  Returns (mean gradient, new error state)."""
    import torch.distributed as dist
    n = dist.get_world_size(group)

    def reduce_exact(g, e):
        gf = g.to(torch.float32) + e
        amax = torch.max(torch.abs(gf)).reshape(1)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        smax = amax[0] / INT8_MAX + 1e-12
        qq = torch.clamp(torch.round(gf / smax), -INT8_MAX, INT8_MAX)
        new_e = gf - qq * smax
        total = qq.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total.to(torch.float32) * smax / n, new_e

    out = [reduce_exact(g, e) for g, e in zip(tree.leaves(grads),
                                              tree.leaves(err))]
    return (tree.unflatten_like(grads, [o[0] for o in out]),
            tree.unflatten_like(grads, [o[1] for o in out]))

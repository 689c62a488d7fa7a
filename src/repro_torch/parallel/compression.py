"""int8 error-feedback gradient compression, the one-device part.

The port of ``repro/parallel/compression.py``'s quantizer: gradients are
quantized to int8 with a per-leaf float32 scale, and the quantization
error is carried to the next step (error feedback), so the scheme stays
unbiased over time.  ``torch.round`` rounds half to even, as
``jnp.round`` does, so the int8 values and the new error equal the
reference's bit for bit on the same inputs.  ``compressed_psum`` (the
int8 all-reduce over a mesh axis) waits for the multi-device slice.
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

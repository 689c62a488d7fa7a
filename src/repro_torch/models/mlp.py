"""Gated feed-forward (SwiGLU / GeGLU); the port of ``repro/models/mlp.py``.

On a mesh whose rules cut d_ff over the model axis (``tp.cuts(d_ff)``)
``w_in``/``w_gate`` are this rank's column blocks and ``w_out`` its row
block, Megatron's way: ``x`` enters through ``collectives.tp_copy`` (its
gradient summed over the model group) and the rank's share of the output
is summed over the group by ``collectives.tp_sum``.  Where d_ff does not
divide, the leaves are whole and nothing is summed."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import activation, dense_init
from repro_torch.parallel import collectives


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype
             ) -> Dict[str, Any]:
    return {
        "w_in": dense_init(gen, (d_model, d_ff), dtype),
        "w_gate": dense_init(gen, (d_model, d_ff), dtype),
        "w_out": dense_init(gen, (d_ff, d_model), dtype),
    }


def mlp_apply(params, x, cfg: ModelConfig, constrain_ffn=None, tp=None):
    act = activation(cfg.act_fn)
    split = tp is not None and tp.cuts(cfg.d_ff)
    if split:
        x = collectives.tp_copy(x, tp.group)
    h = x @ params["w_in"]
    g = x @ params["w_gate"]
    h = h * act(g)
    if constrain_ffn is not None:
        h = constrain_ffn(h)
    y = h @ params["w_out"]
    if split:
        y = collectives.tp_sum(y, tp.group)
    return y

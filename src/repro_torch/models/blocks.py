"""Decoder blocks + the period decomposition of the layer stack.

The port of ``repro/models/blocks.py``.  Every configuration's layer
pattern is periodic in the layer index (gemma3: 5 local + 1 global, period
6; jamba: attention at index 4 of each period-8 block with MoE on odd
layers; all others: period 1).  Parameters for position ``p`` of each
period are stacked over the periods (``"scan"/"p<p>"``, leading dimension
``n_full``), the rest unrolled (``"tail"/"t<j>"``): the reference's layout,
so that its weights carry over key for key.  A layer's behaviour is fixed
by its *signature* ``(kind, is_moe, is_global)``: an attention or a Mamba-2
mixer, then (outside the ssm family) a dense MLP or a mixture of experts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (attention_layer, attn_init,
                                          cache_shape)
from repro_torch.models.common import Params, rmsnorm, rmsnorm_init
from repro_torch.models.mamba import (mamba_cache_shapes, mamba_init,
                                      mamba_layer)
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.models.moe import moe_apply, moe_init


# ---------------------------------------------------------------------------
# Period decomposition
# ---------------------------------------------------------------------------


def layer_signature(cfg: ModelConfig, i: int) -> Tuple[str, bool, bool]:
    return (cfg.layer_kind(i), cfg.layer_is_moe(i),
            cfg.layer_is_global_attn(i))


def find_period(cfg: ModelConfig) -> int:
    """Smallest p such that signature(i) == signature(i % p) for all i."""
    n = cfg.n_layers
    for p in range(1, n + 1):
        if all(layer_signature(cfg, i) == layer_signature(cfg, i % p)
               for i in range(n)):
            return p
    return n


@dataclass(frozen=True)
class PeriodPlan:
    period: int
    n_full: int        # number of stacked periods
    n_tail: int        # unrolled remainder layers

    @property
    def n_layers(self) -> int:
        return self.period * self.n_full + self.n_tail

    def tail_layer_idx(self, j: int) -> int:
        return self.period * self.n_full + j


def make_plan(cfg: ModelConfig) -> PeriodPlan:
    p = find_period(cfg)
    return PeriodPlan(period=p, n_full=cfg.n_layers // p,
                      n_tail=cfg.n_layers % p)


# ---------------------------------------------------------------------------
# Single-layer init / apply
# ---------------------------------------------------------------------------


def layer_has_ffn(cfg: ModelConfig, i: int) -> bool:
    """SSM-family blocks have no separate FFN; everything else does."""
    return cfg.family != "ssm"


def layer_init(gen: torch.Generator, cfg: ModelConfig, layer_idx: int,
               dtype) -> Params:
    kind, is_moe, _ = layer_signature(cfg, layer_idx)
    dev = gen.device
    p: Params = {"ln1": rmsnorm_init(cfg.d_model, dtype, dev)}
    if kind == "attn":
        p["attn"] = attn_init(gen, cfg, dtype)
    else:
        p["ssm"] = mamba_init(gen, cfg, dtype)
    if layer_has_ffn(cfg, layer_idx):
        p["ln2"] = rmsnorm_init(cfg.d_model, dtype, dev)
        if is_moe:
            p["moe"] = moe_init(gen, cfg, dtype)
        else:
            p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def layer_apply(
    params: Params,
    x: torch.Tensor,
    *,
    cfg: ModelConfig,
    layer_idx: int,
    mode: str,
    cache: Optional[Params] = None,
    write_pos: Optional[int] = None,
    q_chunk: int = 256,
    constrain: Optional[Callable[[torch.Tensor, str], torch.Tensor]] = None,
    max_len: int = 0,
    delta_cache: bool = False,
    tp=None,
) -> Tuple[torch.Tensor, Optional[Params], Dict[str, torch.Tensor]]:
    """One decoder block.  Returns (x, new_cache, aux_losses).  ``tp``
    (this rank's share on a mesh) reaches the attention layer (its
    heads), the MLP (its columns), the Mamba layer (its SSM heads) and
    the MoE layer (its experts) in every mode, train too."""
    kind, is_moe, _ = layer_signature(cfg, layer_idx)
    cst = constrain or (lambda v, _name: v)
    aux: Dict[str, torch.Tensor] = {}

    h = rmsnorm(x, params["ln1"], cfg.norm_eps)
    if kind == "attn":
        y, new_cache = attention_layer(
            params["attn"], h, cfg=cfg, layer_idx=layer_idx, mode=mode,
            cache=cache, write_pos=write_pos, q_chunk=q_chunk,
            max_len=max_len, delta_cache=delta_cache, tp=tp)
    else:
        y, new_cache = mamba_layer(params["ssm"], h, cfg=cfg, mode=mode,
                                   cache=cache, tp=tp)
    x = cst(x + y, "hidden")

    if layer_has_ffn(cfg, layer_idx):
        h = rmsnorm(x, params["ln2"], cfg.norm_eps)
        if is_moe:
            y, aux = moe_apply(
                params["moe"], h, cfg,
                constrain_dispatch=lambda v: cst(v, "dispatch"),
                dropless=mode != "train", tp=tp)
        else:
            y = mlp_apply(params["mlp"], h, cfg,
                          constrain_ffn=lambda v: cst(v, "ffn"), tp=tp)
        x = cst(x + y, "hidden")
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Cache construction for one layer
# ---------------------------------------------------------------------------


def layer_cache_struct(cfg: ModelConfig, layer_idx: int, batch: int,
                       max_len: int, kv_dtype=torch.bfloat16) -> Params:
    """This layer's decode cache as tensors on the ``meta`` device: shapes
    and dtypes, no memory.  An attention layer's k and v are ``kv_dtype``;
    a Mamba layer's state is float32 and its conv history ``kv_dtype``."""
    kind, _, _ = layer_signature(cfg, layer_idx)
    if kind == "attn":
        shp = cache_shape(cfg, layer_idx, batch, max_len)
        return {"k": torch.empty(shp, dtype=kv_dtype, device="meta"),
                "v": torch.empty(shp, dtype=kv_dtype, device="meta")}
    shapes = mamba_cache_shapes(cfg, batch)
    return {"ssm": torch.empty(shapes["ssm"], dtype=torch.float32,
                               device="meta"),
            "conv": torch.empty(shapes["conv"], dtype=kv_dtype,
                                device="meta")}

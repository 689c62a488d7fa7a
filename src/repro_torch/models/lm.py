"""Model assembly: embeddings + period-stacked decoder stack + LM head.

The port of ``repro/models/lm.py``.

Entry points
------------
``init_params(cfg, gen)``            parameter dict (period-stacked), made
                                     on ``gen``'s device from ``gen``.
``forward(params, tokens, ...)``     -> (hidden, caches, aux) for
                                     mode in {"train", "prefill", "decode"}.
``unembed_logits(params, h, cfg)``   LM-head projection, float32 logits.
``init_cache / cache_struct``        decode caches matching the layout.
``param_struct(cfg)``                the parameters as ``meta`` tensors.
``param_specs / cache_specs``        partition-spec trees from ShardingRules.

On a mesh (``tp``, :class:`repro_torch.parallel.collectives.
TensorParallel`, None off a mesh) the parameters are this rank's blocks
by :func:`param_specs`: a cut ``embed`` is looked up vocabulary-parallel
(the rank's rows, zeros for the others', summed over the model group by
the differentiable ``collectives.tp_sum``, so that in training each
rank's block gets the gradient of its rows), a cut unembedding gives the
rank's vocabulary block of the logits, gathered whole on every rank
(serving; training keeps them cut, ``train.step.vocab_parallel_ce``),
and the layers split their arithmetic (:mod:`repro_torch.models.
attention`, ``mlp``, in train mode too; ``moe`` and ``mamba`` in prefill
and decode).  The caches are this rank's blocks by :func:`cache_specs`,
but a Mamba layer's conv cache, whose channels are the rank's
head-aligned ones (``mamba.head_columns``) where its heads are cut and
whole where they are not (:func:`rank_cache_struct`).

Parameter layout (see blocks.py for the period decomposition)::

    {"embed": (Vp, D), "unembed": (Vp, D)?, "final_norm": (D,),
     "scan": {"p0": <stacked over n_full>, ..., "p<period-1>": ...},
     "tail": {"t0": <single layer>, ...}}

The reference's ``lax.scan`` over the periods is a Python loop over the
stacked leading dimension.  A decode step writes into the caches it is
given (the reference donates them) and returns the same dicts: an
attention layer's new token's slot, a Mamba layer's whole new state
(``ssm`` and ``conv``), each into the tensor that held the old one, in
device or pinned host memory.  ``aux`` carries the MoE losses summed over
layers and the drop fraction averaged over the MoE layers, as the
reference's; it is empty for a configuration without experts.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.attention import cache_slot
from repro_torch.models.blocks import make_plan
from repro_torch.models.common import (Params, dtype_of, embed_init, rmsnorm,
                                       rmsnorm_init)
from repro_torch.parallel import collectives

_MOE_AUX_KEYS = ("moe_aux_loss", "moe_z_loss", "moe_drop_frac")
# cache leaves a decode step rewrites whole (a Mamba layer's state)
_STATE_LEAVES = ("ssm", "conv")


# ---------------------------------------------------------------------------
# Pytree helpers over nested dicts of tensors
# ---------------------------------------------------------------------------


def _stack(trees: List[Params]) -> Params:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _index(tree: Params, r: int) -> Params:
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def leaves(tree) -> Iterator[torch.Tensor]:
    for _, t in named_leaves(tree):
        yield t


def named_leaves(tree, name: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(the leaf's own key, the leaf) for every tensor of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, k)
    elif tree is not None:
        yield name, tree


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    dtype = dtype_of(cfg.param_dtype)
    plan = make_plan(cfg)
    shape = (cfg.padded_vocab, cfg.d_model)
    params: Params = {
        "embed": embed_init(gen, shape, dtype, n_rows=cfg.vocab_size),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, shape, dtype,
                                       n_rows=cfg.vocab_size)

    scan_groups: Params = {}
    for p in range(plan.period if plan.n_full else 0):
        scan_groups[f"p{p}"] = _stack(
            [blocks.layer_init(gen, cfg, r * plan.period + p, dtype)
             for r in range(plan.n_full)])
    if scan_groups:
        params["scan"] = scan_groups

    tail: Params = {}
    for j in range(plan.n_tail):
        tail[f"t{j}"] = blocks.layer_init(gen, cfg, plan.tail_layer_idx(j),
                                          dtype)
    if tail:
        params["tail"] = tail
    return params


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def cache_struct(cfg: ModelConfig, batch: int, max_len: int,
                 kv_dtype=torch.bfloat16, rules=None) -> Params:
    """The decode caches as ``meta`` tensors: shapes and dtypes, no
    memory.  With ``rules`` whose mesh is bound, this rank's blocks of
    them (:func:`rank_cache_struct`)."""
    if rules is None or not rules.mesh.bound:
        return _cache_struct(cfg, batch, max_len, kv_dtype)
    return rank_cache_struct(cfg, batch, max_len, kv_dtype, rules)


def rank_cache_struct(cfg: ModelConfig, batch: int, max_len: int,
                      kv_dtype, rules) -> Params:
    """A rank's blocks of the decode caches on ``rules.mesh`` (bound or
    a descriptor; every rank's blocks have the same shapes) as ``meta``
    tensors: each leaf by :func:`cache_specs`, but a conv cache's channels
    are the head-aligned ones of a rank where the SSM heads are cut
    (``mamba.head_columns``), and all of them where they are not."""
    from repro_torch.models import mamba
    whole = _cache_struct(cfg, batch, max_len, kv_dtype)
    tp = rules.mesh.axis_sizes.get(rules.tp, 1)
    channels = None
    if cfg.ssm is not None and mamba.heads_split(cfg, tp):
        cols = mamba.head_columns(cfg, tp, 0)
        channels = sum(b - a for a, b in cols["conv"])

    def block(path, t, sp):
        shape = collectives.block_shape(tuple(t.shape), sp, rules.mesh)
        if path.split("/")[-1] == "conv":
            shape = shape[:-1] + (channels or t.shape[-1],)
        return t.new_empty(shape)

    specs = tree_mod.leaves(cache_specs(rules, whole))
    return tree_mod.unflatten_like(
        whole, [block(path, t, sp) for (path, t), sp in
                zip(tree_mod.flatten_with_path(whole), specs)])


def _cache_struct(cfg: ModelConfig, batch: int, max_len: int,
                  kv_dtype) -> Params:
    plan = make_plan(cfg)
    out: Params = {}
    if plan.n_full:
        grp = {}
        for p in range(plan.period):
            one = blocks.layer_cache_struct(cfg, p, batch, max_len, kv_dtype)
            grp[f"p{p}"] = {k: s.new_empty((plan.n_full,) + s.shape)
                            for k, s in one.items()}
        out["scan"] = grp
    if plan.n_tail:
        out["tail"] = {
            f"t{j}": blocks.layer_cache_struct(
                cfg, plan.tail_layer_idx(j), batch, max_len, kv_dtype)
            for j in range(plan.n_tail)}
    return out


def _materialise(tree, device) -> Params:
    if isinstance(tree, dict):
        return {k: _materialise(v, device) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=tree.dtype, device=device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               kv_dtype=torch.bfloat16, device="cuda", rules=None) -> Params:
    return _materialise(cache_struct(cfg, batch, max_len, kv_dtype, rules),
                        device)


def host_traffic_bytes(caches: Params, device: torch.device
                       ) -> Tuple[int, int]:
    """(read, written) bytes one decode step moves between host memory and
    ``device`` for these caches: every cache held off the device is read
    whole; an attention cache gets one token's slot written back, a Mamba
    layer's ``ssm`` and ``conv`` their whole new state."""
    read = written = 0
    for name, t in named_leaves(caches):
        if t.device != device:
            n = t.numel() * t.element_size()
            read += n
            written += n if name in _STATE_LEAVES else \
                n // t.shape[-3]                 # (..., Sbuf, KV, hd)
    return read, written


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _zero_aux(cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    if cfg.moe is None:
        return {}
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in _MOE_AUX_KEYS}


def _acc_aux(acc: Dict[str, torch.Tensor], aux: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    for k, v in aux.items():
        acc[k] = acc[k] + v.float()
    return acc


def _write_state(old: Params, new: Params) -> Params:
    """A Mamba layer's new ``ssm`` and ``conv`` into the tensors that held
    the old ones (device or pinned host memory), in stream order."""
    for name, t in new.items():
        old[name].copy_(t, non_blocking=True)
    return old


def _apply_kv_deltas(cfg: ModelConfig, old_scan: Params, emitted: Params,
                     write_pos: int, tp=None) -> Params:
    """Decode's cache writes for the stacked layers, each into old_scan[p]
    (device or pinned host memory) in place: emitted[p] holds either
    {"k_new","v_new"} stacks (n_full, B, 1, KV, hd), each landing in its
    slot, or a Mamba position's full new state stacks {"ssm","conv"},
    written whole.  A cache cut by positions (``tp.seq_cut``) takes the
    write on the rank whose block holds the slot alone."""
    seq = tp is not None and tp.seq_cut
    for p_key, grp in emitted.items():
        old = old_scan[p_key]
        if "k_new" not in grp:
            _write_state(old, grp)
            continue
        blk = old["k"].shape[2]
        p = int(p_key[1:])
        window = 0 if cfg.layer_is_global_attn(p) else cfg.sliding_window
        slot, _ = cache_slot(window, blk * tp.seq_size if seq else blk,
                             write_pos)
        if seq:
            owner, slot = divmod(slot, blk)
            if owner != tp.seq_index:
                continue
        for name in ("k", "v"):
            new = grp[f"{name}_new"][:, :, 0]
            old[name][:, :, slot].copy_(new.to(old[name].dtype))
    return old_scan


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                 frontend: Optional[Dict[str, torch.Tensor]] = None,
                 tp=None):
    w = params["embed"]
    if w.shape[0] < cfg.padded_vocab:
        # vocabulary-parallel: this rank's rows, zeros for the others'
        lo = tp.index * w.shape[0]
        local = tokens - lo
        inside = (local >= 0) & (local < w.shape[0])
        x = torch.where(inside[..., None],
                        w[local.clamp(0, w.shape[0] - 1)], 0)
        x = collectives.tp_sum(x, tp.group)
    else:
        x = w[tokens]
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    if frontend:
        if cfg.frontend == "audio" and "frame_embeds" in frontend:
            x = x + frontend["frame_embeds"].to(x.dtype)
        elif cfg.frontend == "vlm" and "prefix_embeds" in frontend:
            pe = frontend["prefix_embeds"].to(x.dtype)
            x = x.clone()
            x[:, :pe.shape[1]] = pe
    return x


def unembed_logits(params: Params, h: torch.Tensor, cfg: ModelConfig,
                   tp=None):
    """float32 logits, as the reference's ``preferred_element_type``; a
    rank holding a vocabulary block computes its block and gathers the
    whole over the model group."""
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = torch.einsum("bsd,vd->bsv", h.float(), w.float())
    if w.shape[0] < cfg.padded_vocab:
        logits = collectives.tp_all_gather(logits, -1, tp.group)
    return logits



def forward(
    params: Params,
    tokens: torch.Tensor,
    *,
    cfg: ModelConfig,
    mode: str = "train",                  # train | prefill | decode
    caches: Optional[Params] = None,
    write_pos: Optional[int] = None,      # absolute position (decode)
    frontend: Optional[Dict[str, torch.Tensor]] = None,
    constrain: Optional[Callable[[torch.Tensor, str], torch.Tensor]] = None,
    remat: str = "none",                  # none | layer
    q_chunk: int = 256,
    max_len: int = 0,                     # cache capacity (prefill)
    tp=None,                              # this rank's share on a mesh
) -> Tuple[torch.Tensor, Optional[Params], Dict[str, Any]]:
    """tokens: (B, S) int -> (hidden (B,S,D), caches', aux).

    ``tp`` (a :class:`repro_torch.parallel.collectives.TensorParallel`)
    splits the arithmetic over a mesh (see the module's notes); None
    computes everything here, from whole parameters.

    ``remat="layer"`` in train mode runs each period of the stacked layers
    through ``torch.utils.checkpoint`` (non-reentrant), as the reference
    wraps its scan body in ``jax.checkpoint``: the period's activations are
    recomputed in the backward pass instead of kept.  The tail layers are
    not wrapped, as in the reference.  With ``tp`` the recompute runs the
    period's forward collectives again (up to its last saved tensor,
    where ``checkpoint`` stops), in the same order on every rank of the
    model group, since every rank runs the same backward."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode: {mode!r}")
    if remat not in ("none", "layer"):
        raise ValueError(f"remat must be none or layer: {remat!r}")
    plan = make_plan(cfg)
    cst = constrain or (lambda v, _n: v)
    x = cst(embed_tokens(params, tokens, cfg, frontend, tp), "hidden")
    # decode: stacked attention layers emit one-token (k, v) deltas, written
    # into the stacked caches at once after the loop
    delta = mode == "decode"
    old = (caches or {}).get("scan") if delta else None
    layer_kw = dict(cfg=cfg, mode=mode, write_pos=write_pos, q_chunk=q_chunk,
                    constrain=cst, max_len=max_len, tp=tp)

    aux = _zero_aux(cfg, x.device)

    def one_period(x, r: int):
        """Layers p0..p<period-1> of period r -> (x, aux, new caches)."""
        a = _zero_aux(cfg, x.device)
        ncs = []
        for p in range(plan.period):
            key = f"p{p}"
            c = _index(old[key], r) if old is not None else None
            x, nc, la = blocks.layer_apply(
                _index(params["scan"][key], r), x, layer_idx=p, cache=c,
                delta_cache=delta, **layer_kw)
            a = _acc_aux(a, la)
            ncs.append((key, nc))
        return x, a, ncs

    emitted: Dict[str, List[Params]] = {}
    aux_keys = list(aux)
    for r in range(plan.n_full):
        if remat == "layer" and mode == "train":
            def body(x_, r=r):
                y, a, _ = one_period(x_, r)
                return (y, *(a[k] for k in aux_keys))
            x, *vals = checkpoint(body, x, use_reentrant=False)
            aux = _acc_aux(aux, dict(zip(aux_keys, vals)))
            continue
        x, la, ncs = one_period(x, r)
        aux = _acc_aux(aux, la)
        for key, nc in ncs:
            if nc is not None:
                emitted.setdefault(key, []).append(nc)

    tail_caches: Params = {}
    for j in range(plan.n_tail):
        key = f"t{j}"
        c = caches["tail"][key] if delta else None
        x, nc, la = blocks.layer_apply(
            params["tail"][key], x, layer_idx=plan.tail_layer_idx(j),
            cache=c, **layer_kw)
        aux = _acc_aux(aux, la)
        if nc is not None:
            # an attention layer wrote its slot into c already
            tail_caches[key] = _write_state(c, nc) if delta and \
                "ssm" in nc else nc

    x = cst(rmsnorm(x, params["final_norm"], cfg.norm_eps), "hidden")
    if aux:
        # drop_frac is a mean over the MoE layers; the losses stay sums of
        # the per-layer values, each already scaled by its weight
        n_moe = sum(1 for i in range(cfg.n_layers) if cfg.layer_is_moe(i))
        if n_moe:
            aux["moe_drop_frac"] = aux["moe_drop_frac"] / n_moe

    if mode == "train":
        return x, None, aux
    new_caches: Params = {}
    if emitted:
        scan = {k: _stack(v) for k, v in emitted.items()}
        new_caches["scan"] = (_apply_kv_deltas(cfg, old, scan, write_pos,
                                               tp) if delta else scan)
    if tail_caches:
        new_caches["tail"] = tail_caches
    return x, new_caches, aux


class _MetaGenerator(torch.Generator):
    """A generator whose tensors are made on the ``meta`` device."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def param_struct(cfg: ModelConfig) -> Params:
    """The parameters' shapes and dtypes as ``meta`` tensors, at any size
    (the reference's ``jax.eval_shape`` of ``init_params``)."""
    return init_params(cfg, _MetaGenerator())


# ---------------------------------------------------------------------------
# Partition specs for params and caches
# ---------------------------------------------------------------------------


def _spec_tree(tree, spec_for):
    return tree_mod.unflatten_like(
        tree, [spec_for(path, leaf)
               for path, leaf in tree_mod.flatten_with_path(tree)])


def param_spec(rules, path: str, shape) -> Any:
    """The spec of the parameter leaf at ``path``; a scan-stacked leaf
    gets a leading None axis."""
    from repro_torch.parallel.sharding import P
    if path.startswith("scan/"):
        return P(None, *tuple(rules.param_spec(path, tuple(shape[1:]))))
    return rules.param_spec(path, tuple(shape))


def param_specs(rules, params: Params):
    """Spec tree; scan-stacked leaves get a leading None axis."""
    return _spec_tree(params,
                      lambda path, leaf: param_spec(rules, path, leaf.shape))


def cache_specs(rules, struct: Params):
    """Spec tree for a cache tree (tensors or ``meta`` tensors)."""
    from repro_torch.parallel.sharding import P

    def spec_for(path, leaf):
        stacked = path.startswith("scan/")
        shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
        leaf_name = path.split("/")[-1]
        if leaf_name in ("k", "v"):
            base = rules.kv_cache_spec()           # (B, S, KV, hd)
        elif leaf_name == "ssm":
            base = rules.ssm_state_spec()          # (B, H, P, N)
        elif leaf_name == "conv":
            base = P(rules.batch if rules.batch else None, None,
                     _maybe_axis(rules, shape[-1]))
        else:
            base = P(*([None] * len(shape)))
        return P(None, *tuple(base)) if stacked else base

    return _spec_tree(struct, spec_for)


def _maybe_axis(rules, dim: int):
    from repro_torch.parallel.sharding import _maybe
    return _maybe(rules.tp, dim, rules.mesh)

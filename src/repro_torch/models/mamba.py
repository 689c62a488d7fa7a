"""Mamba-2 (SSD, state-space duality) layers.

The port of ``repro/models/mamba.py``.  Train and prefill use the chunked
SSD algorithm (arXiv:2405.21060 §6): within-chunk "attention-like"
products plus a recurrence over the chunk states, which the reference
runs as a ``lax.scan`` and this port as a Python loop over the chunks.
Decode is the O(1) recurrent update.  Internals are float32 (float64
where the inputs are float64).

State layout: (B, H, P, N) with H = ssm heads, P = head_dim, N = d_state.
Conv cache: (B, K-1, conv_channels).  A decode step over a cache in pinned
host memory reads ``ssm`` and ``conv`` into device memory in stream order
(``attention._on``); ``lm`` writes the new state back into the same
tensors.

At jamba's width (h = 128, T = 256) one within-chunk tensor of a batch of
4 x 2048 tokens is (4, 8, 256, 256, 128) float32, 1.07 GB: each is
dropped as soon as the next is made.

SSM-head parallelism (``tp``, where ``tp.cuts(n_heads)``: the reference's
``ssm_state_spec``) gives each rank of the model group its block of
``nh/tp`` heads.  Its ``w_zxbcdt`` columns and conv channels are
head-aligned (:func:`head_columns`): its heads' ``z``, ``x`` and ``dt``
columns and the B/C columns of the groups its heads read, whole on every
rank where there is one group; ``A_log``, ``dt_bias``, ``ssm_D``,
``ssm_norm`` and ``w_ssm_out`` are the spec's own blocks.  The input
enters through ``collectives.tp_copy``; the conv and the SSD run on the
rank's heads (state ``(B, nh/tp, P, N)``); :func:`mamba_mix` gives the
rank's gated block ``y·silu(z)`` and its float32 sum of squares, summed
over the group (the first all-reduce, ``(B, S, 1)``) because the gated
RMSNorm spans the whole ``d_inner``; :func:`mamba_out` normalises the
block by the total and multiplies it by the rank's rows of ``w_ssm_out``,
and the partials are summed (the second all-reduce, ``(B, S, D)``).
The total of the sums of squares feeds every rank's own block, so a
rank's gradient of it is only its share: in training it is summed over
the group too (``tp_copy`` after ``tp_sum``: an all-reduce each way).
Where the heads do not divide, every leaf is whole and nothing is
summed.

Training keeps the reference's contiguous spec blocks of ``w_zxbcdt``,
``conv_w`` and ``conv_b`` in its state; its step hands the layer those
leaves whole (``train.step``), and the layer takes the rank's
head-aligned columns itself (:func:`rank_columns`), so that autograd
gives their gradient in the whole leaf's shape.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import _on
from repro_torch.models.common import Params, dense_init
from repro_torch.parallel import collectives


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the layer's internal precision: float32, or float64 where
    it is float64 already."""
    return t if t.dtype == torch.float64 else t.float()


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    return s, d, di, nh, s.n_groups, s.d_state, s.d_conv, s.head_dim


def heads_split(cfg: ModelConfig, size: int) -> bool:
    """Does a model axis of ``size`` ranks cut the SSM heads (the rules'
    ``ssm_state_spec``)?"""
    return size > 1 and cfg.ssm.n_heads(cfg.d_model) % size == 0


def _merge(ranges):
    out = []
    for a, b in ranges:
        if out and out[-1][1] == a:
            out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return tuple(out)


def head_columns(cfg: ModelConfig, size: int, index: int):
    """Rank ``index`` of a model group of ``size``: its head-aligned
    column ranges ``[(start, stop), ...]`` of ``w_zxbcdt`` (``"proj"``)
    and of the conv channels (``conv_w``, ``conv_b``, the conv cache:
    ``"conv"``), in the layer's order (z, x, B, C, dt; x, B, C), and its
    first head, heads, first group and groups.  A rank's heads read the
    groups ``h // (nh/ng)`` (the reference's ``repeat``); a block of heads
    that reads its groups unevenly raises."""
    s, d, di, nh, ng, ds, k, hp = _dims(cfg)
    if nh % size:
        raise ValueError(f"head_columns: {nh} SSM heads over {size} ranks")
    nhl = nh // size
    h0 = index * nhl
    per_group = nh // ng
    g0, g1 = h0 // per_group, (h0 + nhl - 1) // per_group + 1
    if g1 - g0 > 1 and (nhl % per_group or h0 % per_group):
        raise ValueError(f"head_columns: heads {h0}..{h0 + nhl - 1} read "
                         f"groups of {per_group} heads unevenly")
    z = (h0 * hp, (h0 + nhl) * hp)
    bc = ((g0 * ds, g1 * ds), (ng * ds + g0 * ds, ng * ds + g1 * ds))
    proj = [z, (di + z[0], di + z[1])]
    proj += [(2 * di + a, 2 * di + b) for a, b in bc]
    proj.append((2 * di + 2 * ng * ds + h0, 2 * di + 2 * ng * ds + h0 + nhl))
    conv = [z] + [(di + a, di + b) for a, b in bc]
    return {"proj": _merge(proj), "conv": _merge(conv), "head0": h0,
            "heads": nhl, "group0": g0, "groups": g1 - g0}


def take_columns(t: torch.Tensor, ranges) -> torch.Tensor:
    """The columns (last dimension) of ``t`` in ``ranges``, concatenated
    (works on ``meta`` tensors)."""
    return torch.cat([t[..., a:b] for a, b in ranges], dim=-1)


def rank_columns(params, cfg: ModelConfig, tp):
    """``params`` with ``w_zxbcdt``, ``conv_w`` and ``conv_b`` cut to this
    rank's head-aligned columns where ``tp`` cuts the heads and they are
    whole (a train step hands them whole; serving, already cut)."""
    if tp is None or not heads_split(cfg, tp.size):
        return params
    s, d, di, nh, ng, ds, k, hp = _dims(cfg)
    if params["w_zxbcdt"].shape[-1] != 2 * di + 2 * ng * ds + nh:
        return params
    cols = head_columns(cfg, tp.size, tp.index)
    out = dict(params)
    for name, key in (("w_zxbcdt", "proj"), ("conv_w", "conv"),
                      ("conv_b", "conv")):
        out[name] = take_columns(params[name], cols[key])
    return out


def _local_dims(cfg: ModelConfig, tp):
    """:func:`_dims` for this rank's share: d_inner, heads and groups of
    its block where the heads are cut."""
    s, d, di, nh, ng, ds, k, hp = _dims(cfg)
    if tp is None or not heads_split(cfg, tp.size):
        return s, d, di, nh, ng, ds, k, hp
    cols = head_columns(cfg, tp.size, tp.index)
    return s, d, di // tp.size, cols["heads"], cols["groups"], ds, k, hp


def mamba_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    s, d, di, nh, ng, ds, k, hp = _dims(cfg)
    conv_ch = di + 2 * ng * ds
    proj_out = 2 * di + 2 * ng * ds + nh
    dev = gen.device
    w_zxbcdt = dense_init(gen, (d, proj_out), dtype)
    conv_w = dense_init(gen, (k, conv_ch), dtype, fan_in=k)
    lo, hi = math.log(0.001), math.log(0.1)
    dt = torch.exp(torch.rand((nh,), generator=gen, device=dev) * (hi - lo)
                   + lo)
    return {
        "w_zxbcdt": w_zxbcdt,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=dev)),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "ssm_D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "ssm_norm": torch.zeros((di,), dtype=dtype, device=dev),
        "w_ssm_out": dense_init(gen, (di, d), dtype, fan_in=di),
    }


def _split_proj(zxbcdt, dims):
    s, d, di, nh, ng, ds, k, hp = dims
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * ng * ds]
    dt = zxbcdt[..., -nh:]
    return z, xbc, dt


def _causal_conv(xbc, conv_w, conv_b, prev: Optional[torch.Tensor] = None):
    """Depthwise causal conv along S.  xbc: (B,S,CH); conv_w: (K,CH).

    prev: optional (B, K-1, CH) history prepended (decode/chunked prefill).
    Returns (out (B,S,CH), tail (B,K-1,CH))."""
    k = conv_w.shape[0]
    if prev is None:
        prev = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[-1]))
    dtype = torch.promote_types(prev.dtype, xbc.dtype)
    xp = torch.cat([prev.to(dtype), xbc.to(dtype)], dim=1)
    s = xbc.shape[1]
    out = sum(xp[:, i:i + s] * conv_w[i] for i in range(k))
    out = F.silu(out + conv_b)
    tail = xp[:, xp.shape[1] - (k - 1):]
    return out, tail


# ---------------------------------------------------------------------------
# Chunked SSD (train / prefill)
# ---------------------------------------------------------------------------


def ssd_chunked(x, dt, A, B, C, chunk: int, init_state=None):
    """x: (B,S,H,P); dt: (B,S,H); A: (H,) (negative); B,C: (B,S,G,N).

    Returns (y (B,S,H,P), final_state (B,H,P,N)).  f32 internals."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    if s % chunk:
        raise ValueError(f"ssd_chunked: S {s} not a multiple of chunk {chunk}")
    nc = s // chunk
    xc = _wide(x.reshape(b, nc, chunk, h, p))
    dtc = _wide(dt.reshape(b, nc, chunk, h))
    Bc = _wide(B.reshape(b, nc, chunk, g, n))
    Cc = _wide(C.reshape(b, nc, chunk, g, n))

    seg = torch.cumsum(dtc * A, dim=2)               # (b,nc,T,h)
    seg_last = seg[:, :, -1:]                        # (b,nc,1,h)

    # within-chunk (diagonal block): L[i,j] = exp(seg_i - seg_j) for i >= j,
    # weighted by dt_j and the scores C_i . B_j (group-broadcast to heads);
    # each (b,nc,T,T,h) tensor is freed once the next is made.  The
    # exponent is masked before the exp (-inf above the diagonal, where
    # seg_i - seg_j > 0 overflows at a full chunk): masking the exp's
    # output instead, as the reference does, gives the same values but a
    # NaN gradient (inf times the mask's 0)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    M = torch.exp(torch.where(mask[None, None, :, :, None],
                              seg[:, :, :, None, :] - seg[:, :, None, :, :],
                              -math.inf))
    M = M * dtc[:, :, None, :, :]
    Gm = torch.einsum("bctgn,bcsgn->bctsg", Cc, Bc)  # (b,nc,T,T,g)
    M = (M.reshape(b, nc, chunk, chunk, g, hg) * Gm[..., None]
         ).reshape(b, nc, chunk, chunk, h)
    del Gm
    y = torch.einsum("bctsh,bcshp->bcthp", M, xc)
    del M

    # chunk-local end states: sum_j exp(seg_last - seg_j) dt_j B_j x_j
    decay = torch.exp(seg_last - seg)                # (b,nc,T,h)
    dtx = (dtc * decay)[..., None] * xc              # (b,nc,T,h,p)
    Bh = torch.repeat_interleave(Bc, hg, dim=3)      # (b,nc,T,h,n)
    s_local = torch.einsum("bcthn,bcthp->bchpn", Bh, dtx)   # (b,nc,h,p,n)
    del dtx, Bh

    # inter-chunk recurrence over nc (the reference's lax.scan): the state
    # entering each chunk, and the final one
    chunk_decay = torch.exp(seg_last[:, :, 0])       # (b,nc,h)
    state = (torch.zeros((b, h, p, n), dtype=xc.dtype, device=x.device)
             if init_state is None else _wide(init_state))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + s_local[:, c]
    prev_states = torch.stack(prev, dim=1)           # (b,nc,h,p,n)

    # off-diagonal: y_off[i] = exp(seg_i) * C_i . S_prev
    Ch = torch.repeat_interleave(Cc, hg, dim=3)      # (b,nc,T,h,n)
    y_off = torch.einsum("bcthn,bchpn->bcthp", Ch, prev_states)
    y = y + y_off * torch.exp(seg)[..., None]
    return y.reshape(b, s, h, p), state


def ssd_step(state, x, dt, A, B, C):
    """One recurrent step.  state: (B,H,P,N); x: (B,H,P); dt: (B,H);
    B,C: (B,G,N).  Returns (y (B,H,P), new_state)."""
    b, h, p, n = state.shape
    g = B.shape[1]
    hg = h // g
    Bh = torch.repeat_interleave(B, hg, dim=1)       # (b,h,n)
    Ch = torch.repeat_interleave(C, hg, dim=1)
    da = torch.exp(dt * A)                           # (b,h)
    upd = (dt[..., None] * x)[..., None] * Bh[:, :, None, :]   # (b,h,p,n)
    new = state * da[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new, Ch)
    return y, new


# ---------------------------------------------------------------------------
# Layer entry point
# ---------------------------------------------------------------------------


def mamba_mix(params, x, *, cfg: ModelConfig, mode: str,
              cache: Optional[Params] = None, tp=None):
    """x: (B,S,D) -> (the gated block ``y·silu(z)`` (B,S,d_inner) in
    x's dtype, its float32 sum of squares (B,S,1), new_cache or None):
    the layer up to its norm, on this rank's heads where ``tp`` cuts them
    (then ``params`` are the rank's blocks, the block is ``d_inner/tp``
    wide and the sum covers it alone)."""
    dims = _local_dims(cfg, tp)
    s_cfg, d, di, nh, ng, ds, k, hp = dims
    b, s, _ = x.shape
    zxbcdt = torch.einsum("bsd,de->bse", x, params["w_zxbcdt"])
    z, xbc, dt = _split_proj(zxbcdt, dims)
    dt = F.softplus(_wide(dt) + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        conv_out, conv_tail = _causal_conv(
            xbc, params["conv_w"], params["conv_b"],
            prev=_on(cache["conv"], x.device))
        xs = _wide(conv_out[..., :di].reshape(b, nh, hp))
        Bm = conv_out[..., di:di + ng * ds].reshape(b, ng, ds)
        Cm = conv_out[..., di + ng * ds:].reshape(b, ng, ds)
        y, new_state = ssd_step(
            _wide(_on(cache["ssm"], x.device)), xs, dt[:, 0], A,
            _wide(Bm), _wide(Cm))
        y = y + params["ssm_D"][:, None] * xs
        y = y.reshape(b, 1, di)
        new_cache = {"ssm": new_state, "conv": conv_tail}
    else:
        prev_conv = init_state = None
        if cache is not None:
            prev_conv = _on(cache["conv"], x.device)
            init_state = _on(cache["ssm"], x.device)
        conv_out, conv_tail = _causal_conv(
            xbc, params["conv_w"], params["conv_b"], prev=prev_conv)
        xs = conv_out[..., :di].reshape(b, s, nh, hp)
        Bm = conv_out[..., di:di + ng * ds].reshape(b, s, ng, ds)
        Cm = conv_out[..., di + ng * ds:].reshape(b, s, ng, ds)
        chunk = min(s_cfg.chunk, s)
        pad = (-s) % chunk
        if pad:
            # zero-pad to a chunk multiple; dt=0 on padding makes the padded
            # steps identity transitions (no decay, no contribution)
            xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
            Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
            Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
        y, final = ssd_chunked(xs, dt, A, Bm, Cm, chunk,
                               init_state=init_state)
        if pad:
            y = y[:, :s]
            xs = xs[:, :s]
        y = y + params["ssm_D"][None, None, :, None] * _wide(xs)
        y = y.reshape(b, s, di)
        new_cache = None
        if mode == "prefill":
            new_cache = {"ssm": final, "conv": conv_tail}

    y = y.to(x.dtype) * F.silu(z)
    yf = _wide(y)
    return y, (yf * yf).sum(dim=-1, keepdim=True), new_cache


def mamba_norm(params, y, sumsq, cfg: ModelConfig):
    """The gated RMSNorm of this rank's block ``y`` over the whole
    ``d_inner``, given the float32 sum of squares of every rank's block
    (``sumsq``, (B,S,1)), in y's dtype."""
    di = cfg.ssm.d_inner(cfg.d_model)
    yn = _wide(y) * torch.rsqrt(sumsq / di + cfg.norm_eps)
    return (yn * (1.0 + _wide(params["ssm_norm"]))).to(y.dtype)


def mamba_out(params, y, sumsq, cfg: ModelConfig):
    """:func:`mamba_norm`, then the block's product with its rows of
    ``w_ssm_out``: (B,S,D), the rank's partial of the layer's output (the
    output itself on one rank)."""
    return torch.einsum("bse,ed->bsd", mamba_norm(params, y, sumsq, cfg),
                        params["w_ssm_out"])


def mamba_layer(params, x, *, cfg: ModelConfig, mode: str,
                cache: Optional[Params] = None, tp=None):
    """x: (B,S,D) -> (y (B,S,D), new_cache or None).

    A decode step returns the new state as new tensors; the caller writes
    them into the cache (``lm``).  ``tp``: this rank's share on a mesh
    (the module's notes): two sums over ``tp.group`` where the heads are
    cut (and two more in the backward pass), none otherwise; the three
    head-aligned leaves may come whole (:func:`rank_columns`)."""
    split = tp is not None and heads_split(cfg, tp.size)
    if split:
        x = collectives.tp_copy(x, tp.group)
        params = rank_columns(params, cfg, tp)
    y, sumsq, new_cache = mamba_mix(params, x, cfg=cfg, mode=mode,
                                    cache=cache, tp=tp)
    if split:
        # summed forward, and its gradient summed backward: the total
        # feeds every rank's block
        sumsq = collectives.tp_copy(collectives.tp_sum(sumsq, tp.group),
                                    tp.group)
    out = mamba_out(params, y, sumsq, cfg)
    if split:
        out = collectives.tp_sum(out, tp.group)
    return out, new_cache


def mamba_cache_shapes(cfg: ModelConfig, batch: int):
    s, d, di, nh, ng, ds, k, hp = _dims(cfg)
    return {"ssm": (batch, nh, hp, ds),
            "conv": (batch, k - 1, di + 2 * ng * ds)}

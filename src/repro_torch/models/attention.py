"""GQA attention: prefill and train through the flash kernel, decode in torch.

The port of ``repro/models/attention.py``.  The reference computes every
path in jnp; here the full-sequence paths (``mode="prefill"`` and
``"train"``) call the hand-written flash kernel,
:func:`repro_torch.kernels.ops.flash_attention`, which computes the same
function: causal for a global layer, causal with the band ``k > q - window``
for a local one (the reference's ``rel > -window``), head ``h`` reading KV
head ``h·KVH // H`` (``_split_heads``).  The kernel takes (B, H, S, D)
and the model's layout is (B, S, H, hd), so q, k, v and the output each
take one transposed copy (:func:`prefill_attention`).  The kernel admits
positions from 0 for q and k alike and has no logit softcap: decode, which
attends one query at an offset, stays on the plain torch functions below,
as it is jnp in the reference, and a softcap is refused.  In train mode,
with grad enabled, the wrapper goes through its autograd Function, whose
backward is the hand-written backward kernel
(``csrc/flash_attention_bwd.cu``); prefill runs under ``no_grad`` in the
engine and launches the forward alone.

The plain functions (:func:`causal_attention`, :func:`window_attention`,
:func:`causal_window_fallback`, and the decode pair over :func:`_gqa_attend`)
keep the reference's algorithms, each held against its counterpart by the
parity tests.

KV caches for sliding-window layers are ring buffers of size ``window``.
A decode step over a cache in pinned host memory reads each layer's cache
into device memory over PCIe and attends there; ``lm`` writes the new
token's slot back into host memory.

On a mesh (``tp``, a :class:`repro_torch.parallel.collectives.
TensorParallel`) a rank holds its blocks of the weights and the cache,
cut as the rules cut them (``repro/parallel/sharding.py``), and computes
its share, Megatron's way:

* **"head" mode** (the KV heads divide the model axis): ``wq``/``wk``/
  ``wv`` are column blocks of ``H/tp`` q heads and ``KV/tp`` KV heads,
  the rank attends its heads alone (the flash kernel in prefill), its
  cache holds its KV heads, and ``wo`` is a row block whose partial
  output is summed over the model group.
* **"seq" mode with ``q_heads_tp``** (the q heads divide, the KV heads do
  not): ``wq``/``wo`` as above, ``wk``/``wv`` whole.  Prefill runs the
  rank's q heads against the KV heads they read (:func:`kv_heads_of`);
  the cache keeps the rank's block of positions.
* **"seq" mode without it**: the projections and ``wo`` whole; only the
  cache's positions are cut.

Where a rank computes a share of the heads (:func:`heads_split`), the
block from :func:`project_qkv` to ``wo`` is one region, Megatron's: the
hidden enters it through ``collectives.tp_copy`` (identity forward, its
gradient summed over the model group backward) and the sum after ``wo``
is ``collectives.tp_sum`` (the gradient passes to each rank's share), so
the layer trains on its blocks.  The leaves that are whole on every rank
but read for the rank's share only (:func:`partial_leaves`: the bias and
qk-norm leaves, and in "seq" mode ``wk``/``wv``, whose KV heads
:func:`kv_heads_of` selects) get this rank's share of their gradient;
the train step sums them over the model group once after the backward
(``repro_torch.train.step``).  Where no heads are cut the layer computes
everything whole and takes no *f*.  Train mode runs each rank's head
block through ``flash_attention.FlashAttentionFn``: kernel #12 forward
with the log-sum-exp, #12b backward.

A decode step in "seq" mode (:func:`seq_decode_attention`) gathers q's
heads over the model group where they are cut, attends every head over
the rank's block of positions, and combines the blocks' partial softmax
over the sequence group (:func:`repro_torch.parallel.collectives.
lse_combine`); the new token's (k, v) counts once, on the rank whose
block holds its slot (:func:`cache_slot`), which alone writes it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import (apply_rope, dense_init, rmsnorm,
                                       rmsnorm_init, rope_sincos, softcap)
from repro_torch.parallel import collectives

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype
              ) -> Dict[str, Any]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = gen.device
    p = {
        "wq": dense_init(gen, (d, h, hd), dtype, fan_in=d),
        "wk": dense_init(gen, (d, kv, hd), dtype, fan_in=d),
        "wv": dense_init(gen, (d, kv, hd), dtype, fan_in=d),
        "wo": dense_init(gen, (h, hd, d), dtype, fan_in=h * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv, hd), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, dev)
        p["k_norm"] = rmsnorm_init(hd, dtype, dev)
    return p


# ---------------------------------------------------------------------------
# Core scoring helper (GQA): one q-chunk against a KV extent.
# ---------------------------------------------------------------------------


def _gqa_attend(q, k, v, mask, scale: float, cap: float):
    """q: (B, Sq, KV, G, hd); k/v: (B, Sk, KV, hd); mask: (B?, Sq, Sk) bool.

    Returns (B, Sq, KV, G, hd).  Scores accumulate in f32."""
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    s = softcap(s, cap)
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None]
        s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def _split_heads(q, n_kv: int):
    b, s, h, hd = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, hd)


def _merge_heads(o):
    b, s, kv, g, hd = o.shape
    return o.reshape(b, s, kv * g, hd)


# ---------------------------------------------------------------------------
# Full-context causal attention, q-chunked (plain torch).
# ---------------------------------------------------------------------------


def causal_attention(q, k, v, *, q_positions, k_positions, scale, cap=0.0,
                     q_chunk: int = 256, k_valid=None):
    """q: (B,Sq,H,hd) | k,v: (B,Sk,KV,hd).  Positions are absolute.

    k_valid: optional (B, Sk) bool — entries beyond the written cache."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = _split_heads(q, kvh)

    def attend(qc, qp):
        mask = k_positions[None, None, :] <= qp[None, :, None]
        mask = mask.expand(b, qp.shape[0], k.shape[1])
        if k_valid is not None:
            mask = mask & k_valid[:, None, :]
        return _gqa_attend(qc, k, v, mask, scale, cap)

    if sq <= q_chunk:
        return _merge_heads(attend(qg, q_positions))
    if sq % q_chunk:
        raise ValueError(f"causal_attention: Sq {sq} not a multiple of "
                         f"q_chunk {q_chunk}")
    outs = [attend(qg[:, i:i + q_chunk], q_positions[i:i + q_chunk])
            for i in range(0, sq, q_chunk)]
    return _merge_heads(torch.cat(outs, dim=1))


# ---------------------------------------------------------------------------
# Sliding-window attention via overlapping blocks (exact O(S*W), plain).
# ---------------------------------------------------------------------------


def window_attention(q, k, v, *, window: int, scale, cap=0.0,
                     q_chunk: int = 256):
    """Self-attention where q index i attends k indices (i-window, i].

    q: (B,S,H,hd); k,v: (B,S,KV,hd) aligned with q."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    dev = q.device
    if s <= window + q_chunk:
        pos = torch.arange(s, device=dev)
        return causal_window_fallback(q, k, v, pos, window, scale, cap,
                                      q_chunk)
    block = q_chunk
    if s % block:
        raise ValueError(f"window_attention: S {s} not a multiple of "
                         f"q_chunk {block}")
    nb = s // block
    ext = window + block

    # (nb, ext) absolute k row index per block, clipped at the left edge
    starts = torch.arange(nb, device=dev) * block - window
    idx = starts[:, None] + torch.arange(ext, device=dev)[None, :]
    valid_edge = idx >= 0
    idx = idx.clamp(min=0)

    qb = _split_heads(q, kvh).reshape(b, nb, block, kvh, h // kvh, hd)
    kb = k[:, idx]                          # (B, nb, ext, KV, hd)
    vb = v[:, idx]

    # band mask: qpos = n*block + qi ; kpos = n*block - window + ei
    qi = torch.arange(block, device=dev)
    ei = torch.arange(ext, device=dev)
    rel = ei[None, :] - window - qi[:, None]      # kpos - qpos
    band = (rel <= 0) & (rel > -window)           # (block, ext)
    mask = band[None, :, :] & valid_edge[:, None, :]   # (nb, block, ext)

    sc = torch.einsum("bnqkgh,bnekh->bnkgqe", qb.float(), kb.float()) * scale
    sc = softcap(sc, cap)
    sc = torch.where(mask[None, :, None, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bnkgqe,bnekh->bnqkgh", p.to(vb.dtype).float(),
                     vb.float()).to(v.dtype)
    return o.reshape(b, s, h, hd)


def causal_window_fallback(q, k, v, positions, window, scale, cap, q_chunk):
    """Small-S path: full mask with window band."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qg = _split_heads(q, kvh)
    mask = (positions[None, :] <= positions[:, None]) & \
           (positions[None, :] > positions[:, None] - window)
    mask = mask[None].expand(b, s, s)
    return _merge_heads(_gqa_attend(qg, k, v, mask, scale, cap))


# ---------------------------------------------------------------------------
# Prefill / train: the hand-written flash kernel
# ---------------------------------------------------------------------------


def prefill_attention(q, k, v, *, window: int, scale: float, cap: float = 0.0,
                      q_chunk: int = 256):
    """Causal attention of a whole sequence, positions from 0, through
    ``ops.flash_attention``: q (B,S,H,hd), k, v (B,S,KV,hd) -> (B,S,H,hd).

    A local layer (``window > 0``) admits keys ``(i - window, i]``.  The
    kernel takes (B, H, S, D): q, k and v are each copied once into that
    layout and the output once back.  On a CPU tensor the wrapper runs its
    plain version, tiled by ``q_chunk``; on the card the kernel picks its
    own tiles.  The kernel has no logit softcap, so ``cap`` must be 0."""
    if cap:
        raise ValueError(f"prefill_attention: attn_logit_softcap={cap}; the "
                         "flash kernel has no logit softcap")
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    out = ops.flash_attention(qt, kt, vt, causal=True, window=window,
                              sm_scale=scale, block_q=q_chunk,
                              block_k=q_chunk)
    return out.transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# Decode: one query position against the cache (plain torch).
# ---------------------------------------------------------------------------


def decode_attention(q1, cache_k, cache_v, *, write_pos: int, scale, cap=0.0,
                     ring: bool = False, window: int = 0):
    """q1: (B,1,H,hd); cache_k/v: (B,Sbuf,KV,hd); write_pos: the absolute
    position just written (valid entries: <= write_pos).

    ring=True: the buffer is a ring of size `window` holding the last
    `window` positions — everything in it is valid once
    write_pos >= window-1."""
    b, sbuf = cache_k.shape[0], cache_k.shape[1]
    idx = torch.arange(sbuf, device=cache_k.device)
    if ring:
        valid = (idx <= write_pos) | (write_pos >= sbuf)
    else:
        valid = idx <= write_pos
        if window:
            valid = valid & (idx > write_pos - window)
    kvh = cache_k.shape[2]
    qg = _split_heads(q1, kvh)
    mask = valid[None, None, :].expand(b, 1, sbuf)
    return _merge_heads(_gqa_attend(qg, cache_k, cache_v, mask, scale, cap))


def decode_attention_delta(q1, cache_k, cache_v, k_new, v_new, *,
                           write_pos: int, scale, cap=0.0, ring: bool = False,
                           window: int = 0):
    """Decode without an updated cache: attends the OLD cache (entries
    < write_pos) plus the new token's (k, v) by a two-part softmax.  The
    caller writes (k_new, v_new) into the cache afterwards
    (``lm._apply_kv_deltas``).

    q1, k_new, v_new: (B, 1, H|KV, hd).  Returns (B, 1, H, hd)."""
    b, sbuf, kvh, hd = cache_k.shape
    idx = torch.arange(sbuf, device=cache_k.device)
    if ring:
        slot = write_pos % sbuf
        # cache holds positions write_pos-sbuf .. write_pos-1; the slot
        # about to be overwritten (oldest) leaves the window
        valid = ((idx < write_pos) | (write_pos >= sbuf)) & (idx != slot)
    else:
        valid = idx < write_pos
        if window:
            valid = valid & (idx > write_pos - window)
    qg = _split_heads(q1, kvh).float()               # (B,1,KV,G,hd)

    s_old = torch.einsum("bqkgh,bskh->bkgqs", qg, cache_k.float()) * scale
    s_new = torch.einsum("bqkgh,bskh->bkgqs", qg, k_new.float()) * scale
    s_old = softcap(s_old, cap)
    s_new = softcap(s_new, cap)
    s_old = torch.where(valid[None, None, None, None, :], s_old, NEG_INF)

    m = torch.maximum(s_old.amax(dim=-1, keepdim=True), s_new)
    p_old = torch.exp(s_old - m)
    p_new = torch.exp(s_new - m)
    denom = p_old.sum(dim=-1, keepdim=True) + p_new
    dt = cache_v.dtype
    o = torch.einsum("bkgqs,bskh->bqkgh", (p_old / denom).to(dt).float(),
                     cache_v.float())
    o = o + torch.einsum("bkgqs,bskh->bqkgh", (p_new / denom).to(dt).float(),
                         v_new.float())
    return _merge_heads(o.to(dt))


def cache_slot(window: int, sbuf: int, write_pos: int) -> Tuple[int, bool]:
    """(the slot a decode step at ``write_pos`` writes, whether the
    cache of ``sbuf`` positions is a ring): a local layer's ring of
    ``window`` slots takes ``write_pos % window``, any other cache
    ``write_pos`` (its last slot once full)."""
    ring = bool(window) and sbuf == window
    return (write_pos % sbuf if ring else min(write_pos, sbuf - 1)), ring


def seq_decode_attention(q1, cache_k, cache_v, k_new, v_new, *,
                         write_pos: int, sbuf: int, scale, cap=0.0,
                         window: int = 0, tp):
    """:func:`decode_attention_delta` over a cache cut by positions: this
    rank holds positions ``[i·L, (i+1)·L)`` of ``sbuf`` (``L`` =
    ``cache_k.shape[1]``, ``i`` = ``tp.seq_index``), attends every q head
    of ``q1`` over them with its own maximum and sum, and the blocks are
    combined over ``tp.seq_group`` (:func:`collectives.lse_combine`).
    The new token's (k, v) counts on the rank whose block holds its slot
    and nowhere else.  Returns (B, 1, H, hd)."""
    b, blk, kvh, hd = cache_k.shape
    slot, ring = cache_slot(window, sbuf, write_pos)
    idx = tp.seq_index * blk + torch.arange(blk, device=cache_k.device)
    if ring:
        valid = ((idx < write_pos) | (write_pos >= sbuf)) & (idx != slot)
    else:
        valid = idx < write_pos
        if window:
            valid = valid & (idx > write_pos - window)
    qg = _split_heads(q1, kvh).float()               # (B,1,KV,G,hd)
    s_old = softcap(torch.einsum("bqkgh,bskh->bkgqs", qg, cache_k.float())
                    * scale, cap)
    s_old = torch.where(valid, s_old, NEG_INF)
    m = s_old.amax(dim=-1, keepdim=True)             # (B,KV,G,1,1)
    holds_new = slot // blk == tp.seq_index
    if holds_new:
        s_new = softcap(torch.einsum("bqkgh,bskh->bkgqs", qg, k_new.float())
                        * scale, cap)
        m = torch.maximum(m, s_new)
    p_old = torch.where(valid, torch.exp(s_old - m), 0.0)
    l = p_old.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskh->bkgqh", p_old, cache_v.float())
    if holds_new:
        p_new = torch.exp(s_new - m)
        l = l + p_new
        o = o + torch.einsum("bkgqs,bskh->bkgqh", p_new, v_new.float())
    out = collectives.lse_combine(m, l, o, tp.seq_group)   # (B,KV,G,1,hd)
    return _merge_heads(out.permute(0, 3, 1, 2, 4).to(cache_v.dtype))


# ---------------------------------------------------------------------------
# Layer entry point
# ---------------------------------------------------------------------------


def layer_rope_theta(cfg: ModelConfig, layer_idx: int) -> float:
    is_global = cfg.layer_is_global_attn(layer_idx)
    return cfg.rope_theta if (is_global or not cfg.rope_theta_local) \
        else cfg.rope_theta_local


def layer_window(cfg: ModelConfig, layer_idx: int) -> int:
    return 0 if cfg.layer_is_global_attn(layer_idx) else cfg.sliding_window


def q_head_start(params, cfg: ModelConfig, tp) -> int:
    """The first q head of this rank's ``wq`` block (0 where it is
    whole)."""
    hl = params["wq"].shape[1]
    return 0 if hl == cfg.n_heads else tp.index * hl


def kv_heads_of(h0: int, n: int, n_heads: int, n_kv: int):
    """The KV heads the kernel must see for q heads ``h0 .. h0+n-1``: the
    kernel maps local head ``j`` to KV head ``j·KVl // n`` of the
    ``KVl`` it is given, global head ``h`` reads ``h·KV // H``.  Where
    the block's heads fall on its KV heads evenly those KV heads, in
    order; else one KV head a q head, repeated as the map asks."""
    want = [(h0 + j) * n_kv // n_heads for j in range(n)]
    distinct = sorted(set(want))
    g, r = divmod(n, len(distinct))
    if not r and all(want[j] == distinct[j // g] for j in range(n)):
        return distinct
    return want


def heads_split(cfg: ModelConfig, tp) -> bool:
    """Does this rank compute a share of the heads: "head" mode, or "seq"
    with ``q_heads_tp``, on a model group of more than one rank (the
    rules then cut ``wq`` and ``wo`` by heads)?"""
    return (tp is not None and tp.cuts(cfg.n_heads)
            and (tp.attn_mode == "head" or tp.q_heads_tp))


def partial_leaves(cfg: ModelConfig, tp) -> Tuple[str, ...]:
    """The attention leaves, whole on every rank, of which a rank reads
    its share of heads only where :func:`heads_split`: its gradient of
    them is its share, summed over the model group by the train step.
    Empty where no heads are cut."""
    if not heads_split(cfg, tp):
        return ()
    names = ("bq", "bk", "bv") if cfg.qkv_bias else ()
    if cfg.qk_norm:
        names += ("q_norm", "k_norm")
    if tp.attn_mode == "seq":
        names += ("wk", "wv")
    return names


def project_qkv(params, x, *, cfg: ModelConfig, layer_idx: int, positions,
                tp=None):
    """x: (B, S, D) -> q (B,S,H,hd), k, v (B,S,KV,hd) at ``positions``:
    projections, biases, qk-norm and rope.  On a mesh ``wq``/``wk``/``wv``
    may be this rank's column blocks (H/tp, KV/tp heads); the biases,
    whole on every rank, are cut to the same heads."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qkv_bias:
        h0, hl = q_head_start(params, cfg, tp), q.shape[2]
        kl = k.shape[2]
        k0 = 0 if kl == cfg.n_kv_heads else tp.index * kl
        q = q + params["bq"][h0:h0 + hl]
        k = k + params["bk"][k0:k0 + kl]
        v = v + params["bv"][k0:k0 + kl]
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    theta = layer_rope_theta(cfg, layer_idx)
    if theta:
        cos, sin = rope_sincos(positions, cfg.head_dim, theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` in ``device``'s memory: a cache held in pinned host memory is
    read over PCIe (asynchronously, in stream order)."""
    return t if t.device == device else t.to(device, non_blocking=True)


def _seq_block(t: torch.Tensor, tp) -> torch.Tensor:
    """This rank's block of positions (dim 1) of a whole cache tensor."""
    n = t.shape[1]
    if n % tp.seq_size:
        raise ValueError(f"a cache of {n} positions does not divide over "
                         f"{tp.kv_seq_axes} ({tp.seq_size} ranks)")
    blk = n // tp.seq_size
    return t[:, tp.seq_index * blk:(tp.seq_index + 1) * blk].clone()


def attention_layer(params, x, *, cfg: ModelConfig, layer_idx: int,
                    mode: str, cache: Optional[Dict[str, Any]] = None,
                    write_pos: Optional[int] = None, q_chunk: int = 256,
                    max_len: int = 0, delta_cache: bool = False, tp=None):
    """x: (B, S, D) -> (out (B,S,D), new_cache or None).

    mode: "train" | "prefill" | "decode".
    cache: {"k": (B,Sbuf,KV,hd), "v": ...} for decode, in device memory or
    pinned host memory.  A decode step without ``delta_cache`` writes the
    new token's slot into the given cache (the reference donates it).
    ``tp``: this rank's share on a mesh (see the module's notes); None
    computes everything here."""
    b, s, d = x.shape
    window = layer_window(cfg, layer_idx)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    cap = cfg.attn_logit_softcap
    seq_cut = tp is not None and tp.seq_cut
    h0 = q_head_start(params, cfg, tp)
    split = heads_split(cfg, tp)
    if split:
        # the region's entry (Megatron's f): every rank's share of the
        # gradient of x summed backward
        x = collectives.tp_copy(x, tp.group)

    if mode in ("train", "prefill"):
        positions = torch.arange(s, device=x.device)
        q, k, v = project_qkv(params, x, cfg=cfg, layer_idx=layer_idx,
                              positions=positions, tp=tp)
        kq, vq = k, v
        if q.shape[2] < cfg.n_heads and k.shape[2] == cfg.n_kv_heads:
            # this rank's q heads against the KV heads they read
            idx = kv_heads_of(h0, q.shape[2], cfg.n_heads, cfg.n_kv_heads)
            if idx != list(range(cfg.n_kv_heads)):
                kq, vq = k[:, :, idx], v[:, :, idx]
        out = prefill_attention(q, kq, vq, window=window, scale=scale,
                                cap=cap, q_chunk=q_chunk)
        new_cache = None
        if mode == "prefill":
            sbuf = max(max_len, s)
            if window:
                sbuf = min(window, sbuf)
            if window and window < s:
                # keep the last `window` positions as the ring buffer,
                # slot = pos % window
                roll = (-(s % window)) % window
                new_cache = {"k": torch.roll(k[:, s - window:], roll, 1),
                             "v": torch.roll(v[:, s - window:], roll, 1)}
            elif sbuf == s:
                new_cache = {"k": k, "v": v}
            else:
                # the first s positions of a max_len-sized buffer, so
                # decode appends without clobbering prefill entries
                new_cache = {}
                for name, t in (("k", k), ("v", v)):
                    buf = t.new_zeros((b, sbuf) + t.shape[2:])
                    buf[:, :s] = t
                    new_cache[name] = buf
            if seq_cut:
                new_cache = {n: _seq_block(t, tp)
                             for n, t in new_cache.items()}
    else:  # decode
        if cache is None or write_pos is None:
            raise ValueError("decode needs a cache and write_pos")
        write_pos = int(write_pos)
        # made on the device: a host tensor copied over would synchronise
        # the stream in every layer
        positions = torch.arange(write_pos, write_pos + 1, device=x.device)
        q, k, v = project_qkv(params, x, cfg=cfg, layer_idx=layer_idx,
                              positions=positions, tp=tp)
        blk = cache["k"].shape[1]
        sbuf = blk * tp.seq_size if seq_cut else blk
        slot, ring = cache_slot(window, sbuf, write_pos)
        ck, cv = _on(cache["k"], x.device), _on(cache["v"], x.device)
        if seq_cut:
            hl = q.shape[2]
            if hl < cfg.n_heads:
                q = collectives.tp_all_gather(q, 2, tp.group)
            out = seq_decode_attention(
                q, ck, cv, k, v, write_pos=write_pos, sbuf=sbuf, scale=scale,
                cap=cap, window=window, tp=tp)
            out = out[:, :, h0:h0 + hl]
            if delta_cache:
                new_cache = {"k_new": k, "v_new": v}
            else:
                if slot // blk == tp.seq_index:
                    for c, t in ((cache["k"], k), (cache["v"], v)):
                        c[:, slot % blk].copy_(t[:, 0].to(c.dtype))
                new_cache = {"k": cache["k"], "v": cache["v"]}
        elif delta_cache:
            out = decode_attention_delta(
                q, ck, cv, k, v, write_pos=write_pos, scale=scale, cap=cap,
                ring=ring, window=0 if ring else window)
            new_cache = {"k_new": k, "v_new": v}
        else:
            for c_dev, c, t in ((ck, cache["k"], k), (cv, cache["v"], v)):
                c_dev[:, slot] = t[:, 0].to(c.dtype)
                if c_dev is not c:
                    c[:, slot].copy_(c_dev[:, slot])
            out = decode_attention(q, ck, cv, write_pos=write_pos,
                                   scale=scale, cap=cap, ring=ring,
                                   window=0 if ring else window)
            new_cache = {"k": cache["k"], "v": cache["v"]}

    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    if split:
        # row-parallel: this rank's heads' share, summed over the group
        y = collectives.tp_sum(y, tp.group)
    return y, new_cache


def cache_shape(cfg: ModelConfig, layer_idx: int, batch: int,
                max_len: int) -> Tuple[int, int, int, int]:
    """(B, Sbuf, KV, hd) for this layer's cache."""
    window = layer_window(cfg, layer_idx)
    sbuf = max_len if not window else min(window, max_len)
    return (batch, sbuf, cfg.n_kv_heads, cfg.head_dim)

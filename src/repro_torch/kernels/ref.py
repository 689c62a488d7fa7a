"""Plain PyTorch versions of every kernel (what the CPU runs, and what
the CUDA kernels are held against on the card).

The reads, the on-chip read and the chases take a leading member axis
too, as their kernels do: a (g, rows, 128) stack gives one result per
member, what ``jax.vmap`` of the reference kernel gives.  Copy and rmw are
elementwise and take any leading axes as they are."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

# --- stream ----------------------------------------------------------------


def read_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dim=(-2, -1), dtype=torch.float32)


def write_ref(shape_rows: int, value: float = 1.0,
              device="cpu") -> torch.Tensor:
    return torch.full((shape_rows, 128), value, dtype=torch.float32,
                      device=device)


def write_seeded_ref(shape_rows: int, value: float,
                     seed: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to float32, then a float32 add of the (1, 1)
    ``seed``: what the reference's seeded body computes, on ``seed``'s
    device."""
    return write_ref(shape_rows, value, seed.device) + seed.reshape(())


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
    """The block rule applied to each member of ``x``'s leading axes; the
    write half as :func:`write_seeded_ref` computes it (``value`` and
    ``seed`` each rounded to float32, then added in float32)."""
    blk, n_r, n_w = mixed_split(x.shape[-2], read_fraction, block_rows)
    written = torch.full((*x.shape[:-2], n_w * blk, 128), value,
                         dtype=torch.float32, device=x.device)
    return (read_ref(x[..., :n_r * blk, :]),
            written + torch.tensor(seed, dtype=torch.float32,
                                   device=x.device))


def triad_ref(b: torch.Tensor, c: torch.Tensor,
              scalar: float = 3.0) -> torch.Tensor:
    """STREAM triad, two roundings: ``scalar * c``, then ``b +`` it."""
    return b + scalar * c


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


# --- flash attention ---------------------------------------------------------

NEG_INF = -1e30


def _attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                    window: int) -> torch.Tensor:
    """Which (query, key) pairs are admitted; both positions count from 0."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,Sq,D); k,v: (B,KVH,Sk,D) -> (B,H,Sq,D).  The dense oracle:
    the whole (Sq, Sk) score matrix, so small shapes only.  A row with no
    admissible key gets the mean of v (a softmax over equal scores)."""
    h, sq, d = q.shape[1], q.shape[2], q.shape[3]
    g = h // k.shape[1]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = _attention_mask(torch.arange(sq, device=q.device),
                           torch.arange(k.shape[2], device=q.device),
                           causal, window)
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        sm_scale: Optional[float] = None, block_q: int = 128,
                        block_k: int = 128) -> torch.Tensor:
    """The JAX package's online-softmax algorithm (``_flash_body``) in
    PyTorch: a loop over KV blocks, each applied to every query block whose
    skip predicates admit it, all those rows at once.  Memory is O(S·block)
    for the scores and O(S·D) for the accumulator, so it runs at 32k
    tokens.  Every rule of the Pallas body holds: masked scores are
    ``NEG_INF`` and their ``p`` is 0, accumulation is float32 for any
    input dtype, head ``h`` reads KV head ``h·KVH // H``, causal and window
    positions both count from 0 (also when Sq != Sk), and a row with no
    admissible key returns 0 (the reference divides by 1 where ``l == 0``).
    A padded KV tail contributes nothing there, so only the real keys of
    the last block are taken here."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    scale = sm_scale if sm_scale is not None else d ** -0.5
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    n_k = -(-sk // block_k)
    qf = q.float().reshape(b, kvh, g, sq, d)
    m = torch.full((b, kvh, g, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, g, sq, d), dtype=torch.float32,
                      device=q.device)
    q_pos = torch.arange(sq, device=q.device)
    for ik in range(n_k):
        k0, k1 = ik * block_k, min((ik + 1) * block_k, sk)
        # the query blocks iq whose predicates run this KV block:
        # causal  ik*bk <= iq*bq + bq - 1
        # window  ik*bk + bk - 1 > iq*bq - window
        iq_lo = max(0, -(-(k0 - block_q + 1) // block_q)) if causal else 0
        iq_hi = (-(-(k0 + block_k - 1 + window) // block_q) if window
                 else -(-sq // block_q))
        r0, r1 = iq_lo * block_q, min(iq_hi * block_q, sq)
        if r0 >= r1:
            continue
        kf = k[:, :, None, k0:k1].float()               # (b, kvh, 1, bk, d)
        vf = v[:, :, None, k0:k1].float()
        s = qf[..., r0:r1, :] @ kf.transpose(-1, -2) * scale
        mask = _attention_mask(q_pos[r0:r1],
                               torch.arange(k0, k1, device=q.device),
                               causal, window)
        s = torch.where(mask, s, NEG_INF)
        m_prev = m[..., r0:r1, :]
        m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m_prev - m_new)
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        l[..., r0:r1, :] = l[..., r0:r1, :] * alpha + p.sum(-1, keepdim=True)
        m[..., r0:r1, :] = m_new
        acc[..., r0:r1, :] = acc[..., r0:r1, :] * alpha + p @ vf
    safe = torch.where(l == 0.0, 1.0, l)
    return (acc / safe).reshape(b, h, sq, d).to(q.dtype)


# --- kernel-support probe ----------------------------------------------------


def probe_add_one_ref(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


# --- contention ladder -------------------------------------------------------


def role_ref(role, xf_e: torch.Tensor, xi_e: torch.Tensor) -> torch.Tensor:
    """One engine's role of one step, as a 0-d float32: the arithmetic of
    the JAX package's ``_pallas_branch_fn`` over its kernels' plain
    versions, pass by pass.  ``xf_e``/``xi_e`` are the engine's operands;
    nothing is written to them (the plain version is functional)."""
    from repro_torch.kernels import contention as C

    code, rows, n, read_rows, write_rows = (int(v) for v in role[:5])
    acc = torch.zeros((), dtype=torch.float32, device=xf_e.device)
    if code == C.READ:
        for _ in range(n):
            acc = acc * 0.5 + read_ref(xf_e[:rows])
        return acc
    if code == C.SEEDED_WRITE:
        for _ in range(n):
            seed = xf_e[0, 0] + acc * 1e-30
            out = write_ref(rows, 1.0, xf_e.device) + seed
            acc = acc * 0.5 + out[0, 0]
        return acc
    if code in (C.RMW, C.COPY):
        x = xf_e[:rows]
        for _ in range(n):
            x = rmw_ref(x) if code == C.RMW else copy_ref(x)
        return x[0, 0]
    if code == C.MIXED:
        for _ in range(n):
            s = read_ref(xf_e[:read_rows])
            out = torch.full((write_rows, 128), 1.0, dtype=torch.float32,
                             device=xf_e.device) + xf_e[0, 0]
            acc = acc * 0.5 + s + out[:1].sum()
        return acc
    if code in (C.CHASE_GLOBAL, C.CHASE_SHARED):
        for _ in range(n):
            acc = acc + float(chase_ref(xi_e[:rows], rows))
        return acc
    acc = xf_e[0, 0] * 1e-30            # idle: the memory-idle spin
    for _ in range(n * 8):
        acc = acc * 0.999 + 1.0
    return acc


def _stamp(t: int) -> List[int]:
    return [t // 1_000_000_000, t % 1_000_000_000]


def contention_ladder_ref(xf, xi, table, roles, group_of, leaders, *,
                          skew_ns: int = 0, skip_start_wait: bool = False):
    """The ladder's steps run engine by engine, group by group.  Stamps
    come from the host's ``perf_counter_ns``, taken in an order that
    keeps the fence: every engine of a group arrives before any begins,
    and the leader's stop stamp follows every end.  With
    ``skip_start_wait`` each engine arrives (``e * skew_ns`` late) just
    before it begins, as in the kernel's negative case."""
    import time

    from repro_torch.kernels import contention as C

    n_eng, steps = xf.shape[0], table.shape[0]
    outs = torch.zeros((n_eng, steps), dtype=torch.float32, device=xf.device)
    t0s = torch.zeros((n_eng, steps, 2), dtype=torch.int32)
    t1s = torch.zeros_like(t0s)
    arrive, begin, end = (torch.zeros((n_eng, steps), dtype=torch.int64)
                          for _ in range(3))
    groups: dict = {}
    for e in range(n_eng):
        groups.setdefault(int(group_of[e]), []).append(e)
    now = time.perf_counter_ns
    for s in range(steps):
        for g in sorted(groups):
            members = groups[g]
            lead = next((e for e in members if leaders[e]), None)
            if not skip_start_wait:
                for e in members:
                    arrive[e, s] = now()
            if lead is not None:
                t0s[lead, s] = torch.tensor(_stamp(now()))
            for e in members:
                if skip_start_wait:
                    time.sleep(e * skew_ns / 1e9)
                    arrive[e, s] = now()
                begin[e, s] = now()
                outs[e, s] = role_ref(roles[table[s, e]], xf[e], xi[e])
                end[e, s] = now()
            if lead is not None:
                t1s[lead, s] = torch.tensor(_stamp(now()))
    return C.LadderOut(outs, t0s, t1s, arrive, begin, end)

"""Serving engine: prefill + decode with placed KV caches.

The port of ``repro/serve/engine.py``.  The KV cache is a placeable
object: the engine sizes it from the model config, asks the
:class:`~repro_torch.core.placement.PlacementAdvisor` which pool it
belongs in under the expected contention (device memory normally; pinned
host memory when device capacity binds), and places it through that
pool's upool.  This is the paper's Fig. 14 loop (characterize -> place ->
run) applied to an inference server.

Prefill runs the whole prompt through ``lm.forward``, whose attention is
the hand-written flash kernel on the card.  Decode is a Python loop over
one-token steps (the reference's ``lax.scan``); a cache placed in pinned
host memory stays there between steps, each step reading it into device
memory layer by layer over PCIe and writing back the new token's slot of
an attention layer and the whole new state (``ssm``, ``conv``) of a Mamba
layer, into the same tensors (``lm.host_traffic_bytes`` counts both,
:class:`GenerateResult` records them).  It is never moved to the device behind the advisor's back; a
migration or rollback to ``hbm`` moves it through the ``hbm`` upool.

With a :class:`repro_torch.serve.monitor.ServeMonitor` (or an ``on_step``
hook) every decode step is wall-timed up to a synchronise of the card:
the watchdog detects contention drift, a probe sweep refreshes the
drifted cells, and the migration guard moves the live caches when the
refreshed surface flips the advisor's decision.  Timed or not, the loop
draws the same tokens: greedy by argmax, sampled from one explicit
:class:`torch.Generator` seeded by ``seed``, one draw a token, the
prefill's first.

On a bound mesh (``rules.mesh``) the engine holds this rank's blocks of
the parameters (:func:`rank_params`: ``lm.param_specs``' blocks, but a
Mamba layer's head-aligned columns; cut from the same whole init on every
rank) and of the caches, serves the rows ``rules.batch`` gives it, and
its steps split the arithmetic of every layer over the model group
(:func:`repro_torch.parallel.collectives.tensor_parallel`): attention
heads, MLP columns, experts and SSM heads.  Every rank of
a model group holds the whole logits of its rows and the same generator,
so it draws the same tokens; a draw at temperature > 0 on a batch cut
over ranks samples the whole batch's gathered logits, as one device
would.  The pool is chosen from the whole cache's bytes, and the pool
the first rank chooses (or a monitor's migration it decides) is the one
every rank takes.  :class:`GenerateResult` holds the whole batch's
tokens and last logits on every rank.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import tree as tree_mod
from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.models import lm, mamba
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import P, ShardingRules
from repro_torch.train.step import make_constrain

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Cache sizing / placement
# ---------------------------------------------------------------------------


def cache_bytes(cfg: ModelConfig, batch: int, max_len: int,
                kv_dtype=torch.bfloat16) -> int:
    """Bytes of the decode caches, from shapes and dtypes alone."""
    struct = lm.cache_struct(cfg, batch, max_len, kv_dtype)
    return sum(t.numel() * t.element_size() for t in lm.leaves(struct))


def decode_rw_mix(batch: int, max_len: int) -> float:
    """Read share of the decode step's KV traffic (the ``rw_ratio``
    surface coordinate).  Each generated token reads the whole cache
    prefix — ``max_len`` positions per sequence — and writes exactly
    one new slot, so the mix approaches pure-read as contexts grow."""
    reads = float(max(1, max_len))
    return reads / (reads + 1.0)


def pool_capacities(advisor, *, pool_mgr=None,
                    hbm_free_bytes: Optional[int] = None,
                    ) -> Optional[Dict[str, int]]:
    """Candidate-pool capacities for the KV placement solve.

    Live accounting first: a pool manager knows what is actually free
    (``pool.available``).  Without one the advisor's own platform
    capacities apply, overridden for ``hbm`` by ``hbm_free_bytes``; no
    pool's capacity is invented."""
    caps: Dict[str, int] = {}
    if pool_mgr is not None:
        for p in advisor.pools:
            try:
                caps[p] = pool_mgr.pool(p).available
            except Exception:
                continue            # pool not backed on this platform
    elif hbm_free_bytes is not None:
        caps = {p: advisor.platform.memories[p].size_bytes
                for p in advisor.pools if p in advisor.platform.memories}
    if hbm_free_bytes is not None and ("hbm" in caps or not caps):
        caps["hbm"] = hbm_free_bytes
    return caps or None


def choose_kv_pool(cfg: ModelConfig, batch: int, max_len: int, *,
                   advisor=None, scfg: Optional[ServeConfig] = None,
                   pool_mgr=None,
                   hbm_free_bytes: Optional[int] = None,
                   rw_mix: Optional[float] = None,
                   inject_rate: Optional[float] = None) -> str:
    scfg = scfg or ServeConfig()
    if scfg.kv_placement != "auto":
        return scfg.kv_placement
    if advisor is None:
        return "hbm"
    from repro_torch.core.placement import ContentionSpec, kv_cache_object
    nbytes = cache_bytes(cfg, batch, max_len)
    obj = kv_cache_object("kv", nbytes, bytes_read_per_token=float(nbytes))
    caps = pool_capacities(advisor, pool_mgr=pool_mgr,
                           hbm_free_bytes=hbm_free_bytes)
    # advise at the engine's observed decode traffic coordinates
    if rw_mix is None:
        rw_mix = decode_rw_mix(batch, max_len)
    plan = advisor.advise(
        [obj], ContentionSpec(0, rw_ratio=rw_mix, inject_rate=inject_rate),
        capacities=caps)
    return plan.pool_of("kv")


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, rules: ShardingRules, *,
                      max_len: int, q_chunk: int = 256):
    """``prefill(params, tokens)`` -> (caches, last logits (B, V)).  On a
    bound mesh ``params`` are this rank's blocks and ``tokens`` its rows;
    the caches come back as its blocks, the logits whole over V."""
    cst = make_constrain(rules)
    tp = collectives.tensor_parallel(rules)

    def prefill(params: Params, tokens, frontend=None):
        hidden, caches, _ = lm.forward(
            params, tokens, cfg=cfg, mode="prefill", frontend=frontend,
            constrain=cst, max_len=max_len, q_chunk=q_chunk, tp=tp)
        logits = lm.unembed_logits(params, hidden[:, -1:], cfg, tp)
        return caches, logits[:, 0]

    return prefill


def make_decode_step(cfg: ModelConfig, rules: ShardingRules):
    """``decode(params, caches, token, write_pos)`` -> (caches, logits);
    on a mesh as :func:`make_prefill_step`."""
    cst = make_constrain(rules)
    tp = collectives.tensor_parallel(rules)

    def decode(params: Params, caches: Params, token, write_pos: int,
               frontend=None):
        """token: (B, 1) int; write_pos: the absolute position."""
        hidden, caches, _ = lm.forward(
            params, token, cfg=cfg, mode="decode", caches=caches,
            write_pos=write_pos, frontend=frontend, constrain=cst, tp=tp)
        logits = lm.unembed_logits(params, hidden, cfg, tp)
        return caches, logits[:, 0]

    return decode


def param_shardings(cfg: ModelConfig, rules: ShardingRules):
    """Each parameter leaf's placement on ``rules.mesh`` by
    ``lm.param_specs`` (None off a bound mesh)."""
    if not rules.mesh.bound:
        return None
    struct = lm.param_struct(cfg)
    return collectives.shardings_of(rules.mesh,
                                    lm.param_specs(rules, struct), struct)


# the Mamba leaves whose rank block is head-aligned, and their column map
_HEAD_ALIGNED = {"w_zxbcdt": "proj", "conv_w": "conv", "conv_b": "conv"}


def rank_block(cfg: ModelConfig, rules: ShardingRules, path: str,
               leaf: torch.Tensor, coords=None) -> torch.Tensor:
    """The block of the parameter leaf at ``path`` (``lm.param_specs``'s
    paths) that a rank holds on ``rules.mesh``: ``coords`` (its
    coordinates; default this rank's).  A Mamba layer's ``w_zxbcdt``,
    ``conv_w`` and ``conv_b`` are its head-aligned columns
    (``mamba.head_columns``) where the SSM heads are cut, and every Mamba
    leaf is whole where they are not (the layer then runs whole, as
    ``ssm_state_spec`` replicates its state); every other leaf is its
    block by ``lm.param_specs``.  A new tensor where the leaf is cut, the
    leaf itself otherwise; ``meta`` leaves give ``meta`` blocks."""
    mesh = rules.mesh
    coords = mesh.coords if coords is None else coords
    parts = path.split("/")
    if len(parts) > 1 and parts[-2] == "ssm":
        tp = mesh.axis_sizes.get(rules.tp, 1)
        if not mamba.heads_split(cfg, tp):
            return leaf
        if parts[-1] in _HEAD_ALIGNED:
            cols = mamba.head_columns(cfg, tp, coords[rules.tp])
            return mamba.take_columns(leaf, cols[_HEAD_ALIGNED[parts[-1]]])
    sl = collectives.block_slices(tuple(leaf.shape),
                                  lm.param_spec(rules, path, leaf.shape),
                                  mesh, coords)
    if all(s == slice(None) for s in sl):
        return leaf
    return leaf[sl].clone()


def rank_params(cfg: ModelConfig, rules: ShardingRules, params: Params,
                coords=None) -> Params:
    """Every leaf of the whole ``params`` cut to a rank's block
    (:func:`rank_block`)."""
    return tree_mod.unflatten_like(
        params, [rank_block(cfg, rules, path, leaf, coords)
                 for path, leaf in tree_mod.flatten_with_path(params)])


def sample_token(logits: torch.Tensor, gen: Optional[torch.Generator] = None,
                 temperature: float = 0.0) -> torch.Tensor:
    """(B, V) logits -> (B,) token ids: the argmax at temperature 0, else
    one draw from ``gen`` of softmax(logits / temperature)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    if gen is None:
        raise ValueError("sample_token: temperature > 0 needs a generator")
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


@dataclass
class GenerateResult:
    tokens: Any                 # (B, T)
    steps: int
    kv_pool: str                # the pool the caches ENDED in
    # (B, V) float32: the logits the last token was drawn from
    logits: Any = None
    # online-loop provenance (monitored decode only; empty otherwise)
    drift_events: List[Any] = field(default_factory=list)
    migrations: List[Any] = field(default_factory=list)
    probe_sweeps: int = 0
    # bytes the decode steps moved between pinned host memory and the card
    # (a cache placed in host memory: read whole each step, and one slot of
    # an attention cache, a Mamba layer's state whole, written back); 0 for
    # a cache in device memory
    host_read_bytes: int = 0
    host_written_bytes: int = 0


class ServeEngine:
    """Batched prefill+decode over a placed KV cache, on the device that
    holds ``params`` (whole; on a bound mesh the engine keeps this rank's
    blocks of them).

    ``monitor`` (a :class:`repro_torch.serve.monitor.ServeMonitor`) or an
    ``on_step`` hook times every decode step: per-step wall timing feeds
    the contention watchdog, and the engine applies the monitor's
    migrate/rollback actions to the live caches between steps."""

    def __init__(self, cfg: ModelConfig, params: Params,
                 rules: ShardingRules, scfg: Optional[ServeConfig] = None,
                 advisor=None, pool_mgr=None, monitor=None):
        self.cfg = cfg
        if rules.mesh.bound:
            params = rank_params(cfg, rules, params)
        self.params = params
        self.rules = rules
        mesh = rules.mesh
        # the whole mesh (the pool's agreement) and the batch's group
        self._mesh_group = (collectives.axis_group(mesh, mesh.axis_names)
                            if mesh.bound else None)
        self._batch_group = (collectives.axis_group(mesh, rules.batch)
                             if mesh.bound else None)
        self.scfg = scfg or ServeConfig()
        self.advisor = advisor
        self.pool_mgr = pool_mgr
        self.monitor = monitor
        self.device = params["embed"].device
        self._decode = make_decode_step(cfg, rules)
        # observed decode duty cycle (EWMA across generate calls): the
        # inject_rate coordinate the engine feeds back into placement
        self._duty: Optional[float] = None

    # -- placement -----------------------------------------------------------
    def _place_caches(self, caches: Params, pool_name: str) -> Params:
        """Place the caches in ``pool_name`` through its upool.  With a
        pool manager every pool goes through ``upool.place``, including
        "hbm", so a rollback moves host-placed caches back to device
        memory."""
        if self.pool_mgr is None:
            return caches
        try:
            upool = self.pool_mgr.upool(pool_name)
        except Exception:
            return caches           # pool not backed on this platform
        return upool.place(caches)

    def _observe_duty(self, busy_s: float, wall_s: float) -> None:
        if wall_s <= 0.0:
            return
        d = min(1.0, busy_s / wall_s)
        self._duty = d if self._duty is None else 0.2 * d + 0.8 * self._duty

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the mesh ------------------------------------------------------------
    def _agree(self, pool: str) -> str:
        """The first rank's pool on every rank of the mesh."""
        return collectives.broadcast_text(pool, self._mesh_group)

    def _rows(self, b: int) -> slice:
        """This rank's rows of a whole batch of ``b``."""
        if not self.rules.mesh.bound:
            return slice(None)
        return collectives.block_slices((b,), P(self.rules.batch or None),
                                        self.rules.mesh)[0]

    def _whole_rows(self, x: torch.Tensor, b: int) -> torch.Tensor:
        """The whole batch of a per-rank tensor of rows (gathered over the
        batch's group; ``x`` itself where the batch is not cut)."""
        g = self._batch_group
        if g is None or g.size == 1:
            return x
        return collectives.gather(x, P(self.rules.batch, None),
                                  self.rules.mesh, (b,) + tuple(x.shape[1:]))

    def _sample(self, logits, gen, temperature: float, b: int):
        """This rank's rows' tokens: argmax at temperature 0; else drawn
        from the whole batch's logits, so that the draws are one device's."""
        g = self._batch_group
        if temperature <= 0.0 or g is None or g.size == 1:
            return sample_token(logits, gen, temperature)
        whole = self._whole_rows(logits, b)
        return sample_token(whole, gen, temperature)[self._rows(b)]

    # -- generation ----------------------------------------------------------
    def generate(self, tokens, *, max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0,
                 frontend=None,
                 on_step: Optional[Callable[[int, str], None]] = None,
                 ) -> GenerateResult:
        cfg = self.cfg
        b, s = tokens.shape
        max_len = s + max_new_tokens
        rw_mix = decode_rw_mix(b, max_len)
        kv_pool = self._agree(choose_kv_pool(
            cfg, b, max_len, advisor=self.advisor, scfg=self.scfg,
            pool_mgr=self.pool_mgr, rw_mix=rw_mix, inject_rate=self._duty))

        rows = self._rows(b)
        if rows != slice(None):
            tokens = tokens[rows]
            frontend = ({k: v[rows] for k, v in frontend.items()}
                        if frontend else frontend)
        prefill = make_prefill_step(cfg, self.rules, max_len=max_len)
        caches, logits = prefill(self.params, tokens, frontend)
        caches = self._place_caches(caches, kv_pool)

        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=logits.device).manual_seed(seed)
        tok = self._sample(logits, gen, temperature, b)[:, None]
        return self._decode_loop(caches, tok, logits, gen, s, b, max_len,
                                 max_new_tokens, temperature, kv_pool,
                                 rw_mix, on_step)

    def _decode_loop(self, caches, tok, logits, gen, s: int, b: int,
                     max_len: int,
                     max_new_tokens: int, temperature: float, kv_pool: str,
                     rw_mix: float, on_step) -> GenerateResult:
        """The decode loop.  Untimed without a monitor and ``on_step``
        (the reference's ``_generate_scan``), else each step wall-timed
        up to a synchronise (``_generate_monitored``): the same draws in
        the same order and the same pre-update emission either way.
        ``on_step(abs_step, pool)`` runs INSIDE the timed window — it
        stands in for the external contention the step experiences."""
        mon = self.monitor
        timed = mon is not None or on_step is not None
        d0 = m0 = r0 = 0
        if mon is not None:
            mon.bind(kv_bytes=cache_bytes(self.cfg, b, max_len),
                     rw_mix=rw_mix, pool=kv_pool,
                     inject_rate=self._duty,
                     capacities=pool_capacities(self.advisor,
                                                pool_mgr=self.pool_mgr)
                     if self.advisor is not None else None)
            kv_pool = mon.pool or kv_pool
            d0 = len(mon.drift_events)
            m0 = len(mon.migrations)
            r0 = len(mon.refreshes)

        emitted: List[torch.Tensor] = []
        host_read = host_written = 0
        busy_s = 0.0
        t_loop = time.perf_counter()
        for i in range(max_new_tokens - 1):
            read, written = lm.host_traffic_bytes(caches, self.device)
            host_read += read
            host_written += written
            t0 = time.perf_counter()
            if on_step is not None:
                on_step(s + i, kv_pool)
            caches, logits = self._decode(self.params, caches, tok, s + i)
            if timed:
                self._sync()
                wall_s = time.perf_counter() - t0
                busy_s += wall_s
            nxt = self._sample(logits, gen, temperature, b)[:, None]
            emitted.append(tok[:, 0])
            tok = nxt
            if mon is not None:
                action = mon.on_step(wall_s * 1e9)
                to_pool = self._agree(action.to_pool if action else "")
                if to_pool:
                    caches = self._place_caches(caches, to_pool)
                    kv_pool = to_pool
        if timed:
            self._observe_duty(busy_s, time.perf_counter() - t_loop)

        out = torch.cat([torch.stack(emitted, dim=1), tok], dim=1) \
            if max_new_tokens > 1 else tok
        out, logits = self._whole_rows(out, b), self._whole_rows(logits, b)
        result = GenerateResult(out, max_new_tokens, kv_pool, logits,
                                host_read_bytes=host_read,
                                host_written_bytes=host_written)
        if mon is not None:
            result.drift_events = list(mon.drift_events[d0:])
            result.migrations = list(mon.migrations[m0:])
            result.probe_sweeps = len(mon.refreshes) - r0
        return result

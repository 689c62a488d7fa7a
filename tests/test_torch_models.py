"""Port vs reference for the LM stack, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package's
model functions and the port's (``repro_torch.models``), the reference's
weights carried over by ``repro_torch.models.convert``.  Everything is
float32 at ``reduced()`` sizes, for every family: dense, local/global,
moe, ssm, hybrid, audio, vlm.  The port's prefill and train attention goes
through ``ops.flash_attention``, which on a CPU tensor runs its plain
version (``ref.flash_attention_ref``); the CUDA kernel runs only on the
card (chip_smoke.py's ``serve`` and ``serve_families`` phases).  The MoE
layer computes the reference's function without its padded dispatch
buffer, and the Mamba-2 layer the reference's chunked scan as a loop.

Tolerances, set beforehand from float32 (24 bits): 1e-5 for one function
(a few f32 roundings of values of order 1), 1e-4 for a whole model (two
to five layers, embeddings and the LM head sum more terms).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.kernels import counts
from repro_torch.models import (attention, blocks, common, convert, lm, mamba,
                                moe)

FN_ATOL, MODEL_ATOL = 1e-5, 1e-4
DENSE = ["qwen2-1.5b", "gemma3-1b", "gemma3-4b", "glm4-9b", "internvl2-26b",
         "musicgen-large"]
FAMILIES = ["phi3.5-moe-42b-a6.6b", "olmoe-1b-7b", "mamba2-370m",
            "jamba-v0.1-52b"]
ALL = DENSE + FAMILIES


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=atol,
                               err_msg=what)


def _randn(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _model(arch, seed=0, n_layers=None):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, convert.params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def _flat_ref(tree) -> dict:
    """The reference's tree as {key path: leaf}."""
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat(tree, path="") -> dict:
    """The port's tree as {key path: leaf}, paths as the reference's."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + f"['{k}']"))
        return out
    return {path: tree}


def _close_trees(got, want, atol, what):
    jflat, tflat = _flat_ref(want), _flat(got)
    assert sorted(tflat) == sorted(jflat), what
    for k, leaf in jflat.items():
        _close(tflat[k], leaf, atol, f"{what} {k}")


# ---------------------------------------------------------------------------
# Functions
# ---------------------------------------------------------------------------


def test_rmsnorm_and_rope_match_the_reference():
    rng = np.random.default_rng(0)
    x, w = _randn(rng, 2, 5, 3, 16), _randn(rng, 16)
    (jx, jw), (tx, tw) = _both(x, w)
    _close(common.rmsnorm(tx, tw, 1e-6), jcommon.rmsnorm(jx, jw, 1e-6),
           FN_ATOL)
    for positions in (np.arange(5), np.array([17])):
        jc, js = jcommon.rope_sincos(jnp.asarray(positions), 16, 1e6)
        tc, ts = common.rope_sincos(torch.from_numpy(positions), 16, 1e6)
        _close(tc, jc, FN_ATOL)
        _close(ts, js, FN_ATOL)
        xs = x[:, :len(positions)]
        _close(common.apply_rope(torch.from_numpy(xs), tc, ts),
               jcommon.apply_rope(jnp.asarray(xs), jc, js), FN_ATOL)
    for name in ("silu", "gelu", "relu"):
        _close(common.activation(name)(tx), jcommon.activation(name)(jx),
               FN_ATOL, name)
    _close(common.softcap(tx, 0.3), jcommon.softcap(jx, 0.3), FN_ATOL)


@pytest.mark.parametrize("h,kvh", [(4, 2), (4, 1), (2, 2)])
def test_gqa_attend_and_causal_attention(h, kvh):
    rng = np.random.default_rng(h * 10 + kvh)
    b, s, hd = 2, 16, 16
    q, k, v = (_randn(rng, b, s, h, hd), _randn(rng, b, s, kvh, hd),
               _randn(rng, b, s, kvh, hd))
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    mask = np.tril(np.ones((s, s), bool))[None].repeat(b, 0)
    _close(attention._gqa_attend(
        attention._split_heads(tq, kvh), tk, tv, torch.from_numpy(mask),
        0.25, 0.0),
        jattn._gqa_attend(jattn._split_heads(jq, kvh), jk, jv,
                          jnp.asarray(mask), 0.25, 0.0), FN_ATOL)
    pos = np.arange(s)
    valid = np.ones((b, s), bool)
    valid[1, 12:] = False
    for chunk in (16, 4):            # one chunk, and q-chunked
        kw = dict(scale=0.25, q_chunk=chunk)
        _close(attention.causal_attention(
            tq, tk, tv, q_positions=torch.from_numpy(pos),
            k_positions=torch.from_numpy(pos),
            k_valid=torch.from_numpy(valid), **kw),
            jattn.causal_attention(
                jq, jk, jv, q_positions=jnp.asarray(pos),
                k_positions=jnp.asarray(pos), k_valid=jnp.asarray(valid),
                **kw), FN_ATOL, f"q_chunk {chunk}")


@pytest.mark.parametrize("s,window,block", [
    (64, 16, 8), (96, 24, 8), (64, 8, 32), (20, 8, 16)])   # last: fallback
def test_window_attention(s, window, block):
    rng = np.random.default_rng(s + window)
    q, k, v = (_randn(rng, 2, s, 4, 16), _randn(rng, 2, s, 2, 16),
               _randn(rng, 2, s, 2, 16))
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    _close(attention.window_attention(tq, tk, tv, window=window, scale=0.25,
                                      q_chunk=block),
           jattn.window_attention(jq, jk, jv, window=window, scale=0.25,
                                  q_chunk=block), FN_ATOL)


@pytest.mark.parametrize("ring,window,write_pos", [
    (False, 0, 5), (False, 0, 15), (False, 4, 9), (True, 8, 3),
    (True, 8, 8), (True, 8, 21)])
def test_decode_attention_and_delta(ring, window, write_pos):
    rng = np.random.default_rng(write_pos)
    sbuf = 8 if ring else 16
    q1, ck, cv = (_randn(rng, 2, 1, 4, 16), _randn(rng, 2, sbuf, 2, 16),
                  _randn(rng, 2, sbuf, 2, 16))
    kn, vn = _randn(rng, 2, 1, 2, 16), _randn(rng, 2, 1, 2, 16)
    (jq, jck, jcv, jkn, jvn), (tq, tck, tcv, tkn, tvn) = \
        _both(q1, ck, cv, kn, vn)
    kw = dict(scale=0.25, ring=ring, window=window)
    _close(attention.decode_attention(tq, tck, tcv, write_pos=write_pos,
                                      **kw),
           jattn.decode_attention(jq, jck, jcv,
                                  write_pos=jnp.int32(write_pos), **kw),
           FN_ATOL)
    _close(attention.decode_attention_delta(
        tq, tck, tcv, tkn, tvn, write_pos=write_pos, **kw),
        jattn.decode_attention_delta(jq, jck, jcv, jkn, jvn,
                                     write_pos=jnp.int32(write_pos), **kw),
        FN_ATOL)


# ---------------------------------------------------------------------------
# Prefill attention: the flash wrapper's plain version vs the reference's jnp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,layer,s,max_len", [
    ("qwen2-1.5b", 0, 24, 24),      # global, GQA 4/2, cache == s
    ("qwen2-1.5b", 1, 24, 32),      # global, cache padded to max_len
    ("gemma3-1b", 0, 24, 32),       # local, window 8 < s: the ring roll
    ("gemma3-1b", 0, 6, 32),        # local, s < window
    ("gemma3-1b", 1, 24, 24),       # global layer of the local family
])
def test_attention_layer_prefill_through_the_flash_wrapper(arch, layer, s,
                                                           max_len):
    jcfg, cfg, jp, tp = _model(arch)
    rng = np.random.default_rng(s)
    x = _randn(rng, 2, s, cfg.d_model)
    plan = blocks.make_plan(cfg)
    key, r = f"p{layer % plan.period}", layer // plan.period
    jl = jax.tree.map(lambda a: a[r], jp["scan"][key]["attn"])
    tl = {k: t[r] for k, t in tp["scan"][key]["attn"].items()}
    counts.reset()
    ty, tc = attention.attention_layer(tl, torch.from_numpy(x), cfg=cfg,
                                       layer_idx=layer, mode="prefill",
                                       max_len=max_len, q_chunk=8)
    assert counts.PLAIN["flash_attention"] == 1
    assert counts.LAUNCHES["flash_attention"] == 0
    jy, jc = jattn.attention_layer(jl, jnp.asarray(x), cfg=jcfg,
                                   layer_idx=layer, mode="prefill",
                                   max_len=max_len, q_chunk=8)
    _close(ty, jy, FN_ATOL)
    assert tc["k"].shape == jc["k"].shape
    _close(tc["k"], jc["k"], FN_ATOL)
    _close(tc["v"], jc["v"], FN_ATOL)


def test_prefill_attention_refuses_a_softcap():
    q = torch.zeros(1, 4, 2, 16)
    k = torch.zeros(1, 4, 1, 16)
    with pytest.raises(ValueError, match="softcap"):
        attention.prefill_attention(q, k, k, window=0, scale=0.25, cap=30.0)


# ---------------------------------------------------------------------------
# Mixture of experts: the reference's function without its dispatch buffer
# ---------------------------------------------------------------------------


def _moe_case(capacity_factor=1.25, seed=0):
    """olmoe's reduced widths (4 experts, top-2), the reference's weights."""
    jcfg = jget_config("olmoe-1b-7b").reduced()
    cfg = get_config("olmoe-1b-7b").reduced()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity_factor))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = _randn(np.random.default_rng(seed), 2, 32, cfg.d_model)
    return jcfg, cfg, jp, tp, x


@pytest.mark.parametrize("dropless,capacity_factor,n_groups", [
    (False, 0.5, 0),        # capacity mode, cap 8 of ~16 a group: drops
    (False, 0.5, 1),        # one group over the batch
    (False, 1.25, 0),       # training's default factor
    (True, 1.25, 0),        # serving: every assignment kept
    (True, 1.25, 4),        # serving, four groups of 16 tokens
])
def test_moe_apply_matches_the_reference(dropless, capacity_factor, n_groups):
    jcfg, cfg, jp, tp, x = _moe_case(capacity_factor)
    (jx,), (tx,) = _both(x)
    jy, jaux = jmoe.moe_apply(jp, jx, jcfg, n_groups=n_groups,
                              dropless=dropless)
    ty, taux = moe.moe_apply(tp, tx, cfg, n_groups=n_groups,
                             dropless=dropless)
    _close(ty, jy, FN_ATOL, "output")
    assert sorted(taux) == sorted(jaux)
    for key in taux:
        _close(taux[key], jaux[key], FN_ATOL, key)
    if dropless:
        assert float(taux["moe_drop_frac"]) == 0.0
    elif capacity_factor < 1:
        assert float(taux["moe_drop_frac"]) > 0.1     # the drop rule ran


def test_moe_skips_experts_without_rows_and_syncs_once():
    """A router that sends every token to experts 0 and 1: experts 2 and 3
    get no GEMM, and the segment sizes come to the host once."""
    jcfg, cfg, jp, tp, x = _moe_case()
    router = np.zeros((cfg.d_model, cfg.moe.n_experts), np.float32)
    router[:, :2] = np.abs(_randn(np.random.default_rng(3), cfg.d_model, 2))
    x = np.abs(x)
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    seen = []

    class Spy(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            seen.append(getattr(func, "__name__", ""))
            return func(*args, **(kwargs or {}))

    with Spy():
        ty, _ = moe.moe_apply(tp, torch.from_numpy(x), cfg, dropless=True)
    jy, _ = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, dropless=True)
    _close(ty, jy, FN_ATOL)
    assert seen.count("matmul") == 2 * 3 and seen.count("tolist") == 1


# ---------------------------------------------------------------------------
# Mamba-2: conv, the chunked scan, the step, the layer
# ---------------------------------------------------------------------------


def _ssm_cfgs():
    return (jget_config("mamba2-370m").reduced(),
            get_config("mamba2-370m").reduced())


@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv_matches_the_reference(with_prev):
    rng = np.random.default_rng(7)
    xbc, w, bias = _randn(rng, 2, 9, 12), _randn(rng, 4, 12), _randn(rng, 12)
    prev = _randn(rng, 2, 3, 12) if with_prev else None
    (jx, jw, jb), (tx, tw, tb) = _both(xbc, w, bias)
    jout, jtail = jmamba._causal_conv(
        jx, jw, jb, prev=None if prev is None else jnp.asarray(prev))
    tout, ttail = mamba._causal_conv(
        tx, tw, tb, prev=None if prev is None else torch.from_numpy(prev))
    _close(tout, jout, FN_ATOL, "out")
    _close(ttail, jtail, FN_ATOL, "tail")


def _ssd_inputs(rng, b=2, s=24, h=4, p=8, g=2, n=16):
    x = _randn(rng, b, s, h, p)
    dt = np.log1p(np.exp(_randn(rng, b, s, h))).astype(np.float32)
    a = -np.exp(_randn(rng, h)).astype(np.float32)
    bm, cm = _randn(rng, b, s, g, n), _randn(rng, b, s, g, n)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_matches_the_reference(with_init):
    rng = np.random.default_rng(11)
    arrays = _ssd_inputs(rng)
    init = _randn(rng, 2, 4, 8, 16) if with_init else None
    j, t = _both(*arrays)
    jy, jfinal = jmamba.ssd_chunked(
        *j, 8, init_state=None if init is None else jnp.asarray(init))
    ty, tfinal = mamba.ssd_chunked(
        *t, 8, init_state=None if init is None else torch.from_numpy(init))
    _close(ty, jy, FN_ATOL, "y")
    _close(tfinal, jfinal, FN_ATOL, "final state")
    with pytest.raises(ValueError, match="multiple of chunk"):
        mamba.ssd_chunked(*t, 7)


def test_ssd_step_matches_the_reference():
    rng = np.random.default_rng(12)
    state, x = _randn(rng, 2, 4, 8, 16), _randn(rng, 2, 4, 8)
    dt = np.log1p(np.exp(_randn(rng, 2, 4))).astype(np.float32)
    a = -np.exp(_randn(rng, 4)).astype(np.float32)
    bm, cm = _randn(rng, 2, 2, 16), _randn(rng, 2, 2, 16)
    j, t = _both(state, x, dt, a, bm, cm)
    jy, jnew = jmamba.ssd_step(*j)
    ty, tnew = mamba.ssd_step(*t)
    _close(ty, jy, FN_ATOL, "y")
    _close(tnew, jnew, FN_ATOL, "state")


def test_mamba_layer_prefill_and_decode_match_the_reference():
    """Prefill over 13 tokens (the chunk is 8: the zero-padded tail), then
    three decode steps through the cache."""
    jcfg, cfg = _ssm_cfgs()
    jp = jmamba.mamba_init(jax.random.PRNGKey(4), jcfg, jnp.float32)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(13)
    x = _randn(rng, 2, 13, cfg.d_model)
    (jx,), (tx,) = _both(x)
    for mode in ("train", "prefill"):
        jy, jc = jmamba.mamba_layer(jp, jx, cfg=jcfg, mode=mode)
        ty, tc = mamba.mamba_layer(tp, tx, cfg=cfg, mode=mode)
        _close(ty, jy, FN_ATOL, mode)
    assert jc is not None and sorted(tc) == sorted(jc)
    for step in range(3):
        x1 = _randn(rng, 2, 1, cfg.d_model)
        (jx1,), (tx1,) = _both(x1)
        jy, jc = jmamba.mamba_layer(jp, jx1, cfg=jcfg, mode="decode",
                                    cache=jc)
        ty, tc = mamba.mamba_layer(tp, tx1, cfg=cfg, mode="decode",
                                   cache=tc)
        _close(ty, jy, FN_ATOL, f"decode {step}")
        _close(tc["ssm"], jc["ssm"], FN_ATOL, f"ssm {step}")
        _close(tc["conv"], jc["conv"], FN_ATOL, f"conv {step}")


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-v0.1-52b"])
@pytest.mark.parametrize("full", [False, True])
def test_mamba_cache_shapes_match_the_reference(arch, full):
    jcfg, cfg = jget_config(arch), get_config(arch)
    if not full:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    for batch in (1, 4):
        assert mamba.mamba_cache_shapes(cfg, batch) == \
            jmamba.mamba_cache_shapes(jcfg, batch)


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------


def _frontend(cfg, b, s, rng):
    if cfg.frontend == "audio":
        return {"frame_embeds": _randn(rng, b, s, cfg.d_model, scale=0.02)}
    if cfg.frontend == "vlm":
        return {"prefix_embeds": _randn(rng, b, cfg.n_prefix_embeds,
                                        cfg.d_model, scale=0.02)}
    return None


# every config at reduced(), and jamba at 5 layers: two stacked periods
# and a Mamba tail layer
FORWARD_CASES = [(a, None) for a in ALL] + [("jamba-v0.1-52b", 5)]


@pytest.mark.parametrize("arch,n_layers", FORWARD_CASES, ids=[
    a if n is None else f"{a}-{n}-layers" for a, n in FORWARD_CASES])
def test_forward_train_prefill_decode_match_the_reference(arch, n_layers):
    jcfg, cfg, jp, tp = _model(arch, n_layers=n_layers)
    b, s, prompt = 2, 24, 16
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (b, s))
    fe = _frontend(cfg, b, s, rng)
    jfe = {k: jnp.asarray(v) for k, v in fe.items()} if fe else None
    tfe = {k: torch.from_numpy(v) for k, v in fe.items()} if fe else None
    jt, tt = jnp.asarray(tokens, jnp.int32), torch.from_numpy(tokens)

    jh, _, jaux = jlm.forward(jp, jt, cfg=jcfg, mode="train", frontend=jfe)
    th, tc, aux = lm.forward(tp, tt, cfg=cfg, mode="train", frontend=tfe)
    assert tc is None
    assert sorted(aux) == sorted(jaux)
    assert bool(aux) == (cfg.moe is not None)
    for key in aux:                 # the MoE losses, the mean drop fraction
        _close(aux[key], jaux[key], MODEL_ATOL, f"train {key}")
    _close(th, jh, MODEL_ATOL, "train hidden")
    _close(lm.unembed_logits(tp, th, cfg), jlm.unembed_logits(jp, jh, jcfg),
           MODEL_ATOL, "train logits")

    pfe = jfe and {k: v[:, :prompt] if k == "frame_embeds" else v
                   for k, v in jfe.items()}
    tpfe = tfe and {k: v[:, :prompt] if k == "frame_embeds" else v
                    for k, v in tfe.items()}
    jh, jc, jaux = jlm.forward(jp, jt[:, :prompt], cfg=jcfg, mode="prefill",
                               frontend=pfe, max_len=s, q_chunk=8)
    th, tc, aux = lm.forward(tp, tt[:, :prompt], cfg=cfg, mode="prefill",
                             frontend=tpfe, max_len=s, q_chunk=8)
    _close(th, jh, MODEL_ATOL, "prefill hidden")
    _close_trees(tc, jc, MODEL_ATOL, "prefill cache")
    for key in aux:
        _close(aux[key], jaux[key], MODEL_ATOL, f"prefill {key}")
    # one trace for every step (eager, each call would trace anew)
    jdecode = jax.jit(lambda p_, t_, c_, w_: jlm.forward(
        p_, t_, cfg=jcfg, mode="decode", caches=c_, write_pos=w_))
    held = {k: t.data_ptr() for k, t in _flat(tc).items()}
    for pos in range(prompt, s):
        jh, jc, _ = jdecode(jp, jt[:, pos:pos + 1], jc, jnp.int32(pos))
        th, tc, _ = lm.forward(tp, tt[:, pos:pos + 1], cfg=cfg,
                               mode="decode", caches=tc, write_pos=pos)
        _close(th, jh, MODEL_ATOL, f"decode hidden at {pos}")
    _close_trees(tc, jc, MODEL_ATOL, "decoded cache")
    # decode wrote into the tensors it was given, attention and Mamba alike
    assert {k: t.data_ptr() for k, t in _flat(tc).items()} == held


def test_layout_matches_the_reference():
    """Same keys, shapes and dtypes, period stacking included, for a dense,
    a local/global, two moe, an ssm and a hybrid config (jamba at
    reduced()'s period of 2 and at a depth of 5: two stacked periods and a
    tail), from shapes alone."""
    for arch, n_layers in (("gemma3-1b", None), ("qwen2-1.5b", None),
                           ("phi3.5-moe-42b-a6.6b", None),
                           ("olmoe-1b-7b", None), ("mamba2-370m", None),
                           ("jamba-v0.1-52b", None), ("jamba-v0.1-52b", 5)):
        jcfg, cfg, jp, tp = _model(arch, n_layers=n_layers)
        jflat = _flat_ref(jp)
        tflat = _flat(lm.init_params(cfg, torch.Generator().manual_seed(0)))
        assert sorted(tflat) == sorted(jflat), arch
        for k, t in tflat.items():
            assert tuple(t.shape) == jflat[k].shape, k
            assert t.dtype == torch.float32
            assert jflat[k].dtype == jnp.float32, k


def test_period_plans_match_the_reference():
    from repro.models import blocks as jblocks
    for arch in ALL:
        full_j, full_t = jget_config(arch), get_config(arch)
        jp, tp = jblocks.make_plan(full_j), blocks.make_plan(full_t)
        assert (tp.period, tp.n_full, tp.n_tail) == \
            (jp.period, jp.n_full, jp.n_tail), arch
        assert [blocks.layer_signature(full_t, i)
                for i in range(full_t.n_layers)] == \
            [jblocks.layer_signature(full_j, i)
             for i in range(full_j.n_layers)]


def test_cache_struct_is_shapes_only_and_matches_the_reference():
    for arch in ["qwen2-1.5b", "gemma3-1b"] + FAMILIES:
        for full in (False, True):
            jcfg, cfg = jget_config(arch), get_config(arch)
            if not full:
                jcfg, cfg = jcfg.reduced(), cfg.reduced()
            for batch, max_len in ((4, 64), (1, 5)):
                js = _flat_ref(jlm.cache_struct(jcfg, batch, max_len))
                ts = _flat(lm.cache_struct(cfg, batch, max_len))
                assert sorted(ts) == sorted(js), arch
                for k, t in ts.items():
                    assert t.device.type == "meta"
                    assert tuple(t.shape) == js[k].shape, (arch, k)
                    state = k.endswith("['ssm']")
                    assert t.dtype == (torch.float32 if state
                                       else torch.bfloat16), (arch, k)
                    assert js[k].dtype == (jnp.float32 if state
                                           else jnp.bfloat16), (arch, k)
    for arch in ("gemma3-1b", "jamba-v0.1-52b"):
        cache = lm.init_cache(get_config(arch).reduced(), 2, 12,
                              device="cpu")
        assert all(t.device.type == "cpu" and not t.any()
                   for t in lm.leaves(cache))


def test_host_traffic_counts_what_lies_off_the_device():
    cfg = get_config("gemma3-1b").reduced()
    struct = lm.cache_struct(cfg, 2, 32)     # on "meta": off the CPU
    read, written = lm.host_traffic_bytes(struct, torch.device("cpu"))
    from repro_torch.serve.engine import cache_bytes
    assert read == cache_bytes(cfg, 2, 32)
    # one token's slot of k and of v in each of the two layers' caches
    # (a local ring of 8, a global buffer of 32): batch x KV x hd x 2 bytes
    slot = 2 * cfg.n_kv_heads * cfg.head_dim * 2
    assert written == 4 * slot
    assert lm.host_traffic_bytes(struct, torch.device("meta")) == (0, 0)


def test_host_traffic_counts_a_mamba_state_whole():
    """jamba reduced: two stacked Mamba layers (ssm f32, conv bf16) are read
    and written whole; two attention layers read whole, one slot written."""
    cfg = get_config("jamba-v0.1-52b").reduced()
    struct = lm.cache_struct(cfg, 2, 32)
    read, written = lm.host_traffic_bytes(struct, torch.device("cpu"))
    from repro_torch.serve.engine import cache_bytes
    assert read == cache_bytes(cfg, 2, 32)
    shapes = mamba.mamba_cache_shapes(cfg, 2)
    state = 2 * (np.prod(shapes["ssm"]) * 4 + np.prod(shapes["conv"]) * 2)
    slot = 2 * 2 * cfg.n_kv_heads * cfg.head_dim * 2
    assert written == state + 2 * slot


# ---------------------------------------------------------------------------
# The converter
# ---------------------------------------------------------------------------


def test_converter_is_bit_exact_for_bfloat16():
    jcfg = jget_config("qwen2-1.5b").reduced()
    import dataclasses
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jleaves) == len(list(lm.leaves(tp)))
    for (path, want), got in zip(jleaves, lm.leaves(tp)):
        assert got.dtype == torch.bfloat16, path
        w = np.asarray(want).view(np.uint16)
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                              w), path
    # float32 and int leaves go across unchanged too
    arr = np.arange(6, dtype=np.int32).reshape(2, 3)
    out = convert.tensor_from_numpy(arr, "cpu")
    assert out.dtype == torch.int32 and out.tolist() == arr.tolist()

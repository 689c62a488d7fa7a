"""Port vs reference for training, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package's
``train/step.py``, ``optim/adamw.py`` and ``parallel/compression.py`` and
the port's, the reference's weights and train state carried over by
``repro_torch.models.convert``.  Everything is float32 at ``reduced()``
sizes.  The port's train attention goes through ``ops.flash_attention``'s
autograd Function, whose forward and backward on a CPU tensor are the
plain versions of the two kernels; the reference differentiates its jnp
attention.

Limits, set beforehand from float32 (24 bits):
- the optimizer, the schedule and the compression on identical inputs:
  within a few float32 roundings (``adamw_update`` within 1e-6 of each
  leaf's largest value: the global norm's sums are grouped differently by
  XLA and by PyTorch, which moves the clip factor by an ulp; the int8
  values and the error state of the compression bit for bit);
- the cross-entropy: 1e-6 relative (sums over chunks and the vocabulary
  in another order);
- a whole step's gradients: a normalised error of 1e-5 over all leaves,
  1e-4 for the worst leaf;
- the new parameters after one step: at step 1 AdamW moves an element by
  about ``lr·sign(g)``, and an element whose gradient is near 0 may flip
  its sign between packages on summation order alone (a difference of
  ``2·lr``): at most 0.1 % of the elements may differ by more than 1e-5,
  the rest within it; the moments within 1e-5 of each leaf's largest;
- the int8-EF error state after a step: within 1e-5 of the leaf's largest
  gradient (at least 254 times its largest error, since an error is at
  most half a quantum of max|g| / 127), but for the elements whose int8
  value flips between packages on a gradient near a half quantum (a
  difference of one quantum): at most 0.1 % of them.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.base import get_config as jget_config
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.parallel import compression as jcompression
from repro.parallel.sharding import make_rules as jmake_rules
from repro.train import step as jstep
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import counts
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import convert, lm
from repro_torch.optim import adamw
from repro_torch.parallel import compression
from repro_torch.parallel.sharding import make_rules
from repro_torch.train import step as step_mod

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
B, S = 4, 32
CE_REL, GRAD_NORM_REL, GRAD_LEAF_REL = 1e-6, 1e-5, 1e-4
PARAM_ATOL, FLIP_SHARE, MOMENT_REL = 1e-5, 1e-3, 1e-5


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return raw[:, :-1], raw[:, 1:].copy()


def _setup(arch, **tkw):
    """(reference cfg, rules, tcfg; port cfg, rules, tcfg)."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    kw = dict(total_steps=10, warmup_steps=2, loss_chunk=12)
    kw.update(tkw)
    jr = jmake_rules(jcfg, jmake_host_mesh(1, 1), global_batch=B,
                     shape_kind="train")
    tr = make_rules(cfg, make_host_mesh(1, 1), global_batch=B)
    return jcfg, jr, JTrainConfig(**kw), cfg, tr, TrainConfig(**kw)


def _state_pair(jcfg, jtcfg, seed=0):
    """The reference's initial state and the port's converted copy."""
    jst = jstep.init_state(jcfg, jtcfg, jax.random.PRNGKey(seed))
    return jst, convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jst), "cpu")


def _check_params(got, want, what):
    flips = total = 0
    for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
        d = np.abs(_np(a) - _np(b))
        flips += int((d > PARAM_ATOL).sum())
        total += d.size
    assert flips <= FLIP_SHARE * total, (what, flips, total)


def _check_moments(got, want, what):
    for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
        top = float(np.abs(_np(b)).max()) or 1.0
        assert float(np.abs(_np(a) - _np(b)).max()) <= MOMENT_REL * top, what


# ---------------------------------------------------------------------------
# Cross-entropy
# ---------------------------------------------------------------------------


def _hidden_and_params(arch="qwen2-1.5b", seed=0):
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, convert.params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu"), h


@pytest.mark.parametrize("chunk", [4, 8, 12, 32, 64])
def test_chunked_ce_matches_the_reference(chunk):
    """Chunks of 4, 8 and 32 tile S = 32; 12 leaves a remainder chunk of
    8; 64 is cut to S."""
    jcfg, cfg, jp, tp, h = _hidden_and_params()
    _, y = _batch(cfg)
    jl, jc = jstep.chunked_ce(jp, jnp.asarray(h), jnp.asarray(y), cfg=jcfg,
                              chunk=chunk, cst=lambda x, n: x)
    tl, tc = step_mod.chunked_ce(tp, torch.from_numpy(h),
                                 torch.from_numpy(y).long(), cfg=cfg,
                                 chunk=chunk)
    assert tl.dtype == torch.float32
    assert float(tc) == float(jc) == B * S
    assert abs(float(tl) - float(jl)) <= CE_REL * abs(float(jl))


def test_ce_label_masking_matches_the_reference():
    jcfg, cfg, jp, tp, h = _hidden_and_params(seed=1)
    _, y = _batch(cfg, seed=1)
    y[:, :8] = -1
    y[0, 20] = -1
    jl, jc = jstep.chunked_ce(jp, jnp.asarray(h), jnp.asarray(y), cfg=jcfg,
                              chunk=12, cst=lambda x, n: x)
    tl, tc = step_mod.chunked_ce(tp, torch.from_numpy(h),
                                 torch.from_numpy(y).long(), cfg=cfg,
                                 chunk=12)
    assert float(tc) == float(jc) == B * (S - 8) - 1
    assert np.isfinite(float(tl))
    assert abs(float(tl) - float(jl)) <= CE_REL * abs(float(jl))


def test_chunked_ce_gradients_match_the_reference():
    """The gradients of the summed loss through the chunks (recomputed in
    the backward pass) against ``jax.grad`` of the reference's scan, for
    the hidden states and the tied embedding."""
    jcfg, cfg, jp, tp, h = _hidden_and_params(seed=2)
    _, y = _batch(cfg, seed=2)

    def jf(emb, hh):
        return jstep.chunked_ce({**jp, "embed": emb}, hh, jnp.asarray(y),
                                cfg=jcfg, chunk=12, cst=lambda x, n: x)[0]

    jge, jgh = jax.grad(jf, argnums=(0, 1))(jp["embed"], jnp.asarray(h))
    emb = tp["embed"].clone().requires_grad_()
    th = torch.from_numpy(h).requires_grad_()
    loss, _ = step_mod.chunked_ce({**tp, "embed": emb}, th,
                                  torch.from_numpy(y).long(), cfg=cfg,
                                  chunk=12)
    loss.backward()
    for got, want in ((emb.grad, jge), (th.grad, jgh)):
        want = np.asarray(want)
        err = float(np.abs(_np(got) - want).max())
        assert err <= GRAD_NORM_REL * float(np.abs(want).max())


# ---------------------------------------------------------------------------
# AdamW, the schedule, the compression
# ---------------------------------------------------------------------------


def _leaves(seed, shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"a": (7, 5), "b": (33,), "c": (2, 3, 4)}


@pytest.mark.parametrize("grad_clip,step", [(0.0, 0), (1.0, 0), (0.5, 3)])
def test_adamw_update_matches_the_reference(grad_clip, step):
    """One update on identical parameters, gradients and moments, from
    the reference's schedule: the new parameters and moments within 1e-6
    of each leaf's largest value, the stats within 1e-6 relative (the same
    float32 arithmetic in the same order, the global norm's sums grouped
    differently)."""
    tcfg_kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
                   weight_decay=0.1, grad_clip=grad_clip)
    p, g = _leaves(0, SHAPES), _leaves(1, SHAPES, 0.3)
    m, v = _leaves(2, SHAPES, 0.01), {k: np.abs(x) for k, x in
                                      _leaves(3, SHAPES, 0.01).items()}
    jopt = jadamw.OptState(jax.tree.map(jnp.asarray, m),
                           jax.tree.map(jnp.asarray, v), jnp.int32(step))
    jp, jo, js = jadamw.adamw_update(jax.tree.map(jnp.asarray, p),
                                     jax.tree.map(jnp.asarray, g), jopt,
                                     JTrainConfig(**tcfg_kw))
    t = lambda d: {k: torch.from_numpy(x.copy()) for k, x in d.items()}
    topt = adamw.OptState(t(m), t(v), torch.tensor(step, dtype=torch.int32))
    tp, to, ts = adamw.adamw_update(t(p), t(g), topt, TrainConfig(**tcfg_kw))
    for got, want in ((tp, jp), (to.m, jo.m), (to.v, jo.v)):
        for k in SHAPES:
            w = np.asarray(want[k])
            np.testing.assert_allclose(_np(got[k]), w, rtol=0,
                                       atol=1e-6 * float(np.abs(w).max()))
    assert int(to.step) == int(jo.step) == step + 1
    for k in ("grad_norm", "lr", "update_scale"):
        np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=1e-6)


def test_adamw_updates_in_place_and_keeps_dtypes():
    """The parameters and moments are updated in their own tensors; a
    bf16 parameter stays bf16, its update computed in float32 and rounded
    once."""
    p = {"w": torch.ones(8, dtype=torch.bfloat16), "b": torch.zeros(3)}
    g = {"w": torch.full((8,), 0.5), "b": torch.ones(3)}
    opt = adamw.init_opt_state(p)
    before = [id(x) for x in tree.leaves(p) + tree.leaves(opt.m)]
    newp, newopt, _ = adamw.adamw_update(p, g, opt, TrainConfig(
        learning_rate=1e-2, warmup_steps=0, grad_clip=0.0))
    assert newp is p
    assert [id(x) for x in tree.leaves(newp) + tree.leaves(newopt.m)] \
        == before
    assert newp["w"].dtype == torch.bfloat16
    assert newopt.m["w"].dtype == torch.float32
    want = (1.0 - 1e-2 * (1.0 + 0.1)) * torch.ones(8)
    assert torch.equal(newp["w"], want.to(torch.bfloat16))


def test_warmup_cosine_matches_the_reference():
    tk = dict(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    jlr, tlr = jadamw.warmup_cosine(JTrainConfig(**tk)), \
        adamw.warmup_cosine(TrainConfig(**tk))
    for s in range(0, 120, 3):
        np.testing.assert_allclose(
            float(tlr(torch.tensor(s, dtype=torch.int32))),
            float(jlr(jnp.int32(s))), rtol=1e-6)


def test_global_norm_matches_the_reference():
    g = _leaves(4, SHAPES)
    want = jadamw.global_norm(jax.tree.map(jnp.asarray, g))
    got = adamw.global_norm({k: torch.from_numpy(x) for k, x in g.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_compress_decompress_is_bit_equal_to_the_reference():
    """Three rounds of int8 error feedback: round half to even in both
    packages, so the int8 values, the scales, the dequantized gradients
    and the carried error are bit for bit the reference's."""
    g = _leaves(5, SHAPES, 0.01)
    g["a"][0, 0] = 0.0
    jerr = jcompression.init_error_state(jax.tree.map(jnp.asarray, g))
    terr = compression.init_error_state(
        {k: torch.from_numpy(x) for k, x in g.items()})
    for r in range(3):
        gi = {k: x * (1.0 + r) for k, x in g.items()}
        jq, js, _ = jcompression.ef_quantize(jax.tree.map(jnp.asarray, gi),
                                             jerr)
        tq, ts, _ = compression.ef_quantize(
            {k: torch.from_numpy(x) for k, x in gi.items()}, terr)
        jout, jerr = jcompression.compress_decompress(
            jax.tree.map(jnp.asarray, gi), jerr)
        tout, terr = compression.compress_decompress(
            {k: torch.from_numpy(x) for k, x in gi.items()}, terr)
        for k in SHAPES:
            assert tq[k].dtype == torch.int8
            np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
            np.testing.assert_array_equal(tout[k].numpy(),
                                          np.asarray(jout[k]))
            np.testing.assert_array_equal(terr[k].numpy(),
                                          np.asarray(jerr[k]))


def test_rounding_is_half_to_even_in_both_packages():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x))))


# ---------------------------------------------------------------------------
# One train step against the reference's
# ---------------------------------------------------------------------------


def _grads_both(jcfg, jr, jtcfg, cfg, tr, tcfg, jst, tst, tokens, labels):
    jloss = jstep.make_loss_fn(jcfg, jr, jtcfg)
    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(
        jst["params"], jnp.asarray(tokens), jnp.asarray(labels), None)
    tloss = step_mod.make_loss_fn(cfg, tr, tcfg)
    flat = [p.detach().clone().requires_grad_()
            for p in tree.leaves(tst["params"])]
    tl, tm = tloss(tree.unflatten_like(tst["params"], flat),
                   torch.from_numpy(tokens).long(),
                   torch.from_numpy(labels).long(), None)
    tg = torch.autograd.grad(tl, flat)
    return (jl, jm, jax.tree.leaves(jg)), (tl, tm, tg)


def _check_grads(tg, jg):
    num = den = 0.0
    for a, b in zip(tg, jg):
        d = _np(a) - np.asarray(b, np.float32)
        w = np.asarray(b, np.float32)
        num, den = num + float((d * d).sum()), den + float((w * w).sum())
        if float((w * w).sum()):
            assert np.sqrt((d * d).sum() / (w * w).sum()) <= GRAD_LEAF_REL
    assert np.sqrt(num / den) <= GRAD_NORM_REL


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-1b"])
@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_matches_the_reference(arch, mb):
    """``make_train_step`` at 1 and 2 microbatches against the reference's
    from converted weights: the loss and every metric, the gradients of
    the loss (by a normalised error), the new parameters (with the flips
    the module docstring allows), the moments and the step.  gemma3-1b
    runs its local layers' windows through the flash Function."""
    jcfg, jr, jtcfg, cfg, tr, tcfg = _setup(arch)
    jst, tst = _state_pair(jcfg, jtcfg)
    tokens, labels = _batch(cfg)
    (_, _, jg), (_, _, tg) = _grads_both(jcfg, jr, jtcfg, cfg, tr, tcfg,
                                         jst, tst, tokens, labels)
    _check_grads(tg, jg)
    jnew, jm = jax.jit(jstep.make_train_step(jcfg, jr, jtcfg,
                                             microbatches=mb))(
        jst, jnp.asarray(tokens), jnp.asarray(labels), None)
    counts.reset()
    tnew, tm = step_mod.make_train_step(cfg, tr, tcfg, microbatches=mb)(
        tst, torch.from_numpy(tokens).long(),
        torch.from_numpy(labels).long())
    # the flash Function: two forwards (remat) and one backward a layer and
    # microbatch, all plain on the CPU
    assert counts.PLAIN["flash_attention"] == 2 * cfg.n_layers * mb
    assert counts.PLAIN["flash_attention_bwd"] == cfg.n_layers * mb
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _check_params(tnew["params"], jnew["params"], arch)
    _check_moments(tnew["opt"].m, jnew["opt"].m, "m")
    _check_moments(tnew["opt"].v, jnew["opt"].v, "v")
    assert int(tnew["opt"].step) == int(jnew["opt"].step) == 1


def test_train_step_with_compression_matches_the_reference():
    jcfg, jr, jtcfg, cfg, tr, tcfg = _setup("qwen2-1.5b",
                                            grad_compression="int8_ef")
    jst, tst = _state_pair(jcfg, jtcfg)
    assert "err" in tst
    tokens, labels = _batch(cfg, seed=3)
    jnew, jm = jax.jit(jstep.make_train_step(jcfg, jr, jtcfg))(
        jst, jnp.asarray(tokens), jnp.asarray(labels), None)
    tnew, tm = step_mod.make_train_step(cfg, tr, tcfg)(
        tst, torch.from_numpy(tokens).long(), torch.from_numpy(labels).long())
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    _check_params(tnew["params"], jnew["params"], "int8_ef")
    flips = total = 0
    for a, b in zip(tree.leaves(tnew["err"]), jax.tree.leaves(jnew["err"])):
        b = np.asarray(b)
        d = np.abs(_np(a) - b)
        flips += int((d > MOMENT_REL * 254 * float(np.abs(b).max())).sum())
        total += d.size
    assert flips <= FLIP_SHARE * total, (flips, total)


def test_moe_train_step_loss_and_aux_match_the_reference():
    """olmoe-1b-7b ``reduced()``: the train step's loss and its MoE
    metrics (the aux and z losses added to the loss, the drop fraction of
    the capacity rule) against the reference's."""
    jcfg, jr, jtcfg, cfg, tr, tcfg = _setup("olmoe-1b-7b")
    jst, tst = _state_pair(jcfg, jtcfg)
    tokens, labels = _batch(cfg, seed=4)
    _, jm = jax.jit(jstep.make_train_step(jcfg, jr, jtcfg))(
        jst, jnp.asarray(tokens), jnp.asarray(labels), None)
    _, tm = step_mod.make_train_step(cfg, tr, tcfg)(
        tst, torch.from_numpy(tokens).long(), torch.from_numpy(labels).long())
    assert {"moe_aux", "moe_drop_frac", "ce_loss", "loss"} <= set(tm)
    for k in ("loss", "ce_loss", "moe_aux", "moe_drop_frac", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_remat_gives_the_same_gradients():
    """``remat="layer"`` recomputes each period in the backward pass; the
    gradients equal those without it."""
    _, _, _, cfg, tr, _ = _setup("gemma3-1b")
    params = convert.params_from_numpy(jax.tree.map(
        np.asarray, jlm.init_params(jget_config("gemma3-1b").reduced(),
                                    jax.random.PRNGKey(0))), "cpu")
    tokens, labels = _batch(cfg, seed=5)
    grads = []
    for remat in ("none", "layer"):
        loss_fn = step_mod.make_loss_fn(cfg, tr, TrainConfig(
            remat=remat, loss_chunk=12))
        flat = [p.detach().clone().requires_grad_()
                for p in tree.leaves(params)]
        counts.reset()
        loss, _ = loss_fn(tree.unflatten_like(params, flat),
                          torch.from_numpy(tokens).long(),
                          torch.from_numpy(labels).long(), None)
        grads.append(torch.autograd.grad(loss, flat))
        assert counts.PLAIN["flash_attention"] == \
            cfg.n_layers * (2 if remat == "layer" else 1)
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-9)


def test_remat_must_be_none_or_layer():
    _, _, _, cfg, _, _ = _setup("qwen2-1.5b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="remat"):
        lm.forward(params, torch.zeros((1, 4), dtype=torch.long), cfg=cfg,
                   remat="full")


@pytest.mark.parametrize("mb", [2, 4])
def test_microbatch_equivalence(mb):
    """The port's twin of the reference's: 1 and ``mb`` microbatches give
    the same update."""
    _, _, _, cfg, tr, _ = _setup("qwen2-1.5b")
    tcfg = TrainConfig(total_steps=10, warmup_steps=1, grad_clip=0.0,
                       loss_chunk=16)
    tokens, labels = _batch(cfg, seed=6)
    news = []
    for n in (1, mb):
        state = step_mod.init_state(cfg, tcfg, torch.Generator()
                                    .manual_seed(0))
        new, m = step_mod.make_train_step(cfg, tr, tcfg, microbatches=n)(
            state, torch.from_numpy(tokens).long(),
            torch.from_numpy(labels).long())
        news.append((new, float(m["loss"])))
    np.testing.assert_allclose(news[0][1], news[1][1], rtol=2e-5)
    for a, b in zip(tree.leaves(news[0][0]["params"]),
                    tree.leaves(news[1][0]["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-5)


def test_the_step_updates_the_state_in_place():
    _, _, _, cfg, tr, tcfg = _setup("qwen2-1.5b")
    state = step_mod.init_state(cfg, tcfg, torch.Generator().manual_seed(0))
    before = [id(t) for t in tree.leaves(state)]
    first = tree.leaves(state["params"])[0].clone()
    tokens, labels = _batch(cfg)
    new, _ = step_mod.make_train_step(cfg, tr, tcfg, microbatches=2)(
        state, torch.from_numpy(tokens).long(),
        torch.from_numpy(labels).long())
    assert new is state
    assert [id(t) for t in tree.leaves(new["params"])] == \
        before[-len(tree.leaves(new["params"])):]
    assert not torch.equal(tree.leaves(new["params"])[0], first)
    assert not any(t.requires_grad for t in tree.leaves(new))


def test_a_batch_that_does_not_split_into_microbatches_raises():
    _, _, _, cfg, tr, tcfg = _setup("qwen2-1.5b")
    state = step_mod.init_state(cfg, tcfg, torch.Generator().manual_seed(0))
    tokens, labels = _batch(cfg, b=3)
    with pytest.raises(ValueError, match="microbatches"):
        step_mod.make_train_step(cfg, tr, tcfg, microbatches=2)(
            state, torch.from_numpy(tokens).long(),
            torch.from_numpy(labels).long())


def test_overfit_tiny_batch():
    """The twin of the reference's ``test_overfit_tiny_batch``: 60 steps on
    one batch lower the cross-entropy by more than 1.0."""
    _, _, _, cfg, tr, _ = _setup("qwen2-1.5b")
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=60,
                       loss_chunk=16)
    state = step_mod.init_state(cfg, tcfg, torch.Generator().manual_seed(1))
    step = step_mod.make_train_step(cfg, tr, tcfg)
    tokens = (torch.arange(B * S).reshape(B, S) * 13) % cfg.vocab_size
    labels = torch.roll(tokens, -1, dims=1)
    losses = []
    for _ in range(60):
        state, metrics = step(state, tokens, labels)
        losses.append(float(metrics["ce_loss"]))
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])


def test_converted_train_state_is_bit_exact():
    jcfg, _, jtcfg, _, _, _ = _setup("qwen2-1.5b",
                                     grad_compression="int8_ef")
    jst = jstep.init_state(jcfg, jtcfg, jax.random.PRNGKey(2))
    jst["opt"] = jst["opt"]._replace(step=jnp.int32(5))
    tst = convert.train_state_from_numpy(jax.tree.map(np.asarray, jst),
                                         "cpu")
    assert isinstance(tst["opt"], adamw.OptState)
    assert tst["opt"].step.dtype == torch.int32 and int(tst["opt"].step) == 5
    got = tree.flatten_with_path(tst)
    want = jax.tree_util.tree_flatten_with_path(jst)[0]
    assert len(got) == len(want)
    for (path, t), (_, w) in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w), err_msg=path)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def test_launch_train_runs_to_the_end_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "qwen2-1.5b", "--reduced", "--steps", "6",
            "--batch", "4", "--seq", "32", "--microbatches", "2",
            "--checkpoint-every", "2", "--inject-fault-at", "3",
            "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    assert train_cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "[memscope] placement plan:" in out
    assert "restarts=1" in out and "[train] done: 6 steps" in out
    r = train_cli.run(argv[:-6] + ["--ckpt-dir", str(tmp_path / "b"),
                                   "--device", "cpu", "--no-advice"],
                      verbose=False)
    assert r.result.final_step == 6 and r.result.restarts == 0
    assert all(np.isfinite(m["loss"]) for m in r.result.metrics_history)
    assert r.device == torch.device("cpu")


def test_launch_train_defaults_to_the_card():
    args = train_cli.parser().parse_args(["--arch", "qwen2-1.5b"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.run(["--arch", "qwen2-1.5b", "--reduced", "--steps",
                           "1", "--no-advice"], verbose=False)


def test_train_example_twin_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch",
                                      "train_tiny_lm.py"),
         "--device", "cpu", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "restarts=1" in out.stdout
    assert "[train] done: 60 steps" in out.stdout

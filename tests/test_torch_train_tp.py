"""Tensor-parallel training of the dense decoder: port vs reference, CPU.

The reference runs once, in a subprocess with 4 forced host devices (the
``run_forced`` pattern): its init and one GSPMD train step of qwen2-1.5b
on (1,2) ("head" mode: a KV head a rank) and (1,4) ("seq" with
``q_heads_tp``: a q head a rank, the KV heads whole), gemma3-1b (tied,
qk-norm, sliding window) on (2,2) and glm4-9b (qkv bias, untied) on
(1,2), all ``reduced()``, the last label of every row masked (-1).  The
port runs the same steps from the reference's init
(``tree.unflatten_like`` of its arrays) on 2 and 4 gloo ranks, each rank
its own interpreter joined within ``RANK_LIMIT`` (the ``spawn`` of
``tests/test_torch_distribution.py``), and on an unbound one-device mesh,
the port's (1,1).  Limits, set beforehand (those of the step on a mesh):
- the loss and the first parameter leaf within 3e-4 of the reference's on
  the same mesh and of the port's (1,1);
- ``grad_norm`` and every first-moment leaf within ``GRAD_REL`` = 1e-5
  (``_hold_gradient``): a Megatron *f* or a sum missed or doubled moves
  them by a factor;
- the differentiable collectives' gradients within 1e-12 of autograd's
  on the whole computation (float64);
- collectives counted, leaf shapes and tokens: exact.
"""
import json
import os
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models import blocks
from repro_torch.parallel import collectives, sharding
from repro_torch.train import step as step_mod

from test_torch_distribution import (_hold_gradient, planned_collectives,
                                     run_forced, spawn)

B, S = 4, 32
TCFG = dict(total_steps=5, warmup_steps=1, loss_chunk=16)
CASES = (("qwen2-1.5b", (1, 2)), ("glm4-9b", (1, 2)),
         ("qwen2-1.5b", (1, 4)), ("gemma3-1b", (2, 2)))


REF = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.configs.base import TrainConfig, get_config
from repro.parallel.sharding import make_rules
from repro.train import step as step_mod

def key(k):
    if hasattr(k, "key"):
        return str(k.key)
    if hasattr(k, "name"):
        return "." + k.name
    return str(k.idx)

def flat(t):
    return {"/".join(key(k) for k in kp): np.asarray(jax.device_get(v))
            for kp, v in jax.tree_util.tree_flatten_with_path(t)[0]}

tcfg = TrainConfig(**TCFG)
arrays, results = {}, {}
for arch, shape in CASES:
    cfg = get_config(arch).reduced()
    tok = (np.arange(B * S, dtype=np.int32).reshape(B, S) * 13) % cfg.vocab_size
    lab = np.roll(tok, -1, axis=1)
    lab[:, -1] = -1
    state = step_mod.init_state(cfg, tcfg, jax.random.PRNGKey(0))
    for k, v in flat(state).items():
        arrays[f"init/{arch}/{k}"] = v
    mesh = compat.make_mesh(shape, ("data", "model"))
    rules = make_rules(cfg, mesh, global_batch=B, shape_kind="train")
    specs = step_mod.state_specs(cfg, rules, tcfg, state["params"])
    state = jax.tree.map(lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)),
                         state, specs)
    bsh = NamedSharding(mesh, P(rules.batch if rules.batch else None, None))
    step = jax.jit(step_mod.make_train_step(cfg, rules, tcfg))
    new_state, metrics = step(state, jax.device_put(jnp.asarray(tok), bsh),
                              jax.device_put(jnp.asarray(lab), bsh), None)
    tag = f"{arch}/{shape}"
    results[tag] = {k: float(metrics[k]) for k in ("loss", "grad_norm")}
    arrays[f"first/{tag}"] = np.asarray(
        jax.device_get(jax.tree.leaves(new_state["params"])[0]), np.float32)
    for k, v in flat(new_state["opt"].m).items():
        arrays[f"m/{tag}/{k}"] = v
np.savez(OUT_PATH + ".npz", **arrays)
with open(OUT_PATH + ".json", "w") as fh:
    json.dump(results, fh)
"""


@pytest.fixture(scope="module")
def ref_steps(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref_tp") / "ref")
    body = (f"import json\nOUT_PATH = {path!r}\nB, S = {B}, {S}\n"
            f"TCFG = {TCFG!r}\nCASES = {CASES!r}\n" + REF)
    run_forced(body, n_devices=4)
    with open(path + ".json") as f:
        return path + ".npz", json.load(f)


# The port's rank program: the reference's init, the step on this rank's
# blocks and rows, the whole state gathered; rank 0 also runs the
# one-device step on an unbound (1,1) mesh.
PORT = """
from repro_torch import tree
from repro_torch.analysis import cost
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.parallel.sharding import make_rules
from repro_torch.train import step as step_mod

ref = np.load(REF)
tcfg = TrainConfig(**TCFG)
RES = {}

def batch(cfg):
    tok = (np.arange(B * S, dtype=np.int32).reshape(B, S) * 13) % cfg.vocab_size
    lab = np.roll(tok, -1, axis=1)
    lab[:, -1] = -1
    return torch.from_numpy(tok), torch.from_numpy(lab)

def init(arch, cfg):
    struct = step_mod.state_struct(cfg, tcfg)
    if f"init/{arch}/params/embed" not in ref:
        return step_mod.init_state(cfg, tcfg,
                                   torch.Generator().manual_seed(0))
    return tree.unflatten_like(struct, [
        torch.from_numpy(np.array(ref[f"init/{arch}/{p}"]))
        for p, _ in tree.flatten_with_path(struct)])

def run(arch, shape, seen=None, counted=False):
    cfg = get_config(arch).reduced()
    mesh = (make_host_mesh(*shape) if shape != (1, 1) else
            Mesh(("data", "model"), (1, 1)))
    rules = make_rules(cfg, mesh, global_batch=B)
    struct = step_mod.state_struct(cfg, tcfg)
    specs = step_mod.state_specs(cfg, rules, tcfg, struct["params"])
    sh = collectives.shardings_of(mesh, specs, struct)
    state = init(arch, cfg)
    if mesh.bound:
        state = collectives.shard_tree(state, sh)
    tokens, labels = batch(cfg)
    rows = collectives.block_slices(
        (B, S), step_mod.batch_specs(rules, cfg)[0], mesh)
    step = step_mod.make_train_step(cfg, rules, tcfg)
    out = {"split": step_mod.model_split(cfg, rules)}
    if counted:
        c = cost.analyze(step, state, tokens[rows], labels[rows])
        out["counted"] = [[o.kind, o.bytes_per_call, o.group_size]
                          for o in c.collectives]
        state = collectives.shard_tree(init(arch, cfg), sh)
    real = torch.autograd.grad
    def spy(outputs, inputs, *a, **k):
        if seen is not None:
            seen.append([list(t.shape) for t in inputs])
        return real(outputs, inputs, *a, **k)
    torch.autograd.grad = spy
    try:
        state, metrics = step(state, tokens[rows], labels[rows])
    finally:
        torch.autograd.grad = real
    out["metrics"] = {k: float(metrics[k]) for k in ("loss", "grad_norm")}
    whole = collectives.gather_tree(state, sh) if mesh.bound else state
    if RANK == 0:
        tag = f"{arch}_{shape[0]}x{shape[1]}"
        np.savez(os.path.join(OUT, tag + ".npz"),
                 **{p: t.numpy() for p, t in tree.flatten_with_path(whole)})
    return out
"""

TWO = """
for arch in ("qwen2-1.5b", "glm4-9b"):
    seen = []
    RES[arch, (1, 2)] = run(arch, (1, 2), seen=seen,
                            counted=(arch == "qwen2-1.5b"))
    RES[arch, (1, 2)]["leaves"] = seen[0]
    if RANK == 0:
        RES[arch, (1, 1)] = run(arch, (1, 1))

# serving on (1, 2): the engine's tokens against the unbound engine's
from repro_torch.models import lm
from repro_torch.serve import engine as eng
cfg = get_config("qwen2-1.5b").reduced()
params = lm.init_params(cfg, torch.Generator().manual_seed(0))
toks = torch.from_numpy(
    np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 16))).long()
for shape in ((1, 2), (1, 1)):
    mesh = (make_host_mesh(*shape) if shape != (1, 1) else
            Mesh(("data", "model"), (1, 1)))
    rules = make_rules(cfg, mesh, global_batch=2, shape_kind="decode")
    res = eng.ServeEngine(cfg, params, rules).generate(toks,
                                                       max_new_tokens=6)
    RES["serve", shape] = res.tokens.tolist()

# the differentiable collectives against autograd on the whole
# computation, float64: f and g around a column/row split, the gather
rng = np.random.default_rng(11)
x0 = torch.from_numpy(rng.standard_normal((3, 5, 8)))
a, bm = (torch.from_numpy(rng.standard_normal(s)) for s in ((8, 6), (6, 8)))
c = torch.from_numpy(rng.standard_normal((8, 4)))
w1, w2 = (torch.from_numpy(rng.standard_normal(s)) for s in ((3, 5, 8),
                                                            (3, 5, 4)))
g = collectives.axis_group(make_host_mesh(1, 2), ("model",))
cols = slice(3 * RANK, 3 * RANK + 3)
half = slice(2 * RANK, 2 * RANK + 2)
leaves = [t.clone().requires_grad_() for t in
          (x0, a[:, cols], bm[cols], c[:, half])]
x, ab, bb, cb = leaves
xc = collectives.tp_copy(x, g)
y = collectives.tp_sum(torch.tanh(xc @ ab) @ bb, g)
z = collectives.tp_all_gather(xc @ cb, -1, g)
((y * w1).sum() + (z * w2).sum()).backward()
RES["grads"] = [t.grad.tolist() for t in leaves]
RES["outs"] = [y.tolist(), z.tolist()]

with open(os.path.join(OUT, f"rank{RANK}.json"), "w") as f:
    json.dump({repr(k): v for k, v in RES.items()}, f)
"""

FOUR = """
RES["qwen2-1.5b", (1, 4)] = run("qwen2-1.5b", (1, 4))
RES["gemma3-1b", (2, 2)] = run("gemma3-1b", (2, 2), counted=True)
if RANK == 0:
    RES["qwen2-1.5b", (1, 1)] = run("qwen2-1.5b", (1, 1))
    RES["gemma3-1b", (1, 1)] = run("gemma3-1b", (1, 1))
with open(os.path.join(OUT, f"rank{RANK}.json"), "w") as f:
    json.dump({repr(k): v for k, v in RES.items()}, f)
"""


def _launch(tmp, world, body, ref_npz):
    prelude = f"REF = {ref_npz!r}\nB, S = {B}, {S}\nTCFG = {TCFG!r}\n"
    d = spawn(tmp, world, prelude + PORT + textwrap.dedent(body))
    recs = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return d, recs


@pytest.fixture(scope="module")
def two(ref_steps, tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("tp_two"), 2, TWO, ref_steps[0])


@pytest.fixture(scope="module")
def four(ref_steps, tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("tp_four"), 4, FOUR,
                   ref_steps[0])


def _get(rec, *key):
    return rec[repr(key if len(key) > 1 else key[0])]


def _state(d, arch, shape):
    return dict(np.load(os.path.join(d, f"{arch}_{shape[0]}x{shape[1]}.npz")))


def _moments(state):
    return {p[len("opt/.m/"):]: v for p, v in state.items()
            if p.startswith("opt/.m/")}


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1][0]}x"
                         f"{c[1][1]}")
def test_the_split_step_matches_the_reference(ref_steps, two, four, case):
    """One step of the dense decoder split over "model": the loss and the
    first leaf within 3e-4 of the reference's GSPMD step on the same mesh
    and of the port's (1,1); ``grad_norm`` and every first moment within
    ``GRAD_REL`` of both; every rank's metrics equal."""
    arch, shape = case
    d, recs = two if shape[0] * shape[1] == 2 else four
    ref_npz, ref_metrics = ref_steps
    ref = np.load(ref_npz)
    tag = f"{arch}/{shape}"
    got = _get(recs[0], arch, shape)
    assert got["split"] == "arithmetic"
    for r in recs[1:]:
        assert _get(r, arch, shape)["metrics"] == got["metrics"]
    state, base = _state(d, arch, shape), _state(d, arch, (1, 1))
    base_metrics = _get(recs[0], arch, (1, 1))["metrics"]
    loss, gnorm = got["metrics"]["loss"], got["metrics"]["grad_norm"]
    assert abs(loss - ref_metrics[tag]["loss"]) < 3e-4
    assert abs(loss - base_metrics["loss"]) < 3e-4
    np.testing.assert_allclose(state["params/embed"], ref[f"first/{tag}"],
                               atol=3e-4)
    np.testing.assert_allclose(state["params/embed"], base["params/embed"],
                               atol=3e-4)
    ref_m = {p: ref[f"m/{tag}/{p}"] for p in _moments(state)}
    _hold_gradient(tag, gnorm, _moments(state),
                   ref_metrics[tag]["grad_norm"], ref_m, "none")
    _hold_gradient(tag, gnorm, _moments(state), base_metrics["grad_norm"],
                   _moments(base), "none")


def test_the_split_step_takes_blocks_and_gathers_nothing_over_model(two):
    """On (1,2) autograd differentiates the rank's blocks (a cut leaf's
    shape is its block's), and the collectives ``analysis.cost`` counts
    are the split step's plan: no all-gather at all (no parameter over
    "model"; "data" is 1, so no ZeRO-1 refresh either)."""
    _, recs = two
    cfg = get_config("qwen2-1.5b").reduced()
    tcfg = TrainConfig(**TCFG)
    struct = step_mod.state_struct(cfg, tcfg)["params"]
    for r, rec in enumerate(recs):
        mesh = Mesh(("data", "model"), (1, 2), rank=r)
        rules = sharding.make_rules(cfg, mesh, global_batch=B)
        specs = tree.leaves(step_mod.state_specs(cfg, rules, tcfg,
                                                 struct)["params"])
        want = [list(collectives.block_shape(tuple(s.shape), sp, mesh))
                for s, sp in zip(tree.leaves(struct), specs)]
        got = _get(rec, "qwen2-1.5b", (1, 2))
        assert got["leaves"] == want
        assert any(w != list(s.shape)
                   for w, s in zip(want, tree.leaves(struct)))
        assert got["counted"] == planned_collectives(rules, tcfg, struct)
        assert not any(k == "all-gather" for k, _, _ in got["counted"])


def test_the_counted_collectives_follow_the_remat_periods(four):
    """gemma3-1b on (2,2): its layers form a period of two (local, then
    global attention) that ``lm.forward`` checkpoints whole, so the
    backward repeats both layers' forward sums (up to the second layer's
    ``w_out`` product) before either layer's *f* sums.  The collectives
    ``analysis.cost`` counts on every rank are the split step's plan."""
    _, recs = four
    cfg = get_config("gemma3-1b").reduced()
    plan = blocks.make_plan(cfg)
    assert plan.period > 1 and plan.n_full > 0
    tcfg = TrainConfig(**TCFG)
    struct = step_mod.state_struct(cfg, tcfg)["params"]
    for r, rec in enumerate(recs):
        rules = sharding.make_rules(
            cfg, Mesh(("data", "model"), (2, 2), rank=r), global_batch=B)
        assert step_mod.model_split(cfg, rules) == "arithmetic"
        got = _get(rec, "gemma3-1b", (2, 2))["counted"]
        assert got == planned_collectives(rules, tcfg, struct), r


def test_the_differentiable_collectives_give_autograds_gradients(two):
    """``tp_copy`` (f) and ``tp_sum`` (g) around a column/row split and
    ``tp_all_gather``'s backward on 2 ranks: every rank's outputs and
    gradients (of x whole, of its blocks) equal autograd's on the whole
    computation within 1e-12 (float64)."""
    _, recs = two
    rng = np.random.default_rng(11)
    x0 = torch.from_numpy(rng.standard_normal((3, 5, 8)))
    a, bm = (torch.from_numpy(rng.standard_normal(s))
             for s in ((8, 6), (6, 8)))
    c = torch.from_numpy(rng.standard_normal((8, 4)))
    w1, w2 = (torch.from_numpy(rng.standard_normal(s))
              for s in ((3, 5, 8), (3, 5, 4)))
    leaves = [t.clone().requires_grad_() for t in (x0, a, bm, c)]
    x, aw, bw, cw = leaves
    y = torch.tanh(x @ aw) @ bw
    z = x @ cw
    ((y * w1).sum() + (z * w2).sum()).backward()
    for r, rec in enumerate(recs):
        cols, half = slice(3 * r, 3 * r + 3), slice(2 * r, 2 * r + 2)
        want = [x.grad, aw.grad[:, cols], bw.grad[cols], cw.grad[:, half]]
        for g, w in zip(_get(rec, "grads"), want):
            np.testing.assert_allclose(np.array(g), w.numpy(), rtol=0,
                                       atol=1e-12)
        np.testing.assert_allclose(np.array(_get(rec, "outs")[0]),
                                   y.detach().numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(np.array(_get(rec, "outs")[1]),
                                   z.detach().numpy(), rtol=0, atol=1e-12)


def test_the_collectives_are_the_identity_alone():
    """On no group ``tp_copy``, ``tp_sum`` and ``tp_all_gather`` return
    their input itself; on a group of two where autograd does not record,
    ``tp_copy`` gives the input's values and records no gradient."""
    x = torch.ones(2, 3, requires_grad=True)
    assert collectives.tp_copy(x, None) is x
    assert collectives.tp_sum(x, None) is x
    assert collectives.tp_all_gather(x, -1, None) is x
    two = collectives.AxisGroup(("model",), (0, 1), None)
    with torch.no_grad():
        y = collectives.tp_copy(x, two)
    assert torch.equal(y, x) and y.grad_fn is None and not y.requires_grad


def test_serving_on_two_ranks_is_unchanged(two):
    """Serving qwen2-1.5b on (1,2) gives the unbound engine's tokens on
    every rank, through the same differentiable collectives as training
    (under no grad)."""
    _, recs = two
    want = _get(recs[0], "serve", (1, 1))
    for rec in recs:
        assert _get(rec, "serve", (1, 2)) == want


def test_the_rank_terms_of_the_cross_entropy_combine_to_chunked_ce():
    """:func:`vocab_ce_terms` once a block of 2 and 4, combined as the
    group would (a MAX of the maxima, a SUM of the rescaled sums and the
    label logits), and :func:`vocab_ce_grads` a block: the loss within
    1e-6 relative of ``chunked_ce`` on the whole vocabulary, the hidden's
    gradient (the blocks' shares summed) and each block's gradient within
    1e-6 of the largest element (float32)."""
    cfg = get_config("qwen2-1.5b").reduced()
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model))
                         .astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((cfg.padded_vocab, cfg.d_model))
                         .astype(np.float32) * 0.1).requires_grad_()
    y = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    y[:, -2:] = -1
    loss, _ = step_mod.chunked_ce({"embed": w}, h, y, cfg=cfg, chunk=16)
    loss.backward()
    loss = loss.detach()
    for n in (2, 4):
        rows = cfg.padded_vocab // n
        blocks = [w.detach()[i * rows:(i + 1) * rows] for i in range(n)]
        terms = [step_mod.vocab_ce_terms(h.detach(), y, blk, i * rows)
                 for i, blk in enumerate(blocks)]
        m = torch.stack([t[0] for t in terms]).amax(0)
        s = sum(t[1] * torch.exp(t[0] - m) for t in terms)
        ll = sum(t[2] for t in terms)
        lse = m + torch.log(s)
        got = torch.where(y >= 0, lse - ll, 0.0).sum()
        assert abs(float(got - loss)) <= 1e-6 * abs(float(loss))
        one = torch.ones(())
        grads = [step_mod.vocab_ce_grads(h.detach(), y, blk, i * rows, lse,
                                         one)
                 for i, blk in enumerate(blocks)]
        dh = sum(g[0] for g in grads)
        top = float(h.grad.abs().max())
        assert float((dh - h.grad).abs().max()) <= 1e-6 * top
        top = float(w.grad.abs().max())
        for i, (_, dw) in enumerate(grads):
            want = w.grad[i * rows:(i + 1) * rows]
            assert float((dw - want).abs().max()) <= 1e-6 * top


def test_model_split_names_each_configuration():
    """``model_split``: every family (dense, MoE, Mamba and hybrid) splits
    its arithmetic on a model axis of 2, and a model axis of 1 splits
    nothing."""
    for arch in ("gemma3-4b", "qwen2-1.5b", "gemma3-1b", "glm4-9b",
                 "musicgen-large", "internvl2-26b", "phi3.5-moe-42b-a6.6b",
                 "olmoe-1b-7b", "mamba2-370m", "jamba-v0.1-52b"):
        cfg = get_config(arch)
        for shape, k in (((1, 2), "arithmetic"), ((2, 1), "none")):
            rules = sharding.make_rules(cfg, Mesh(("data", "model"), shape),
                                        global_batch=8)
            assert step_mod.model_split(cfg, rules) == k, (arch, shape)

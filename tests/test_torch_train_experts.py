"""Training the MoE and Mamba-2 families split over "model": port vs
reference, CPU.

The reference runs once, in a subprocess with 4 forced host devices (the
``run_forced`` pattern): its init and one GSPMD train step of
olmoe-1b-7b, mamba2-370m and jamba-v0.1-52b on (1,2) and (2,2), and of
olmoe and mamba2 on (1,4), all ``reduced()`` (4 experts, 8 SSM heads:
every axis divides), the last label of every row masked (-1).  The port
runs the same steps from the reference's init on 2 and 4 gloo ranks,
each rank its own interpreter joined within ``RANK_LIMIT`` (the ``spawn``
of ``tests/test_torch_distribution.py``), and on an unbound one-device
mesh, the port's (1,1).  Limits, set beforehand (those of the dense
decoder's split step):
- the loss within 3e-4 of the reference's on the same mesh and of the
  port's (1,1); ``moe_drop_frac`` equal (the same drops on every rank);
- ``grad_norm`` and every first-moment leaf within ``GRAD_REL`` = 1e-5
  (``_hold_gradient``): a sum over the model group missed or doubled
  moves them by a factor;
- the MoE and Mamba layers' gradients on two ranks within 1e-12 of
  autograd's on the whole layer (float64);
- collectives counted: exact, against ``planned_collectives``.
A mamba2 with 2 SSM heads on (1,4) runs its layers whole (against the
port's (1,1), from the port's init), and one full-width Mamba layer's
gradient is finite where the reference's is NaN.
"""
import dataclasses
import inspect
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
from repro_torch.models import blocks, lm, mamba, moe
from repro_torch.parallel import collectives, sharding
from repro_torch.train import step as step_mod

from test_torch_distribution import (_hold_gradient, planned_collectives,
                                     run_forced, spawn)

B, S = 4, 32
TCFG = dict(total_steps=5, warmup_steps=1, loss_chunk=16)
FAMILIES = ("olmoe-1b-7b", "mamba2-370m", "jamba-v0.1-52b")
CASES = tuple((a, (1, 2)) for a in FAMILIES) + \
    tuple((a, (2, 2)) for a in FAMILIES) + \
    (("olmoe-1b-7b", (1, 4)), ("mamba2-370m", (1, 4)))
METRICS = ("loss", "grad_norm", "moe_drop_frac")
# mamba2-370m reduced with head_dim 64: 2 SSM heads, which a model axis
# of 4 does not divide (the port's own init; the reference has no such
# config)
NARROW = "mamba2-370m-2-heads"


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
    results[tag] = {k: float(metrics[k]) for k in METRICS if k in metrics}
    for k, v in flat(new_state["opt"].m).items():
        arrays[f"m/{tag}/{k}"] = v
np.savez(OUT_PATH + ".npz", **arrays)
with open(OUT_PATH + ".json", "w") as fh:
    json.dump(results, fh)
"""


@pytest.fixture(scope="module")
def ref_steps(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref_experts") / "ref")
    body = (f"import json\nOUT_PATH = {path!r}\nB, S = {B}, {S}\n"
            f"TCFG = {TCFG!r}\nCASES = {CASES!r}\nMETRICS = {METRICS!r}\n"
            + REF)
    run_forced(body, n_devices=4)
    with open(path + ".json") as f:
        return path + ".npz", json.load(f)


# The port's rank program: the reference's init, the step on this rank's
# blocks and rows (counted by ``analysis.cost`` first where asked, from a
# fresh state), the whole state gathered; rank 0 also runs the one-device
# step on an unbound (1,1) mesh.
PORT = """
import dataclasses
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

def config(arch):
    if arch != NARROW:
        return get_config(arch).reduced()
    base = get_config("mamba2-370m").reduced()
    return dataclasses.replace(base, ssm=dataclasses.replace(
        base.ssm, head_dim=64))

def init(arch, cfg):
    struct = step_mod.state_struct(cfg, tcfg)
    if f"init/{arch}/params/embed" not in ref:
        return step_mod.init_state(cfg, tcfg,
                                   torch.Generator().manual_seed(0))
    return tree.unflatten_like(struct, [
        torch.from_numpy(np.array(ref[f"init/{arch}/{p}"]))
        for p, _ in tree.flatten_with_path(struct)])

def run(arch, shape, counted=False):
    cfg = config(arch)
    mesh = (make_host_mesh(*shape) if shape != (1, 1) else
            Mesh(("data", "model"), (1, 1)))
    rules = make_rules(cfg, mesh, global_batch=B)
    struct = step_mod.state_struct(cfg, tcfg)
    specs = step_mod.state_specs(cfg, rules, tcfg, struct["params"])
    sh = collectives.shardings_of(mesh, specs, struct)
    fresh = lambda: (collectives.shard_tree(init(arch, cfg), sh)
                     if mesh.bound else init(arch, cfg))
    tokens, labels = batch(cfg)
    rows = collectives.block_slices(
        (B, S), step_mod.batch_specs(rules, cfg)[0], mesh)
    step = step_mod.make_train_step(cfg, rules, tcfg)
    out = {"split": step_mod.model_split(cfg, rules)}
    if counted:
        c = cost.analyze(step, fresh(), tokens[rows], labels[rows])
        out["counted"] = [[o.kind, o.bytes_per_call, o.group_size]
                          for o in c.collectives]
    state, metrics = step(fresh(), tokens[rows], labels[rows])
    out["metrics"] = {k: float(metrics[k]) for k in METRICS if k in metrics}
    whole = collectives.gather_tree(state, sh) if mesh.bound else state
    if RANK == 0:
        tag = f"{arch}_{shape[0]}x{shape[1]}"
        np.savez(os.path.join(OUT, tag + ".npz"),
                 **{p: t.numpy() for p, t in tree.flatten_with_path(whole)})
    return out
"""

TWO = """
for arch in FAMILIES:
    RES[arch, (1, 2)] = run(arch, (1, 2), counted=True)
    if RANK == 0:
        RES[arch, (1, 1)] = run(arch, (1, 1))

# one MoE and one Mamba layer in float64 on the model group of two, each
# rank's leaves as the step hands them, against autograd on the whole
# layer (the test's side)
from repro_torch.models import mamba, moe
mesh = make_host_mesh(1, 2)
for arch, sub in (("olmoe-1b-7b", "moe"), ("mamba2-370m", "ssm")):
    cfg = get_config(arch).reduced()
    rules = make_rules(cfg, mesh, global_batch=B)
    tp = collectives.tensor_parallel(rules)
    lp, x, w = layer64(cfg, sub)
    loc = {}
    for k, v in lp.items():
        path = f"tail/t0/{sub}/{k}"
        if sub == "ssm" and k in step_mod.HEAD_ALIGNED:
            loc[k] = v.clone()
        else:
            loc[k] = v[collectives.block_slices(
                tuple(v.shape), lm.param_spec(rules, path, v.shape),
                mesh)].clone()
        loc[k].requires_grad_()
    xr = x.clone().requires_grad_()
    if sub == "moe":
        y, aux = moe.moe_apply(loc, xr, cfg, dropless=False, tp=tp)
        loss = ((y * w).sum() + aux["moe_aux_loss"] + aux["moe_z_loss"])
        RES["drop64", arch] = float(aux["moe_drop_frac"])
    else:
        y, _ = mamba.mamba_layer(loc, xr, cfg=cfg, mode="train", tp=tp)
        loss = (y * w).sum()
    loss.backward()
    RES["grads64", arch] = {"x": xr.grad.tolist(), "y": y.tolist(),
                            **{k: v.grad.tolist() for k, v in loc.items()}}

with open(os.path.join(OUT, f"rank{RANK}.json"), "w") as f:
    json.dump({repr(k): v for k, v in RES.items()}, f)
"""

FOUR = """
for arch in FAMILIES:
    RES[arch, (2, 2)] = run(arch, (2, 2), counted=(arch == "jamba-v0.1-52b"))
for arch in ("olmoe-1b-7b", "mamba2-370m"):
    RES[arch, (1, 4)] = run(arch, (1, 4))
RES[NARROW, (1, 4)] = run(NARROW, (1, 4), counted=True)
if RANK == 0:
    RES[NARROW, (1, 1)] = run(NARROW, (1, 1))
with open(os.path.join(OUT, f"rank{RANK}.json"), "w") as f:
    json.dump({repr(k): v for k, v in RES.items()}, f)
"""

def layer64(cfg, sub):
    """The first layer with a ``sub`` ("moe", "ssm") of the model's init
    from seed 0, unstacked, in float64; a seeded input and upstream
    gradient (2, 16, d_model)."""
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    i = next(i for i in range(cfg.n_layers)
             if (cfg.layer_is_moe(i) if sub == "moe"
                 else cfg.layer_kind(i) == "ssm"))
    period = blocks.make_plan(cfg).period
    node = params["scan"][f"p{i % period}"][sub]
    lp = {k: v[0].detach().to(torch.float64) for k, v in node.items()}
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model)))
    w = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model)))
    return lp, x, w


def _launch(tmp, world, body, ref_npz):
    prelude = (f"REF = {ref_npz!r}\nB, S = {B}, {S}\nTCFG = {TCFG!r}\n"
               f"FAMILIES = {FAMILIES!r}\nMETRICS = {METRICS!r}\n"
               f"NARROW = {NARROW!r}\n"
               "from repro_torch.models import blocks, lm\n"
               + inspect.getsource(layer64))
    d = spawn(tmp, world, prelude + PORT + textwrap.dedent(body))
    recs = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return d, recs


@pytest.fixture(scope="module")
def two(ref_steps, tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("ex_two"), 2, TWO, ref_steps[0])


@pytest.fixture(scope="module")
def four(ref_steps, tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("ex_four"), 4, FOUR,
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
    """One step split over "model" (experts and SSM heads): the loss
    within 3e-4 of the reference's GSPMD step on the same mesh and of the
    port's (1,1), ``moe_drop_frac`` equal to both; ``grad_norm`` and
    every first moment within ``GRAD_REL`` of both; every rank's metrics
    equal."""
    arch, shape = case
    d, recs = two if shape[0] * shape[1] == 2 else four
    ref_npz, ref_metrics = ref_steps
    ref = np.load(ref_npz)
    tag = f"{arch}/{shape}"
    got = _get(recs[0], arch, shape)
    assert got["split"] == "arithmetic"
    for r in recs[1:]:
        assert _get(r, arch, shape)["metrics"] == got["metrics"]
    base_metrics = _get(two[1][0], arch, (1, 1))["metrics"]
    want = ref_metrics[tag]
    assert abs(got["metrics"]["loss"] - want["loss"]) < 3e-4
    assert abs(got["metrics"]["loss"] - base_metrics["loss"]) < 3e-4
    if "moe_drop_frac" in want:
        drop = got["metrics"]["moe_drop_frac"]
        assert drop == base_metrics["moe_drop_frac"]
        assert abs(drop - want["moe_drop_frac"]) <= 1e-7, (drop, want)
    state, base = _state(d, arch, shape), _state(two[0], arch, (1, 1))
    ref_m = {p: ref[f"m/{tag}/{p}"] for p in _moments(state)}
    gnorm = got["metrics"]["grad_norm"]
    _hold_gradient(tag, gnorm, _moments(state), want["grad_norm"], ref_m,
                   "none")
    _hold_gradient(tag, gnorm, _moments(state), base_metrics["grad_norm"],
                   _moments(base), "none")


def _narrow_config():
    base = get_config("mamba2-370m").reduced()
    return dataclasses.replace(base, ssm=dataclasses.replace(
        base.ssm, head_dim=64))


def test_a_mamba_layer_whose_heads_do_not_divide_runs_whole(four):
    """mamba2-370m with 2 SSM heads on (1,4): the heads do not divide, so
    its layers run whole on every rank.  The step gathers every Mamba leaf
    the spec cuts (``conv_w``, ``ssm_norm``, ``w_ssm_out``) and each rank
    keeps its block of the identical gradient: the loss within 3e-4 of
    the port's (1,1), ``grad_norm`` and every first moment within
    ``GRAD_REL``, every rank's metrics equal, and the counted collectives
    ``planned_collectives``' (those three gathers, and no layer sum)."""
    d, recs = four
    cfg = _narrow_config()
    assert cfg.ssm.n_heads(cfg.d_model) == 2
    got = _get(recs[0], NARROW, (1, 4))
    base = _get(recs[0], NARROW, (1, 1))
    assert got["split"] == "arithmetic"
    for r in recs[1:]:
        assert _get(r, NARROW, (1, 4))["metrics"] == got["metrics"]
    assert abs(got["metrics"]["loss"] - base["metrics"]["loss"]) < 3e-4
    _hold_gradient(NARROW, got["metrics"]["grad_norm"],
                   _moments(_state(d, NARROW, (1, 4))),
                   base["metrics"]["grad_norm"],
                   _moments(_state(d, NARROW, (1, 1))), "none")
    tcfg = TrainConfig(**TCFG)
    struct = step_mod.state_struct(cfg, tcfg)["params"]
    for r, rec in enumerate(recs):
        rules = sharding.make_rules(cfg, Mesh(("data", "model"), (1, 4),
                                              rank=r), global_batch=B)
        counted = _get(rec, NARROW, (1, 4))["counted"]
        assert counted == planned_collectives(rules, tcfg, struct), r
        assert [c[0] for c in counted].count("all-gather") == 3


def _whole64(arch, sub):
    """Autograd on the whole float64 layer: (output, x's gradient, every
    leaf's gradient, the drop share)."""
    cfg = get_config(arch).reduced()
    lp, x, w = layer64(cfg, sub)
    lp = {k: v.clone().requires_grad_() for k, v in lp.items()}
    xr = x.clone().requires_grad_()
    drop = None
    if sub == "moe":
        y, aux = moe.moe_apply(lp, xr, cfg, dropless=False)
        loss = (y * w).sum() + aux["moe_aux_loss"] + aux["moe_z_loss"]
        drop = float(aux["moe_drop_frac"])
    else:
        y, _ = mamba.mamba_layer(lp, xr, cfg=cfg, mode="train")
        loss = (y * w).sum()
    loss.backward()
    return cfg, y.detach(), xr.grad, {k: v.grad for k, v in lp.items()}, drop


@pytest.mark.parametrize("arch,sub", [("olmoe-1b-7b", "moe"),
                                      ("mamba2-370m", "ssm")])
def test_the_layer_gradients_on_two_ranks_are_autograds(two, arch, sub):
    """Float64, a model group of two: each rank's output and gradient of
    ``x`` equal the whole layer's, each spec block's gradient (an expert
    block; ``A_log``, ``dt_bias``, ``ssm_D``, ``ssm_norm``,
    ``w_ssm_out``) the whole gradient's slice, the router's the whole
    router's on every rank, and the head-aligned Mamba leaves' whole-shaped
    gradients summed over the ranks (B/C columns included) the whole
    gradient, within 1e-12; the MoE's drops equal."""
    _, recs = two
    cfg, y, gx, gl, drop = _whole64(arch, sub)
    rules = sharding.make_rules(cfg, Mesh(("data", "model"), (1, 2)),
                                global_batch=B)
    summed = {}
    for r, rec in enumerate(recs):
        got = _get(rec, "grads64", arch)
        np.testing.assert_allclose(np.array(got["y"]), y.numpy(), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(np.array(got["x"]), gx.numpy(), rtol=0,
                                   atol=1e-12)
        if drop is not None:
            assert _get(rec, "drop64", arch) == drop
        mesh = Mesh(("data", "model"), (1, 2), rank=r)
        for k, g in gl.items():
            gr = np.array(got[k])
            if sub == "ssm" and k in step_mod.HEAD_ALIGNED:
                assert gr.shape == tuple(g.shape)
                summed[k] = summed.get(k, 0) + gr
                continue
            sl = collectives.block_slices(
                tuple(g.shape),
                lm.param_spec(rules, f"tail/t0/{sub}/{k}", g.shape), mesh)
            if k in ("we_in", "we_gate", "we_out", "A_log", "w_ssm_out"):
                assert gr.shape != tuple(g.shape), k
            np.testing.assert_allclose(gr, g[sl].numpy(), rtol=0,
                                       atol=1e-12, err_msg=k)
    for k, v in summed.items():
        np.testing.assert_allclose(v, gl[k].numpy(), rtol=0, atol=1e-12,
                                   err_msg=k)



@pytest.mark.parametrize("arch,shape", [(a, (1, 2)) for a in FAMILIES]
                         + [("jamba-v0.1-52b", (2, 2))],
                         ids=lambda v: v if isinstance(v, str)
                         else f"{v[0]}x{v[1]}")
def test_the_counted_collectives_are_the_split_plan(two, four, arch, shape):
    """The collectives ``analysis.cost`` counts on every rank are
    ``planned_collectives``': the MoE gates' sum and the Mamba sum of
    squares' sums in both directions among the layers' sums, and the only
    all-gathers over "model" those of the Mamba leaves a rank computes on
    by head-aligned columns that the spec cuts (``w_zxbcdt``, ``conv_w``;
    ``conv_b`` is replicated), each followed by one sum of its gradient."""
    _, recs = two if shape == (1, 2) else four
    cfg = get_config(arch).reduced()
    tcfg = TrainConfig(**TCFG)
    struct = step_mod.state_struct(cfg, tcfg)["params"]
    for r, rec in enumerate(recs):
        rules = sharding.make_rules(cfg, Mesh(("data", "model"), shape,
                                              rank=r), global_batch=B)
        got = _get(rec, arch, shape)["counted"]
        assert got == planned_collectives(rules, tcfg, struct), r
        gathers = [c for c in got if c[0] == "all-gather"]
        if shape == (1, 2):
            assert len(gathers) == (2 if cfg.ssm else 0)
            if cfg.moe:
                gate = B * S * cfg.moe.top_k * 4
                assert ["all-reduce", gate, 2] in got
            if cfg.ssm:
                # three a Mamba layer (forward, recompute, backward), and
                # each CE chunk's SUM of two (B, 16) float32 rows
                chunks = S // TCFG["loss_chunk"]
                assert got.count(["all-reduce", B * S * 4, 2]) == \
                    3 * sum(cfg.layer_kind(i) == "ssm"
                            for i in range(cfg.n_layers)) + chunks


SSD_REF = """
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_config
from repro.models import mamba
cfg = dataclasses.replace(get_config("mamba2-370m"), n_layers=1)
p = mamba.mamba_init(jax.random.PRNGKey(0), cfg, jnp.float32)
x = jax.random.normal(jax.random.PRNGKey(1), (1, 512, cfg.d_model))
def loss(p, x):
    y, _ = mamba.mamba_layer(p, x, cfg=cfg, mode="train")
    return (y ** 2).sum()
y, _ = mamba.mamba_layer(p, x, cfg=cfg, mode="train")
g = jax.grad(loss)(p, x)
out = {"x": np.asarray(x), "y": np.asarray(y)}
out.update({"p/" + k: np.asarray(v) for k, v in p.items()})
out.update({"g/" + k: np.asarray(v) for k, v in g.items()})
np.savez(OUT_PATH, **out)
"""


def test_the_ssd_gradient_is_finite_at_a_full_chunk(tmp_path):
    """One Mamba layer of mamba2-370m at full width (32 heads, chunk 256)
    over 512 tokens, float32, from the reference's init: the reference
    masks ``exp(seg_i - seg_j)`` after the exp, so where the exponent
    overflows above the diagonal its gradient of ``w_zxbcdt``, ``A_log``
    and ``dt_bias`` is NaN (inf times the mask's 0).  The port masks the
    exponent: the same output within 1e-4 of the reference's largest
    element, every gradient finite, and the gradients the reference gets
    finite within 1e-4 of their largest element."""
    path = str(tmp_path / "ssd.npz")
    run_forced(f"import dataclasses\nOUT_PATH = {path!r}\n" + SSD_REF,
               n_devices=1)
    ref = np.load(path)
    cfg = dataclasses.replace(get_config("mamba2-370m"), n_layers=1)
    params = {k[2:]: torch.from_numpy(ref[k].copy()).requires_grad_()
              for k in ref.files if k.startswith("p/")}
    y, _ = mamba.mamba_layer(params, torch.from_numpy(ref["x"].copy()),
                             cfg=cfg, mode="train")
    (y ** 2).sum().backward()
    scale = float(np.abs(ref["y"]).max())
    assert float((y.detach() - torch.from_numpy(ref["y"])).abs().max()) \
        <= 1e-4 * scale
    nan = [k for k in params if not np.isfinite(ref["g/" + k]).all()]
    assert sorted(nan) == ["A_log", "dt_bias", "w_zxbcdt"]
    for k, p in params.items():
        assert bool(torch.isfinite(p.grad).all()), k
        if k not in nan:
            want = ref["g/" + k]
            np.testing.assert_allclose(
                p.grad.numpy(), want, rtol=0,
                atol=1e-4 * float(np.abs(want).max()), err_msg=k)

"""Port vs reference for the multi-device layer, on the CPU.

The reference runs in subprocesses with forced host devices (the
``run_forced`` pattern of ``tests/test_distribution.py``): 512 devices to
dump every spec tree as JSON, 8 to run its train step on the (1,1), (2,2)
and (4,2) meshes and its ``compressed_psum``.  The port runs in 1, 4 and
8 processes over ``gloo`` (``torch.distributed``), each rank its own
interpreter, meeting in a file store under the test's temporary directory
(no TCP port, so parallel test workers cannot collide), one thread each.
Every multi-rank launch is joined with its own time limit (``RANK_LIMIT``,
under 240 s), its ranks killed when the limit passes, and every rank
destroys its group in a ``finally``.  Every subprocess runs at the lowest
priority, so that the suite's other workers keep their CPU.

Weights and the train state come from the reference's own init, carried
over by ``repro_torch.models.convert``; tokens from numpy.  Limits, set
beforehand:
- specs: equal, entry for entry, for all ten configs at full size on the
  five meshes;
- a train step on a mesh: the loss and the first parameter leaf within
  3e-4 of the reference's on the same mesh and of the port's own (1,1)
  (at step 1 AdamW moves an element by about ``lr`` = 3e-4; the
  placements change only the order of sums); the gradient's scale, by
  ``grad_norm`` and every first-moment leaf, within 1e-5 (with int8_ef,
  where the two sides quantize different things, within 1e-3 and two
  int8 levels);
- ``compressed_psum``: within the int8 scale of the exact mean, within
  1e-6 of the scale of the reference's output;
- ZeRO-1: each rank's moment bytes its blocks' share; the gathered
  moments within 3e-4 of the one-device moments (and, tighter, 1e-5 of
  each leaf's largest);
- ``elastic_remesh``: bit-equal.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, MeshConfig, TrainConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import blocks, lm
from repro_torch.optim import adamw
from repro_torch.parallel import collectives, sharding
from repro_torch.train import step as step_mod

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
RANK_LIMIT = 200            # seconds for one multi-rank launch
REF_LIMIT = 420             # seconds for one reference subprocess
CONFIGS = ("gemma3-4b", "qwen2-1.5b", "gemma3-1b", "glm4-9b",
           "phi3.5-moe-42b-a6.6b", "olmoe-1b-7b", "musicgen-large",
           "internvl2-26b", "mamba2-370m", "jamba-v0.1-52b")
MESHES = ((1, 1), (2, 2), (4, 2), (16, 16), (2, 16, 16))
TRAIN_MESHES = ((1, 1), (2, 2), (4, 2))
B, S = 4, 32


def _axes(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


# ---------------------------------------------------------------------------
# Subprocess plumbing
# ---------------------------------------------------------------------------


def _low_priority():
    """The ranks of this file yield the CPU to the suite's other workers,
    whose wall-clock tests would otherwise feel 8 ranks.  The reference
    runs at the normal priority: its test waits for it, and at the lowest
    one the other workers starve it past its limit."""
    os.nice(19)


def run_forced(body: str, n_devices: int, timeout: int = REF_LIMIT) -> str:
    """The reference in a fresh interpreter with forced host devices."""
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = \
            "--xla_force_host_platform_device_count={n_devices}"
        os.environ["JAX_PLATFORMS"] = "cpu"
        {textwrap.indent(textwrap.dedent(body), '        ').strip()}
        print("SUBPROC_OK")
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, env=env)
    assert r.returncode == 0, f"stderr:\n{r.stderr[-3000:]}"
    assert "SUBPROC_OK" in r.stdout
    return r.stdout


RANK_PRELUDE = """
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
STORE, OUT = sys.argv[3], sys.argv[4]
from repro_torch.parallel import collectives
collectives.setup("gloo", store_path=STORE, rank=RANK, world_size=WORLD)
try:
{body}
finally:
    collectives.teardown()
"""


def spawn(tmp, world: int, body: str, limit: int = RANK_LIMIT):
    """Run ``body`` on ``world`` gloo ranks (each its own interpreter),
    joined within ``limit`` seconds; a rank still running then is killed
    and the launch fails.  ``body`` reads RANK, WORLD, STORE (the file
    store) and OUT (a directory for its results)."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    store = os.path.join(tmp, "store")
    if os.path.exists(store):
        os.remove(store)
    out = os.path.join(tmp, "out")
    os.makedirs(out, exist_ok=True)
    code = RANK_PRELUDE.format(body=textwrap.indent(
        textwrap.dedent(body).strip(), "    "))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    env.pop("RANK", None)
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), store, out],
        env=env, stdout=logs[r], stderr=subprocess.STDOUT,
        preexec_fn=_low_priority)
        for r in range(world)]
    import time
    deadline = time.monotonic() + limit
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"{world} ranks ran past {limit} s: "
                    + _tail(tmp, world))
    finally:
        for f in logs:
            f.close()
    codes = [p.returncode for p in procs]
    assert codes == [0] * world, f"exit codes {codes}: " + _tail(tmp, world)
    return out


def _tail(tmp, world):
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.log")) as f:
            out.append(f"--- rank {r}\n" + f.read()[-2000:])
    return "\n".join(out)


# ---------------------------------------------------------------------------
# (1) Specs: every config at full size on five meshes
# ---------------------------------------------------------------------------

REF_SPECS = """
import json
import jax
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.configs.base import SHAPES, TrainConfig, get_config
from repro.launch.mesh import make_production_mesh
from repro.models import lm
from repro.optim import adamw
from repro.parallel.sharding import make_rules
from repro.train import step as step_mod

def sj(s):
    return [None if e is None else (e if isinstance(e, str) else list(e))
            for e in s]

def key(k):
    if hasattr(k, "key"):
        return str(k.key)
    if hasattr(k, "name"):
        return "." + k.name
    return str(k.idx)

def flat(t):
    leaves = jax.tree_util.tree_flatten_with_path(
        t, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(key(k) for k in kp): sj(v) for kp, v in leaves}

def rules_json(r):
    out = {"batch": list(r.batch), "tp": r.tp, "attn_mode": r.attn_mode,
           "kv_seq_axes": list(r.kv_seq_axes), "q_heads_tp": r.q_heads_tp}
    for name in ("hidden_spec", "ffn_spec", "q_spec", "kv_spec",
                 "kv_cache_spec", "logits_spec", "q_seq_spec",
                 "kv_rep_spec", "ssm_state_spec", "dispatch_spec"):
        out[name] = sj(getattr(r, name)())
    for nb in (1, 4, 16):
        out[f"blocked_q_spec/{nb}"] = sj(r.blocked_q_spec(nb))
        out[f"blocked_kv_spec/{nb}"] = sj(r.blocked_kv_spec(nb))
    return out

res = {"production": {}}
for mp in (False, True):
    m = make_production_mesh(multi_pod=mp)
    res["production"][str(mp)] = [list(m.axis_names), list(m.devices.shape)]
for shape in MESHES:
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    mesh = compat.make_mesh(shape, axes)
    for name in CONFIGS:
        cfg = get_config(name)
        ps = jax.eval_shape(lambda: lm.init_params(cfg, jax.random.PRNGKey(0)))
        r = make_rules(cfg, mesh, global_batch=SHAPES["train_4k"].global_batch)
        rec = {"rules": rules_json(r), "params": flat(lm.param_specs(r, ps))}
        for z in (False, True):
            rec[f"opt/{z}"] = flat(adamw.opt_specs(lm.param_specs(r, ps), ps,
                                                   mesh, zero1=z))
        tc = TrainConfig(grad_compression="int8_ef")
        rec["state"] = flat(step_mod.state_specs(cfg, r, tc, ps))
        rec["batch"] = [sj(s) if s is not None else None
                        for s in step_mod.batch_specs(r, cfg)[:2]]
        fe = step_mod.batch_specs(r, cfg)[2]
        rec["frontend"] = None if fe is None else {k: sj(v) for k, v in fe.items()}
        for sname in ("decode_32k", "long_500k"):
            sh = SHAPES[sname]
            rd = make_rules(cfg, mesh, global_batch=sh.global_batch,
                            shape_kind="decode")
            cs = lm.cache_struct(cfg, sh.global_batch, sh.seq_len)
            rec[f"rules/{sname}"] = rules_json(rd)
            rec[f"cache/{sname}"] = flat(lm.cache_specs(rd, cs))
        res[f"{shape}/{name}"] = rec
with open(OUT_PATH, "w") as f:
    json.dump(res, f)
"""


def _sj(s):
    return [None if e is None else (e if isinstance(e, str) else list(e))
            for e in s]


def _flat(t):
    return {path: _sj(v) for path, v in tree.flatten_with_path(t)}


def _rules_json(r):
    out = {"batch": list(r.batch), "tp": r.tp, "attn_mode": r.attn_mode,
           "kv_seq_axes": list(r.kv_seq_axes), "q_heads_tp": r.q_heads_tp}
    for name in ("hidden_spec", "ffn_spec", "q_spec", "kv_spec",
                 "kv_cache_spec", "logits_spec", "q_seq_spec",
                 "kv_rep_spec", "ssm_state_spec", "dispatch_spec"):
        out[name] = _sj(getattr(r, name)())
    for nb in (1, 4, 16):
        out[f"blocked_q_spec/{nb}"] = _sj(r.blocked_q_spec(nb))
        out[f"blocked_kv_spec/{nb}"] = _sj(r.blocked_kv_spec(nb))
    return out


@pytest.fixture(scope="module")
def ref_specs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("specs") / "ref.json")
    body = (f"OUT_PATH = {path!r}\nMESHES = {MESHES!r}\n"
            f"CONFIGS = {CONFIGS!r}\n" + REF_SPECS)
    run_forced(body, n_devices=512)
    with open(path) as f:
        return json.load(f)


def test_production_meshes_match_the_reference(ref_specs):
    for mp in (False, True):
        m = mesh_mod.make_production_mesh(multi_pod=mp)
        assert [list(m.axis_names), list(m.shape)] == \
            ref_specs["production"][str(mp)]
        assert not m.bound and m.rank is None
    assert mesh_mod.make_production_mesh().size == 256
    assert mesh_mod.make_production_mesh(multi_pod=True).size == 512
    mc = mesh_mod.mesh_from_config(MeshConfig(data=2, model=4, pods=2))
    assert (mc.axis_names, mc.shape) == (("pod", "data", "model"), (2, 2, 4))
    assert mesh_mod.describe(mc) == "pod=2xdata=2xmodel=4"


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_every_spec_tree_equals_the_reference(ref_specs, shape):
    """Rules, activation specs, param/opt/state/batch/cache specs of all
    ten configs at full size, computed with no process group."""
    mesh = mesh_mod.Mesh(_axes(shape), shape)
    for name in CONFIGS:
        want = ref_specs[f"{shape}/{name}"]
        cfg = get_config(name)
        ps = lm.param_struct(cfg)
        r = sharding.make_rules(cfg, mesh,
                                global_batch=SHAPES["train_4k"].global_batch)
        got = {"rules": _rules_json(r),
               "params": _flat(lm.param_specs(r, ps))}
        for z in (False, True):
            got[f"opt/{z}"] = _flat(adamw.opt_specs(
                lm.param_specs(r, ps), ps, mesh, zero1=z))
        tc = TrainConfig(grad_compression="int8_ef")
        got["state"] = _flat(step_mod.state_specs(cfg, r, tc, ps))
        toks, labels, fe = step_mod.batch_specs(r, cfg)
        got["batch"] = [_sj(toks), _sj(labels)]
        got["frontend"] = (None if fe is None
                           else {k: _sj(v) for k, v in fe.items()})
        for sname in ("decode_32k", "long_500k"):
            sh = SHAPES[sname]
            rd = sharding.make_rules(cfg, mesh, global_batch=sh.global_batch,
                                     shape_kind="decode")
            cs = lm.cache_struct(cfg, sh.global_batch, sh.seq_len)
            got[f"rules/{sname}"] = _rules_json(rd)
            got[f"cache/{sname}"] = _flat(lm.cache_specs(rd, cs))
        assert got == want, (shape, name)


def test_logical_to_spec_and_constrain():
    cfg = get_config("olmoe-1b-7b")
    mesh = mesh_mod.Mesh(("data", "model"), (2, 4))
    r = sharding.make_rules(cfg, mesh, global_batch=8)
    ps = lm.param_struct(cfg)
    specs = sharding.logical_to_spec(r, ps)
    assert specs["embed"] == sharding.P("model", None)
    assert specs["final_norm"] == sharding.P(None)
    x = torch.ones(2, 3)
    assert sharding.constrain(x, mesh, r.hidden_spec()) is x
    cst = step_mod.make_constrain(r)
    for name in ("hidden", "ffn", "kv", "dispatch", "logits", "q_seq",
                 "kv_rep", "other"):
        assert cst(x, name) is x
    assert cst(torch.ones(2, 4, 3), "blocked_q").shape == (2, 4, 3)


def test_state_struct_allocates_nothing():
    cfg = get_config("jamba-v0.1-52b")
    st = step_mod.state_struct(cfg, TrainConfig(grad_compression="int8_ef"))
    leaves = tree.leaves(st)
    assert all(t.is_meta for t in leaves)
    n = sum(t.numel() for t in tree.leaves(st["params"]))
    assert n == sum(t.numel() for t in tree.leaves(st["opt"].m))
    assert all(t.dtype == torch.float32 for t in tree.leaves(st["opt"]) if
               t.dim())
    assert st["opt"].step.dtype == torch.int32
    assert set(st) == {"params", "opt", "err"}


def test_host_mesh_shrinks_to_the_world_without_a_group():
    for data, model in ((1, 1), (2, 1), (1, 4), (2, 2)):
        m = mesh_mod.make_host_mesh(data, model)
        assert (m.axis_names, m.shape) == (("data", "model"), (1, 1))
        assert not m.bound and m.coords == {"data": 0, "model": 0}


def test_block_slices_follow_the_mesh_order():
    mesh = mesh_mod.Mesh(("pod", "data", "model"), (2, 2, 2))
    shape = (8, 6)
    spec = sharding.P(("pod", "data"), "model")
    seen = np.zeros(shape, int)
    for r in range(8):
        coords = mesh_mod.Mesh(mesh.axis_names, mesh.shape, r).coords
        sl = collectives.block_slices(shape, spec, mesh, coords)
        seen[sl] += 1
        assert sl[0] == slice(2 * (2 * coords["pod"] + coords["data"]),
                              2 * (2 * coords["pod"] + coords["data"]) + 2)
        assert sl[1] == slice(3 * coords["model"], 3 * coords["model"] + 3)
    assert (seen == 1).all()
    assert collectives.block_shape(shape, spec, mesh) == (2, 3)
    with pytest.raises(ValueError, match="divide"):
        collectives.block_slices((5,), sharding.P("model"), mesh,
                                 {"pod": 0, "data": 0, "model": 0})


# ---------------------------------------------------------------------------
# (2)-(5) The train step, compressed_psum, ZeRO-1, elastic re-mesh
# ---------------------------------------------------------------------------

REF_TRAIN = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.configs.base import TrainConfig, get_config
from repro.parallel import compression
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

cfg = get_config("qwen2-1.5b").reduced()
tokens = (jnp.arange(B * S, dtype=jnp.int32).reshape(B, S) * 13) % cfg.vocab_size
labels = jnp.roll(tokens, -1, axis=1)
arrays = {}
results = {}
for comp in ("none", "int8_ef"):
    tcfg = TrainConfig(total_steps=5, warmup_steps=1, loss_chunk=16,
                       grad_compression=comp)
    init = step_mod.init_state(cfg, tcfg, jax.random.PRNGKey(0))
    for k, v in flat(init).items():
        arrays[f"init/{comp}/{k}"] = v
for shape, mb, comp in CASES:
    tcfg = TrainConfig(total_steps=5, warmup_steps=1, loss_chunk=16,
                       grad_compression=comp)
    mesh = compat.make_mesh(shape, ("data", "model"))
    rules = make_rules(cfg, mesh, global_batch=B, shape_kind="train")
    state = step_mod.init_state(cfg, tcfg, jax.random.PRNGKey(0))
    specs = step_mod.state_specs(cfg, rules, tcfg, state["params"])
    sh = jax.tree.map(lambda s, sp: NamedSharding(mesh, sp), state, specs)
    state = jax.tree.map(lambda x, s: jax.device_put(x, s), state, sh)
    bsh = NamedSharding(mesh, P(rules.batch if rules.batch else None, None))
    step = jax.jit(step_mod.make_train_step(cfg, rules, tcfg, microbatches=mb))
    new_state, metrics = step(state, jax.device_put(tokens, bsh),
                              jax.device_put(labels, bsh), None)
    tag = f"{shape}/{mb}/{comp}"
    results[tag] = float(metrics["loss"])
    results[tag + "/grad_norm"] = float(metrics["grad_norm"])
    arrays[f"first/{tag}"] = np.asarray(
        jax.device_get(jax.tree.leaves(new_state["params"])[0]), np.float32)
    for k, v in flat(new_state["opt"].m).items():
        arrays[f"m/{tag}/{k}"] = v

# compressed_psum on 8 devices, the inputs of tests/test_distribution.py
mesh = compat.make_mesh((8,), ("data",))
def f(g):
    err = jax.tree.map(lambda x: jnp.zeros_like(x), g)
    mean, _ = compression.compressed_psum(g, err, "data")
    exact = jax.tree.map(lambda x: jax.lax.pmean(x, "data"), g)
    return mean, exact
g = {"w": jax.random.normal(jax.random.PRNGKey(0), (8, 64))}
fm = compat.shard_map(f, mesh=mesh, in_specs=({"w": P("data")},),
                      out_specs=({"w": P("data")}, {"w": P("data")}))
mean, exact = fm(g)
arrays["psum/g"] = np.asarray(g["w"])
arrays["psum/mean"] = np.asarray(mean["w"])
arrays["psum/exact"] = np.asarray(exact["w"])
np.savez(OUT_PATH + ".npz", **arrays)
with open(OUT_PATH + ".json", "w") as fh:
    json.dump(results, fh)
"""

TRAIN_CASES = (((1, 1), 1, "none"), ((2, 2), 1, "none"),
               ((4, 2), 1, "none"), ((2, 2), 2, "none"),
               ((2, 2), 1, "int8_ef"))


@pytest.fixture(scope="module")
def ref_train(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("train") / "ref")
    body = (f"import json\nOUT_PATH = {path!r}\nB, S = {B}, {S}\n"
            f"CASES = {TRAIN_CASES!r}\n" + REF_TRAIN)
    run_forced(body, n_devices=8)
    with open(path + ".json") as f:
        losses = json.load(f)
    return path + ".npz", losses


# The port's rank program for (2)-(5): the reference's initial state from
# the .npz, the step on this rank's rows, the whole state gathered.
PORT_TRAIN = """
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.parallel.sharding import make_rules
from repro_torch.train import step as step_mod

ref = np.load(REF)
cfg = get_config("qwen2-1.5b").reduced()
tok = (np.arange(B * S, dtype=np.int32).reshape(B, S) * 13) % cfg.vocab_size
tokens = torch.from_numpy(tok)
labels = torch.from_numpy(np.roll(tok, -1, axis=1))

def init(tcfg, comp):
    struct = step_mod.state_struct(cfg, tcfg)
    return tree.unflatten_like(struct, [
        torch.from_numpy(np.array(ref[f"init/{comp}/{p}"]))
        for p, _ in tree.flatten_with_path(struct)])

def on_mesh(shape, tcfg, comp):
    mesh = make_host_mesh(*shape)
    rules = make_rules(cfg, mesh, global_batch=B)
    struct = step_mod.state_struct(cfg, tcfg)
    specs = step_mod.state_specs(cfg, rules, tcfg, struct["params"])
    sh = collectives.shardings_of(mesh, specs, struct)
    return mesh, rules, sh

def run_step(shape, mb, comp, state=None):
    tcfg = TrainConfig(total_steps=5, warmup_steps=1, loss_chunk=16,
                       grad_compression=comp)
    mesh, rules, sh = on_mesh(shape, tcfg, comp)
    if not mesh.bound:
        return None
    local = (collectives.shard_tree(init(tcfg, comp), sh) if state is None
             else state)
    rows = collectives.block_slices((B, S), step_mod.batch_specs(rules, cfg)[0],
                                    mesh)
    step = step_mod.make_train_step(cfg, rules, tcfg, microbatches=mb)
    local, metrics = step(local, tokens[rows], labels[rows])
    moment_numel = sum(t.numel() for t in tree.leaves(local["opt"].m))
    whole = collectives.gather_tree(local, sh)
    return ({k: float(metrics[k]) for k in ("loss", "grad_norm")}, whole,
            moment_numel, local, sh)
"""


def _save(path, tree_):
    np.savez(path, **{p: t.numpy() for p, t in tree.flatten_with_path(tree_)})


@pytest.fixture(scope="module")
def port_train(ref_train, tmp_path_factory):
    """The port's steps: (1,1) on one rank; (2,2) at mb 1, mb 2 and with
    int8_ef on four; (4,2) on eight.  Each rank 0 saves the loss, the
    whole state after the step and the moment elements it stores."""
    ref_npz, _ = ref_train
    base = tmp_path_factory.mktemp("port_train")
    out = {}
    for world, cases in ((1, [((1, 1), 1, "none")]),
                         (4, [((2, 2), 1, "none"), ((2, 2), 2, "none"),
                              ((2, 2), 1, "int8_ef")]),
                         (8, [((4, 2), 1, "none")])):
        body = f"REF = {ref_npz!r}\nB, S = {B}, {S}\nCASES = {cases!r}\n" + \
            PORT_TRAIN + textwrap.dedent("""
            res = {}
            for shape, mb, comp in CASES:
                metrics, whole, n_mom, _, _ = run_step(shape, mb, comp)
                tag = f"{tuple(shape)}/{mb}/{comp}"
                res.setdefault("moments", {})[tag] = n_mom
                if RANK == 0:
                    res[tag] = metrics
                    np.savez(os.path.join(OUT, tag.replace("/", "_") + ".npz"),
                             **{p: t.numpy() for p, t in
                                tree.flatten_with_path(whole)})
            with open(os.path.join(OUT, f"rank{RANK}.json"), "w") as f:
                json.dump(res, f)
            """)
        d = spawn(base / f"w{world}", world, body)
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                rec = json.load(f)
            for tag, n in rec.pop("moments").items():
                out.setdefault(("moments", tag), []).append(n)
            for tag, metrics in rec.items():
                out[tag] = (metrics, dict(np.load(os.path.join(
                    d, tag.replace("/", "_") + ".npz"))))
    return out


def _first(state):
    return state["params/embed"]


def _moments(state):
    return {p[len("opt/.m/"):]: v for p, v in state.items()
            if p.startswith("opt/.m/")}


@pytest.mark.parametrize("case", TRAIN_CASES,
                         ids=lambda c: f"{c[0][0]}x{c[0][1]}-mb{c[1]}-{c[2]}")
def test_train_step_on_a_mesh_matches_the_reference(ref_train, port_train,
                                                     case):
    """The reference's test_dp_tp_train_step_matches_single_device on the
    port: the loss and the first leaf within 3e-4 of the reference's on
    the same mesh, and of the port's own (1,1).  At step 1 AdamW moves an
    element by about sign(g)·lr, so the parameters alone would pass a
    gradient wrong by any positive factor: the step's ``grad_norm`` and
    its first moments m = (1 - b1)·clip·g, which carry the gradient's
    scale, are held too, against the reference's on the same mesh and,
    uncompressed, the port's own (1,1) (see :func:`_hold_gradient`)."""
    ref_npz, ref_metrics = ref_train
    ref = np.load(ref_npz)
    shape, mb, comp = case
    tag = f"{tuple(shape)}/{mb}/{comp}"
    metrics, state = port_train[tag]
    loss = metrics["loss"]
    assert abs(loss - ref_metrics[tag]) < 3e-4, (tag, loss, ref_metrics[tag])
    np.testing.assert_allclose(_first(state), ref[f"first/{tag}"], atol=3e-4)
    base_metrics, base = port_train["(1, 1)/1/none"]
    assert abs(loss - base_metrics["loss"]) < 3e-4
    np.testing.assert_allclose(_first(state), _first(base), atol=3e-4)
    ref_m = {p: ref[f"m/{tag}/{p}"] for p in _moments(state)}
    _hold_gradient(tag, metrics["grad_norm"], _moments(state),
                   ref_metrics[tag + "/grad_norm"], ref_m, comp)
    if comp == "none":
        _hold_gradient(tag, metrics["grad_norm"], _moments(state),
                       base_metrics["grad_norm"], _moments(base), comp)
        # the placements change only the order of sums: every leaf close
        for p, v in base.items():
            if p.startswith("params/"):
                np.testing.assert_allclose(state[p], v, atol=3e-4,
                                           err_msg=p)


# the gradient's scale: grad_norm and every first-moment leaf within this
# share (of the norm; of the leaf's largest element) of the other side's
GRAD_REL = 1e-5
# with int8_ef the two sides quantize different things: the reference the
# mean gradient against its own largest element (compress_decompress in
# one program), the port each rank's gradient against the batch group's
# largest (compressed_psum).  Each side's mean lies within half an int8
# level of the exact mean, so a moment element within two levels (2/127)
# of its leaf's largest and the norm within 1e-3; a factor of 2 (a
# missing 1/N) moves both by 1/2 or more.
INT8_GNORM_REL = 1e-3
INT8_M_REL = 2.0 / 127.0


def _hold_gradient(tag, gnorm, m, want_gnorm, want_m, comp):
    """``grad_norm`` and each first-moment leaf ``m`` against ``want_*``.
    A missing 1/N after the all-reduce, a wrong 1/mb or a wrongly scaled
    int8 mean moves both by a factor."""
    gnorm_rel, m_rel = ((INT8_GNORM_REL, INT8_M_REL) if comp == "int8_ef"
                        else (GRAD_REL, GRAD_REL))
    assert abs(gnorm - want_gnorm) <= gnorm_rel * want_gnorm, \
        (tag, gnorm, want_gnorm)
    assert sorted(m) == sorted(want_m)
    for p, v in want_m.items():
        scale = max(float(np.abs(v).max()), 1e-30)
        err = float(np.abs(m[p] - v).max())
        assert err <= m_rel * scale, (tag, p, err / scale)


def test_zero1_moments_are_sharded_and_equal_the_one_device_moments(
        ref_train, port_train):
    """(2,2) with ZeRO-1: each rank stores its blocks' share of the moment
    elements (parameter spec plus "data"), and the gathered moments equal
    the one-device moments."""
    cfg = get_config("qwen2-1.5b").reduced()
    tcfg = TrainConfig(total_steps=5, warmup_steps=1, loss_chunk=16)
    mesh = mesh_mod.Mesh(("data", "model"), (2, 2))
    r = sharding.make_rules(cfg, mesh, global_batch=B)
    struct = step_mod.state_struct(cfg, tcfg)
    specs = step_mod.state_specs(cfg, r, tcfg, struct["params"])
    want = 0
    whole = 0
    for s, sp in zip(tree.leaves(struct["params"]),
                     tree.leaves(specs["opt"].m)):
        n = s.numel()
        for a in collectives.spec_axes(sp):
            n //= mesh.axis_sizes[a]
        want += n
        whole += s.numel()
    assert any("data" in collectives.spec_axes(sp)
               for sp in tree.leaves(specs["opt"].m))
    assert port_train[("moments", "(2, 2)/1/none")] == [want] * 4
    assert want < whole / 2
    _, state = port_train["(2, 2)/1/none"]
    _, base = port_train["(1, 1)/1/none"]
    for p, v in base.items():
        if p.startswith("opt/"):
            np.testing.assert_allclose(state[p], v, atol=3e-4, err_msg=p)
            scale = max(float(np.abs(v).max()), 1e-30)
            assert float(np.abs(state[p] - v).max()) <= 1e-5 * scale, p


def test_one_rank_step_equals_the_one_device_step(ref_train, port_train):
    """On a 1x1 mesh bound to a one-rank group the step computes what it
    computes on a one-device mesh with no process group (where no
    collective runs), bit for bit."""
    ref_npz, _ = ref_train
    ref = np.load(ref_npz)
    cfg = get_config("qwen2-1.5b").reduced()
    tcfg = TrainConfig(total_steps=5, warmup_steps=1, loss_chunk=16)
    struct = step_mod.state_struct(cfg, tcfg)
    state = tree.unflatten_like(struct, [
        torch.from_numpy(np.array(ref[f"init/none/{p}"]))
        for p, _ in tree.flatten_with_path(struct)])
    rules = sharding.make_rules(cfg, mesh_mod.make_host_mesh(1, 1),
                                global_batch=B)
    tok = (np.arange(B * S, dtype=np.int32).reshape(B, S) * 13) \
        % cfg.vocab_size
    step = step_mod.make_train_step(cfg, rules, tcfg)
    state, metrics = step(state, torch.from_numpy(tok),
                          torch.from_numpy(np.roll(tok, -1, axis=1)))
    base_metrics, base = port_train["(1, 1)/1/none"]
    for k, v in base_metrics.items():
        assert float(metrics[k]) == v, k
    for p, t in tree.flatten_with_path(state):
        assert np.array_equal(t.numpy(), base[p]), p


def test_compressed_psum_on_eight_ranks(ref_train, tmp_path):
    """The reference's inputs (test_distribution.py's), one row a rank:
    within the int8 scale of the exact mean, within 1e-6 of the scale of
    the reference's compressed_psum."""
    ref_npz, _ = ref_train
    body = f"REF = {ref_npz!r}\n" + textwrap.dedent("""
        import torch.distributed as dist
        from repro_torch.parallel import compression
        g = np.load(REF)["psum/g"]
        mine = {"w": torch.from_numpy(np.array(g[RANK:RANK + 1]))}
        err = {"w": torch.zeros_like(mine["w"])}
        mean, new_err = compression.compressed_psum(mine, err, dist.group.WORLD)
        np.save(os.path.join(OUT, f"mean{RANK}.npy"), mean["w"].numpy())
        np.save(os.path.join(OUT, f"err{RANK}.npy"), new_err["w"].numpy())
        """)
    d = spawn(tmp_path, 8, body)
    ref = np.load(ref_npz)
    g = ref["psum/g"]
    scale = float(np.abs(g).max()) / 127.0
    for r in range(8):
        mean = np.load(os.path.join(d, f"mean{r}.npy"))
        np.testing.assert_allclose(mean[0], g.mean(0), atol=scale)
        np.testing.assert_allclose(mean[0], ref["psum/exact"][r], atol=scale)
        np.testing.assert_allclose(mean[0], ref["psum/mean"][r],
                                   atol=1e-6 * scale, rtol=0)
        err = np.load(os.path.join(d, f"err{r}.npy"))
        assert float(np.abs(err).max()) <= scale / 2 * (1 + 1e-5)


def test_compressed_psum_on_one_rank_is_compress_decompress(tmp_path):
    """At n = 1 the compressed all-reduce computes compress_decompress,
    bit for bit (the card's phase holds the same over NCCL)."""
    body = textwrap.dedent("""
        import torch.distributed as dist
        from repro_torch.parallel import compression
        rng = np.random.default_rng(3)
        g = {"a": torch.from_numpy(rng.standard_normal((33, 7)).astype(np.float32)),
             "b": torch.from_numpy(rng.standard_normal((5,)).astype(np.float32))}
        e = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32) * 1e-3)
             for k, v in g.items()}
        m1, e1 = compression.compressed_psum(g, e, dist.group.WORLD)
        m2, e2 = compression.compress_decompress(g, e)
        for k in g:
            assert torch.equal(m1[k], m2[k]) and torch.equal(e1[k], e2[k]), k
        open(os.path.join(OUT, "ok"), "w").close()
        """)
    d = spawn(tmp_path, 1, body)
    assert os.path.exists(os.path.join(d, "ok"))


def test_elastic_remesh_is_bit_equal_and_a_step_after_it_equals_one_without(
        ref_train, tmp_path):
    """(2,2) -> (4,1) -> (1,1) on four ranks gives every leaf back
    bit-equal; a step on (4,1) after the re-mesh equals a step on (4,1)
    from the same state without it."""
    ref_npz, _ = ref_train
    body = f"REF = {ref_npz!r}\nB, S = {B}, {S}\n" + PORT_TRAIN + \
        textwrap.dedent("""
        from repro_torch.runtime.fault_tolerance import elastic_remesh
        tcfg = TrainConfig(total_steps=5, warmup_steps=1, loss_chunk=16)
        whole = init(tcfg, "none")
        _, _, sh22 = on_mesh((2, 2), tcfg, "none")
        _, _, sh41 = on_mesh((4, 1), tcfg, "none")
        _, _, sh11 = on_mesh((1, 1), tcfg, "none")
        s22 = collectives.shard_tree(whole, sh22)
        s41 = elastic_remesh(s22, sh41, shardings=sh22)
        for a, b in zip(tree.leaves(s41),
                        tree.leaves(collectives.shard_tree(whole, sh41))):
            assert torch.equal(a, b)
        s11 = elastic_remesh(s41, sh11, shardings=sh41)
        if RANK == 0:
            for a, b in zip(tree.leaves(s11), tree.leaves(whole)):
                assert torch.equal(a, b)
        else:
            assert s11 is None
        after = run_step((4, 1), 1, "none", state=s41)
        direct = run_step((4, 1), 1, "none")
        assert after[0] == direct[0]
        for a, b in zip(tree.leaves(after[1]), tree.leaves(direct[1])):
            assert torch.equal(a, b)
        open(os.path.join(OUT, f"ok{RANK}"), "w").close()
        """)
    d = spawn(tmp_path, 4, body)
    assert sorted(os.listdir(d)) == [f"ok{r}" for r in range(4)]


# ---------------------------------------------------------------------------
# (6) The launcher on four gloo ranks
# ---------------------------------------------------------------------------

LAUNCH = """
import contextlib, io
from repro_torch.launch import train
argv = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu", "--data",
        "2", "--model", "2", "--steps", "3", "--batch", "4", "--seq", "32",
        "--checkpoint-every", "3", "--no-advice",
        "--ckpt-dir", os.path.join(OUT, f"ckpt{RANK}")]
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    r = train.run(argv)
with open(os.path.join(OUT, f"log{RANK}.txt"), "w") as f:
    f.write(buf.getvalue())
with open(os.path.join(OUT, f"losses{RANK}.json"), "w") as f:
    json.dump([m["loss"] for m in r.result.metrics_history], f)
"""


def test_the_launcher_trains_on_four_ranks(tmp_path):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train as train_cli
    d = spawn(tmp_path / "four", 4, LAUNCH)
    with open(os.path.join(d, "log0.txt")) as f:
        log = f.read()
    assert "mesh=data=2xmodel=2 model_axis=arithmetic" in log
    for r in range(1, 4):
        with open(os.path.join(d, f"log{r}.txt")) as f:
            assert f.read() == ""                   # rank 0 speaks
    losses4 = [json.load(open(os.path.join(d, f"losses{r}.json")))
               for r in range(4)]
    assert all(l == losses4[0] for l in losses4)
    one_dir = str(tmp_path / "one")
    r1 = train_cli.run(["--arch", "qwen2-1.5b", "--reduced", "--device",
                        "cpu", "--data", "2", "--model", "2", "--steps", "3",
                        "--batch", "4", "--seq", "32", "--checkpoint-every",
                        "3", "--no-advice", "--ckpt-dir", one_dir],
                       verbose=False)
    assert mesh_mod.describe(r1.mesh) == "data=1xmodel=1"
    losses1 = [m["loss"] for m in r1.result.metrics_history]
    np.testing.assert_allclose(losses4[0], losses1, atol=3e-4)
    # rank 0 wrote the only checkpoint, in the one-device layout
    assert os.listdir(os.path.join(d, "ckpt0")) == ["step_00000003"]
    for r in range(1, 4):
        assert os.listdir(os.path.join(d, f"ckpt{r}")) == []
    four = os.path.join(d, "ckpt0", "step_00000003")
    one = os.path.join(one_dir, "step_00000003")
    assert sorted(os.listdir(four)) == sorted(os.listdir(one))
    m4 = json.load(open(os.path.join(four, "manifest.json")))
    m1 = json.load(open(os.path.join(one, "manifest.json")))
    assert m4 == m1
    # the four-rank state, written again by one process: the same bytes
    struct = step_mod.state_struct(r1.cfg, r1.tcfg)
    state = CheckpointManager(os.path.join(d, "ckpt0")).restore(struct, 3)
    again = str(tmp_path / "again")
    CheckpointManager(again).save(state, 3)
    for name in os.listdir(four):
        with open(os.path.join(four, name), "rb") as a, \
                open(os.path.join(again, "step_00000003", name), "rb") as b:
            assert a.read() == b.read(), name


# the metrics a step all-reduces over the batch group: ce_loss, tokens,
# loss (qwen2-1.5b has no experts)
STEP_METRICS = 3


def planned_collectives(rules, tcfg, params_struct, *, seq=S,
                        microbatches=1):
    """The oracle: the collectives one train step on ``rules.mesh`` must
    run, as its specs imply them, in launch order, ``[kind, operand
    bytes, group size]`` a call (an all-gather's input, an all-reduce's
    tensor, as ``analysis.cost`` counts them), for this rank's rows of the
    global batch ``B`` of ``seq`` tokens.  On a model axis of more than
    one rank the step splits the arithmetic of every family
    (:func:`_split_calls`), and the only leaves gathered over "model" are
    a Mamba layer's: ``w_zxbcdt`` and ``conv_w`` where its SSM heads are
    cut (a rank computes on head-aligned columns, not on its spec block),
    every cut one where they are not (the layer runs whole); each is
    gathered before the forward, in leaf order.  Then over the batch axes
    each float32 gradient block all-reduced (after its int8 scale's MAX
    with ``int8_ef``), then the metrics; the sums of squares all-reduced
    once a set of moment axes; each updated block gathered over the axes
    ZeRO-1 adds."""
    mesh = rules.mesh
    cfg = rules.cfg
    specs = step_mod.state_specs(cfg, rules, tcfg, params_struct)
    flat = tree.leaves(params_struct)
    paths = [p for p, _ in tree.flatten_with_path(params_struct)]
    pspecs = tree.leaves(specs["params"])
    mspecs = tree.leaves(specs["opt"].m)

    def axes(named):
        return tuple(a for a in mesh.axis_names if a in named)

    def size(ax):
        return int(np.prod([mesh.axis_sizes[a] for a in ax]))

    def nbytes(p, spec, itemsize):
        return int(np.prod(collectives.block_shape(tuple(p.shape), spec,
                                                   mesh))) * itemsize

    batch = axes(rules.batch)
    calls = []
    if mesh.axis_sizes.get("model", 1) > 1:
        for path, p, ps in zip(paths, flat, pspecs):
            ax = axes(collectives.spec_axes(ps))
            if ax and _mamba_whole(cfg, rules, path):
                calls.append(["all-gather", nbytes(p, ps, p.element_size()),
                              size(ax)])
        calls += _split_calls(rules, tcfg, params_struct,
                              B // size(batch), seq, microbatches)
    if batch:
        for p, ps in zip(flat, pspecs):
            if tcfg.grad_compression == "int8_ef":
                calls.append(["all-reduce", 4, size(batch)])
            calls.append(["all-reduce", nbytes(p, ps, 4), size(batch)])
        calls.append(["all-reduce", 4 * STEP_METRICS
                      + 8 * any(cfg.layer_is_moe(i)
                                for i in range(cfg.n_layers)),
                      size(batch)])
    keys = [axes(collectives.spec_axes(ms)) for ms in mspecs]
    for key in dict.fromkeys(k for k in keys if k):
        calls.append(["all-reduce", 4 * keys.count(key), size(key)])
    for p, ps, ms in zip(flat, pspecs, mspecs):
        ax = axes(collectives.spec_axes(
            collectives.relative_spec(ps, ms, p.dim())))
        if ax:
            calls.append(["all-gather", nbytes(p, ms, p.element_size()),
                          size(ax)])
    return calls


def _ssm_heads_cut(cfg, m) -> bool:
    return cfg.ssm is not None and cfg.ssm.n_heads(cfg.d_model) % m == 0


def _mamba_whole(cfg, rules, path) -> bool:
    """Does the split step hand the Mamba leaf at ``path`` to the layer
    whole: one of the three whose head-aligned columns a rank computes
    on, where the SSM heads are cut, or any, where they are not?"""
    parts = path.split("/")
    if len(parts) < 2 or parts[-2] != "ssm":
        return False
    if not _ssm_heads_cut(cfg, rules.mesh.axis_sizes["model"]):
        return True
    return parts[-1] in ("w_zxbcdt", "conv_w", "conv_b")


def _layer_sums(rules, i, act, rows, seq):
    """Layer ``i``'s all-reduces over the model group: (forward, in
    order; backward, in order; whether the layer's last operation is a
    forward sum).  Mixer then FFN forward, FFN then mixer backward.  An
    attention layer with its heads cut: the sum after ``wo``, its *f*
    backward.  A Mamba layer with its SSM heads cut: the float32 (B,S,1)
    sum of squares, then the output's sum; backward the sum of squares'
    gradient (summed both ways), then the input's *f*.  An MLP with its
    columns cut: the sum after ``w_out``, its *f*.  A MoE with its
    experts cut: the sum of the partials; backward the dispatched rows'
    *f*, then the float32 (g, n, k) gates' *f*.  A part that is not cut
    runs whole: no sum."""
    cfg, m = rules.cfg, rules.mesh.axis_sizes["model"]
    heads = ((rules.attn_mode == "head" or rules.q_heads_tp)
             and cfg.n_heads % m == 0)
    sumsq = rows * seq * 4
    if cfg.layer_kind(i) == "attn":
        mix_f, mix_b = ([act], [act]) if heads else ([], [])
    else:
        mix_f, mix_b = (([sumsq, act], [sumsq, act])
                        if _ssm_heads_cut(cfg, m) else ([], []))
    if not blocks.layer_has_ffn(cfg, i):
        return mix_f, mix_b, bool(mix_f)
    if cfg.layer_is_moe(i):
        cut = cfg.moe.n_experts % m == 0
        gates = rows * seq * cfg.moe.top_k * 4
        ffn_f, ffn_b = ([act], [act, gates]) if cut else ([], [])
    else:
        ffn_f, ffn_b = ([act], [act]) if cfg.d_ff % m == 0 else ([], [])
    return mix_f + ffn_f, ffn_b + mix_b, bool(ffn_f)


def _split_calls(rules, tcfg, params_struct, rows, seq, mb):
    """The model group's all-reduces of a tensor-parallel step (Megatron)
    over ``rows`` rows in ``mb`` microbatches.  Per microbatch, forward:
    the vocabulary-parallel embedding's sum, each layer's forward sums
    (:func:`_layer_sums`), each cross-entropy chunk's MAX of the rows'
    maxima and SUM of their rescaled sums and label logits.  Backward:
    the sum of the hidden's gradient entering the CE (*f*); each tail
    layer's backward sums, last layer first; then, last period first, the
    period's recompute and its layers' backward sums, last layer first.
    ``lm.forward`` checkpoints a whole period, so its recompute repeats
    the period's forward sums in forward order up to its last saved
    tensor: a sum that is the period's last operation (an MLP's or MoE's,
    or a Mamba layer's output with no FFN after it) is not repeated.
    After the last microbatch, one SUM a leaf of the whole-shaped float32
    gradients of the Mamba leaves a rank computes on by head-aligned
    columns (where the SSM heads are cut), in leaf order; then one flat
    SUM of the leaves whole on every rank that a rank reads for its heads
    only (biases, qk-norms; ``wk``/``wv`` in "seq" mode)."""
    cfg, m = rules.cfg, rules.mesh.axis_sizes["model"]
    item = params_struct["embed"].element_size()   # the activations'
    r = rows // mb
    act = r * seq * cfg.d_model * item
    heads = ((rules.attn_mode == "head" or rules.q_heads_tp)
             and cfg.n_heads % m == 0)
    vocab = cfg.padded_vocab % m == 0
    plan = blocks.make_plan(cfg)
    layer = [_layer_sums(rules, i, act, r, seq) for i in range(cfg.n_layers)]
    chunk = min(tcfg.loss_chunk, seq)
    chunks = [chunk] * (seq // chunk) + ([seq % chunk] if seq % chunk else [])
    one = [act] if vocab else []
    for f, _, _ in layer:
        one += f
    if vocab:
        for c in chunks:
            one += [r * c * 4, 2 * r * c * 4]
        one.append(act)
    for j in reversed(range(plan.n_tail)):
        one += layer[plan.tail_layer_idx(j)][1]
    for _ in range(plan.n_full):
        if tcfg.remat == "layer":
            redo = [n for p in range(plan.period) for n in layer[p][0]]
            one += redo[:-1] if layer[plan.period - 1][2] else redo
        for p in reversed(range(plan.period)):
            one += layer[p][1]
    calls = [["all-reduce", n, m] for n in one] * mb
    if _ssm_heads_cut(cfg, m):
        calls += [["all-reduce", 4 * leaf.numel(), m] for path, leaf in
                  tree.flatten_with_path(params_struct)
                  if _mamba_whole(cfg, rules, path)]
    names = ((("bq", "bk", "bv") if cfg.qkv_bias else ())
             + (("q_norm", "k_norm") if cfg.qk_norm else ())
             + (("wk", "wv") if rules.attn_mode == "seq" else ()))
    partial = sum(leaf.numel() for path, leaf in
                  tree.flatten_with_path(params_struct)
                  if heads and path.split("/")[-2:] in
                  (["attn", n] for n in names))
    if partial:
        calls.append(["all-reduce", 4 * partial, m])
    return calls


def test_the_cost_counter_sees_the_collectives_the_specs_imply(ref_train,
                                                               tmp_path):
    """One train step on (2,2), with ZeRO-1 and with int8_ef, counted by
    ``analysis.cost``: its collectives, in order, kind and operand bytes,
    are those :func:`planned_collectives` derives from the specs (the
    card's phase holds the same over NCCL on 1x1).  The step splits
    qwen2-1.5b's arithmetic over "model": every all-gather is a ZeRO-1
    refresh over "data", none a parameter over "model"."""
    ref_npz, _ = ref_train
    body = f"REF = {ref_npz!r}\nB, S = {B}, {S}\n" + PORT_TRAIN + \
        textwrap.dedent("""
        from repro_torch.analysis import cost
        out = {}
        for comp in ("none", "int8_ef"):
            tcfg = TrainConfig(total_steps=5, warmup_steps=1, loss_chunk=16,
                               grad_compression=comp)
            mesh, rules, sh = on_mesh((2, 2), tcfg, comp)
            local = collectives.shard_tree(init(tcfg, comp), sh)
            rows = collectives.block_slices(
                (B, S), step_mod.batch_specs(rules, cfg)[0], mesh)
            step = step_mod.make_train_step(cfg, rules, tcfg)
            c = cost.analyze(step, local, tokens[rows], labels[rows])
            out[comp] = {
                "counted": [[o.kind, o.bytes_per_call, o.group_size]
                            for o in c.collectives],
                "collective_bytes": c.collective_bytes}
        with open(os.path.join(OUT, f"rank{RANK}.json"), "w") as f:
            json.dump(out, f)
        """)
    d = spawn(tmp_path, 4, body)
    cfg = get_config("qwen2-1.5b").reduced()
    rules = sharding.make_rules(cfg, mesh_mod.Mesh(("data", "model"), (2, 2)),
                                global_batch=B)
    for r in range(4):
        rec = json.load(open(os.path.join(d, f"rank{r}.json")))
        assert sorted(rec) == ["int8_ef", "none"]
        for comp, v in rec.items():
            tcfg = TrainConfig(total_steps=5, warmup_steps=1, loss_chunk=16,
                               grad_compression=comp)
            plan = planned_collectives(
                rules, tcfg, step_mod.state_struct(cfg, tcfg)["params"])
            assert v["counted"] == plan, (r, comp)
            assert v["collective_bytes"] == sum(n for _, n, _ in plan)
            kinds = {k for k, _, _ in plan}
            assert kinds == {"all-gather", "all-reduce"}, kinds


def test_the_launcher_refuses_a_mesh_smaller_than_its_world(tmp_path):
    """Two ranks asked for a 1x1 mesh: every rank refuses, none trains
    alone as if it held the whole job."""
    body = textwrap.dedent("""
        from repro_torch.launch import train
        try:
            train.run(["--arch", "qwen2-1.5b", "--reduced", "--device",
                       "cpu", "--steps", "1", "--no-advice",
                       "--no-checkpoint"])
        except ValueError as e:
            assert "over a world of 2" in str(e), e
            open(os.path.join(OUT, f"refused{RANK}"), "w").close()
        """)
    d = spawn(tmp_path, 2, body)
    assert sorted(os.listdir(d)) == ["refused0", "refused1"]


def test_the_loader_yields_each_ranks_rows(tmp_path):
    """``DataLoader(mesh=)`` on a bound (2,2) mesh: each rank gets the rows
    of its "data" coordinate (row-major ranks, batch over "data"), and the
    two data coordinates together hold the global batch once."""
    body = textwrap.dedent("""
        from repro_torch.configs import get_config
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.data.pipeline import DataLoader
        from repro_torch.launch.mesh import make_host_mesh
        cfg = get_config("qwen2-1.5b").reduced()
        loader = DataLoader(cfg, ShapeSpec("t", 16, 4, "train"),
                            mesh=make_host_mesh(2, 2), device="cpu", seed=5)
        b = loader.device_batch(3)
        np.save(os.path.join(OUT, f"tokens{RANK}.npy"), b.tokens.numpy())
        np.save(os.path.join(OUT, f"labels{RANK}.npy"), b.labels.numpy())
        """)
    d = spawn(tmp_path, 4, body)
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataLoader
    cfg = get_config("qwen2-1.5b").reduced()
    whole = DataLoader(cfg, ShapeSpec("t", 16, 4, "train"), device="cpu",
                       seed=5).host_batch(3)
    for r in range(4):
        rows = slice(2 * (r // 2), 2 * (r // 2) + 2)
        np.testing.assert_array_equal(
            np.load(os.path.join(d, f"tokens{r}.npy")), whole.tokens[rows])
        np.testing.assert_array_equal(
            np.load(os.path.join(d, f"labels{r}.npy")), whole.labels[rows])


def test_a_mesh_of_several_devices_needs_a_process_group():
    """The step on a descriptor mesh of more than one device refuses (it
    would take the whole state for a block); on a one-device mesh with no
    group it is the one-device step, and the loader yields every row."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataLoader
    cfg = get_config("qwen2-1.5b").reduced()
    tcfg = TrainConfig(total_steps=5, warmup_steps=1, loss_chunk=16)
    rules = sharding.make_rules(cfg, mesh_mod.Mesh(("data", "model"), (2, 2)),
                                global_batch=B)
    with pytest.raises(ValueError, match="process group"):
        step_mod.make_train_step(cfg, rules, tcfg)
    one = mesh_mod.make_host_mesh(1, 1)
    assert not one.bound
    assert collectives.axis_group(one, ("data",)) is None
    x = torch.arange(6.0).reshape(2, 3)
    assert collectives.gather(x, sharding.P("data", "model"), one,
                              (2, 3)) is x
    shape = ShapeSpec("t", 16, 4, "train")
    a = DataLoader(cfg, shape, mesh=one, device="cpu", seed=5).device_batch(1)
    b = DataLoader(cfg, shape, device="cpu", seed=5).device_batch(1)
    assert a.tokens.shape[0] == 4
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.labels, b.labels)


def test_nccl_refuses_a_world_larger_than_the_cards(tmp_path):
    """--device cuda takes one card a rank: a world larger than the cards
    present raises before any NCCL call, and no group is left behind."""
    with pytest.raises(RuntimeError, match="one card a rank"):
        collectives.setup("nccl", store_path=str(tmp_path / "store"),
                          rank=0, world_size=torch.cuda.device_count() + 1)
    assert not collectives.initialized()
    with pytest.raises(ValueError, match="nccl.*gloo"):
        collectives.setup("mpi", store_path=str(tmp_path / "store"), rank=0,
                          world_size=1)

"""Port vs reference for serving on a mesh and for GPipe, on the CPU.

The reference runs once, in a subprocess with 8 forced host devices (the
``run_forced`` pattern of ``tests/test_distribution.py``): its init of
gemma3-1b, qwen2-1.5b and glm4-9b ``reduced()``, a prefill and one decode
step of each on its meshes, and ``make_gpipe`` on 4 stages.  The port runs
in two launches over ``gloo``, one interpreter a rank at the lowest
priority, meeting in a file store under the test's temporary directory,
each launch joined within ``RANK_LIMIT`` and killed past it: 8 ranks for
the (2,4) and (1,8) meshes and GPipe on a (2,4) ("data", "stage") mesh,
2 ranks for (1,2), the MoE and Mamba families on (2,1) and the launcher.
Every rank also serves the same inputs on an unbound one-device mesh, the
port's (1,1).  Weights come from the reference's init through
``models.convert``; tokens from numpy.  Limits, set beforehand:
- logits, float32: within 3e-4 of the reference's on the same mesh and of
  the port's (1,1) (the row-parallel sums and the split softmax change
  only the order of float32 sums);
- greedy and sampled tokens: equal on every rank and to (1,1);
- GPipe: within 1e-5 of the reference's and of ``reference_pipeline``;
- bytes and collectives: exact.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.parallel import collectives, pipeline, sharding

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
RANK_LIMIT = 200            # seconds for one multi-rank launch
REF_LIMIT = 300             # seconds for the reference subprocess
B, PROMPT, NEW = 2, 12, 4
LOGITS_TOL = 3e-4
# (arch, the meshes the reference serves it on)
REF_RUNS = (("gemma3-1b", ((1, 1), (1, 2), (2, 4), (1, 8))),
            ("qwen2-1.5b", ((1, 1), (2, 4))),
            ("glm4-9b", ((1, 1), (2, 4))))


def _low_priority():
    os.nice(19)


# ---------------------------------------------------------------------------
# The reference, once
# ---------------------------------------------------------------------------

REF_BODY = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.configs.base import get_config
from repro.models import lm
from repro.parallel.pipeline import make_gpipe, reference_pipeline
from repro.parallel.sharding import make_rules
from repro.serve import engine as eng
from jax.sharding import PartitionSpec as P

out = {}
for arch, meshes in REF_RUNS:
    cfg = get_config(arch).reduced()
    params = lm.init_params(cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    rec = {"params": jax.tree.map(np.asarray, params), "tokens": tokens}
    for shape in meshes:
        n = shape[0] * shape[1]
        mesh = compat.make_mesh(shape, ("data", "model"),
                                devices=jax.devices()[:n])
        rules = make_rules(cfg, mesh, global_batch=B, shape_kind="decode")
        prefill = jax.jit(eng.make_prefill_step(cfg, rules,
                                                max_len=PROMPT + NEW))
        decode = jax.jit(eng.make_decode_step(cfg, rules))
        caches, l1 = prefill(params, jnp.asarray(tokens), None)
        caches, l2 = decode(params, caches, jnp.asarray(tokens[:, -1:]),
                            jnp.int32(PROMPT), None)
        rec[shape] = (np.asarray(l1), np.asarray(l2))
    out[arch] = rec

mesh = compat.make_mesh((4,), ("stage",), devices=jax.devices()[:4])
def apply_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])
gp = {"w": jax.random.normal(jax.random.PRNGKey(0), (4, 8, 8)) * 0.5,
      "b": jnp.zeros((4, 1, 8))}
x = jax.random.normal(jax.random.PRNGKey(1), (7, 2, 8))
y = jax.jit(make_gpipe(mesh, apply_stage, n_micro=7, x_spec=P()))(gp, x)
out["gpipe"] = {"params": jax.tree.map(np.asarray, gp), "x": np.asarray(x),
                "y": np.asarray(y),
                "y_seq": np.asarray(reference_pipeline(apply_stage, gp, x))}
with open(OUT, "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref_serve_mesh") / "ref.pkl")
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        os.environ["JAX_PLATFORMS"] = "cpu"
        REF_RUNS = {REF_RUNS!r}
        B, PROMPT, NEW = {B}, {PROMPT}, {NEW}
        OUT = {path!r}
    """) + textwrap.dedent(REF_BODY)
    env = dict(os.environ, PYTHONPATH=SRC)
    # at the normal priority: every test of this file waits for it, and
    # at the lowest one the suite's other workers starve it past its limit
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=REF_LIMIT, env=env)
    assert r.returncode == 0, f"stderr:\n{r.stderr[-3000:]}"
    with open(path, "rb") as f:
        return path, pickle.load(f)


# ---------------------------------------------------------------------------
# The port's ranks
# ---------------------------------------------------------------------------

RANK_PRELUDE = """
import json, os, pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
STORE, OUT, REF = sys.argv[3], sys.argv[4], sys.argv[5]
from repro_torch.parallel import collectives
collectives.setup("gloo", store_path=STORE, rank=RANK, world_size=WORLD)
try:
{body}
finally:
    collectives.teardown()
"""

# what every rank's body starts with: the reference's weights and tokens,
# and one prefill + decode step (and a generate) on a mesh
PORT_COMMON = """
from repro_torch.analysis import cost
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh
from repro_torch.models import convert, lm
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import P
from repro_torch.serve import engine as eng
B, PROMPT, NEW = {B}, {PROMPT}, {NEW}
with open(REF, "rb") as f:
    REFS = pickle.load(f)
RESULT = {{}}

SEEN = []                      # q heads and KV heads each flash call sees
_flash = ops.flash_attention
def _spy(q, k, v, **kw):
    SEEN.append([q.shape[1], k.shape[1]])
    return _flash(q, k, v, **kw)
ops.flash_attention = _spy


BOUND = {{}}


def on_mesh(shape, axes=("data", "model")):
    # (1,1): an unbound one-device mesh, the port's (1,1); else bound once
    if shape == (1, 1):
        return Mesh(axes, shape)
    if (axes, shape) not in BOUND:
        BOUND[axes, shape] = collectives.bind(Mesh(axes, shape))
    return BOUND[axes, shape]


def setup_arch(arch, shape):
    cfg = get_config(arch).reduced()
    mesh = on_mesh(shape)
    rules = sharding.make_rules(cfg, mesh, global_batch=B,
                                shape_kind="decode")
    params = convert.params_from_numpy(REFS[arch]["params"], "cpu")
    return cfg, mesh, rules, params


def whole_rows(x, rules):
    g = collectives.axis_group(rules.mesh, rules.batch) \\
        if rules.mesh.bound else None
    if g is None or g.size == 1:
        return x
    return collectives.gather(x, P(rules.batch, None), rules.mesh,
                              (B,) + tuple(x.shape[1:]))


def steps(arch, shape, count=False):
    # prefill + one decode step: the whole logits of both, the flash
    # calls' heads, the caches' and parameters' bytes, the collectives
    cfg, mesh, rules, params = setup_arch(arch, shape)
    sh = eng.param_shardings(cfg, rules)
    local = collectives.shard_tree(params, sh) if sh else params
    rows = (collectives.block_slices((B,), P(rules.batch or None), mesh)[0]
            if mesh.bound else slice(None))
    tokens = torch.from_numpy(REFS[arch]["tokens"]).long()[rows]
    prefill = eng.make_prefill_step(cfg, rules, max_len=PROMPT + NEW)
    decode = eng.make_decode_step(cfg, rules)
    del SEEN[:]
    caches, l1 = prefill(local, tokens)
    seen = [list(s) for s in SEEN]
    caches, l2 = decode(local, caches, tokens[:, -1:], PROMPT)
    rec = {{"prefill": whole_rows(l1, rules).tolist(),
           "decode": whole_rows(l2, rules).tolist(), "seen": seen,
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in lm.leaves(local)),
           "cache_shapes": [list(t.shape) for t in lm.leaves(caches)],
           "cache_bytes": sum(t.numel() * t.element_size()
                              for t in lm.leaves(caches)),
           "cache_struct": [list(t.shape) for t in lm.leaves(
               lm.cache_struct(cfg, B, PROMPT + NEW, torch.float32,
                               rules=rules))]}}
    if count:
        caches, _ = prefill(local, tokens)
        cp = cost.analyze(prefill, local, tokens)
        cd = cost.analyze(decode, local, caches, tokens[:, -1:], PROMPT)
        rec["collectives"] = {{
            k: [[o.kind, o.bytes_per_call, o.group_size]
                for o in c.collectives] for k, c in
            (("prefill", cp), ("decode", cd))}}
    return rec


def generate(arch, shape, **kw):
    cfg, mesh, rules, params = setup_arch(arch, shape)
    e = eng.ServeEngine(cfg, params, rules)
    toks = torch.from_numpy(REFS[arch]["tokens"]).long()
    res = e.generate(toks, **kw)
    return {{"tokens": res.tokens.tolist(), "logits": res.logits.tolist(),
            "kv_pool": res.kv_pool}}
"""


def spawn(tmp, world: int, body: str, ref_path: str,
          limit: int = RANK_LIMIT) -> str:
    """Run ``body`` on ``world`` gloo ranks (each its own interpreter),
    joined within ``limit`` seconds; a rank still running then is killed
    and the launch fails.  Returns the directory of the ranks' files."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    store = os.path.join(tmp, "store")
    if os.path.exists(store):
        os.remove(store)
    out = os.path.join(tmp, "out")
    os.makedirs(out, exist_ok=True)
    code = RANK_PRELUDE.format(body=textwrap.indent(
        textwrap.dedent(PORT_COMMON.format(B=B, PROMPT=PROMPT, NEW=NEW))
        + textwrap.dedent(body), "    "))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), store, out,
         ref_path], env=env, stdout=logs[r], stderr=subprocess.STDOUT,
        preexec_fn=_low_priority) for r in range(world)]
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
            out.append(f"--- rank {r}\n" + f.read()[-2500:])
    return "\n".join(out)


def _ranks(d, world):
    recs = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs


EIGHT_BODY = """
from repro_torch.parallel.pipeline import make_gpipe, reference_pipeline
RESULT["one"] = {a: steps(a, (1, 1)) for a in
                 ("gemma3-1b", "qwen2-1.5b", "glm4-9b")}
RESULT["gemma3-1b", (2, 4)] = steps("gemma3-1b", (2, 4))
RESULT["gemma3-1b", (1, 8)] = steps("gemma3-1b", (1, 8), count=True)
for a in ("qwen2-1.5b", "glm4-9b"):
    RESULT[a, (2, 4)] = steps(a, (2, 4), count=(a == "qwen2-1.5b"))
    RESULT["gen", a, (2, 4)] = generate(a, (2, 4), max_new_tokens=8)
    RESULT["gen", a, (1, 1)] = generate(a, (1, 1), max_new_tokens=8)
for shape in ((2, 4), (1, 1)):
    RESULT["sample", shape] = generate("qwen2-1.5b", shape,
                                       max_new_tokens=8, temperature=0.8,
                                       seed=3)

# GPipe on a (2, 4) ("data", "stage") mesh: each data row one pipeline
gp = {k: torch.from_numpy(np.asarray(v)) for k, v in
      REFS["gpipe"]["params"].items()}
x = torch.from_numpy(REFS["gpipe"]["x"])
def apply_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])
mesh = on_mesh((2, 4), ("data", "stage"))
y = make_gpipe(mesh, apply_stage, n_micro=7)(gp, x)
RESULT["gpipe"] = {"y": y.tolist(),
                   "y_seq": reference_pipeline(apply_stage, gp, x).tolist()}

with open(os.path.join(OUT, f"rank{RANK}.json"), "w") as f:
    json.dump({repr(k): v for k, v in RESULT.items()}, f)
"""

TWO_BODY = """
import contextlib, io
RESULT["one"] = {"gemma3-1b": steps("gemma3-1b", (1, 1))}
RESULT["gemma3-1b", (1, 2)] = steps("gemma3-1b", (1, 2), count=True)
RESULT["gen", "gemma3-1b", (1, 2)] = generate("gemma3-1b", (1, 2),
                                              max_new_tokens=8)
RESULT["gen", "gemma3-1b", (1, 1)] = generate("gemma3-1b", (1, 1),
                                              max_new_tokens=8)

# the MoE and Mamba families: a (2, 1) mesh splits the batch only; the
# launcher on a model axis of 2 splits the experts and the SSM heads
for a in ("olmoe-1b-7b", "mamba2-370m"):
    cfg = get_config(a).reduced()
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, PROMPT))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    for shape in ((2, 1), (1, 1)):
        rules = sharding.make_rules(cfg, on_mesh(shape), global_batch=B,
                                    shape_kind="decode")
        res = eng.ServeEngine(cfg, params, rules).generate(
            torch.from_numpy(toks).long(), max_new_tokens=5)
        RESULT["family", a, shape] = {"tokens": res.tokens.tolist(),
                                      "logits": res.logits.tolist()}
    from repro_torch.launch import serve as serve_cli
    r = serve_cli.run(["--arch", a, "--reduced", "--batch", "2",
                       "--prompt-len", "8", "--new-tokens", "2", "--data",
                       "1", "--model", "2", "--device", "cpu"])
    RESULT["family_launcher", a] = {"mesh": [list(r.mesh.shape),
                                             r.mesh.rank],
                                    "tokens": r.result.tokens.tolist()}

# the launcher's mesh path: the group exists, so it binds a (1, 2) mesh
from repro_torch.launch import serve as serve_cli
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    code = serve_cli.main(LAUNCH_ARGV)
r = serve_cli.run(LAUNCH_ARGV)
try:
    serve_cli.run(LAUNCH_ARGV[:-5] + ["1", "--device", "cpu"])
    RESULT["launcher_small_mesh"] = ""
except ValueError as e:
    RESULT["launcher_small_mesh"] = str(e)
RESULT["launcher"] = {"code": code, "stdout": buf.getvalue(),
                      "mesh": [r.mesh.axis_names, r.mesh.shape,
                               r.mesh.rank],
                      "tokens": r.result.tokens.tolist(),
                      "kv_bytes": r.kv_bytes}

with open(os.path.join(OUT, f"rank{RANK}.json"), "w") as f:
    json.dump({repr(k): v for k, v in RESULT.items()}, f)
"""

LAUNCH_ARGV = ["--arch", "qwen2-1.5b", "--reduced", "--batch", "2",
               "--prompt-len", "16", "--new-tokens", "6", "--data", "1",
               "--model", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def eight(ref, tmp_path_factory):
    d = spawn(tmp_path_factory.mktemp("eight"), 8, EIGHT_BODY, ref[0])
    return _ranks(d, 8)


@pytest.fixture(scope="module")
def two(ref, tmp_path_factory):
    body = f"LAUNCH_ARGV = {LAUNCH_ARGV!r}\n" + TWO_BODY
    d = spawn(tmp_path_factory.mktemp("two"), 2, body, ref[0])
    return _ranks(d, 2)


def _get(rec, *key):
    return rec[repr(key if len(key) > 1 else key[0])]


# ---------------------------------------------------------------------------
# (2), (3) logits on every mesh, beside the reference's and (1,1)
# ---------------------------------------------------------------------------


def _hold_logits(rec, one, want, tag):
    for step, i in (("prefill", 0), ("decode", 1)):
        got = np.asarray(rec[step], np.float32)
        assert got.shape == want[i].shape, (tag, step)
        np.testing.assert_allclose(got, want[i], atol=LOGITS_TOL,
                                   err_msg=f"{tag} {step} vs reference")
        np.testing.assert_allclose(got, np.asarray(one[step], np.float32),
                                   atol=LOGITS_TOL,
                                   err_msg=f"{tag} {step} vs port (1,1)")


@pytest.mark.parametrize("arch,shape", [
    ("gemma3-1b", (1, 1)), ("gemma3-1b", (1, 2)), ("gemma3-1b", (2, 4)),
    ("gemma3-1b", (1, 8)), ("qwen2-1.5b", (2, 4)), ("glm4-9b", (2, 4))])
def test_prefill_and_decode_logits_on_a_mesh_match_the_reference(
        ref, eight, two, arch, shape):
    """The twin of ``tests/test_distribution.py``'s decode test: a prefill
    and one decode step on (1,1), (1,2) ("head" mode), (2,4) ("seq" with
    ``q_heads_tp``) and (1,8) ("seq" only), every rank's whole logits
    within 3e-4 of the reference's on the same mesh and of the port's
    (1,1)."""
    want = ref[1][arch][shape]
    ranks = two if shape in ((1, 1), (1, 2)) else eight
    for r, rec in enumerate(ranks):
        one = rec[repr("one")][arch]
        got = one if shape == (1, 1) else _get(rec, arch, shape)
        _hold_logits(got, one, want, f"{arch} {shape} rank {r}")


def test_the_rules_pick_the_three_modes():
    """The meshes above exercise the three modes (reduced(): 4 q heads, 2
    KV heads, d_ff 128, vocab 256)."""
    cfg = get_config("gemma3-1b").reduced()
    modes = {}
    for shape in ((1, 2), (2, 4), (1, 8)):
        r = sharding.make_rules(cfg, Mesh(("data", "model"), shape),
                                global_batch=B, shape_kind="decode")
        modes[shape] = (r.attn_mode, r.q_heads_tp, r.kv_seq_axes)
    assert modes == {(1, 2): ("head", False, ()),
                     (2, 4): ("seq", True, ("model",)),
                     (1, 8): ("seq", False, ("model",))}


@pytest.mark.parametrize("arch,shape", [("gemma3-1b", (1, 2)),
                                        ("qwen2-1.5b", (2, 4)),
                                        ("glm4-9b", (2, 4))])
def test_greedy_tokens_are_equal_on_every_rank_and_to_one_device(
        eight, two, arch, shape):
    """A whole ``generate`` of 8 greedy tokens: the same tokens on every
    rank and on (1,1), the last logits within 3e-4."""
    ranks = two if shape == (1, 2) else eight
    one = _get(ranks[0], "gen", arch, (1, 1))
    assert np.asarray(one["tokens"]).shape == (B, 8)
    for rec in ranks:
        got = _get(rec, "gen", arch, shape)
        assert got["tokens"] == one["tokens"]
        assert got["kv_pool"] == "hbm"
        np.testing.assert_allclose(got["logits"], one["logits"],
                                   atol=LOGITS_TOL)


def test_sampling_draws_the_same_tokens_on_every_rank(eight):
    """(5) Temperature 0.8 on (2,4), the batch cut over "data": every rank
    draws the whole batch's tokens from the same generator, as (1,1)."""
    one = _get(eight[0], "sample", (1, 1))["tokens"]
    for rec in eight:
        assert _get(rec, "sample", (2, 4))["tokens"] == one


# ---------------------------------------------------------------------------
# (4) each rank's blocks, and the heads each rank attends
# ---------------------------------------------------------------------------


def _block_bytes(cfg, rules, struct, specs, itemsize=4):
    mesh = rules.mesh
    from repro_torch import tree
    return sum(int(np.prod(collectives.block_shape(tuple(t.shape), sp,
                                                   mesh))) * itemsize
               for t, sp in zip(tree.leaves(struct), tree.leaves(specs)))


@pytest.mark.parametrize("arch,shape", [("gemma3-1b", (1, 2)),
                                        ("gemma3-1b", (2, 4)),
                                        ("gemma3-1b", (1, 8)),
                                        ("glm4-9b", (2, 4))])
def test_each_rank_holds_its_blocks_of_the_parameters_and_the_caches(
        eight, two, arch, shape):
    """A rank's parameter bytes and cache bytes are its blocks' share by
    ``param_specs`` and ``cache_specs``; its caches' shapes are
    ``cache_struct``'s blocks."""
    cfg = get_config(arch).reduced()
    rules = sharding.make_rules(cfg, Mesh(("data", "model"), shape),
                                global_batch=B, shape_kind="decode")
    pstruct = lm.param_struct(cfg)
    want_p = _block_bytes(cfg, rules, pstruct,
                          lm.param_specs(rules, pstruct))
    cstruct = lm.cache_struct(cfg, B, PROMPT + NEW, torch.float32)
    want_c = _block_bytes(cfg, rules, cstruct,
                          lm.cache_specs(rules, cstruct))
    whole_p = sum(t.numel() * 4 for t in lm.leaves(pstruct))
    whole_c = sum(t.numel() * 4 for t in lm.leaves(cstruct))
    assert want_p < whole_p and want_c < whole_c
    ranks = two if shape == (1, 2) else eight
    for rec in ranks:
        got = _get(rec, arch, shape)
        assert got["param_bytes"] == want_p
        assert got["cache_bytes"] == want_c
        assert got["cache_shapes"] == got["cache_struct"]
    assert ranks[0]["'one'"][arch]["cache_bytes"] == whole_c


@pytest.mark.parametrize("arch,shape,heads", [
    ("gemma3-1b", (1, 2), [2, 1]),     # "head": H/tp q heads, KV/tp
    ("qwen2-1.5b", (2, 4), [1, 1]),    # "seq" + q_heads_tp: its KV head
    ("gemma3-1b", (1, 8), [4, 2]),     # "seq" only: every head
    ("gemma3-1b", (1, 1), [4, 2])])
def test_the_prefill_kernel_sees_the_ranks_heads(eight, two, arch, shape,
                                                 heads):
    """Each prefill layer's flash call (its plain version here) on each
    rank sees the rank's q heads and the KV heads they read."""
    ranks = two if shape in ((1, 1), (1, 2)) else eight
    n_layers = get_config(arch).reduced().n_layers
    for rec in ranks:
        got = (rec["'one'"][arch] if shape == (1, 1)
               else _get(rec, arch, shape))
        assert got["seen"] == [heads] * n_layers


def planned_serve_collectives(cfg, rules, mode):
    """The oracle: the collectives one prefill (``PROMPT`` positions) or
    one decode step on ``rules.mesh`` must run, in order, ``[kind,
    operand bytes, group size]``, float32: the vocabulary-parallel
    embedding's sum; a layer's gather of q's heads, the split softmax's
    MAX and SUM over the sequence group (decode in "seq" mode), the
    row-parallel ``wo`` and ``w_out`` sums; the logits' gather."""
    sizes = rules.mesh.axis_sizes
    tp = sizes["model"]
    bl = B // int(np.prod([sizes[a] for a in rules.batch]))
    seq = int(np.prod([sizes[a] for a in rules.kv_seq_axes]))
    s = PROMPT if mode == "prefill" else 1
    h, kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    hidden = bl * s * d * 4
    vocab_cut = cfg.padded_vocab % tp == 0
    heads_cut = rules.attn_mode == "head" or rules.q_heads_tp
    calls = []
    if vocab_cut:
        calls.append(["all-reduce", hidden, tp])
    for _ in range(cfg.n_layers):
        if mode == "decode" and rules.attn_mode == "seq":
            if rules.q_heads_tp:
                calls.append(["all-gather", bl * (h // tp) * hd * 4, tp])
            calls.append(["all-reduce", bl * h * 4, seq])
            calls.append(["all-reduce", bl * h * (hd + 1) * 4, seq])
        if heads_cut:
            calls.append(["all-reduce", hidden, tp])
        if cfg.d_ff % tp == 0:
            calls.append(["all-reduce", hidden, tp])
    if vocab_cut:
        calls.append(["all-gather", bl * cfg.padded_vocab // tp * 4, tp])
    return calls


@pytest.mark.parametrize("arch,shape", [("gemma3-1b", (1, 2)),
                                        ("qwen2-1.5b", (2, 4)),
                                        ("gemma3-1b", (1, 8))])
def test_the_cost_counter_sees_one_sum_a_row_parallel_contraction(
        eight, two, arch, shape):
    """``analysis.cost`` over a prefill and a decode step on each mode's
    mesh: the collectives, in order, kind, bytes and group, are those
    :func:`planned_serve_collectives` derives, one sum after each
    row-parallel ``wo`` and ``w_out`` a layer."""
    cfg = get_config(arch).reduced()
    rules = sharding.make_rules(cfg, Mesh(("data", "model"), shape),
                                global_batch=B, shape_kind="decode")
    ranks = two if shape == (1, 2) else eight
    for rec in ranks:
        got = _get(rec, arch, shape)["collectives"]
        for mode in ("prefill", "decode"):
            assert got[mode] == planned_serve_collectives(cfg, rules, mode), \
                (shape, mode)


# ---------------------------------------------------------------------------
# (7) MoE and Mamba, (6) the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-370m"])
def test_moe_and_mamba_serve_on_the_data_axis_and_on_the_model_axis(
        two, arch):
    """(2,1) splits the batch only: the same tokens as (1,1), logits within
    3e-4; the launcher on a model axis of 2 (the experts or the SSM heads
    split) serves the same tokens as the one-process launcher's (1,1)."""
    alone = serve_cli.run(["--arch", arch, "--reduced", "--batch", "2",
                           "--prompt-len", "8", "--new-tokens", "2",
                           "--data", "1", "--model", "2", "--device", "cpu"])
    assert not alone.mesh.bound
    for r, rec in enumerate(two):
        got = _get(rec, "family", arch, (2, 1))
        one = _get(rec, "family", arch, (1, 1))
        assert got["tokens"] == one["tokens"]
        np.testing.assert_allclose(got["logits"], one["logits"],
                                   atol=LOGITS_TOL)
        launched = _get(rec, "family_launcher", arch)
        assert launched["mesh"] == [[1, 2], r]
        assert launched["tokens"] == alone.result.tokens.tolist()


def test_the_launcher_serves_on_two_ranks(two):
    """``launch.serve`` inside a gloo group of 2: a bound (1,2) mesh, rank 0
    prints, and the tokens are the one-process launcher's."""
    alone = serve_cli.run(LAUNCH_ARGV)
    assert tuple(alone.mesh.shape) == (1, 1) and not alone.mesh.bound
    for r, rec in enumerate(two):
        got = rec["'launcher'"]
        assert got["code"] == 0
        assert got["mesh"] == [["data", "model"], [1, 2], r]
        assert got["tokens"] == alone.result.tokens.tolist()
        assert got["kv_bytes"] == alone.kv_bytes
        if r == 0:
            assert "[serve] arch=qwen2-1.5b-reduced mesh=data=1xmodel=2" \
                in got["stdout"]
        else:
            assert got["stdout"] == ""


def test_the_launcher_refuses_a_mesh_smaller_than_its_world(two):
    """Two ranks asked for a (1,1) mesh: every rank refuses, as the train
    launcher does."""
    for rec in two:
        assert "must use them all" in rec["'launcher_small_mesh'"]


# ---------------------------------------------------------------------------
# (1) GPipe
# ---------------------------------------------------------------------------


def test_gpipe_on_four_stages_matches_the_reference(ref, eight):
    """The twin of ``tests/test_distribution.py``'s GPipe test: 4 stages
    over gloo (each data row of a (2,4) ("data", "stage") mesh one
    pipeline) equal the reference's ``make_gpipe`` on 4 forced devices and
    the port's ``reference_pipeline``, within 1e-5, on every rank."""
    want = ref[1]["gpipe"]
    np.testing.assert_allclose(want["y"], want["y_seq"], atol=1e-5)
    for rec in eight:
        got = np.asarray(rec["'gpipe'"]["y"], np.float32)
        np.testing.assert_allclose(got, want["y"], atol=1e-5)
        np.testing.assert_allclose(got, rec["'gpipe'"]["y_seq"], atol=1e-5)


def test_gpipe_without_a_group_is_the_sequential_oracle():
    """One stage and no process group: no collective runs, and the result
    is ``reference_pipeline``'s bit for bit; a stage axis the mesh lacks,
    or an ``x_spec`` naming it, is refused."""
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(1, 8, 8, generator=g), "b": torch.zeros(1, 1, 8)}
    x = torch.randn(5, 2, 8, generator=g)

    def apply_stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    mesh = Mesh(("stage",), (1,))
    y = pipeline.make_gpipe(mesh, apply_stage, n_micro=5)(params, x)
    assert torch.equal(y, pipeline.reference_pipeline(apply_stage, params, x))
    with pytest.raises(ValueError):
        pipeline.make_gpipe(Mesh(("data",), (1,)), apply_stage, n_micro=5)
    with pytest.raises(ValueError):
        pipeline.make_gpipe(mesh, apply_stage, n_micro=5,
                            x_spec=sharding.P("stage"))
    with pytest.raises(ValueError):
        pipeline.gpipe_schedule(apply_stage, n_stages=2, n_micro=3)


# ---------------------------------------------------------------------------
# (8) no mesh: today's behaviour
# ---------------------------------------------------------------------------


def test_no_context_on_one_device_or_a_data_only_mesh():
    """``tensor_parallel`` is None with no process group, so ``forward``
    takes the path it took before (``tp=None``); the blocks of a one-device
    mesh are the leaves themselves."""
    cfg = get_config("qwen2-1.5b").reduced()
    rules = sharding.make_rules(cfg, Mesh(("data", "model"), (1, 1)),
                                global_batch=B)
    assert collectives.tensor_parallel(rules) is None
    gen = torch.Generator().manual_seed(0)
    params = lm.init_params(cfg, gen)
    tokens = torch.randint(0, cfg.vocab_size, (B, 8), generator=gen)
    a, _, _ = lm.forward(params, tokens, cfg=cfg, mode="prefill", max_len=8)
    b, _, _ = lm.forward(params, tokens, cfg=cfg, mode="prefill", max_len=8,
                         tp=None)
    assert torch.equal(a, b)
    assert lm.cache_struct(cfg, B, 8, rules=rules)["scan"]["p0"]["k"].shape \
        == lm.cache_struct(cfg, B, 8)["scan"]["p0"]["k"].shape


def test_kv_heads_of_maps_every_block_as_the_kernel_reads_it():
    """For every (H, KV, tp) that divides, the KV heads handed to the
    kernel make its local map ``j·KVl // Hl`` read global head
    ``h·KV // H``."""
    from repro_torch.models.attention import kv_heads_of
    for h in range(1, 17):
        for kv in range(1, h + 1):
            if h % kv:
                continue
            for tp in range(1, h + 1):
                if h % tp:
                    continue
                hl = h // tp
                for i in range(tp):
                    idx = kv_heads_of(i * hl, hl, h, kv)
                    for j in range(hl):
                        assert idx[j * len(idx) // hl] == \
                            (i * hl + j) * kv // h, (h, kv, tp, i, j)

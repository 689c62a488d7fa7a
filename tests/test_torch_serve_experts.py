"""Port vs reference for serving the MoE and Mamba-2 families on a model
axis, on the CPU: experts split over "model" (route all, compute own, sum)
and SSM heads split over "model" (head-aligned columns, two sums).

The reference runs once, in a subprocess with 8 forced host devices (the
``run_forced`` pattern of ``tests/test_distribution.py``): its init of
olmoe-1b-7b, phi3.5-moe, mamba2-370m and jamba-v0.1-52b ``reduced()``, a
prefill and one decode step of each on (1,1), (1,2), (2,2) and (1,4), and
two configurations whose split the rules replicate on (1,4): olmoe with 6
experts and mamba2 with 2 SSM heads (``head_dim`` 64).  The port runs in
two launches over ``gloo``, one interpreter a rank at the lowest
priority, meeting in a file store under the test's temporary directory,
each joined within ``RANK_LIMIT`` and killed past it: 4 ranks for (1,4)
and (2,2), 2 ranks for (1,2).  Every rank of the 4-rank launch also serves
on an unbound one-device mesh, the port's (1,1).  Weights come from the
reference's init through ``models.convert``; tokens from numpy.  Limits,
set beforehand:
- logits, float32: within 3e-4 of the reference's on the same mesh and of
  the port's (1,1) (the split sums change only the order of float32
  sums);
- greedy tokens: equal on every rank and to (1,1);
- blocks, bytes and collectives: exact.
"""
import os
import pickle
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models import blocks, lm, mamba, moe
from repro_torch.parallel import collectives, sharding
from repro_torch.serve import engine as eng

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
RANK_LIMIT = 200            # seconds for one multi-rank launch
REF_LIMIT = 300             # seconds for the reference subprocess
B, PROMPT, NEW = 2, 12, 4
LOGITS_TOL = 3e-4
SPLIT = ((1, 2), (2, 2), (1, 4))
# key -> (arch, MoE fields, SSM fields) over its reduced() config
VARIANTS = {"olmoe-1b-7b": ("olmoe-1b-7b", None, None),
            "phi3.5-moe-42b-a6.6b": ("phi3.5-moe-42b-a6.6b", None, None),
            "mamba2-370m": ("mamba2-370m", None, None),
            "jamba-v0.1-52b": ("jamba-v0.1-52b", None, None),
            "olmoe-6e": ("olmoe-1b-7b", {"n_experts": 6}, None),
            "mamba2-2h": ("mamba2-370m", None, {"head_dim": 64})}
FAMILIES = ("olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "mamba2-370m",
            "jamba-v0.1-52b")
REPLICATED = ("olmoe-6e", "mamba2-2h")
# (key, the meshes the reference serves it on)
REF_RUNS = tuple((k, ((1, 1),) + SPLIT) for k in FAMILIES) + \
    tuple((k, ((1, 1), (1, 4))) for k in REPLICATED)
CASES = [(k, s) for k in FAMILIES for s in SPLIT] + \
    [(k, (1, 4)) for k in REPLICATED]

MAKE_CFG = """
import dataclasses
def make_cfg(get_config, key):
    arch, moe_f, ssm_f = VARIANTS[key]
    cfg = get_config(arch).reduced()
    if moe_f:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe_f))
    if ssm_f:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               **ssm_f))
    return cfg
"""
_NS: dict = {"VARIANTS": VARIANTS}
exec(MAKE_CFG, _NS)


def make_cfg(key):
    return _NS["make_cfg"](get_config, key)


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
from repro.parallel.sharding import make_rules
from repro.serve import engine as eng

out = {}
for key, meshes in REF_RUNS:
    cfg = make_cfg(get_config, key)
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
    out[key] = rec
with open(OUT, "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref_serve_experts") / "ref.pkl")
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        os.environ["JAX_PLATFORMS"] = "cpu"
        REF_RUNS = {REF_RUNS!r}
        VARIANTS = {VARIANTS!r}
        B, PROMPT, NEW = {B}, {PROMPT}, {NEW}
        OUT = {path!r}
    """) + textwrap.dedent(MAKE_CFG) + textwrap.dedent(REF_BODY)
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
import os, pickle, sys
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

# every rank: the reference's weights and tokens; a prefill + decode step
# on a mesh, the rank's blocks and caches, the counted collectives; a
# generate
PORT_COMMON = """
from repro_torch import tree
from repro_torch.analysis import cost
from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models import convert, lm
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import P
from repro_torch.serve import engine as eng
B, PROMPT, NEW = {B}, {PROMPT}, {NEW}
VARIANTS = {VARIANTS!r}
with open(REF, "rb") as f:
    REFS = pickle.load(f)
RESULT = {{}}
BOUND = {{}}


def on_mesh(shape):
    # (1,1): an unbound one-device mesh, the port's (1,1); else bound once
    if shape == (1, 1):
        return Mesh(("data", "model"), shape)
    if shape not in BOUND:
        BOUND[shape] = collectives.bind(Mesh(("data", "model"), shape))
    return BOUND[shape]


def setup_key(key, shape):
    cfg = make_cfg(get_config, key)
    mesh = on_mesh(shape)
    rules = sharding.make_rules(cfg, mesh, global_batch=B,
                                shape_kind="decode")
    params = convert.params_from_numpy(REFS[key]["params"], "cpu")
    return cfg, mesh, rules, params


def whole_rows(x, rules):
    g = collectives.axis_group(rules.mesh, rules.batch) \\
        if rules.mesh.bound else None
    if g is None or g.size == 1:
        return x
    return collectives.gather(x, P(rules.batch, None), rules.mesh,
                              (B,) + tuple(x.shape[1:]))


def steps(key, shape, count=False):
    cfg, mesh, rules, params = setup_key(key, shape)
    local = eng.rank_params(cfg, rules, params) if mesh.bound else params
    rows = (collectives.block_slices((B,), P(rules.batch or None), mesh)[0]
            if mesh.bound else slice(None))
    tokens = torch.from_numpy(REFS[key]["tokens"]).long()[rows]
    prefill = eng.make_prefill_step(cfg, rules, max_len=PROMPT + NEW)
    decode = eng.make_decode_step(cfg, rules)
    caches, l1 = prefill(local, tokens)
    shapes = [list(t.shape) for t in tree.leaves(caches)]
    caches, l2 = decode(local, caches, tokens[:, -1:], PROMPT)
    rec = {{"prefill": whole_rows(l1, rules).numpy(),
           "decode": whole_rows(l2, rules).numpy(),
           "coords": mesh.coords,
           "blocks": {{p: t.numpy() for p, t in tree.flatten_with_path(local)
                      if "/moe/" in p or "/ssm/" in p}},
           "cache_shapes": shapes,
           "cache_shapes_decode": [list(t.shape)
                                   for t in tree.leaves(caches)],
           "cache_struct": [list(t.shape) for t in tree.leaves(
               lm.cache_struct(cfg, B, PROMPT + NEW, torch.float32,
                               rules=rules))],
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in tree.leaves(local))}}
    if count:
        caches, _ = prefill(local, tokens)
        cp = cost.analyze(prefill, local, tokens)
        cd = cost.analyze(decode, local, caches, tokens[:, -1:], PROMPT)
        rec["collectives"] = {{
            k: [[o.kind, o.bytes_per_call, o.group_size]
                for o in c.collectives] for k, c in
            (("prefill", cp), ("decode", cd))}}
    return rec


def generate(key, shape):
    cfg, mesh, rules, params = setup_key(key, shape)
    res = eng.ServeEngine(cfg, params, rules).generate(
        torch.from_numpy(REFS[key]["tokens"]).long(), max_new_tokens=NEW)
    return {{"tokens": res.tokens.tolist(), "logits": res.logits.numpy()}}


def serve_all(shapes, keys):
    for shape in shapes:
        for key in keys:
            RESULT[key, shape] = steps(key, shape, count=True)
            RESULT["gen", key, shape] = generate(key, shape)
    with open(os.path.join(OUT, f"rank{{RANK}}.pkl"), "wb") as f:
        pickle.dump(RESULT, f)
"""

FOUR_BODY = """
serve_all(((1, 1), (1, 4)), FAMILIES + REPLICATED)
"""
# the (2,2) mesh binds after (1,4) in every rank, so its groups are made
# in the same order everywhere
FOUR_BODY_22 = """
serve_all(((2, 2),), FAMILIES)
"""
TWO_BODY = """
serve_all(((1, 2),), FAMILIES)
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
    head = (f"FAMILIES = {FAMILIES!r}\nREPLICATED = {REPLICATED!r}\n"
            + textwrap.dedent(MAKE_CFG)
            + textwrap.dedent(PORT_COMMON.format(
                B=B, PROMPT=PROMPT, NEW=NEW, VARIANTS=VARIANTS)))
    code = RANK_PRELUDE.format(body=textwrap.indent(
        head + textwrap.dedent(body), "    "))
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
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            recs.append(pickle.load(f))
    return recs


@pytest.fixture(scope="module")
def four(ref, tmp_path_factory):
    d = spawn(tmp_path_factory.mktemp("four"), 4,
              FOUR_BODY + FOUR_BODY_22, ref[0])
    return _ranks(d, 4)


@pytest.fixture(scope="module")
def two(ref, tmp_path_factory):
    d = spawn(tmp_path_factory.mktemp("two"), 2, TWO_BODY, ref[0])
    return _ranks(d, 2)


def _launch(four, two, shape):
    return two if shape == (1, 2) else four


# ---------------------------------------------------------------------------
# Logits and tokens on every mesh, beside the reference's and (1,1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key,shape", CASES)
def test_prefill_and_decode_logits_match_the_reference(ref, four, two, key,
                                                       shape):
    """A prefill and one decode step with the experts and the SSM heads
    split over "model" (replicated where they do not divide): every rank's
    whole logits within 3e-4 of the reference's on the same mesh and of
    the port's (1,1), which holds the reference's (1,1) too."""
    want = ref[1][key]
    for r, rec in enumerate(_launch(four, two, shape)):
        got, one = rec[key, shape], four[r][key, (1, 1)]
        for step, i in (("prefill", 0), ("decode", 1)):
            tag = f"{key} {shape} rank {r} {step}"
            assert got[step].shape == want[shape][i].shape, tag
            np.testing.assert_allclose(got[step], want[shape][i],
                                       atol=LOGITS_TOL, err_msg=tag)
            np.testing.assert_allclose(got[step], one[step],
                                       atol=LOGITS_TOL, err_msg=tag)
            np.testing.assert_allclose(one[step], want[(1, 1)][i],
                                       atol=LOGITS_TOL, err_msg=tag)


@pytest.mark.parametrize("key,shape", CASES)
def test_greedy_tokens_are_equal_on_every_rank_and_to_one_device(
        four, two, key, shape):
    """A whole ``ServeEngine.generate`` of ``NEW`` greedy tokens: the same
    tokens on every rank and on (1,1), the last logits within 3e-4."""
    one = four[0]["gen", key, (1, 1)]
    assert np.asarray(one["tokens"]).shape == (B, NEW)
    for rec in _launch(four, two, shape):
        got = rec["gen", key, shape]
        assert got["tokens"] == one["tokens"]
        np.testing.assert_allclose(got["logits"], one["logits"],
                                   atol=LOGITS_TOL)


# ---------------------------------------------------------------------------
# Each rank's blocks: E/tp experts, head-aligned Mamba columns and state
# ---------------------------------------------------------------------------


def oracle_mamba_columns(cfg, tp, r):
    """The head-aligned columns of rank ``r``, restated: its heads' z, x
    and dt columns and every B/C column (one group); the conv channels,
    its x channels and every B/C channel."""
    s = cfg.ssm
    di, nh, ds, ng = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model), \
        s.d_state, s.n_groups
    assert ng == 1
    hp, nhl = s.head_dim, nh // tp
    heads = np.arange(r * nhl, (r + 1) * nhl)
    zx = (heads[:, None] * hp + np.arange(hp)[None]).reshape(-1)
    bc = np.arange(2 * ds)
    proj = np.concatenate([zx, di + zx, 2 * di + bc, 2 * di + 2 * ds + heads])
    conv = np.concatenate([zx, di + bc])
    return proj, conv, heads


def expected_block(cfg, rules, path, whole, coords):
    """The block a rank must hold, from the spec and the restated column
    map: the experts' block ``E/tp``, the head-aligned Mamba columns, the
    spec's block of every other leaf; every Mamba leaf whole where the
    heads do not divide."""
    mesh = rules.mesh
    tp = mesh.axis_sizes["model"]
    parts = path.split("/")
    leaf = parts[-1]
    if len(parts) > 1 and parts[-2] == "ssm":
        nh = cfg.ssm.n_heads(cfg.d_model)
        if tp == 1 or nh % tp:
            return whole
        proj, conv, _ = oracle_mamba_columns(cfg, tp, coords["model"])
        idx = {"w_zxbcdt": proj, "conv_w": conv, "conv_b": conv}.get(leaf)
        if idx is not None and isinstance(whole, torch.Tensor):
            return whole.index_select(-1, torch.as_tensor(
                idx, device=whole.device))
        if idx is not None:
            return whole[..., idx]
    sl = collectives.block_slices(whole.shape,
                                  lm.param_spec(rules, path, whole.shape),
                                  mesh, coords)
    return whole[sl]


@pytest.mark.parametrize("key,shape", CASES)
def test_each_rank_holds_exactly_its_blocks(ref, four, two, key, shape):
    """Every MoE and Mamba leaf a rank holds is its block: ``E/tp`` experts
    (``we_*``) where the experts divide, whole otherwise; the head-aligned
    columns of ``w_zxbcdt``, ``conv_w`` and ``conv_b``; the spec's blocks
    of ``A_log``, ``dt_bias``, ``ssm_D``, ``ssm_norm``, ``w_ssm_out``.  Its
    caches are ``cache_struct``'s blocks: the state's ``nh/tp`` heads and
    the conv cache's head-aligned channels."""
    cfg = make_cfg(key)
    whole = {p: np.asarray(t) for p, t in tree.flatten_with_path(
        ref[1][key]["params"])}
    rules = sharding.make_rules(cfg, Mesh(("data", "model"), shape),
                                global_batch=B, shape_kind="decode")
    tp = shape[1]
    for rec in _launch(four, two, shape):
        got = rec[key, shape]
        assert got["blocks"], key
        for path, blk in got["blocks"].items():
            want = expected_block(cfg, rules, path, whole[path],
                                  got["coords"])
            assert blk.shape == want.shape, path
            assert np.array_equal(blk, want), path
            if path.endswith("we_in"):
                e = cfg.moe.n_experts
                assert blk.shape[-3] == (e // tp if e % tp == 0 else e)
        assert got["cache_shapes"] == got["cache_struct"]
        assert got["cache_shapes_decode"] == got["cache_struct"]
    if cfg.ssm is not None:
        nh = cfg.ssm.n_heads(cfg.d_model)
        heads = nh // tp if nh % tp == 0 else nh
        cs = lm.rank_cache_struct(cfg, B, PROMPT + NEW, torch.float32, rules)
        for p, t in tree.flatten_with_path(cs):
            if p.endswith("/ssm"):
                assert t.shape[-3] == heads
            if p.endswith("/conv"):
                _, conv, _ = oracle_mamba_columns(cfg, tp if heads < nh
                                                  else 1, 0)
                assert t.shape[-1] == conv.size


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-v0.1-52b"])
def test_head_columns_cover_each_z_x_dt_column_once(arch):
    """At full size and reduced, for every model axis that divides the SSM
    heads: the union of the ranks' z, x and dt columns covers each column
    once, every rank holds every B/C column, and ``head_columns`` equals
    the restated map."""
    for cfg in (get_config(arch), get_config(arch).reduced()):
        s = cfg.ssm
        di, nh, ds = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model), s.d_state
        width = 2 * di + 2 * ds + nh
        bc = set(range(2 * di, 2 * di + 2 * ds))
        for tp in (1, 2, 4, 8, 16):
            if nh % tp:
                continue
            seen = np.zeros(width, np.int64)
            for r in range(tp):
                cols = mamba.head_columns(cfg, tp, r)
                idx = np.concatenate([np.arange(a, b)
                                      for a, b in cols["proj"]])
                cidx = np.concatenate([np.arange(a, b)
                                       for a, b in cols["conv"]])
                proj, conv, heads = oracle_mamba_columns(cfg, tp, r)
                assert np.array_equal(idx, proj) and \
                    np.array_equal(cidx, conv), (arch, tp, r)
                assert (cols["head0"], cols["heads"]) == (heads[0], nh // tp)
                assert bc <= set(idx.tolist())
                seen[idx] += 1
            assert (seen[sorted(bc)] == tp).all()
            rest = np.setdiff1d(np.arange(width), sorted(bc))
            assert (seen[rest] == 1).all(), (arch, tp)
    with pytest.raises(ValueError):
        mamba.head_columns(get_config("mamba2-370m").reduced(), 3, 0)


# ---------------------------------------------------------------------------
# The collectives: one sum a split MoE layer, two a split Mamba layer
# ---------------------------------------------------------------------------


def planned_collectives(cfg, rules, mode):
    """The oracle: the collectives one prefill (``PROMPT`` positions) or
    one decode step on ``rules.mesh`` runs, in order, ``[kind, operand
    bytes, group size]``, float32: the vocabulary-parallel embedding's
    sum; each layer's mixer (attention as in ``test_torch_serve_mesh``;
    a Mamba layer whose heads divide: the gated norm's (B,S,1) sum of
    squares and the (B,S,D) output), its FFN (a MoE layer whose experts
    divide: one (B,S,D) sum; a dense MLP whose d_ff divides: one); the
    logits' gather.  A layer the rules replicate runs none."""
    sizes = rules.mesh.axis_sizes
    tp = sizes["model"]
    bl = B // int(np.prod([sizes[a] for a in rules.batch]))
    seq = int(np.prod([sizes[a] for a in rules.kv_seq_axes]))
    s = PROMPT if mode == "prefill" else 1
    h, hd, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    hidden = bl * s * d * 4
    heads_cut = h and (rules.attn_mode == "head" or rules.q_heads_tp)
    calls = []
    if cfg.padded_vocab % tp == 0:
        calls.append(["all-reduce", hidden, tp])
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) == "attn":
            if mode == "decode" and rules.attn_mode == "seq":
                if rules.q_heads_tp:
                    calls.append(["all-gather", bl * (h // tp) * hd * 4, tp])
                calls.append(["all-reduce", bl * h * 4, seq])
                calls.append(["all-reduce", bl * h * (hd + 1) * 4, seq])
            if heads_cut:
                calls.append(["all-reduce", hidden, tp])
        elif cfg.ssm.n_heads(d) % tp == 0:
            calls.append(["all-reduce", bl * s * 4, tp])
            calls.append(["all-reduce", hidden, tp])
        if cfg.family == "ssm":
            continue
        if cfg.layer_is_moe(i):
            if cfg.moe.n_experts % tp == 0:
                calls.append(["all-reduce", hidden, tp])
        elif cfg.d_ff % tp == 0:
            calls.append(["all-reduce", hidden, tp])
    if cfg.padded_vocab % tp == 0:
        calls.append(["all-gather", bl * cfg.padded_vocab // tp * 4, tp])
    return calls


@pytest.mark.parametrize("key,shape", CASES)
def test_the_cost_counter_sees_one_sum_a_moe_layer_and_two_a_mamba_layer(
        four, two, key, shape):
    """``analysis.cost`` over a prefill and a decode step: the collectives,
    in order, kind, bytes and group, are :func:`planned_collectives`': one
    ``(B,S,D)`` all-reduce a split MoE layer, a ``(B,S,1)`` float32 and a
    ``(B,S,D)`` one a split Mamba layer, none for a replicated one."""
    cfg = make_cfg(key)
    rules = sharding.make_rules(cfg, Mesh(("data", "model"), shape),
                                global_batch=B, shape_kind="decode")
    for rec in _launch(four, two, shape):
        got = rec[key, shape]["collectives"]
        for mode in ("prefill", "decode"):
            assert got[mode] == planned_collectives(cfg, rules, mode), \
                (key, shape, mode)


# ---------------------------------------------------------------------------
# Rank views without a group: segments, refusals, bytes at full size
# ---------------------------------------------------------------------------


def _layer(params, path):
    node = params
    for k in path.split("/"):
        node = node[k]
    return node


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-v0.1-52b"])
def test_the_ranks_expert_segments_add_up_to_the_whole_layers(arch):
    """Each rank of model axes 2 and 4 runs the GEMMs of its own experts
    only: over the ranks its segments and rows add up to the whole
    layer's, and the partials sum to the whole output within 1e-5."""
    cfg = get_config(arch).reduced()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    i = next(i for i in range(cfg.n_layers) if cfg.layer_is_moe(i))
    period = blocks.make_plan(cfg).period
    path = f"scan/p{i % period}/moe"
    whole = {k: v[0] for k, v in _layer(params, path).items()}
    x = torch.randn(B, PROMPT, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    seen = []
    real = moe._expert_ffn

    def spy(seg, *a):
        seen.append(seg.shape[0])
        return real(seg, *a)

    moe._expert_ffn = spy
    try:
        want, _ = moe.moe_apply(whole, x, cfg, dropless=True)
        whole_segs = list(seen)
        for tp in (2, 4):
            rules = sharding.make_rules(cfg, Mesh(("data", "model"), (1, tp)),
                                        global_batch=B, shape_kind="decode")
            segs, total = [], torch.zeros_like(want)
            for r in range(tp):
                del seen[:]
                loc = {k: eng.rank_block(cfg, rules, f"{path}/{k}", v[None],
                                         {"data": 0, "model": r})[0]
                       for k, v in whole.items()}
                assert loc["we_in"].shape[0] == cfg.moe.n_experts // tp
                y, _ = moe.moe_apply(loc, x, cfg, dropless=True,
                                     tp=collectives.rank_view(rules, r))
                total += y
                segs += seen
            assert segs == whole_segs, tp
            assert sum(segs) == B * PROMPT * cfg.moe.top_k
            torch.testing.assert_close(total, want, atol=1e-5, rtol=0)
    finally:
        moe._expert_ffn = real


@pytest.mark.parametrize("arch,kind", [("olmoe-1b-7b", "moe"),
                                       ("mamba2-370m", "ssm"),
                                       ("jamba-v0.1-52b", "moe"),
                                       ("jamba-v0.1-52b", "ssm")])
def test_train_mode_with_a_split_raises_naming_the_next_item(arch, kind):
    """A MoE or Mamba layer in train mode on a model axis of 2 runs (the
    split in training; no layer refuses any more): ``layer_apply`` in
    train mode on a rank view gives finite values, capacity-mode
    ``moe_apply`` on each rank's experts sums to the whole layer's output
    within 1e-5 with the same drops, and the Mamba layer's ranks (their
    sums of squares added before ``mamba_out``) sum to the whole train
    output within 1e-5.  Prefill on the same rank view runs."""
    cfg = get_config(arch).reduced()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    rules = sharding.make_rules(cfg, Mesh(("data", "model"), (1, 2)),
                                global_batch=B, shape_kind="decode")
    i = next(i for i in range(cfg.n_layers)
             if (cfg.layer_is_moe(i) if kind == "moe"
                 else cfg.layer_kind(i) == "ssm"))
    period = blocks.make_plan(cfg).period
    path = f"scan/p{i % period}"

    def rank_leaves(r):
        return tree.unflatten_like(
            _layer(params, path),
            [eng.rank_block(cfg, rules, f"{path}/{p}", t,
                            {"data": 0, "model": r})[0]
             for p, t in tree.flatten_with_path(_layer(params, path))])

    node = _layer(params, path)
    whole = tree.unflatten_like(node, [t[0] for t in tree.leaves(node)])
    lp = rank_leaves(0)
    x = torch.randn(B, PROMPT, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    view = collectives.rank_view(rules, 0)
    y, _, _ = blocks.layer_apply(lp, x, cfg=cfg, layer_idx=i % period,
                                 mode="train", tp=view)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    views = [collectives.rank_view(rules, r) for r in range(2)]
    locs = [rank_leaves(r) for r in range(2)]
    if kind == "moe":
        want, waux = moe.moe_apply(whole["moe"], x, cfg, dropless=False)
        parts = [moe.moe_apply(locs[r]["moe"], x, cfg, dropless=False,
                               tp=views[r]) for r in range(2)]
        for _, aux in parts:
            assert float(aux["moe_drop_frac"]) == \
                float(waux["moe_drop_frac"])
        got = parts[0][0] + parts[1][0]
    else:
        want, _ = mamba.mamba_layer(whole["ssm"], x, cfg=cfg, mode="train")
        mixed = [mamba.mamba_mix(locs[r]["ssm"], x, cfg=cfg, mode="train",
                                 tp=views[r]) for r in range(2)]
        sumsq = mixed[0][1] + mixed[1][1]
        got = sum(mamba.mamba_out(locs[r]["ssm"], mixed[r][0], sumsq, cfg)
                  for r in range(2))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    y, _, _ = blocks.layer_apply(lp, x, cfg=cfg, layer_idx=i % period,
                                 mode="prefill", max_len=PROMPT, tp=view)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())


def _nbytes(t):
    return t.numel() * t.element_size()


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "phi3.5-moe-42b-a6.6b"])
def test_a_ranks_bytes_at_full_size_are_a_quarter_and_the_replicated(arch):
    """At full size on (1,4), from ``meta`` structs (nothing allocated):
    a rank's parameter bytes (:func:`engine.rank_params`) are its blocks'
    exactly, and at most a quarter of the whole plus the leaves the rules
    replicate and the B/C columns every rank holds; its serve caches
    (batch 4 x 2080) likewise."""
    cfg = get_config(arch)
    rules = sharding.make_rules(cfg, Mesh(("data", "model"), (1, 4)),
                                global_batch=4, shape_kind="decode")
    struct = lm.param_struct(cfg)
    specs = dict(tree.flatten_with_path(lm.param_specs(rules, struct)))
    whole = replicated = 0
    for p, t in tree.flatten_with_path(struct):
        whole += _nbytes(t)
        if not collectives.spec_axes(specs[p]):
            replicated += _nbytes(t)
        elif p.split("/")[-1] in ("w_zxbcdt", "conv_w", "conv_b"):
            ds = cfg.ssm.d_state * cfg.ssm.n_groups
            replicated += _nbytes(t) // t.shape[-1] * 2 * ds
    for r in range(4):
        coords = {"data": 0, "model": r}
        blk = eng.rank_params(cfg, rules, struct, coords)
        got = sum(_nbytes(t) for t in tree.leaves(blk))
        want = 0
        for p, t in tree.flatten_with_path(struct):
            want += _nbytes(expected_block(cfg, rules, p, t, coords))
        assert got == want
        assert got <= whole / 4 + replicated
        assert got < whole / 2
    cs = lm.rank_cache_struct(cfg, 4, 2080, torch.bfloat16, rules)
    ws = lm.cache_struct(cfg, 4, 2080, torch.bfloat16)
    c_got = sum(_nbytes(t) for t in tree.leaves(cs))
    c_whole = sum(_nbytes(t) for t in tree.leaves(ws))
    bc = sum(_nbytes(t) // t.shape[-1] * 2 * cfg.ssm.d_state
             for p, t in tree.flatten_with_path(ws) if p.endswith("/conv")) \
        if cfg.ssm else 0
    assert c_got <= c_whole / 4 + bc

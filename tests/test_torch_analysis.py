"""Port vs reference for the analysis layer, on the CPU.

The port's cost counter (``repro_torch.analysis.cost``) counts the aten
operations a call dispatches and the work the hand-written kernels
report; the reference's parser (``repro.analysis.hlo``) reads the HLO of
the same function compiled by XLA on the CPU.  The roofline and profile
modules are ports of the reference's, with the H100's constants.

Tolerances, stated beforehand: FLOPs are integers far inside float64's
53 bits, so every count of products is held exactly (a product counts
2·M·N·K in both packages); bytes are held exactly where the test reckons
them from shapes, and by a bound where the reference's test bounds them;
``effective_hbm_bw`` on the same CurveDB JSON exactly (the same
interpolation on the same floats); ``model_flops`` bit for bit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F

from repro.analysis import hlo as jhlo
from repro.analysis import roofline as jroofline
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.base import get_config as jget_config
from repro.core import characterize as jchar
from repro.core.coordinator import CoreCoordinator as JCoreCoordinator
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.models import lm as jlm
from repro.parallel.sharding import make_rules as jmake_rules
from repro.serve import engine as jeng
from repro.train import step as jstep
from repro_torch import tree
from repro_torch.analysis import cost, profile, roofline
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.configs.base import TrainConfig
from repro_torch.core.characterize import CurveDB
from repro_torch.kernels import chase, compute_probe, contention, counts
from repro_torch.kernels import flash_attention, stream
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import convert
from repro_torch.parallel.sharding import make_rules
from repro_torch.serve import engine as eng
from repro_torch.train import step as step_mod

B, S = 2, 64


def _hlo(fn, *structs) -> jhlo.HloCost:
    return jhlo.analyze(jax.jit(fn).lower(*structs).compile().as_text())


def _f32(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


# ---------------------------------------------------------------------------
# Roofline math (the twins of tests/test_analysis.py, on the H100's numbers)
# ---------------------------------------------------------------------------


def test_h100_constants():
    """NVIDIA's H100 SXM datasheet: 989 TFLOP/s bf16 dense, 3.35 TB/s,
    NVLink 900 GB/s over both directions of 18 links."""
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.NVLINK_BW * roofline.N_NVLINK_LINKS * 2 == 900e9


def test_roofline_terms_and_bottleneck():
    cfg = get_config("qwen2-1.5b")
    shape = SHAPES["train_4k"]
    c = cost.Cost(flops=1e15, bytes=1e12, collective_bytes=1e10)
    t = roofline.compute_terms(c, cfg=cfg, shape=shape, mesh_desc="test",
                               n_devices=256)
    assert t.t_compute == pytest.approx(1e15 / roofline.PEAK_FLOPS)
    assert t.t_memory == pytest.approx(1e12 / roofline.HBM_BW)
    assert t.t_collective == pytest.approx(
        1e10 / (roofline.NVLINK_BW * roofline.N_NVLINK_LINKS))
    assert t.bottleneck == "compute"
    assert t.t_bound == t.t_compute
    assert 0 < t.roofline_fraction <= 1.5


@pytest.mark.parametrize("flops,nbytes,coll,want", [
    (1e12, 1e12, 0.0, "memory"), (1e9, 1e6, 1e12, "collective"),
    (1e15, 1e6, 1e6, "compute")])
def test_bottleneck_is_the_largest_term(flops, nbytes, coll, want):
    t = roofline.compute_terms(
        cost.Cost(flops=flops, bytes=nbytes, collective_bytes=coll),
        cfg=get_config("qwen2-1.5b"), shape=SHAPES["prefill_32k"],
        mesh_desc="m", n_devices=1)
    assert t.bottleneck == want
    assert t.t_bound == max(t.t_compute, t.t_memory, t.t_collective)


def test_memory_term_takes_an_effective_bandwidth():
    t = roofline.compute_terms(
        cost.Cost(flops=1.0, bytes=3e9), cfg=get_config("qwen2-1.5b"),
        shape=SHAPES["decode_32k"], mesh_desc="m", n_devices=1,
        hbm_bw=1.5e12)
    assert t.t_memory == pytest.approx(3e9 / 1.5e12)


def test_model_flops_by_kind():
    cfg = get_config("qwen2-1.5b")
    n = cfg.n_active_params()
    assert roofline.model_flops(cfg, SHAPES["train_4k"]) == \
        6.0 * n * SHAPES["train_4k"].tokens
    assert roofline.model_flops(cfg, SHAPES["prefill_32k"]) == \
        2.0 * n * SHAPES["prefill_32k"].tokens
    assert roofline.model_flops(cfg, SHAPES["decode_32k"]) == \
        2.0 * n * SHAPES["decode_32k"].global_batch


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list_configs())
def test_model_flops_equal_the_reference(arch, shape):
    assert len(list_configs()) == 10
    assert roofline.model_flops(get_config(arch), SHAPES[shape]) == \
        jroofline.model_flops(jget_config(arch), JSHAPES[shape])


def test_moe_active_flops_smaller():
    moe = get_config("phi3.5-moe-42b-a6.6b")
    assert roofline.model_flops(moe, SHAPES["train_4k"]) < \
        6.0 * moe.n_params() * SHAPES["train_4k"].tokens * 0.5


@pytest.mark.parametrize("kind", ["train", "prefill", "decode", "other"])
def test_workload_rw_mix_equals_the_reference(kind):
    class _Shape:
        pass
    _Shape.kind = kind
    assert roofline.workload_rw_mix(_Shape()) == \
        jroofline.workload_rw_mix(_Shape())


def test_terms_save_load(tmp_path):
    cfg = get_config("qwen2-1.5b")
    t = roofline.compute_terms(
        cost.Cost(flops=1e12, bytes=1e11, collective_bytes=1e9),
        cfg=cfg, shape=SHAPES["train_4k"], mesh_desc="m", n_devices=4)
    p = str(tmp_path / "t.json")
    roofline.save_terms(t, p)
    d = roofline.load_terms(p)
    assert d["bottleneck"] == t.bottleneck
    assert d["t_bound"] == t.t_bound
    table = roofline.table([d])
    assert "qwen2-1.5b" in table and table.count("\n") == 2


def test_save_terms_writes_the_references_keys(tmp_path):
    jt = jroofline.compute_terms(
        jhlo.HloCost(flops=1e12, bytes=1e11, collective_bytes=1e9),
        cfg=jget_config("qwen2-1.5b"), shape=JSHAPES["train_4k"],
        mesh_desc="m", n_devices=4)
    t = roofline.compute_terms(
        cost.Cost(flops=1e12, bytes=1e11, collective_bytes=1e9),
        cfg=get_config("qwen2-1.5b"), shape=SHAPES["train_4k"],
        mesh_desc="m", n_devices=4)
    jroofline.save_terms(jt, str(tmp_path / "j.json"))
    roofline.save_terms(t, str(tmp_path / "t.json"))
    want = json.load(open(tmp_path / "j.json"))
    got = json.load(open(tmp_path / "t.json"))
    assert list(got) == list(want)
    # the table reads either package's dict the same way
    assert roofline.table([got]).splitlines()[0] == \
        jroofline.table([want]).splitlines()[0]


@pytest.fixture(scope="module")
def surface_json(tmp_path_factory):
    """The reference's measured 3-axis surface grid (simulate physics),
    saved as JSON: tests/test_surface.py's fixture."""
    db = jchar.characterize_surface(
        JCoreCoordinator(backend="simulate"), pools=["hbm", "host"],
        stress_pools=["hbm"], rw_ratios=(0.0, 0.5, 1.0),
        inject_rates=(0.25, 0.5, 1.0), iters=5)
    path = str(tmp_path_factory.mktemp("surface") / "db.json")
    db.save(path)
    return db, path


@pytest.mark.parametrize("n,strat,rw,ir", [
    (0, "w", None, None), (2, "b", 0.9, None), (2, "b", 0.0, None),
    (2, "b", 1.0, None), (5, "b", 2.0 / 3.0, 0.5), (0, "w", 0.75, None),
    (7, "r", None, None), (3, "y", None, 0.3)])
def test_effective_hbm_bw_equals_the_reference(surface_json, n, strat, rw,
                                               ir):
    """The twin of test_surface.py's memory-term test: the port's CurveDB
    loaded from the reference's JSON answers the same bandwidth."""
    jdb, path = surface_json
    kw = dict(n_stressors=n, stress_strategy=strat, rw_ratio=rw,
              inject_rate=ir)
    got = roofline.effective_hbm_bw(CurveDB.load(path), **kw)
    assert got == jroofline.effective_hbm_bw(jdb, **kw)
    assert got > 0


def test_effective_hbm_bw_follows_the_workload_mix(surface_json):
    db = CurveDB.load(surface_json[1])
    mix = roofline.workload_rw_mix(SHAPES["decode_32k"])
    bw_mix, bw_w, bw_r = (roofline.effective_hbm_bw(
        db, n_stressors=2, stress_strategy="b", rw_ratio=r)
        for r in (mix, 0.0, 1.0))
    assert bw_w < bw_mix <= bw_r


# ---------------------------------------------------------------------------
# The counter against the reference's HLO parser
# ---------------------------------------------------------------------------


def test_dot_flops_exact():
    want = _hlo(lambda a, b: a @ b, _f32(64, 128), _f32(128, 32)).flops
    got = cost.analyze(lambda a, b: a @ b, torch.randn(64, 128),
                       torch.randn(128, 32)).flops
    assert got == want == 2 * 64 * 128 * 32


def _loop(x, w):
    for _ in range(5):
        x = torch.tanh(x @ w)
    return x


def test_loop_flops_equal_the_scan_trips():
    """A 5-step ``x @ w`` loop: the reference counts the scan body times
    its trip count, the counter each iteration as it runs (the twin of
    test_profiler_smoke and of the trip multiplier)."""
    def f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        y, _ = jax.lax.scan(body, x, None, length=5)
        return y

    want = _hlo(f, _f32(8, 32), _f32(32, 32))
    got = cost.analyze(_loop, torch.randn(8, 32), torch.randn(32, 32))
    assert list(want.while_trips.values()) == [5]
    assert got.flops == want.flops == 5 * 2 * 8 * 32 * 32
    # eager code has no loops to recover trips from
    assert got.while_trips == {} and got.unknown_trip_whiles == []
    assert got.ops["mm"][0] == 5 and got.ops["tanh"][0] == 5
    p = profile.profile(_loop, torch.randn(8, 32), torch.randn(32, 32))
    assert p["total_flops"] == 5 * 2 * 8 * 32 * 32
    assert profile.render(p)


def test_batch_einsum_flops():
    want = _hlo(lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                _f32(4, 16, 32), _f32(4, 32, 8)).flops
    got = cost.analyze(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                       torch.randn(4, 16, 32), torch.randn(4, 32, 8)).flops
    assert got == want == 2 * 4 * 16 * 32 * 8


def test_conv1d_flops():
    def jconv(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (1,), "VALID", dimension_numbers=("NCH", "OIH", "NCH"))

    want = _hlo(jconv, _f32(2, 8, 32), _f32(16, 8, 5)).flops
    got = cost.analyze(F.conv1d, torch.randn(2, 8, 32),
                       torch.randn(16, 8, 5)).flops
    assert got == want == 2 * 2 * 16 * 28 * 8 * 5


def test_movement_bytes_split():
    """A dtype copy is tallied in ``movement_bytes`` and, unlike the
    reference (where it is a CPU-compile artifact), in ``bytes`` too: on
    the card it runs."""
    def f(x):
        y = x.float()
        return y * y

    c = cost.analyze(f, torch.randn(64, 64).to(torch.bfloat16))
    conv_bytes = 64 * 64 * 2 + 64 * 64 * 4
    assert c.movement_bytes == conv_bytes
    assert c.bytes == conv_bytes + 3 * 64 * 64 * 4  # two reads + one write


def test_contiguous_transpose_is_movement():
    x = torch.randn(4, 8, 16)
    c = cost.analyze(lambda t: t.transpose(1, 2).contiguous(), x)
    assert c.movement_bytes == c.bytes == 2 * x.numel() * 4
    assert list(c.ops) == ["clone"]


def test_stacked_param_slice_bytes_not_inflated():
    """Reading one (64,64) layer of a (24,64,64) stack a step costs about
    one slice, not the stack (the twin of
    test_stacked_param_scan_bytes_not_inflated): exactly the slice, the
    activation and the output of each product and tanh."""
    def f(x, stack):
        for i in range(stack.shape[0]):
            x = torch.tanh(x @ stack[i])
        return x

    c = cost.analyze(f, torch.randn(8, 64), torch.randn(24, 64, 64))
    stack_bytes = 24 * 64 * 64 * 4
    act = 8 * 64 * 4
    assert c.bytes == 24 * ((64 * 64 * 4 + 2 * act) + 2 * act)
    assert c.bytes < 6 * stack_bytes


def test_views_and_allocations_count_nothing():
    def f(x):
        y = x.view(16, 4).t().unsqueeze(0).expand(3, 4, 16)
        torch.empty(1000)
        torch.empty_like(x)
        return y

    c = cost.analyze(f, torch.randn(64))
    assert c.bytes == c.flops == 0 and c.ops == {}


def test_broadcast_operand_counts_its_storage():
    x, b = torch.randn(32, 64), torch.randn(64)
    c = cost.analyze(lambda x, b: x + b.expand(32, 64), x, b)
    assert c.bytes == (2 * 32 * 64 + 64) * 4


def test_gather_counts_its_rows_not_the_table():
    table, idx = torch.randn(1000, 64), torch.tensor([[1, 5, 7]])
    c = cost.analyze(lambda t, i: t[i], table, idx)
    assert c.bytes == 2 * 3 * 64 * 4 + 3 * 8


def test_only_the_calls_devices_are_counted():
    """An operation that touches no tensor on the counted call's devices
    (the host's bookkeeping beside a call on the card; here a meta tensor
    beside a CPU call) counts nothing."""
    def f(x):
        torch.ones(8, device="meta") * 2
        return x * 2

    c = cost.analyze(f, torch.randn(16))
    assert c.bytes == 2 * 16 * 4 and list(c.ops) == ["mul"]


def test_counter_refuses_to_run_under_the_profiler():
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="profiler"):
            cost.analyze(lambda x: x * 2, torch.randn(4))
    assert counts.SINKS == []


def test_collectives_are_counted_with_their_group(tmp_path):
    """c10d collectives, in a one-rank gloo group (a file store, no
    socket): their operand bytes, by kind (none on one device in the
    model paths)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        def f(x):
            dist.all_reduce(x)
            out = [torch.empty(16, 16)]
            dist.all_gather(out, x)      # its outputs come first
            # a functional collective names its group; its wait counts
            # nothing
            return funcol.all_reduce(x, "sum", dist.group.WORLD) * 1

        c = cost.analyze(f, torch.ones(16, 16))
    finally:
        dist.destroy_process_group()
    assert [(o.kind, o.bytes_per_call, o.group_size, o.trips)
            for o in c.collectives] == [("all-reduce", 1024, 1, 1),
                                        ("all-gather", 1024, 1, 1),
                                        ("all-reduce", 1024, 1, 1)]
    assert c.collective_bytes == 3072
    assert c.collective_summary() == {"all-reduce": 2048.0,
                                      "all-gather": 1024.0}
    assert list(c.ops) == ["mul"] and c.bytes == 2 * 1024


# ---------------------------------------------------------------------------
# The hand-written kernels report their counted work
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq,sk,causal,window", [
    (128, 128, True, 0), (200, 200, True, 64), (200, 328, True, 0),
    (328, 200, False, 0), (200, 16, False, 8), (77, 77, True, 500)])
def test_admitted_pairs_count_the_mask(sq, sk, causal, window):
    q, k = np.arange(sq)[:, None], np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= k <= q
    if window:
        mask &= k > q - window
    assert flash_attention.admitted_pairs(sq, sk, causal, window) == \
        int(mask.sum())


def _qkv(b, h, kvh, sq, sk, d, dtype=torch.float32, grad=False):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(shape, generator=g).to(dtype).requires_grad_(grad)
            for shape in ((b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d))]


@pytest.mark.parametrize("block_q,block_k", [(128, 128), (64, 32), (16, 16),
                                             (200, 256), (96, 160)])
def test_flash_plain_version_counts_the_kernels_work(block_q, block_k):
    """The plain version's tiled products are hidden from the counter,
    which counts the kernel's work instead: 4·D a head and admitted pair,
    q, k, v and o once, the same at every tiling."""
    q, k, v = _qkv(1, 4, 2, 200, 200, 32, torch.bfloat16)
    kw = dict(causal=True, window=64, block_q=block_q, block_k=block_k)
    c = cost.analyze(flash_attention.flash_attention, q, k, v, **kw)
    pairs = flash_attention.admitted_pairs(200, 200, True, 64)
    flops, nbytes = 4 * 32 * 4 * pairs, (2 * q.numel() + 2 * k.numel()) * 2
    assert flash_attention.forward_work(q, k, v, causal=True, window=64) \
        == (flops, nbytes)
    assert c.kernels == {"flash_attention": [1, flops, nbytes]}
    assert (c.flops, c.bytes) == (flops, nbytes) and c.ops == {}


@pytest.mark.parametrize("block_q,block_k", [(128, 128), (32, 64)])
def test_flash_gradient_counts_both_kernels(block_q, block_k):
    """Through the autograd Function: the forward with its log-sum-exp,
    the backward at 10·D a pair with q, k, v, o, do, lse read and dq, dk,
    dv written; nothing of the plain versions."""
    q, k, v = _qkv(2, 4, 1, 96, 96, 16, grad=True)
    do = torch.randn(2, 4, 96, 16)

    def fwd_bwd(q, k, v, do):
        flash_attention.flash_attention(q, k, v, causal=True, window=0,
                                        block_q=block_q,
                                        block_k=block_k).backward(do)

    c = cost.analyze(fwd_bwd, q, k, v, do)
    pairs = flash_attention.admitted_pairs(96, 96, True, 0)
    qb, kb, lse = q.numel() * 4, k.numel() * 4, 2 * 4 * 96 * 4
    assert c.kernels == {
        "flash_attention": [1, 4 * 16 * 4 * 2 * pairs, 2 * qb + 2 * kb + lse],
        "flash_attention_bwd": [1, 10 * 16 * 4 * 2 * pairs,
                                4 * qb + 4 * kb + lse]}
    assert c.flops == sum(r[1] for r in c.kernels.values())


def test_a_launch_with_no_work_raises_under_a_counter():
    before = counts.LAUNCHES["read_hbm"]
    counts.launched("read_hbm", None)           # no counter: counted
    assert counts.LAUNCHES["read_hbm"] == before + 1
    with cost.CostCounter():
        with pytest.raises(RuntimeError, match="no counted work"):
            counts.launched("read_hbm", None)
        with pytest.raises(RuntimeError, match="no counted work"):
            with counts.plain("read_hbm", None):
                pass
    assert counts.LAUNCHES["read_hbm"] == before + 1


R = 512                   # rows of a stream buffer: one block of 512


def _rows():
    return torch.rand(R, 128)


def _ladder():
    roles = np.zeros((3, contention.ROLE_FIELDS), np.int32)
    roles[0, :3] = (contention.READ, 16, 2)
    roles[1, :3] = (contention.COPY, 8, 1)
    roles[2, :3] = (contention.IDLE, 0, 1)
    table = np.array([[0, 1], [2, 1]], np.int32)
    xf = torch.rand(2, 16, 128)
    xi = torch.zeros(2, 16, 128, dtype=torch.int32)
    return (xf, xi, torch.zeros_like(xf), table, roles,
            np.array([0, 0], np.int32), np.array([1, 0], np.int32))


# kernel -> (call, its counted work: flops, bytes), by hand from shapes
WRAPPERS = {
    "read_hbm": (lambda: stream.read_hbm(_rows()), (R * 128, R * 512)),
    "write_hbm": (lambda: stream.write_hbm(R, device="cpu"), (0, R * 512)),
    "write_hbm_seeded": (lambda: stream.write_hbm_seeded(
        torch.zeros(1, 1), R), (R * 128, R * 512 + 4)),
    "rmw_hbm": (lambda: stream.rmw_hbm(_rows()), (R * 128, 2 * R * 512)),
    "copy_hbm": (lambda: stream.copy_hbm(_rows()), (0, 2 * R * 512)),
    "triad_hbm": (lambda: stream.triad_hbm(_rows(), _rows()),
                  (2 * R * 128, 3 * R * 512)),
    "read_vmem": (lambda: stream.read_vmem(_rows(), repeats=4),
                  (4 * R * 128, R * 512)),
    "write_vmem": (lambda: stream.write_vmem(R, repeats=4, device="cpu"),
                   (0, R * 512)),
    "chase_vmem": (lambda: chase.chase_vmem(torch.from_numpy(
        chase.chain_buffer(16)), n_steps=16), (0, 16 * 512)),
    "chase_hbm": (lambda: chase.chase_hbm(torch.from_numpy(
        chase.chain_buffer(16)), n_steps=40), (0, 40 * 32)),
    "mxu_probe": (lambda: compute_probe.mxu_probe(
        torch.eye(128), iters=3), (3 * 2 * 128 ** 3, 2 * 128 * 128 * 4)),
    "probe_add_one": (lambda: contention.probe_add_one(torch.zeros(8, 128)),
                      (1024, 8192)),
    "contention_ladder": (lambda: contention.contention_ladder(
        *_ladder(), ctas_per_engine=1),
        # step 0: a read of 16 rows twice and a copy of 8 rows; step 1:
        # idle and the copy again
        (2 * 16 * 128, 2 * 16 * 512 + 2 * (2 * 8 * 512))),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_every_plain_version_reports_its_kernels_work(name):
    call, want = WRAPPERS[name]
    counts.reset()
    with cost.CostCounter() as counter:
        call()
    assert counts.PLAIN[name] == 1
    assert counter.cost.kernels == {name: [1, *want]}
    # nothing of the plain version itself, beside the kernel's work
    assert counter.cost.flops == want[0]
    assert set(WRAPPERS) | {"flash_attention", "flash_attention_bwd"} == \
        set(counts.KERNELS)


# ---------------------------------------------------------------------------
# Model paths: the port's counts against the reference's HLO
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen():
    """The reference's reduced qwen2-1.5b state and the port's copy."""
    arch = "qwen2-1.5b"
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    kw = dict(total_steps=10, warmup_steps=2, loss_chunk=12)
    jst = jstep.init_state(jcfg, JTrainConfig(**kw), jax.random.PRNGKey(0))
    tst = convert.train_state_from_numpy(jax.tree.map(np.asarray, jst),
                                         "cpu")
    raw = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 1))
    return dict(jcfg=jcfg, cfg=cfg, jtcfg=JTrainConfig(**kw),
                tcfg=TrainConfig(**kw), jst=jst, tst=tst,
                tokens=raw[:, :-1].astype(np.int32),
                labels=raw[:, 1:].astype(np.int32))


def _attention_products(cfg) -> float:
    """The reference's attention products a forward, from the shapes: its
    jnp attention computes the scores and the weighted values densely
    over every (query, key) pair, masked and not skipped: 4·B·H·S²·D a
    layer."""
    return cfg.n_layers * 4.0 * B * cfg.n_heads * S * S * cfg.head_dim


def test_prefill_flops_equal_the_reference_but_attention(qwen):
    """A reduced qwen2-1.5b prefill: the port's FLOPs less its flash
    kernel's work equal the reference's HLO FLOPs less its dense attention
    products, exactly; the flash work is 4·D a head and admitted pair."""
    jcfg, cfg = qwen["jcfg"], qwen["cfg"]
    jrules = jmake_rules(jcfg, jmake_host_mesh(1, 1), global_batch=B,
                         shape_kind="prefill")
    rules = make_rules(cfg, make_host_mesh(1, 1), global_batch=B)
    want = jhlo.analyze(jax.jit(jeng.make_prefill_step(
        jcfg, jrules, max_len=S + 8)).lower(
        qwen["jst"]["params"], jnp.asarray(qwen["tokens"]), None)
        .compile().as_text())
    got = cost.analyze(eng.make_prefill_step(cfg, rules, max_len=S + 8),
                       qwen["tst"]["params"],
                       torch.from_numpy(qwen["tokens"]).long())
    calls, flash_flops, _ = got.kernels["flash_attention"]
    assert calls == cfg.n_layers
    assert flash_flops == cfg.n_layers * 4 * cfg.head_dim * cfg.n_heads * \
        B * flash_attention.admitted_pairs(S, S, True, 0)
    assert got.flops - flash_flops == want.flops - _attention_products(cfg)


def test_train_step_flops_match_the_reference_but_attention_and_ce(qwen):
    """One reduced qwen2-1.5b train step (remat by layer): the port's FLOPs
    less its flash kernels' work against the reference's HLO FLOPs less its
    attention products (a forward, the remat's second forward and a
    backward of twice a forward's).  One term differs, exactly: the
    port's chunked cross-entropy recomputes each chunk's logits in the
    backward pass (``torch.utils.checkpoint``), 2·V·d a token more."""
    jcfg, cfg = qwen["jcfg"], qwen["cfg"]
    jrules = jmake_rules(jcfg, jmake_host_mesh(1, 1), global_batch=B,
                         shape_kind="train")
    rules = make_rules(cfg, make_host_mesh(1, 1), global_batch=B)
    want = jhlo.analyze(jax.jit(jstep.make_train_step(
        jcfg, jrules, qwen["jtcfg"])).lower(
        qwen["jst"], jnp.asarray(qwen["tokens"]),
        jnp.asarray(qwen["labels"]), None).compile().as_text())
    tst = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, qwen["jst"]), "cpu")
    got = cost.analyze(step_mod.make_train_step(cfg, rules, qwen["tcfg"]),
                       tst, torch.from_numpy(qwen["tokens"]).long(),
                       torch.from_numpy(qwen["labels"]).long())
    fwd, bwd = got.kernels["flash_attention"], got.kernels[
        "flash_attention_bwd"]
    assert (fwd[0], bwd[0]) == (2 * cfg.n_layers, cfg.n_layers)
    ref_attention = 4 * _attention_products(cfg)    # 1 + 1 + 2 forwards
    ce_recompute = 2.0 * cfg.padded_vocab * cfg.d_model * B * S
    assert got.flops - fwd[1] - bwd[1] == \
        want.flops - ref_attention + ce_recompute


def test_remat_recompute_is_counted(qwen):
    """``torch.utils.checkpoint``'s recompute runs in the backward pass,
    under the counter: remat by layer adds one forward of the layers but
    its last product (the FFN's output: the recompute stops once it has
    every tensor the backward saved, as XLA drops the same dead product
    from ``jax.checkpoint``'s recompute)."""
    cfg, rules = qwen["cfg"], make_rules(qwen["cfg"], make_host_mesh(1, 1),
                                         global_batch=B)
    tokens = torch.from_numpy(qwen["tokens"]).long()
    labels = torch.from_numpy(qwen["labels"]).long()
    got = {}
    for remat in ("none", "layer"):
        loss_fn = step_mod.make_loss_fn(cfg, rules, TrainConfig(
            loss_chunk=12, remat=remat))
        params = convert.params_from_numpy(
            jax.tree.map(np.asarray, qwen["jst"]["params"]), "cpu")

        def loss_and_grad(params, tokens, labels):
            flat = [p.requires_grad_() for p in tree.leaves(params)]
            loss_fn(params, tokens, labels, None)[0].backward()
            return flat

        got[remat] = cost.analyze(loss_and_grad, params, tokens, labels)
    plain = cost.analyze(lambda p, t: eng.make_prefill_step(
        cfg, rules, max_len=S)(p, t), convert.params_from_numpy(
        jax.tree.map(np.asarray, qwen["jst"]["params"]), "cpu"), tokens)
    assert got["layer"].kernels["flash_attention"][0] == 2 * cfg.n_layers
    assert got["none"].kernels["flash_attention"][0] == cfg.n_layers
    # the layers' products of one forward, less the flash kernel's work
    layer_fwd = plain.ops["mm"][1] + plain.ops["bmm"][1] - 2.0 * \
        cfg.padded_vocab * cfg.d_model * B     # the last position's logits
    extra = (got["layer"].flops - got["layer"].kernels["flash_attention"][1]
             - got["none"].flops + got["none"].kernels["flash_attention"][1])
    last = cfg.n_layers * 2.0 * cfg.d_ff * cfg.d_model * B * S
    assert extra == layer_fwd - last


# ---------------------------------------------------------------------------
# The profile
# ---------------------------------------------------------------------------


def test_profile_totals_sites_and_render(qwen):
    cfg = qwen["cfg"]
    rules = make_rules(cfg, make_host_mesh(1, 1), global_batch=B)
    tcfg = TrainConfig(total_steps=10, warmup_steps=2, loss_chunk=12)
    state = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, qwen["jst"]), "cpu")
    args = (state, torch.from_numpy(qwen["tokens"]).long(),
            torch.from_numpy(qwen["labels"]).long())
    step = step_mod.make_train_step(cfg, rules, tcfg)
    c = cost.analyze(step, *args)
    p = profile.profile(step, *args, top=1000)
    assert p["total_flops"] == c.flops and p["total_bytes"] == c.bytes
    assert p["total_collective_bytes"] == 0 and p["collectives"] == []
    sites = dict(p["flops_by_site"])
    assert sites["flash_attention"] == c.kernels["flash_attention"][1]
    assert sites["flash_attention_bwd"] == c.kernels["flash_attention_bwd"][1]
    # the model's lines, forward and backward (with the autograd node)
    assert any(s.startswith("models/mlp.py:") and s.endswith("mlp_apply")
               for s in sites)
    assert any(s.startswith("models/attention.py:") for s in sites)
    assert any("[MmBackward0]" in s for s in sites)
    assert not any(s.startswith(("analysis/", "kernels/")) for s in sites)
    assert [v for _, v in p["bytes_by_site"]] == sorted(
        (v for _, v in p["bytes_by_site"]), reverse=True)
    text = profile.render(p, top=5)
    assert text.splitlines()[0].startswith("total: ")
    for head in ("-- top sites by bytes --", "-- top sites by flops --",
                 "-- top collectives --"):
        assert head in text
    assert len(profile.profile(step, *args, top=3)["bytes_by_site"]) == 3


def test_placement_queries_count_nothing():
    """``is_pinned`` (asked of every CPU tensor that reaches a wrapper)
    reads nothing: the CPU path counts what the card's does."""
    c = cost.analyze(lambda x: (x.is_pinned(), x * 2), torch.randn(16))
    assert list(c.ops) == ["mul"] and c.bytes == 2 * 16 * 4

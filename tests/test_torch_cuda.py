"""The CUDA kernels against their plain versions, on a card.

Needs an NVIDIA card and nvcc, so every test here is marked ``cuda`` and
skips where there is none (whether there is one is decided inside the
fixture, never at import).  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` makes the same comparisons at the main path's sizes.
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch import compat
from repro_torch.core import (characterize, coordinator, devicetree,
                              interface, pools, scenarios)
from repro_torch.core.exec import fence, program, resilience
from repro_torch.core.exec.dispatch import DispatchStats
from repro_torch.kernels import (_build, chase, compute_probe, contention,
                                 counts, flash_attention, ref, stream)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    counts.reset()
    return torch.device("cuda")


def _arr(rows, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0.5, 1.5, size=(rows, 128)).astype(np.float32))


@pytest.mark.parametrize("rows", [8, 1024, 4096 + 8])
def test_streams_match_plain_versions(card, rows):
    x = _arr(rows).to(card)
    want = float(x.double().sum())
    # float32 partial sums in another order than the float64 yardstick
    assert float(stream.read_hbm(x, block_rows=8)) == \
        pytest.approx(want, rel=2e-6)
    assert float(stream.read_vmem(x, repeats=3)) == \
        pytest.approx(3 * want, rel=1e-5)
    assert torch.equal(stream.write_hbm(rows, value=2.5, block_rows=8,
                                        device=card),
                       ref.write_ref(rows, 2.5, card))
    seed = torch.full((1, 1), 0.25, device=card)
    assert torch.equal(stream.write_hbm_seeded(seed, rows, value=2.5,
                                               block_rows=8),
                       ref.write_ref(rows, 2.75, card))
    assert torch.equal(stream.rmw_hbm(x, block_rows=8), ref.rmw_ref(x))
    assert torch.equal(stream.copy_hbm(x, block_rows=8), x)
    xb = x.to(torch.bfloat16)
    assert torch.equal(stream.rmw_hbm(xb, block_rows=8), ref.rmw_ref(xb))
    assert torch.equal(stream.write_vmem(rows, repeats=5, device=card),
                       ref.write_vmem_ref(rows, 5, card))
    launches, plain = counts.snapshot()
    assert not any(plain.values())
    assert launches["read_hbm"] == 1 and launches["rmw_hbm"] == 2


@pytest.mark.parametrize("shape", [(1, 128), (3, 128), (513, 128),
                                   (3, 513, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pinned", [False, True])
def test_rmw_is_x_plus_one_exactly(card, shape, dtype, pinned):
    """Ragged rows (a short last chunk), a stack, pinned host memory and
    device memory, both dtypes: one launch, a new buffer in the input's
    memory, exactly x + 1."""
    x = torch.from_numpy(np.random.default_rng(shape[-2]).uniform(
        0.5, 1.5, size=shape).astype(np.float32)).to(dtype)
    x = x.pin_memory() if pinned else x.to(card)
    out = stream.rmw_hbm(x, block_rows=1)
    torch.cuda.synchronize()
    assert out.data_ptr() != x.data_ptr()
    assert out.is_cuda == (not pinned) and out.is_pinned() == pinned
    assert torch.equal(out.to(card), x.to(card) + 1)
    assert counts.LAUNCHES["rmw_hbm"] == 1 and not any(counts.PLAIN.values())


def _placed(x, card, pinned):
    return x.pin_memory() if pinned else x.to(card)


@pytest.mark.parametrize("shape", [(1, 128), (3, 128), (513, 128),
                                   (3, 513, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("pinned", [False, True])
def test_copy_is_bit_exact(card, shape, dtype, pinned):
    """Ragged rows (a short last chunk), a stack, pinned host memory and
    device memory, three element types: one launch, a new buffer in the
    input's memory, the same 32-bit words."""
    x = torch.from_numpy(np.random.default_rng(shape[-2]).uniform(
        0.0, 1 << 24, size=shape).astype(np.float32))
    x = _placed(x.to(dtype), card, pinned)
    out = stream.copy_hbm(x, block_rows=1)
    torch.cuda.synchronize()
    assert out.data_ptr() != x.data_ptr() and out.dtype == x.dtype
    assert out.is_cuda == (not pinned) and out.is_pinned() == pinned
    assert torch.equal(out.view(torch.int32), x.view(torch.int32))
    assert counts.LAUNCHES["copy_hbm"] == 1 and not any(counts.PLAIN.values())


@pytest.mark.parametrize("rows", [1, 3, 513])
@pytest.mark.parametrize("pinned", [False, True])
def test_triad_is_exact_at_ragged_rows(card, rows, pinned):
    """One launch, a new buffer in the operands' memory, exactly the plain
    version: a short last chunk, pinned host memory and device memory."""
    b = _placed(_arr(rows, 1), card, pinned)
    c = _placed(_arr(rows, 2), card, pinned)
    out = stream.triad_hbm(b, c, scalar=3.0, block_rows=1)
    torch.cuda.synchronize()
    assert out.data_ptr() not in (b.data_ptr(), c.data_ptr())
    assert out.is_cuda == (not pinned) and out.is_pinned() == pinned
    assert torch.equal(out.to(card),
                       ref.triad_ref(b.to(card), c.to(card), 3.0))
    assert counts.LAUNCHES["triad_hbm"] == 1 and not any(counts.PLAIN.values())


def _write(seed, rows, out=None, device=None, value=1 / 3):
    """One call of the write (seeded when ``seed`` is given)."""
    if seed is None:
        return stream.write_hbm(rows, value=value, block_rows=1,
                                device=device, out=out)
    return stream.write_hbm_seeded(seed, rows, value=value, block_rows=1,
                                   out=out)


def _write_want(seed, rows, card, value=1 / 3):
    return (ref.write_ref(rows, value, card) if seed is None
            else ref.write_seeded_ref(rows, value, seed.to(card)))


@pytest.mark.parametrize("rows", [1, 3, 513])
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("dest", ["new", "device_out", "pinned_out"])
def test_write_is_exact_at_ragged_rows(card, rows, seeded, dest):
    """A short last chunk, into a new tensor, the caller's device buffer
    or the caller's pinned host buffer (with the seed in the same memory):
    one launch, nothing plain, exactly the plain version of a value that
    float32 does not hold (1/3, + 0.25 seeded)."""
    pinned = dest == "pinned_out"
    seed = (_placed(torch.full((1, 1), 0.25), card, pinned) if seeded
            else None)
    out = (None if dest == "new" else
           _placed(torch.full((rows, 128), -1.0), card, pinned))
    got = _write(seed, rows, out=out, device=card)
    torch.cuda.synchronize()
    assert out is None or got is out
    assert got.is_cuda == (not pinned) and got.is_pinned() == pinned
    assert torch.equal(got.to(card), _write_want(seed, rows, card))
    name = "write_hbm_seeded" if seeded else "write_hbm"
    assert counts.LAUNCHES[name] == 1 and not any(counts.PLAIN.values())


@pytest.mark.parametrize("seeded", [False, True])
def test_write_into_a_row_slice_leaves_the_guard_rows(card, seeded):
    """``out`` a row-slice of a larger buffer, as letter b's write half
    and the timed write are: its rows exact, the guard rows before and
    after it untouched."""
    big = torch.full((2 + 513 + 7, 128), -1.0, device=card)
    seed = torch.full((1, 1), 0.25, device=card) if seeded else None
    assert _write(seed, 513, out=big[2:515]).data_ptr() == big[2].data_ptr()
    torch.cuda.synchronize()
    assert torch.equal(big[2:515], _write_want(seed, 513, card))
    assert bool((big[:2] == -1.0).all()) and bool((big[515:] == -1.0).all())


def test_seeded_write_reads_the_seed_on_the_device(card):
    """The seed changes on the stream between two calls with no host
    synchronisation: each call's stored value follows the seed it found
    on the device when it ran."""
    seed = torch.zeros((1, 1), device=card)
    outs = []
    for s in (0.25, -3.0):
        seed.fill_(s)
        outs.append(stream.write_hbm_seeded(seed, 513, value=1 / 3,
                                            block_rows=1))
    torch.cuda.synchronize()
    for s, out in zip((0.25, -3.0), outs):
        assert torch.equal(out, ref.write_seeded_ref(
            513, 1 / 3, torch.full((1, 1), s, device=card)))
    assert counts.LAUNCHES["write_hbm_seeded"] == 2
    assert not any(counts.PLAIN.values())


@pytest.mark.parametrize("n_lines", [2, 16, 64, 257, 453])
def test_chases_match_plain_version(card, n_lines):
    host = chase.chain_buffer(n_lines, 3)
    buf = torch.from_numpy(host).to(card)
    for steps in (1, n_lines // 2, n_lines):
        want = ref.chase_ref(host, steps)
        assert int(chase.chase_vmem(buf, n_steps=steps)) == want
        assert int(chase.chase_hbm(buf, n_steps=steps)) == want
    assert int(chase.chase_hbm(buf, n_steps=n_lines)) == 0


def test_pinned_host_tensors_launch_the_kernels(card):
    x = torch.empty((512, 128), pin_memory=True).copy_(_arr(512))
    assert float(stream.read_hbm(x)) == pytest.approx(
        float(x.double().sum()), rel=2e-6)
    out = stream.copy_hbm(x)
    torch.cuda.synchronize()
    assert out.is_pinned() and torch.equal(out, x)
    assert counts.LAUNCHES["read_hbm"] == counts.LAUNCHES["copy_hbm"] == 1
    assert not any(counts.PLAIN.values())


def test_interface_on_the_card_launches_kernels(card):
    iface = interface.MemscopeInterface(coordinator.CoreCoordinator(
        pools.PoolManager(devicetree.H100_SXM), backend="auto"))
    iface.write_experiment("r,hbm,8M w,host,8M iters=3 scenarios=4")
    assert iface.write_cmd("start") == "OK complete"
    m = iface.results.scenarios[0].main
    assert m.bytes_moved == 3 * (8 << 20) and m.elapsed_ns > 0
    # one warm call, one that times the host's enqueue, 3 samples of 3
    assert counts.LAUNCHES["read_hbm"] == 2 + 3 * 3
    assert not any(counts.PLAIN.values())
    assert iface.coord.pools.pool("host").effective_memory_kind() == \
        "pinned_host"


@pytest.mark.parametrize("iters", [0, 1, 3, 8, 64])
def test_mxu_probe_matches_plain_version(card, iters):
    """The chain at the lengths letter i runs, held to the reference's
    limits: powers of 0.5 * I exactly (0.5 splits into TF32 with lo = 0),
    the radius-0.9 operand within 1e-5 of the largest entry (128 products
    an entry in another order and precision, iters times over)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.eye(128, device=card) * 0.5
    torch.testing.assert_close(compute_probe.mxu_probe(a, iters=iters),
                               ref.mxu_probe_ref(a, iters), rtol=1e-6, atol=0)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (128, 128))).float()
    r = (r / torch.linalg.eigvals(r.double()).abs().max() * 0.9).float()
    r = r.to(card)
    want = ref.mxu_probe_ref(r, iters)
    got = compute_probe.mxu_probe(r, iters=iters)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert counts.LAUNCHES["mxu_probe"] == 2 and not any(counts.PLAIN.values())


@pytest.mark.parametrize("rows", [256, 2048 + 8])
@pytest.mark.parametrize("g", [1, 3, 4])
def test_read_vmem_members_spread_over_the_sms(card, g, rows):
    """The on-chip read of a (g, rows, 128) stack, each member spread over
    the SMs' shared memory: within 1e-5 of the float64 sums (float32
    partials in another order), one launch, and the same bits on every
    call (the partials are summed in a fixed order)."""
    x = torch.stack([_arr(rows, s) for s in range(g)]).to(card)
    want = x.double().sum(dim=(1, 2))
    got = stream.read_vmem(x, repeats=8)
    torch.testing.assert_close(got.double(), 8 * want, rtol=1e-5, atol=0)
    for _ in range(9):
        assert torch.equal(stream.read_vmem(x, repeats=8), got)
    one = stream.read_vmem(x[0], repeats=8)
    assert one.dim() == 0
    assert float(one) == pytest.approx(8 * float(want[0]), rel=1e-5)
    assert counts.LAUNCHES["read_vmem"] == 11
    assert not any(counts.PLAIN.values())


@pytest.mark.parametrize("repeats", [1, 2, 7, 8, 9, 2048])
@pytest.mark.parametrize("rows", [1, 3, 8, 257, 453, 2048 + 8, 132 * 453 + 40])
def test_write_vmem_leaves_repeats_minus_one(card, rows, repeats):
    """Every element of the on-chip write is exactly ``repeats - 1`` at
    ragged sizes: a last slice shorter than the others, a buffer larger
    than the SMs' tiles."""
    out = torch.full((rows, 128), -1.0, device=card)
    assert stream.write_vmem(rows, repeats=repeats, out=out) is out
    assert torch.equal(out, ref.write_vmem_ref(rows, repeats, card))
    assert counts.LAUNCHES["write_vmem"] == 1


@pytest.mark.parametrize("rows", [1, 256, 453, 2048 + 8])
def test_one_cta_of_the_on_chip_pair_an_sm(card, rows):
    """The card itself fits one CTA of the read's and of the write's
    kernel on an SM at the slice the wrapper gives them."""
    lay = stream.vmem_layout(rows, stream._sm_count(card))
    occ = _build.bind("stream", "repro_vmem_ctas_per_sm",
                      (ctypes.c_int, ctypes.c_int))
    assert [occ(w, lay.slice_rows * 32) for w in (0, 1)] == [1, 1]


@pytest.mark.parametrize("g", [1, 3, 4])
def test_member_axis_matches_plain_versions(card, g):
    x = torch.stack([_arr(1024 + 8, s) for s in range(g)]).to(card)
    want = x.double().sum(dim=(1, 2))
    torch.testing.assert_close(stream.read_hbm(x, block_rows=8).double(),
                               want, rtol=2e-6, atol=0)
    torch.testing.assert_close(stream.read_vmem(x, repeats=3).double(),
                               3 * want, rtol=1e-5, atol=0)
    assert torch.equal(stream.copy_hbm(x, block_rows=8), x)
    assert torch.equal(stream.rmw_hbm(x, block_rows=8), x + 1)
    s, out = stream.mixed_hbm(x, read_fraction=2 / 3, block_rows=8,
                              seed=torch.zeros((1, 1), device=card))
    ws, wout = ref.mixed_ref(x, 2 / 3, block_rows=8)
    assert torch.equal(out, wout)
    torch.testing.assert_close(s, ws, rtol=2e-6, atol=0)
    host = np.stack([chase.chain_buffer(257, s) for s in range(g)])
    buf = torch.from_numpy(host).to(card)
    for steps in (1, 100, 257, 771):
        want = ref.chase_members_ref(host, steps)
        assert chase.chase_vmem(buf, n_steps=steps).tolist() == want
        assert chase.chase_hbm(buf, n_steps=steps).tolist() == want
    assert not any(counts.PLAIN.values())


def test_matrix_on_the_card_launches_one_kernel_per_group(card):
    coord = coordinator.CoreCoordinator(
        pools.PoolManager(devicetree.H100_SXM), backend="cuda")
    specs = [scenarios.ScenarioSpec(
        f"{o}.{st}", scenarios.ObserverSpec(o, pool, (128 << 10,)),
        (scenarios.StressorSpec(st, "hbm", 8 << 20),), iters=5,
        max_stressors=3)
        for o in ("r", "l", "i") for pool in ("hbm", "host")
        for st in ("w", "y")]
    db = characterize.characterize_matrix(coord, specs)
    # 3 letters x 2 memories, and hbm and pinned host never share a group
    assert db.meta["measure_dispatches"] == 6
    assert db.meta["n_ladders"] == 12
    for surf in db.surfaces.values():
        ex = surf.provenance["execution"]
        assert (ex["backend"], ex["activity"]) == ("cuda", "cuda")
        assert ex["measured_uncontended"]
    assert counts.LAUNCHES["mxu_probe"] > 0 and counts.LAUNCHES["chase_vmem"]
    assert not any(counts.PLAIN.values())
    assert not any(p.allocated for p in coord.pools.pools())


def test_on_chip_rows_are_timed_by_their_slope(card):
    iface = interface.MemscopeInterface(coordinator.CoreCoordinator(
        pools.PoolManager(devicetree.H100_SXM), backend="cuda"))
    for line in ("r,hbm,128K w,hbm,1M iters=20", "l,hbm,128K w,hbm,1M",
                 "i,hbm,0 w,hbm,1M iters=5"):
        iface.write_experiment(line)
        assert iface.write_cmd("start") == "OK complete"
        assert not iface.results.scenarios[0].main.launch_bound
        assert "# note" not in iface.read_results()
    # one warm call, one that times the host's enqueue, 3 samples of 5
    assert counts.LAUNCHES["mxu_probe"] == 2 + 3 * 5


def test_hold_keeps_the_stream_busy(card):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    stream.hold(2_000_000, card)
    stop.record()
    stop.synchronize()
    assert start.elapsed_time(stop) >= 2.0
    assert not any(counts.LAUNCHES.values())


def test_probe_kernel_adds_one_exactly(card):
    x = torch.arange(8 * 128, dtype=torch.float32, device=card)
    out = contention.probe_add_one(x.reshape(8, 128))
    assert torch.equal(out, x.reshape(8, 128) + 1.0)
    assert compat.kernels_supported(card)
    assert counts.LAUNCHES["probe_add_one"] >= 1
    assert compat.device_clock_source(card) == "device"


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_adds_one_exactly_to_random_values(card, seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (8, 128)).astype(np.float32)).to(card)
    assert torch.equal(contention.probe_add_one(x), x + 1.0)
    assert counts.LAUNCHES["probe_add_one"] == 1
    assert not any(counts.PLAIN.values())


SHAPES = {"b": scenarios.TrafficShape.mixed(2, 1),
          "t": scenarios.TrafficShape.strided(8)}


def _ladder(card, rows, roles, subsets=None, samples=1):
    n_eng = len(rows[0])
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    return program.build_program(
        rows, n_eng, kind=None, samples=samples, subsets=subsets,
        op_roles=roles, rows_max=max(r[2] for r in roles), device=card,
        ctas_per_engine=sms // n_eng, stats=DispatchStats())


@pytest.mark.parametrize("letter", list("rswyxcblmti"))
@pytest.mark.parametrize("rows", [16, 453, 4096 + 512])
def test_every_role_alone_matches_its_plain_version(card, letter, rows):
    """One role on engine 0 of an 8-engine, one-step table, the rest
    idle: the kernel's engine values equal the plain version's (sums to
    2e-6, everything else exactly), and the launch is fenced."""
    roles = [(letter, SHAPES.get(letter), rows, 3)] + \
        [("i", None, 1, 3)] * 7
    prog = _ladder(card, [tuple(roles)], roles)
    out = prog.launch().to_cpu()
    want = ref.contention_ladder_ref(
        prog.xf.cpu(), prog.xi.cpu(), prog.table, prog.roles,
        prog.layout.group_of, prog.layout.leaders)
    if letter in "rsb":
        torch.testing.assert_close(out.outs, want.outs, rtol=2e-6, atol=0)
    else:
        assert torch.equal(out.outs, want.outs)
    assert prog.is_fenced(out)
    assert counts.LAUNCHES["contention_ladder"] == 1
    assert not any(counts.PLAIN.values())


def test_fence_negative_on_the_card(card):
    """The start barrier's wait skipped and the engines skewed by
    e x 10 us: the stamps show engines beginning before the last one
    arrived, and the launch is refused; the same program with the wait
    is fenced.  Packed subsets barrier on their own counters."""
    roles = [("r", None, 4096, 2)] * 8
    prog = _ladder(card, [tuple(roles)], roles, samples=3)
    assert prog.is_fenced(prog.launch().to_cpu())
    bad = prog.launch(skip_start_wait=True, skew_ns=10_000).to_cpu()
    assert not prog.is_fenced(bad)
    lag = bad.arrive.numpy().max(0) - bad.begin.numpy().min(0)
    assert (lag >= 60_000).all()
    subsets = ((0, 1), (2, 3), (4, 5), (6, 7))
    packed = _ladder(card, [tuple(roles)], roles, subsets=subsets)
    out = packed.launch().to_cpu()
    assert fence.measured_region_is_fenced(out, packed.layout, subsets)
    # each subset's first engine stamps its own clock, no other engine
    stamped = (out.t1s.numpy() != 0).any(axis=-1)
    assert stamped[[0, 2, 4, 6]].all() and not stamped[[1, 3, 5, 7]].any()


def test_a_failed_ladder_launch_raises_on_the_card(card):
    """A launch the card refuses (more CTAs than can be co-resident) is
    raised, not retried into host-timed or modeled rungs."""
    coord = coordinator.CoreCoordinator(
        pools.PoolManager(devicetree.H100_SXM), backend="spmd")
    coord._dispatcher.ctas_per_engine = 1024
    spec = scenarios.ScenarioSpec(
        "refused", scenarios.ObserverSpec("r", "hbm", (1 << 20,)),
        (scenarios.StressorSpec("w", "hbm", 1 << 20),), iters=2)
    before = counts.LAUNCHES["contention_ladder"]
    with pytest.raises(resilience.GroupExecutionError) as ei:
        coord.run_matrix([spec])
    assert isinstance(ei.value.cause, _build.KernelLaunchError)
    assert counts.LAUNCHES["contention_ladder"] == before


def test_spmd_ladder_on_the_card(card):
    coord = coordinator.CoreCoordinator(
        pools.PoolManager(devicetree.H100_SXM), backend="spmd")
    spec = scenarios.ScenarioSpec(
        "card", scenarios.ObserverSpec("r", "hbm", (16 << 20,)),
        (scenarios.StressorSpec("w", "hbm", 16 << 20),), iters=4)
    res = coord.run_matrix([spec])
    ex = res.runs[0].execution
    assert (ex["activity"], ex["timing_source"], ex["fenced"]) == \
        ("cuda", "device", True)
    assert ex["executed_rungs"] == list(range(8))
    assert res.stats.host_sync_dispatches == 1 + res.stats.noisy_remeasures
    assert counts.LAUNCHES["contention_ladder"] == \
        res.stats.host_sync_dispatches
    assert not any(counts.PLAIN.values())


@pytest.mark.parametrize("rows", [8, 1024, 4096 + 8])
def test_triad_matches_plain_version_exactly(card, rows):
    b, c = _arr(rows, 1).to(card), _arr(rows, 2).to(card)
    # the product and the sum rounded apart on both sides
    assert torch.equal(stream.triad_hbm(b, c, scalar=3.0, block_rows=8),
                       ref.triad_ref(b, c, 3.0))
    assert counts.LAUNCHES["triad_hbm"] == 1 and not any(counts.PLAIN.values())


def _qkv(card, b, h, kvh, sq, sk, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(shape) * 0.5)
                             .astype(np.float32)).to(card, dtype)
            for shape in ((b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d))]


# b, h, kvh, sq, sk, d, causal, window: the reference's six CASES, the
# ragged set, Sq != Sk both ways, rows with no admissible key, and every
# head dim the kernel takes
FLASH_CASES = [
    (1, 1, 1, 128, 128, 64, True, 0), (2, 4, 2, 256, 256, 64, True, 0),
    (1, 4, 1, 256, 256, 128, True, 0), (1, 2, 2, 256, 256, 64, False, 0),
    (1, 4, 2, 512, 512, 64, True, 128), (2, 2, 1, 256, 256, 32, True, 64),
    (1, 2, 2, 192, 192, 64, True, 0), (1, 2, 2, 320, 320, 64, True, 64),
    (1, 2, 2, 160, 160, 64, False, 0), (1, 4, 2, 200, 328, 64, True, 0),
    (1, 4, 2, 328, 200, 128, False, 96), (1, 2, 1, 64, 16, 32, False, 8),
    (1, 4, 2, 96, 96, 16, True, 0), (1, 4, 1, 130, 130, 256, True, 40),
]


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_the_dense_oracle(card, case, dtype, atol):
    """The kernel against the dense oracle (the reference's tolerances:
    2e-5 float32, 2e-2 bfloat16), and against the plain version; float32
    products on the plain side without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, kvh, sq, sk, d, causal, window = case
    q, k, v = _qkv(card, b, h, kvh, sq, sk, d, dtype)
    got = flash_attention.flash_attention(q, k, v, causal=causal,
                                          window=window)
    plain = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), plain.float(), atol=atol, rtol=0)
    if sk >= sq or causal:       # every row has an admissible key
        dense = ref.attention_ref(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got.float(), dense.float(), atol=atol,
                                   rtol=0)
    else:                        # the rows past sk - 1 + window: 0
        assert not got[:, :, sk - 1 + window:].float().abs().max()
    assert counts.LAUNCHES["flash_attention"] == 1
    assert counts.INSTANCES[
        f"flash_attention:{flash_attention.INSTANCE[dtype]}"] == 1
    assert not any(counts.PLAIN.values())


# b, h, kvh, sq, sk, d, causal, window: the tensor-core kernel's tile edges
# (128 query rows a CTA; 128 keys a tile, 64 at D 256): Sq 200 and 130, Sk
# ragged at 320 and 257, Sq != Sk both ways, D 16 and 32, windows narrower
# than a tile, rows with no key
TC_EDGE_CASES = [
    (1, 4, 2, 200, 200, 128, True, 0), (1, 4, 1, 130, 130, 256, True, 0),
    (1, 2, 2, 320, 320, 64, True, 0), (1, 2, 1, 257, 257, 128, False, 0),
    (1, 4, 2, 200, 328, 128, True, 0), (1, 4, 2, 328, 200, 64, False, 0),
    (1, 4, 2, 192, 192, 16, True, 0), (2, 2, 1, 160, 160, 32, True, 0),
    (1, 2, 1, 384, 384, 256, True, 40), (1, 4, 2, 384, 384, 128, True, 64),
    (1, 2, 1, 200, 16, 32, False, 8),
]


@pytest.mark.parametrize("case", FLASH_CASES[:6] + TC_EDGE_CASES)
def test_flash_tc_kernel_matches_the_dense_oracle(card, case):
    """bf16 runs the wgmma kernel: against the dense oracle at 2e-2 (rows
    with no key: 0, as the plain version), and against the FMA kernel on
    the same inputs within one bf16 rounding (2^-7 |want| + 2^-12)."""
    b, h, kvh, sq, sk, d, causal, window = case
    q, k, v = _qkv(card, b, h, kvh, sq, sk, d, torch.bfloat16, seed=3)
    kw = dict(causal=causal, window=window)
    got = flash_attention.flash_attention(q, k, v, **kw)
    assert counts.INSTANCES["flash_attention:wgmma_bf16"] == 1
    if causal or not window or sq <= sk - 1 + window:
        want = ref.attention_ref(q, k, v, **kw)
    else:                        # the rows past sk - 1 + window: 0
        want = ref.flash_attention_ref(q, k, v, **kw)
        assert not got[:, :, sk - 1 + window:].float().abs().max()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)
    fma = flash_attention.run_instance("fma_f32", q, k, v, **kw).float()
    assert float(((got.float() - fma).abs()
                  / (2.0 ** -7 * fma.abs() + 2.0 ** -12)).max()) <= 1.0
    assert counts.INSTANCES["flash_attention:fma_f32"] == 1
    assert not any(counts.PLAIN.values())


def test_a_bf16_call_the_kernel_cannot_take_raises(card):
    """No fallback from the tensor-core kernel: a non-contiguous k, or a
    float32 call sent to the bf16 kernel by name, raises and launches
    nothing."""
    q, k, v = _qkv(card, 1, 2, 1, 128, 128, 64, torch.bfloat16)
    k_t = k.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="k is not contiguous"):
        flash_attention.flash_attention(q, k_t, v)
    with pytest.raises(ValueError, match="wgmma_bf16"):
        flash_attention.run_instance("wgmma_bf16", q.float(), k.float(),
                                     v.float())
    assert not any(counts.LAUNCHES.values()) and not any(counts.PLAIN.values())
    assert not any(counts.INSTANCES.values())


def test_flash_attention_refuses_on_the_card(card):
    q, k, v = _qkv(card, 1, 2, 1, 64, 64, 96, torch.float32)
    with pytest.raises(ValueError, match="head dim 96"):
        flash_attention.flash_attention(q, k, v)
    q, k, v = (t.half() for t in _qkv(card, 1, 2, 1, 64, 64, 64,
                                      torch.float32))
    with pytest.raises(ValueError, match="dtype"):
        flash_attention.flash_attention(q, k, v)
    assert not any(counts.LAUNCHES.values()) and not any(counts.PLAIN.values())

"""The CUDA kernels against their plain versions, on a card.

Needs an NVIDIA card and nvcc, so every test here is marked ``cuda`` and
skips where there is none (whether there is one is decided inside the
fixture, never at import).  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` makes the same comparisons at the main path's sizes.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (characterize, coordinator, devicetree,
                              interface, pools, scenarios)
from repro_torch.kernels import chase, compute_probe, counts, ref, stream

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


def test_mxu_probe_matches_plain_version(card):
    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.eye(128, device=card) * 0.5
    torch.testing.assert_close(compute_probe.mxu_probe(a, iters=3),
                               ref.mxu_probe_ref(a, 3), rtol=1e-6, atol=0)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (128, 128))).float()
    r = (r / torch.linalg.eigvals(r.double()).abs().max() * 0.9).float()
    r = r.to(card)
    want = ref.mxu_probe_ref(r, 64)
    # 128 float32 products an entry, summed in another order, 64 times over
    got = compute_probe.mxu_probe(r, iters=64)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert counts.LAUNCHES["mxu_probe"] == 2 and not any(counts.PLAIN.values())


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

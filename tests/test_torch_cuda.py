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

from repro_torch.core import coordinator, devicetree, interface, pools
from repro_torch.kernels import chase, counts, ref, stream

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
    assert counts.LAUNCHES["read_hbm"] == 1 + 3 * 3
    assert not any(counts.PLAIN.values())
    assert iface.coord.pools.pool("host").effective_memory_kind() == \
        "pinned_host"

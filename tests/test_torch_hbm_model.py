"""The H100 model's uncontended HBM read rate, fitted to the card.

``H100_SXM``'s ``hbm`` node holds ``max_mlp`` lines in flight a stream
engine.  Over the measured 341 ns hop, the model's one-engine ``r`` stream
must give the rate a 1 GiB read measures on the card
(``devicetree.HBM_READ_GBPS``, 3127 GB/s on an NVIDIA H100 80GB HBM3 at
700.00 W), within 0.1 % (the fit's integer step moves it 1.4 GB/s); and a
v3 surface built on the ``cuda`` backend, whose rungs are that model's,
must return the same edge through ``roofline.effective_hbm_bw``, the rate
the roofline's "mem@db" term divides by.
"""
import dataclasses

import pytest

from repro_torch.analysis import roofline
from repro_torch.core import devicetree
from repro_torch.core.characterize import characterize_surface
from repro_torch.core.coordinator import CoreCoordinator
from repro_torch.core.pools import PoolManager
from repro_torch.core.simulate import ActivityClass, simulate_scenario

H100 = devicetree.H100_SXM


def _one_engine(platform, strategy="r", n=1):
    node = platform.memories["hbm"]
    return simulate_scenario(
        platform, [ActivityClass("obs", node, strategy, n)])["obs"]


def test_one_read_engine_runs_at_the_measured_read():
    res = _one_engine(H100)
    assert H100.memories["hbm"].max_mlp == devicetree.HBM_MAX_MLP
    assert res.bw_gbps == pytest.approx(devicetree.HBM_READ_GBPS, rel=1e-3)
    # the old 1024 lines gave half of it (Little: 1024 x 512 B / 341 ns)
    old = dataclasses.replace(H100.memories["hbm"], max_mlp=1024)
    slow = _one_engine(dataclasses.replace(
        H100, memories={**H100.memories, "hbm": old}))
    assert slow.bw_gbps == pytest.approx(1535.23, abs=0.01)


def test_the_shared_port_caps_neither_one_engine_nor_eight():
    one = _one_engine(H100)
    assert one.entry_wait_ns == 0.0          # fewer lines than entries
    eight = _one_engine(H100, n=8)
    assert eight.bw_gbps >= devicetree.HBM_READ_GBPS
    assert eight.bw_gbps <= H100.memories["hbm"].peak_bw_gbps


def test_a_surface_on_the_cuda_backend_returns_the_fitted_edge():
    coord = CoreCoordinator(PoolManager(H100, "cpu"), H100, backend="cuda",
                            device="cpu")
    # a buffer past the 50 MiB L2, as the card's phase reads (a smaller
    # one is modeled as an L2 hit)
    db = characterize_surface(coord, pools=["hbm"], stress_pools=["hbm"],
                              buffer_bytes=64 << 20, obs_strategies=("r",),
                              iters=1, max_stressors=2)
    edge = roofline.effective_hbm_bw(db, n_stressors=0)
    assert edge / 1e9 == pytest.approx(_one_engine(H100).bw_gbps, rel=1e-9)
    assert edge / 1e9 == pytest.approx(devicetree.HBM_READ_GBPS, rel=1e-3)

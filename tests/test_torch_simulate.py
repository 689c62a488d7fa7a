"""Port vs reference: the queueing model and the scenario DSL (CPU).

The modeled rungs of ``CoreCoordinator(backend="simulate").run`` must
equal the reference's to 1e-9 relative on the same tree, converted
through its JSON.  Buffer sizes stay away from the one place the two
packages differ by design: the on-chip residency knee of a tree without a
cache node (64 MiB there, the 50 MB L2 here).
"""
import json

import pytest

from repro.core import coordinator as jco
from repro.core import devicetree as jdt
from repro.core import pools as jpools
from repro.core import scenarios as jsc
from repro.core import simulate as jsim
from repro_torch.core import convert, coordinator, pools, scenarios, simulate

TREES = {"tpu-v5e": (jdt.TPU_V5E, "hbm", "host", (64 << 10, 4 << 20,
                                                  256 << 20)),
         "zcu102": (jdt.ZCU102, "dram", "pl-dram", (64 << 10, 512 << 10,
                                                    8 << 20))}
MAINS = ("r", "w", "s", "x", "y", "c", "b", "l", "m", "t")
STRESS = ("r", "w", "y", "c", "m", "i")
REL = 1e-9


def _pair(name):
    ref_plat = TREES[name][0]
    plat = convert.platform_from_reference_json(ref_plat.to_json(),
                                                ref_plat.cache_node)
    return (jco.CoreCoordinator(jpools.PoolManager(ref_plat), ref_plat,
                                backend="simulate"),
            coordinator.CoreCoordinator(pools.PoolManager(plat, "cpu"), plat,
                                        backend="simulate", device="cpu"))


def _assert_rungs_equal(want, got):
    assert len(got.scenarios) == len(want.scenarios)
    for w, g in zip(want.scenarios, got.scenarios):
        assert g.n_stressors == w.n_stressors and g.source == w.source
        assert g.modeled_bw_gbps == pytest.approx(w.modeled_bw_gbps, rel=REL)
        assert g.modeled_lat_ns == pytest.approx(w.modeled_lat_ns, rel=REL)
        assert g.stress_bw_gbps == pytest.approx(w.stress_bw_gbps, rel=REL)
        assert (g.main.strategy, g.main.pool, g.main.buffer_bytes,
                g.main.iters, g.main.bytes_moved, g.main.transactions) == \
            (w.main.strategy, w.main.pool, w.main.buffer_bytes,
             w.main.iters, w.main.bytes_moved, w.main.transactions)


@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("main", MAINS)
@pytest.mark.parametrize("stress", STRESS)
def test_modeled_ladder_equals_reference(tree, main, stress):
    jc, tc = _pair(tree)
    _, fast, slow, sizes = TREES[tree]
    for size in sizes:
        for spool in (fast, slow):
            want = jc.run(jco.ExperimentConfig(
                jco.ActivitySpec(main, fast, size),
                jco.ActivitySpec(stress, spool, size), iters=3))
            got = tc.run(coordinator.ExperimentConfig(
                coordinator.ActivitySpec(main, fast, size),
                coordinator.ActivitySpec(stress, spool, size), iters=3))
            _assert_rungs_equal(want, got)
            assert got.bandwidth_curve() == pytest.approx(
                want.bandwidth_curve(), rel=REL)
            assert got.latency_curve() == pytest.approx(
                want.latency_curve(), rel=REL)


@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("shape", [dict(read_fraction=2 / 3),
                                   dict(read_fraction=0.25, duty_cycle=0.5),
                                   dict(duty_cycle=0.3), dict(stride=16)])
def test_shaped_activities_model_equal(tree, shape):
    jc, tc = _pair(tree)
    _, fast, slow, sizes = TREES[tree]
    main = "l" if "stride" in shape else "r"
    want = jc.ladder(jco.ActivitySpec(main, fast, sizes[1], **shape),
                     jco.ActivitySpec("w", slow, sizes[1], **shape))
    got = tc.ladder(
        coordinator.ActivitySpec(main, fast, sizes[1], **shape),
        coordinator.ActivitySpec("w", slow, sizes[1], **shape))
    _assert_rungs_equal(want, got)
    assert coordinator.ActivitySpec(main, fast, 1, **shape).shape().tag() \
        == jco.ActivitySpec(main, fast, 1, **shape).shape().tag()


@pytest.mark.parametrize("tree", sorted(TREES))
def test_vmem_and_cache_pools_model_equal(tree):
    jc, tc = _pair(tree)
    on_chip = "vmem" if tree == "tpu-v5e" else "ocm"
    other = TREES[tree][1]
    for main, stress in (("r", "w"), ("l", "y"), ("w", "r")):
        want = jc.ladder(jco.ActivitySpec(main, on_chip, 64 << 10),
                         jco.ActivitySpec(stress, other, 1 << 20), iters=2)
        got = tc.ladder(coordinator.ActivitySpec(main, on_chip, 64 << 10),
                        coordinator.ActivitySpec(stress, other, 1 << 20),
                        iters=2)
        _assert_rungs_equal(want, got)


def test_strategy_tables_equal():
    assert simulate.STRATEGY_TRAFFIC == jsim.STRATEGY_TRAFFIC
    node = jdt.TPU_V5E.memories["hbm"]
    for s in simulate.STRATEGY_TRAFFIC:
        assert simulate.strategy_mlp(s, node) == jsim.strategy_mlp(s, node)


SHAPES = [("steady", ()), ("mixed", (2, 1)), ("mixed", (1, 3)),
          ("burst", (0.25,)), ("burst", (0.5, 16)), ("strided", (8,)),
          ("traffic", (0.5, 0.75)), ("traffic", (1.0, 1.0))]


@pytest.mark.parametrize("kind,args", SHAPES)
def test_traffic_shape_tag_and_dict_byte_equal(kind, args):
    want = getattr(jsc.TrafficShape, kind)(*args)
    got = getattr(scenarios.TrafficShape, kind)(*args)
    assert got.tag() == want.tag()
    assert got.is_steady == want.is_steady
    assert json.dumps(scenarios.asdict(got)) == json.dumps(jsc.asdict(want))


def _spec(mod):
    obs = mod.ObserverSpec("r", "hbm", (64 << 10, 4 << 20),
                           mod.TrafficShape.mixed(2, 1))
    co = mod.ObserverSpec("l", "host", (1 << 20,))
    stress = (mod.StressorSpec("w", "hbm", 4 << 20,
                               mod.TrafficShape.burst(0.5)),
              mod.StressorSpec("c", "host", 1 << 20))
    return mod.ScenarioSpec("demo", obs, stress, iters=7, max_stressors=3,
                            co_observers=(co,))


def test_scenario_spec_dict_keys_and_matrix_byte_equal():
    want, got = _spec(jsc), _spec(scenarios)
    assert json.dumps(got.to_dict()) == json.dumps(want.to_dict())
    assert scenarios.ScenarioSpec.from_dict(got.to_dict()) == got
    for wo, go in zip(want.observers, got.observers):
        for b in wo.buffers:
            assert got.key_for(go, b) == want.key_for(wo, b)
    assert [s.descriptor() for s in got.stressors] == \
        [s.descriptor() for s in want.stressors]
    wm = jsc.scenario_matrix(pools=["hbm", "host"], buffer_bytes=1 << 20)
    gm = scenarios.scenario_matrix(pools=["hbm", "host"],
                                   buffer_bytes=1 << 20)
    assert json.dumps([s.to_dict() for s in gm]) == \
        json.dumps([s.to_dict() for s in wm])
    ws = jsc.surface_matrix(pools=["hbm"], buffer_bytes=1 << 20)
    gs = scenarios.surface_matrix(pools=["hbm"], buffer_bytes=1 << 20)
    assert [s.key() for s in gs] == [s.key() for s in ws]

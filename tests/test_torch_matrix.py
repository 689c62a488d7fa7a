"""Port vs reference: the scenario-matrix runner (CPU).

``run_matrix`` on ``simulate`` must give the reference's runs: the same
keys, the same modeled values (exactly: both packages do the same
float64 arithmetic in the same order on the same tree), the same
``execution`` provenance and the same ``DispatchStats``.  On ``cuda`` with
``device="cpu"`` (the plain versions) against the reference's
``interpret`` backend (its Pallas kernels in interpret mode): the same
dispatch counts, batched and naive, the same accounting of every
measured observer, the same provenance but for the backend and activity
names.  ``measure_group`` letter by letter, chunking included.

Where the two packages place a pool differently the grids say so: the
reference on this CPU reports its ``host`` pool as ``pinned_host`` (and
its batched interpret pass cannot stack such buffers), the port with
``device="cpu"`` has no page-locked memory and reports ``None``.  The
runs against ``interpret`` therefore use trees and pools whose placement
both packages agree on (``hbm`` of the TPU tree; the ZCU102's ``dram``
and ``pl-dram``, which both packages merge into one group).
"""
import dataclasses

import pytest

from repro.core import coordinator as jco
from repro.core import devicetree as jdt
from repro.core import pools as jpools
from repro.core import scenarios as jsc
from repro.core import workloads as jwl
from repro.core.exec import plan as jplan
from repro_torch.core import convert, coordinator, pools, scenarios, workloads
from repro_torch.core.exec import plan
from repro_torch.core.pools import MemoryPool
from repro_torch.kernels import counts

TREES = {"tpu-v5e": jdt.TPU_V5E, "zcu102": jdt.ZCU102}
K64 = 64 << 10


def _pair(tree="tpu-v5e", jbackend="simulate", tbackend="simulate"):
    ref_plat = TREES[tree]
    plat = convert.platform_from_reference_json(ref_plat.to_json(),
                                                ref_plat.cache_node)
    return (jco.CoreCoordinator(jpools.PoolManager(ref_plat), ref_plat,
                                backend=jbackend),
            coordinator.CoreCoordinator(pools.PoolManager(plat, "cpu"), plat,
                                        backend=tbackend, device="cpu"))


def _grid(mod, kind, pools_, obs, iters=2):
    if kind == "scenario":
        return mod.scenario_matrix(
            pools=pools_, buffer_bytes=K64, obs_strategies=obs,
            stress_shapes=mod.DEFAULT_STRESS_SHAPES[:8], iters=iters,
            max_stressors=1)
    return mod.surface_matrix(pools=pools_, buffer_bytes=K64,
                              obs_strategies=obs, iters=iters)


def _main(res):
    return (res.strategy, res.pool, res.buffer_bytes, res.iters,
            res.bytes_moved, res.transactions)


def _assert_runs_equal(want, got, *, measured):
    assert [r.key for r in got.runs] == [r.key for r in want.runs]
    for w, g in zip(want.runs, got.runs):
        assert g.spec.to_dict() == w.spec.to_dict()
        assert g.buffer_bytes == w.buffer_bytes
        assert dataclasses.asdict(g.observer) == \
            dataclasses.asdict(w.observer)
        assert len(g.scenarios) == len(w.scenarios)
        for ws, gs in zip(w.scenarios, g.scenarios):
            assert (gs.n_stressors, gs.source) == (ws.n_stressors, ws.source)
            # same arithmetic in the same order: exact
            assert (gs.modeled_bw_gbps, gs.modeled_lat_ns,
                    gs.stress_bw_gbps) == (ws.modeled_bw_gbps,
                                           ws.modeled_lat_ns,
                                           ws.stress_bw_gbps)
            assert _main(gs.main) == _main(ws.main)
            assert (gs.main.elapsed_ns > 0) == measured
        ge, we = dict(g.execution), dict(w.execution)
        if measured:
            assert (ge.pop("backend"), ge.pop("activity")) == \
                ("cuda", "plain")
            assert (we.pop("backend"), we.pop("activity")) == \
                ("interpret", "pallas")
        assert ge == we


@pytest.mark.parametrize("tree,pools_", [("tpu-v5e", ["hbm", "host"]),
                                         ("zcu102", ["dram", "pl-dram"])])
@pytest.mark.parametrize("kind", ["scenario", "surface"])
def test_simulate_matrix_equals_reference(tree, pools_, kind):
    jc, tc = _pair(tree)
    want = jc.run_matrix(_grid(jsc, kind, pools_, ("r", "w", "l")))
    got = tc.run_matrix(_grid(scenarios, kind, pools_, ("r", "w", "l")))
    _assert_runs_equal(want, got, measured=False)
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    assert got.stats.model_evals > 0 and got.stats.measure_dispatches == 0


@pytest.mark.parametrize("tree,pools_,obs", [
    ("tpu-v5e", ["hbm"], ("r", "w", "l", "c")),
    ("zcu102", ["dram", "pl-dram"], ("r", "m")),
])
@pytest.mark.parametrize("batched", [True, False])
def test_cuda_on_cpu_matrix_equals_interpret(tree, pools_, obs, batched):
    jc, tc = _pair(tree, "interpret", "cuda")
    specs_j = _grid(jsc, "scenario", pools_, obs)[::3]
    specs_t = _grid(scenarios, "scenario", pools_, obs)[::3]
    counts.reset()
    want = jc.run_matrix(specs_j, batched=batched)
    got = tc.run_matrix(specs_t, batched=batched)
    _assert_runs_equal(want, got, measured=True)
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    if batched:
        assert got.stats.measure_dispatches < got.stats.n_ladders
    else:
        assert got.stats.measure_dispatches == len(specs_t)
    launches, plain = counts.snapshot()
    assert not any(launches.values()) and sum(plain.values()) > 0
    for p in tc.pools.pools():
        assert p.allocated == 0


def test_shaped_and_idle_observers_equal_interpret():
    """Mixed (-> b), strided (-> t), copy, rmw and the memory-idle probe
    as observers, two members a group, as the card's matrix phase runs
    them."""
    jc, tc = _pair("tpu-v5e", "interpret", "cuda")

    def specs(mod):
        obs = [mod.ObserverSpec("c", "hbm", (K64,)),
               mod.ObserverSpec("x", "hbm", (K64,)),
               mod.ObserverSpec("r", "hbm", (K64,),
                                mod.TrafficShape.mixed(2, 1)),
               mod.ObserverSpec("m", "hbm", (K64,),
                                mod.TrafficShape.strided(8)),
               mod.ObserverSpec("i", "hbm", (0,))]
        return [mod.ScenarioSpec(f"{o.strategy}{j}", o,
                                 (mod.StressorSpec(s, "hbm", K64),),
                                 iters=2, max_stressors=2)
                for o in obs for j, s in enumerate("wy")]
    counts.reset()
    want = jc.run_matrix(specs(jsc))
    got = tc.run_matrix(specs(scenarios))
    _assert_runs_equal(want, got, measured=True)
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    assert got.stats.measure_dispatches == 5 < got.stats.n_ladders == 10
    assert [r.scenarios[0].main.strategy for r in got.runs[4:8]] == \
        ["b", "b", "t", "t"]
    _, plain = counts.snapshot()
    for k in ("copy_hbm", "rmw_hbm", "read_hbm", "write_hbm_seeded",
              "chase_hbm", "mxu_probe"):
        assert plain[k] > 0, k


def test_journal_is_refused_as_on_the_reference_non_spmd_backends():
    jc, tc = _pair()
    spec_j = _grid(jsc, "scenario", ["hbm"], ("r",))[:1]
    spec_t = _grid(scenarios, "scenario", ["hbm"], ("r",))[:1]
    with pytest.raises(jco.ValidationError):
        jc.run_matrix(spec_j, journal="j.jsonl")
    with pytest.raises(coordinator.ValidationError, match="spmd"):
        tc.run_matrix(spec_t, journal="j.jsonl")


@pytest.mark.parametrize("bad", ["dup", "strategy", "buffer", "stressor",
                                 "iters", "max_stressors"])
def test_validate_spec_errors_equal(bad):
    jc, tc = _pair()

    def spec(mod):
        o = mod.ObserverSpec("q" if bad == "strategy" else "r", "hbm",
                             ((1 << 40) if bad == "buffer" else K64,))
        s = mod.StressorSpec("q" if bad == "stressor" else "w", "hbm", K64)
        return mod.ScenarioSpec(
            "bad", (o, o) if bad == "dup" else o, (s,),
            iters=0 if bad == "iters" else 2,
            max_stressors=99 if bad == "max_stressors" else 1)
    with pytest.raises(jco.ValidationError) as je:
        jc.validate_spec(spec(jsc))
    with pytest.raises(coordinator.ValidationError) as te:
        tc.validate_spec(spec(scenarios))
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# measure_group, letter by letter
# ---------------------------------------------------------------------------

GROUP_LETTERS = [("r", None), ("s", None), ("c", None), ("x", None),
                 ("b", ("mixed", (2, 1))), ("l", None), ("m", None),
                 ("t", ("strided", (8,))), ("w", None), ("y", None),
                 ("i", None), ("r", ("burst", (0.5,)))]


@pytest.fixture
def group_pools(monkeypatch):
    # 32 KiB members: the 64 KiB cap below holds two of them
    monkeypatch.setattr(jwl, "_BATCH_BYTES_CAP", 64 << 10)
    monkeypatch.setattr(workloads, "_BATCH_BYTES_CAP", 64 << 10)
    plat = convert.platform_from_reference_json(jdt.TPU_V5E.to_json())
    return (jpools.PoolManager(jdt.TPU_V5E),
            pools.PoolManager(plat, device="cpu"))


@pytest.mark.parametrize("letter,shape", GROUP_LETTERS)
@pytest.mark.parametrize("size", [32 << 10, 512 << 10])
def test_measure_group_equals_reference(group_pools, letter, shape, size):
    """5 members: a stacked group splits into chunks under the cap (three
    of them at 32 KiB; five at 512 KiB, past the cap); a write-like
    group measures once."""
    jm, tm = group_pools
    if shape is None:
        jshape = tshape = None
    else:
        jshape = getattr(jsc.TrafficShape, shape[0])(*shape[1])
        tshape = getattr(scenarios.TrafficShape, shape[0])(*shape[1])
    buf = 0 if letter == "i" else size
    counts.reset()
    want, jd = jwl.measure_group(letter, jm.pool("hbm"), buf, 5, 2,
                                 shape=jshape)
    got, td = workloads.measure_group(letter, tm.pool("hbm"), buf, 5, 2,
                                      shape=tshape)
    assert td == jd
    assert td == (1 if workloads.resolve_strategy(letter, tshape) not in
                  workloads._VMAP_READS + workloads._VMAP_CHASES
                  else (3 if size == 32 << 10 else 5))
    assert len(got) == len(want) == 5
    for w, g in zip(want, got):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        assert gd.pop("elapsed_ns") > 0 and wd.pop("elapsed_ns") > 0
        assert not gd.pop("launch_bound")
        assert gd == wd
    assert tm.pool("hbm").allocated == jm.pool("hbm").allocated == 0
    launches, plain = counts.snapshot()
    assert not any(launches.values()) and sum(plain.values()) > 0


def test_measure_group_labels_heterogeneous_members():
    """Observers from two pools that land in one memory share a group;
    each result carries its own pool (ZCU102: dram and pl-dram)."""
    plat = convert.platform_from_reference_json(jdt.ZCU102.to_json(), "l2")
    jm, tm = jpools.PoolManager(jdt.ZCU102), pools.PoolManager(plat, "cpu")
    names = ["dram", "pl-dram", "dram"]
    want, jd = jwl.measure_group("l", jm.pool("dram"), K64, 3, 2,
                                 member_pools=[jm.pool(n) for n in names])
    got, td = workloads.measure_group(
        "l", tm.pool("dram"), K64, 3, 2,
        member_pools=[tm.pool(n) for n in names])
    assert td == jd == 1
    assert [r.pool for r in got] == [r.pool for r in want] == names


# ---------------------------------------------------------------------------
# the grouping rule
# ---------------------------------------------------------------------------


def _card_placement(self):
    """``effective_memory_kind`` as on the card (pinned host memory is
    its own memory there), for a coordinator that runs on the CPU."""
    return ("pinned_host" if self.node.memory_kind == "pinned_host"
            else None)


def test_hbm_and_host_share_a_pass_only_off_the_card(monkeypatch):
    """With ``device="cpu"`` there is no page-locked memory: hbm and host
    observers land in one memory and share one stacked pass (what the
    reference's ``test_multi_observer_single_vmapped_pass`` asks of it).
    With the card's placement they never share a group."""
    _, tc = _pair("tpu-v5e", "interpret", "cuda")
    spec = scenarios.ScenarioSpec(
        "multi",
        (scenarios.ObserverSpec("r", "hbm", (K64,)),
         scenarios.ObserverSpec("r", "host", (K64,))),
        (scenarios.StressorSpec("w", "hbm", K64),),
        iters=2, max_stressors=1)
    res = tc.run_matrix([spec])
    assert res.stats.n_ladders == 2 and res.stats.measure_dispatches == 1
    assert {r.key for r in res.runs} == {"hbm:r|hbm:w", "host:r|hbm:w"}
    for r in res.runs:
        assert r.scenarios[0].main.pool == r.observer.pool
        assert r.scenarios[0].main.elapsed_ns > 0
    triples = [(spec, o, K64) for o in spec.observers]
    assert len(plan.observer_groups(triples, tc.pools)) == 1
    # pinned memory cannot be allocated here, so the card's rule is shown
    # on the groups alone
    monkeypatch.setattr(MemoryPool, "effective_memory_kind", _card_placement)
    assert list(plan.observer_groups(triples, tc.pools).values()) == \
        [[0], [1]]


def test_observer_groups_equal_reference_with_the_cards_placement(
        monkeypatch):
    """Where both packages place pools alike, the groups are the same."""
    monkeypatch.setattr(MemoryPool, "effective_memory_kind", _card_placement)
    jc, tc = _pair()
    want = jplan.observer_groups(
        [(s, o, b) for s in _grid(jsc, "scenario", ["hbm", "host"],
                                  ("r", "w"))
         for o in s.observers for b in o.buffers], jc.pools)
    got = plan.observer_groups(
        [(s, o, b) for s in _grid(scenarios, "scenario", ["hbm", "host"],
                                  ("r", "w"))
         for o in s.observers for b in o.buffers], tc.pools)
    assert list(got.values()) == list(want.values())
    assert len(got) == 4


class _NoDuty:
    duty_cycle = None


@pytest.mark.parametrize("shape", [None, "steady", "burst", "no duty"])
def test_plan_helpers_equal_reference(shape):
    def mk(mod):
        return {None: None, "steady": mod.TrafficShape.steady(),
                "burst": mod.TrafficShape.burst(0.25),
                "no duty": _NoDuty()}[shape]
    assert plan.effective_duty(mk(scenarios)) == \
        jplan.effective_duty(mk(jsc)) == (0.25 if shape == "burst" else 1.0)
    for ms in (None, 0, 3, 7):
        ts = scenarios.ScenarioSpec(
            "d", scenarios.ObserverSpec("r", "hbm", (K64,)),
            (scenarios.StressorSpec("w", "hbm", K64),), max_stressors=ms)
        js = jsc.ScenarioSpec(
            "d", jsc.ObserverSpec("r", "hbm", (K64,)),
            (jsc.StressorSpec("w", "hbm", K64),), max_stressors=ms)
        for engines in (1, 4, 8):
            assert plan.ladder_depth(ts, engines) == \
                jplan.ladder_depth(js, engines)

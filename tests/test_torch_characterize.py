"""Port vs reference: characterization, CurveDB and placement (CPU).

``characterize``, ``characterize_surface``, ``characterize_matrix`` and
``refresh_surface_cells`` on ``simulate`` write CurveDB files whose bytes
equal the reference's, on the reference's trees converted through their
JSON.  The committed ``SURFACE_spmd.json``, loaded by both packages and
saved again, gives byte-identical files.  Queries, the MLP table and the
Placement Advisor's decisions are equal on the same database.
"""
import dataclasses
import os

import pytest

from repro.core import characterize as jch
from repro.core import coordinator as jco
from repro.core import devicetree as jdt
from repro.core import placement as jpl
from repro.core import pools as jpools
from repro.core import scenarios as jsc
from repro_torch.core import (characterize, convert, coordinator, placement,
                              pools, scenarios)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SURFACE = os.path.join(ROOT, "SURFACE_spmd.json")
TREES = {"tpu-v5e": (jdt.TPU_V5E, ["hbm", "host"]),
         "zcu102": (jdt.ZCU102, ["dram", "pl-dram"])}


def _pair(tree):
    ref_plat = TREES[tree][0]
    plat = convert.platform_from_reference_json(ref_plat.to_json(),
                                                ref_plat.cache_node)
    return (jco.CoreCoordinator(jpools.PoolManager(ref_plat), ref_plat,
                                backend="simulate"),
            coordinator.CoreCoordinator(pools.PoolManager(plat, "cpu"), plat,
                                        backend="simulate", device="cpu"))


def _bytes_of(db, path, **kw):
    db.save(str(path), **kw)
    with open(path, "rb") as f:
        return f.read()


def _assert_same_file(jdb, tdb, tmp_path, **kw):
    want = _bytes_of(jdb, tmp_path / "ref.json", **kw)
    got = _bytes_of(tdb, tmp_path / "port.json", **kw)
    assert got == want and len(got) > 100


def _run(tree, fn_name, **kw):
    jc, tc = _pair(tree)
    ref_kw = {k: (v(jsc) if callable(v) else v) for k, v in kw.items()}
    port_kw = {k: (v(scenarios) if callable(v) else v)
               for k, v in kw.items()}
    return (getattr(jch, fn_name)(jc, **ref_kw),
            getattr(characterize, fn_name)(tc, **port_kw))


@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("shaped", [False, True])
def test_characterize_writes_the_references_bytes(tree, shaped, tmp_path):
    kw = dict(iters=5, obs_strategies=("r", "w", "l"))
    if shaped:
        kw["stress_shapes"] = lambda mod: mod.DEFAULT_STRESS_SHAPES
        kw["pools"] = TREES[tree][1]
    jdb, tdb = _run(tree, "characterize", **kw)
    assert tdb.meta["measure_dispatches"] == 0
    _assert_same_file(jdb, tdb, tmp_path)
    _assert_same_file(jdb, tdb, tmp_path, schema=2)


@pytest.mark.parametrize("tree", sorted(TREES))
def test_characterize_surface_writes_the_references_bytes(tree, tmp_path):
    jdb, tdb = _run(tree, "characterize_surface", pools=TREES[tree][1],
                    iters=5, max_stressors=3)
    assert all(len(s.axes) == 3 for s in tdb.surfaces.values())
    _assert_same_file(jdb, tdb, tmp_path)
    _assert_same_file(jdb, tdb, tmp_path, schema=2)


@pytest.mark.parametrize("tree", sorted(TREES))
def test_characterize_matrix_writes_the_references_bytes(tree, tmp_path):
    fast, slow = TREES[tree][1]

    def specs(mod):
        multi = mod.ScenarioSpec(
            "multi", (mod.ObserverSpec("r", fast, (64 << 10, 1 << 20)),
                      mod.ObserverSpec("l", slow, (64 << 10,),
                                       mod.TrafficShape.strided(8))),
            (mod.StressorSpec("w", fast, 1 << 20),
             mod.StressorSpec("r", slow, 1 << 20,
                              mod.TrafficShape.mixed(2, 1))),
            iters=5, max_stressors=2)
        return [multi] + mod.scenario_matrix(
            pools=[fast], buffer_bytes=1 << 20, obs_strategies=("x", "i"),
            stress_shapes=mod.DEFAULT_STRESS_SHAPES[:3], iters=5)
    jdb, tdb = _run(tree, "characterize_matrix", specs=specs)
    _assert_same_file(jdb, tdb, tmp_path)


@pytest.mark.parametrize("tree", sorted(TREES))
def test_refresh_surface_cells_equal(tree, tmp_path):
    jc, tc = _pair(tree)
    fast = TREES[tree][1][0]
    jdb = jch.characterize_surface(jc, pools=[fast], iters=5)
    tdb = characterize.characterize_surface(tc, pools=[fast], iters=5)
    for _ in range(2):
        jkeys, jstats = jch.refresh_surface_cells(
            jc, jdb, pools=[fast], rw_ratio=0.3, inject_rate=0.7,
            drift={"gap": 0.2})
        tkeys, tstats = characterize.refresh_surface_cells(
            tc, tdb, pools=[fast], rw_ratio=0.3, inject_rate=0.7,
            drift={"gap": 0.2})
        assert [dataclasses.asdict(k) for k in tkeys] == \
            [dataclasses.asdict(k) for k in jkeys]
        assert tstats == jstats
    _assert_same_file(jdb, tdb, tmp_path)


@pytest.mark.parametrize("schema", [None, 2])
def test_committed_surface_file_round_trips_byte_identically(schema,
                                                             tmp_path):
    jdb = jch.CurveDB.load(SURFACE)
    tdb = characterize.CurveDB.load(SURFACE)
    _assert_same_file(jdb, tdb, tmp_path, schema=schema)
    if schema is None:
        with open(SURFACE, "rb") as f:
            assert _bytes_of(tdb, tmp_path / "again.json") == f.read()
    # and what one package writes, the other reads back to the same bytes
    again = characterize.CurveDB.load(str(tmp_path / "ref.json"))
    assert _bytes_of(again, tmp_path / "again2.json") == \
        _bytes_of(jdb, tmp_path / "ref2.json", schema=schema)


@pytest.fixture(scope="module")
def surface_pair():
    jc, tc = _pair("tpu-v5e")
    specs = {}
    for name, ch, c in (("ref", jch, jc), ("port", characterize, tc)):
        db = ch.characterize_surface(c, pools=["hbm", "host"], iters=5)
        db.surfaces.update(ch.characterize(
            c, pools=["hbm", "host"], obs_strategies=("r", "l"),
            stress_strategies=("r", "w"), iters=5).surfaces)
        specs[name] = (db, c)
    return specs


QUERIES = [
    dict(pool="hbm", n_stressors=3),
    dict(pool="hbm", n_stressors=2.5, rw_ratio=0.3, inject_rate=0.6),
    dict(pool="host", n_stressors=7, stress_pool="hbm", stress_strat="b",
         rw_ratio=0.9),
    dict(pool="hbm", n_stressors=12, obs_strat="l", rw_ratio=1.5),
    dict(pool="host", n_stressors=1, obs_strat="l", stress_strat="r"),
    dict(pool="hbm", n_stressors=4, shape_tag="dc0.50"),
    dict(pool="hbm", n_stressors=4, qualifier="online"),
]


@pytest.mark.parametrize("q", QUERIES)
def test_queries_equal(surface_pair, q):
    jdb, _ = surface_pair["ref"]
    tdb, _ = surface_pair["port"]
    q = dict(q)
    pool, n = q.pop("pool"), q.pop("n_stressors")
    want, got = jdb.query(pool, n, **q), tdb.query(pool, n, **q)
    assert (got.bandwidth_gbps, got.latency_ns, got.extrapolated) == \
        (want.bandwidth_gbps, want.latency_ns, want.extrapolated)
    assert got.coord.coords == want.coord.coords


def test_mlp_table_and_legacy_views_equal(surface_pair):
    jdb, jc = surface_pair["ref"]
    tdb, tc = surface_pair["port"]
    assert characterize.mlp_table(tdb, tc.platform) == \
        jch.mlp_table(jdb, jc.platform)
    assert tdb.mlp("hbm", 512) == jdb.mlp("hbm", 512)
    assert tdb.observer_pools() == jdb.observer_pools()
    assert {k: [dataclasses.asdict(p) for p in v]
            for k, v in tdb.curves.items()} == \
        {k: [dataclasses.asdict(p) for p in v] for k, v in jdb.curves.items()}


def _objects(mod):
    g = 1 << 30
    return [mod.params_object("params", 18 * g),
            mod.kv_cache_object("kv_cache", 20 * g, 20 * g),
            mod.MemObject("activations", 8 * g, 16 * g),
            mod.optimizer_state_object("opt", 4 * g),
            mod.MemObject("index", 1 * g, 1e6, dependent_accesses=5e4),
            mod.MemObject("pinned", 1 << 20, 1e3, pinned_pool="host")]


CONTENTION = [
    (0, "hbm", "w", {}),
    (7, "hbm", "y", {}),
    (3, "hbm", "b", dict(rw_ratio=0.9)),
    (5, "host", "r", {}),
    (4, "hbm", "w", dict(inject_rate=0.5)),
]


def _decisions(plan):
    return {n: (d.pool, d.predicted_step_ns, d.alternatives, d.extrapolated)
            for n, d in plan.decisions.items()}


@pytest.mark.parametrize("n,sp,ss,kw", CONTENTION)
@pytest.mark.parametrize("pessimistic", [False, True])
def test_advise_and_readvise_equal(surface_pair, n, sp, ss, kw, pessimistic):
    jdb, jc = surface_pair["ref"]
    tdb, tc = surface_pair["port"]
    caps = {"hbm": 80 * 10**9, "host": 64 << 30}
    jadv = jpl.PlacementAdvisor(jdb, jc.platform, pools=["hbm", "host"],
                                pessimistic=pessimistic)
    tadv = placement.PlacementAdvisor(tdb, tc.platform,
                                      pools=["hbm", "host"],
                                      pessimistic=pessimistic)
    jcon = jpl.ContentionSpec(n, sp, ss, **kw)
    tcon = placement.ContentionSpec(n, sp, ss, **kw)
    want = jadv.advise(_objects(jpl), jcon, caps)
    got = tadv.advise(_objects(placement), tcon, caps)
    assert _decisions(got) == _decisions(want)
    assert got.report() == want.report()
    assert got.total_predicted_ns() == want.total_predicted_ns()
    current = {"params": "host", "kv_cache": "hbm", "activations": "host"}
    jr = jadv.readvise(_objects(jpl), jcon, current, capacities=caps)
    tr = tadv.readvise(_objects(placement), tcon, current, capacities=caps)
    assert (tr.moves, tr.held, tr.predicted_gain_ns,
            tr.predicted_gain_frac) == (jr.moves, jr.held,
                                        jr.predicted_gain_ns,
                                        jr.predicted_gain_frac)


def test_contention_spec_shaped_equal():
    for kind, args in (("mixed", (2, 1)), ("burst", (0.5,)),
                       ("strided", (8,)), ("steady", ())):
        want = jpl.ContentionSpec.shaped(
            3, "hbm", "w", getattr(jsc.TrafficShape, kind)(*args))
        got = placement.ContentionSpec.shaped(
            3, "hbm", "w", getattr(scenarios.TrafficShape, kind)(*args))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_advise_refusals_equal(surface_pair):
    jdb, jc = surface_pair["ref"]
    tdb, tc = surface_pair["port"]
    big = 200 * 10**9
    for mod, db, c in ((jpl, jdb, jc), (placement, tdb, tc)):
        adv = mod.PlacementAdvisor(db, c.platform, pools=["hbm", "host"])
        with pytest.raises(RuntimeError, match="fits no pool"):
            adv.advise([mod.MemObject("huge", big, 1.0)],
                       capacities={"hbm": 1 << 30, "host": 1 << 30})
        with pytest.raises(RuntimeError, match="no candidate pools"):
            adv.advise([mod.MemObject("x", 1, 1.0)],
                       capacities={"nope": 1 << 30})

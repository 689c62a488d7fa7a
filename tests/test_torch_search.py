"""Port vs reference: the worst-case contention search (CPU).

On the modeled path (``execute=False``) the port's ``worst_case_search``
must serialise its envelopes, probe points and acquisition trace
byte-identically to the JAX package's for the same ``SearchSpec`` on the
same platform tree (handed over as JSON through ``core/convert.py``):
three seeds, with and without a calibrating CurveDB, and across a
save/load of that database — the reference's file loaded by the port.
JAX runs through its own ``CoreCoordinator(backend="simulate")``.

Then the cases of tests/test_search.py on the port, and the executed path
on ``backend="spmd", device="cpu"``: the ladder kernel's plain version,
one host sync an iteration, and dead probes that replay their arm.
"""
import json

import pytest

from repro.core import characterize as jchar
from repro.core import coordinator as jco
from repro.core import devicetree as jdt
from repro.core import pools as jpools
from repro.core import search as jsearch
from repro_torch.core import characterize as tchar
from repro_torch.core import convert
from repro_torch.core.characterize import AXIS_N, CurveDB, SurfaceKey
from repro_torch.core.coordinator import CoreCoordinator
from repro_torch.core.devicetree import H100_SXM
from repro_torch.core.exec.resilience import RetryPolicy
from repro_torch.core.pools import PoolManager
from repro_torch.core.scenarios import TrafficShape
from repro_torch.core.search import (DEFAULT_ARMS, WORSTCASE_QUALIFIER,
                                     SearchArm, SearchSpec,
                                     worst_case_search)
from repro_torch.kernels import counts

BUF = 64 << 10
# tree name -> (the reference's tree, the pool searched)
TREES = {"tpu-v5e": (jdt.TPU_V5E, "hbm"), "zcu102": (jdt.ZCU102, "dram")}


def _pair(tree):
    ref_plat = TREES[tree][0]
    plat = convert.platform_from_reference_json(ref_plat.to_json(),
                                                ref_plat.cache_node)
    return (jco.CoreCoordinator(jpools.PoolManager(ref_plat), ref_plat,
                                backend="simulate"),
            CoreCoordinator(PoolManager(plat, "cpu"), plat,
                            backend="simulate", device="cpu"))


def _bytes(result) -> bytes:
    """Everything the search emits, as one JSON text."""
    return json.dumps(
        {"envelope": {k.to_string(): s.to_dict()
                      for k, s in result.envelope.items()},
         "points": [p.to_dict() for p in result.points],
         "trace": result.trace,
         "executed": result.executed, "fenced": result.fenced},
        sort_keys=True).encode()


def _calibration_db(pkg, pool):
    """A measured-looking edge for ``pool``, built by either package."""
    db = pkg.CurveDB(platform="test")
    db.surfaces[pkg.SurfaceKey(pool, "r", pool, "b")] = pkg.Surface(
        axes=(pkg.SurfaceAxis(pkg.AXIS_N, (0.0, 1.0, 3.0)),),
        bandwidth_gbps=[90.0, 55.0, 30.0], latency_ns=[0.0, 0.0, 0.0])
    db.surfaces[pkg.SurfaceKey(pool, "l", pool, "b")] = pkg.Surface(
        axes=(pkg.SurfaceAxis(pkg.AXIS_N, (0.0, 1.0, 3.0)),),
        bandwidth_gbps=[1.0, 1.0, 1.0], latency_ns=[120.0, 300.0, 700.0])
    return db


@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("seed", [0, 5, 11])
def test_modeled_search_is_byte_identical_to_the_reference(tree, seed,
                                                           tmp_path):
    jc, tc = _pair(tree)
    pool = TREES[tree][1]
    kw = dict(pool=pool, iterations=5, batch=3, max_stressors=3, seed=seed)
    jspec, tspec = jsearch.SearchSpec(**kw), SearchSpec(**kw)
    want = jsearch.worst_case_search(jc, jspec, execute=False)
    got = worst_case_search(tc, tspec, execute=False)
    assert _bytes(got) == _bytes(want)
    assert not got.executed and got.stats.host_sync_dispatches == 0

    # calibrated to a database: the same database built by each package,
    # and the reference's saved file loaded by the port
    jdb = _calibration_db(jchar, pool)
    want = jsearch.worst_case_search(jc, jspec, jdb, execute=False)
    got = worst_case_search(tc, tspec, _calibration_db(tchar, pool),
                            execute=False)
    assert _bytes(got) == _bytes(want)
    path = str(tmp_path / "db.json")
    jdb.save(path)
    loaded = CurveDB.load(path)
    assert _bytes(worst_case_search(tc, tspec, loaded, execute=False)) == \
        _bytes(want)

    # the envelope installed, saved and reloaded: both packages write the
    # same file, and a second search against it is unchanged
    want.install(jdb)
    got.install(loaded)
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    jdb.save(a)
    loaded.save(b)
    assert open(a, "rb").read() == open(b, "rb").read()
    again = worst_case_search(tc, tspec, CurveDB.load(b), execute=False)
    assert _bytes(again) == _bytes(got)


# ---------------------------------------------------------------------------
# The cases of tests/test_search.py, on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def coord():
    return CoreCoordinator(PoolManager(H100_SXM, "cpu"), H100_SXM,
                           backend="simulate", device="cpu")


def test_search_is_seed_deterministic(coord):
    spec = SearchSpec(iterations=5, batch=3, max_stressors=3, seed=11)
    a = worst_case_search(coord, spec, execute=False)
    b = worst_case_search(coord, spec, execute=False)
    assert _bytes(a) == _bytes(b)
    c = worst_case_search(
        coord, SearchSpec(iterations=5, batch=3, max_stressors=3, seed=12),
        execute=False)
    assert [t["candidates"] for t in a.trace] != \
        [t["candidates"] for t in c.trace]


def test_search_envelope_is_worst_per_stressor_count(coord):
    spec = SearchSpec(iterations=6, batch=3, max_stressors=3, seed=2)
    r = worst_case_search(coord, spec, execute=False)
    assert {k.obs_strat for k in r.envelope} == {"r", "l"}
    for key, surf in r.envelope.items():
        assert key.qualifier == WORSTCASE_QUALIFIER
        assert (key.obs_pool, key.stress_pool, key.stress_strat) == \
            ("hbm", "hbm", "b")
        assert surf.axes[0].name == AXIS_N
        prov = surf.provenance["worstcase"]
        assert prov["seed"] == 2 and len(prov["acquisition_trace"]) == 6
        for i, n in enumerate(surf.axes[0].values):
            same_n = [p for p in r.points
                      if p.obs_strat == key.obs_strat
                      and p.n_stressors == int(n)]
            if key.obs_strat == "l":
                assert surf.latency_ns[i] == pytest.approx(
                    max(p.latency_ns for p in same_n))
            else:
                assert surf.bandwidth_gbps[i] == pytest.approx(
                    min(p.bandwidth_gbps for p in same_n))
    worst = r.worst("r")
    key = SurfaceKey("hbm", "r", "hbm", "b", qualifier=WORSTCASE_QUALIFIER)
    assert r.envelope[key].provenance["worstcase"]["worst"] == \
        worst.to_dict()
    with pytest.raises(KeyError, match="no probes"):
        r.worst("w")


def test_search_bandit_plays_every_arm_then_exploits(coord):
    spec = SearchSpec(iterations=len(DEFAULT_ARMS) + 2, batch=2,
                      max_stressors=3, seed=1)
    r = worst_case_search(coord, spec, execute=False)
    played = [t["arm"] for t in r.trace]
    assert sorted(played[:len(DEFAULT_ARMS)]) == \
        sorted(a.label() for a in DEFAULT_ARMS)
    assert set(played[len(DEFAULT_ARMS):]) <= set(played)


def test_search_arm_shapes_honour_coordinates():
    assert SearchArm("t", 32).shape(0.5, 0.5) == TrafficShape(
        kind="strided", stride=32, duty_cycle=0.5)
    assert SearchArm("y").shape(0.5, 1.0) == TrafficShape.steady()
    assert SearchArm("y").shape(0.5, 0.5).duty_cycle == 0.5
    assert SearchArm("b").shape(0.75, 0.5) == TrafficShape.traffic(
        0.75, 0.5)
    assert SearchArm("b").read_fraction(0.75) == 0.75
    assert SearchArm("y").read_fraction(0.75) is None
    assert [a.label() for a in DEFAULT_ARMS] == ["b", "y", "t/st8",
                                                 "t/st64"]


# ---------------------------------------------------------------------------
# The executed path: backend "spmd" on the CPU, the ladder's plain version
# ---------------------------------------------------------------------------


def _spmd(**kw):
    kw.setdefault("faults", False)
    return CoreCoordinator(PoolManager(H100_SXM, "cpu"), H100_SXM,
                           backend="spmd", device="cpu", **kw)


EXEC_SPEC = SearchSpec(iterations=4, batch=2, max_stressors=7, seed=9,
                       buffer_bytes=BUF, iters=2)


def test_executed_search_costs_one_host_sync_an_iteration():
    coord = _spmd(quality="off")
    counts.reset()
    r = worst_case_search(coord, EXEC_SPEC)       # execute=None: spmd
    assert r.executed and r.fenced
    st = r.stats
    assert st.resilience_clean()
    assert st.host_sync_dispatches == EXEC_SPEC.iterations
    assert [t["host_sync_dispatches"] for t in r.trace] == \
        [1] * EXEC_SPEC.iterations
    # every probe batch ran the ladder's plain version, once
    assert counts.PLAIN["contention_ladder"] == st.host_sync_dispatches
    assert counts.LAUNCHES["contention_ladder"] == 0
    assert st.programs_built == EXEC_SPEC.iterations
    assert {k.to_string() for k in r.envelope} == \
        {"hbm:r|hbm:b#worstcase", "hbm:l|hbm:b#worstcase"}
    n_probes = EXEC_SPEC.iterations * EXEC_SPEC.batch * 2
    assert len(r.points) == n_probes
    assert all(p.bandwidth_gbps > 0 for p in r.points)
    assert all(t["dead_probes"] == 0 for t in r.trace)
    assert all(p.n_stressors <= 7 for p in r.points)
    # the model path on the same coordinator, asked for, runs nothing
    counts.reset()
    m = worst_case_search(coord, EXEC_SPEC, execute=False)
    assert not m.executed and m.stats.host_sync_dispatches == 0
    assert not any(counts.PLAIN.values())


def test_execute_none_follows_the_backend():
    counts.reset()
    sim = CoreCoordinator(PoolManager(H100_SXM, "cpu"), H100_SXM,
                          backend="simulate", device="cpu")
    assert not worst_case_search(sim, EXEC_SPEC).executed
    cuda = CoreCoordinator(PoolManager(H100_SXM, "cpu"), H100_SXM,
                           backend="cuda", device="cpu")
    assert not worst_case_search(cuda, EXEC_SPEC).executed
    assert not any(counts.PLAIN.values())


def _no_sleep(_s):
    return None


def test_dead_probes_replay_their_arm():
    """A batch whose dispatch exhausted the resilience ladder is DEAD: it
    folds nothing into the acquisition state, so its arm stays unplayed
    and the bandit plays it again next."""
    policy = RetryPolicy(retries=0, degrade=False, sleep=_no_sleep)
    every = worst_case_search(
        _spmd(faults="compile=1.0", retry=policy, quality="off"), EXEC_SPEC)
    assert every.executed
    assert [t["arm"] for t in every.trace] == ["b"] * EXEC_SPEC.iterations
    assert all(t["dead_probes"] == EXEC_SPEC.batch * 2
               for t in every.trace)
    assert not every.points and not every.envelope
    assert every.stats.modeled_floor_ladders > 0

    spec = SearchSpec(iterations=6, batch=2, max_stressors=7, seed=9,
                      buffer_bytes=BUF, iters=2)
    some = worst_case_search(
        _spmd(faults="compile=0.5,seed=3", retry=policy, quality="off"),
        spec)
    labels = [a.label() for a in spec.arms]
    played, dead_seen, live_seen = set(), False, False
    for t in some.trace:
        unplayed = [a for a in labels if a not in played]
        if unplayed:
            assert t["arm"] == unplayed[0]
        if t["dead_probes"] == spec.batch * 2:
            dead_seen = True
        else:
            assert t["dead_probes"] == 0
            live_seen = True
            played.add(t["arm"])
    assert dead_seen and live_seen

"""Port vs reference: the executed contention ladder (``spmd`` backend).

The JAX package executes its ladders on an ("engine",) mesh of 8 forced
host devices (one subprocess, ``spmd_activity="jnp"``); the port runs the
same specs with ``backend="spmd", device="cpu"``: the ladder's plain
version, engine by engine, on the same platform tree (converted with
``core/convert.py``).  They must agree on the curve keys, the executed
rungs, ``bytes_moved``/``transactions`` of every executed point, every
``DispatchStats`` field in the ``batched``, ``ladder`` and ``rung`` modes
with packing on and off, and the ``execution`` provenance — but for four
fields that differ by design:

* ``activity``: ``"jnp"`` there, ``"plain"`` here (``"cuda"`` on the
  card);
* ``timing_source``: ``"device"`` there (its fused path always says so),
  ``"host"`` here (the plain version stamps with the host's clock;
  ``"device"`` on the card, ``%globaltimer``);
* ``aot`` (and ``DispatchStats.aot_compiles``): the reference compiles
  each program ahead of time, the port builds one kernel once;
* ``rung_time_spread_ns``: measured values (only their count compares).

The rest of the file holds the port's spmd backend to the reference's own
accounting tests (tests/test_contention_fidelity.py, test_resilience.py)
on the CPU, and shows that nothing falls back.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.core import coordinator as jco
from repro.core import devicetree as jdt
from repro.core import scenarios as jsc
from repro_torch import compat
from repro_torch.core import convert
from repro_torch.core.characterize import (CurveDB, characterize,
                                           characterize_matrix,
                                           curvedb_from_result)
from repro_torch.core import coordinator as tco
from repro_torch.core import scenarios as tsc
from repro_torch.core.coordinator import CoreCoordinator, ValidationError
from repro_torch.core.devicetree import H100_SXM
from repro_torch.core.exec import fence
from repro_torch.core.exec import journal as exec_journal
from repro_torch.core.exec import plan as exec_plan
from repro_torch.core.exec import program as exec_program
from repro_torch.core.exec.dispatch import DispatchStats
from repro_torch.core.pools import PoolManager
from repro_torch.core.scenarios import (ObserverSpec, ScenarioSpec,
                                        StressorSpec, TrafficShape)
from repro_torch.kernels import contention, counts

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
BUF = 64 << 10

# the specs and the modes of the comparison, run by the reference in a
# forced-8-device subprocess and by the port in this process
SPECS_SRC = """
from repro.core.scenarios import (ObserverSpec as O, ScenarioSpec,
                                  StressorSpec as S, TrafficShape as T)
B = 64 << 10
SPECS = [
    ScenarioSpec("consistency", O("r", "hbm", (B,)), (S("w", "hbm", B),),
                 iters=3, max_stressors=3),
    ScenarioSpec("acct", (O("r", "hbm", (B,)), O("w", "hbm", (B,))),
                 (S("w", "hbm", B),), iters=3, max_stressors=2),
    *[ScenarioSpec(f"pk{n}", O("r", "hbm", (B,)), (S("w", "hbm", B),),
                   iters=3, max_stressors=1) for n in "abcd"],
    ScenarioSpec("shapes", (O("t", "hbm", (B,), T.strided(8)),
                            O("r", "hbm", (B,), T.mixed(2, 1)),
                            O("l", "hbm", (B,)), O("i", "hbm", (0,))),
                 (S("y", "hbm", B), S("x", "hbm", B, T.burst(0.5))),
                 iters=2, max_stressors=2, coupled=False),
]
MODES = [("batched", "auto", True), ("batched", "off", True),
         ("batched", "auto", False), ("ladder", "auto", True)]
RUNG_SPECS = [0, 2]          # the host-timed per-rung path: a short list
"""

REF_BODY = SPECS_SRC + """
import dataclasses, json
from repro.core.coordinator import CoreCoordinator

def dump(res):
    return {"stats": dataclasses.asdict(res.stats),
            "runs": [{"key": r.key, "execution": r.execution,
                      "points": [[s.source, s.main.strategy,
                                  s.main.bytes_moved, s.main.transactions]
                                 for s in r.scenarios]}
                     for r in res.runs]}

out = {"specs": [s.to_dict() for s in SPECS], "modes": {}}
for mode, pack, batched in MODES:
    c = CoreCoordinator(backend="spmd", spmd_activity="jnp",
                        spmd_dispatch=mode, spmd_pack=pack, faults=False,
                        quality="off")
    out["modes"][f"{mode}/{pack}/{batched}"] = dump(
        c.run_matrix(SPECS, batched=batched))
c = CoreCoordinator(backend="spmd", spmd_activity="jnp",
                    spmd_dispatch="rung", faults=False, quality="off")
out["modes"]["rung"] = dump(c.run_matrix([SPECS[i] for i in RUNG_SPECS]))
print("RESULT " + json.dumps(out))
"""

# provenance fields that differ by design (see the module docstring)
DIFFER = ("activity", "timing_source", "aot", "rung_time_spread_ns")


def _reference_run():
    code = textwrap.dedent("""
        import os
        os.environ["XLA_FLAGS"] = \\
            "--xla_force_host_platform_device_count=8"
    """) + REF_BODY
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("REPRO_FAULT_SPEC", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env)
    assert r.returncode == 0, f"stderr:\n{r.stderr[-3000:]}"
    line = next(ln for ln in r.stdout.splitlines()
                if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def reference():
    return _reference_run()


def _port_coord(**kw):
    ref_plat = jdt.TPU_V5E
    plat = convert.platform_from_reference_json(ref_plat.to_json(),
                                                ref_plat.cache_node)
    return CoreCoordinator(PoolManager(plat, "cpu"), plat, backend="spmd",
                           device="cpu", faults=False, quality="off", **kw)


def _port_dump(res):
    import dataclasses
    return {"stats": dataclasses.asdict(res.stats),
            "runs": [{"key": r.key, "execution": r.execution,
                      "points": [[s.source, s.main.strategy,
                                  s.main.bytes_moved, s.main.transactions]
                                 for s in r.scenarios]}
                     for r in res.runs]}


def _compare(want, got):
    ws, gs = dict(want["stats"]), dict(got["stats"])
    assert gs.pop("aot_compiles") == 0
    ws.pop("aot_compiles")
    assert gs == ws
    assert [r["key"] for r in got["runs"]] == [r["key"] for r in want["runs"]]
    for w, g in zip(want["runs"], got["runs"]):
        assert g["points"] == w["points"], g["key"]
        we, ge = dict(w["execution"]), dict(g["execution"])
        assert ge["activity"] == "plain" and we["activity"] == "jnp"
        assert ge["timing_source"] == "host"
        assert ge["aot"] is False
        assert len(ge["rung_time_spread_ns"]) == \
            len(we["rung_time_spread_ns"])
        for k in DIFFER:
            ge.pop(k), we.pop(k)
        assert ge == we, g["key"]
        assert ge["fenced"] is True


def test_execution_matches_the_reference_in_every_mode(reference):
    ns = {}
    exec(SPECS_SRC.replace("repro.core.scenarios",
                           "repro_torch.core.scenarios"), ns)
    specs = [ScenarioSpec.from_dict(d) for d in reference["specs"]]
    assert [s.to_dict() for s in specs] == \
        [s.to_dict() for s in ns["SPECS"]]
    for mode, pack, batched in ns["MODES"]:
        c = _port_coord(spmd_dispatch=mode, spmd_pack=pack)
        got = _port_dump(c.run_matrix(specs, batched=batched))
        _compare(reference["modes"][f"{mode}/{pack}/{batched}"], got)
    c = _port_coord(spmd_dispatch="rung")
    got = _port_dump(c.run_matrix([specs[i] for i in ns["RUNG_SPECS"]]))
    _compare(reference["modes"]["rung"], got)


# ---------------------------------------------------------------------------
# the port's spmd backend on the CPU: the reference's accounting tests
# ---------------------------------------------------------------------------


def _coord(**kw):
    kw.setdefault("faults", False)
    return CoreCoordinator(PoolManager(H100_SXM, "cpu"), H100_SXM,
                           backend="spmd", device="cpu", **kw)


def _spec(name="s", ostrat="r", pool="hbm", iters=3, k=2, **kw):
    return ScenarioSpec(name, ObserverSpec(ostrat, pool, (BUF,)),
                        (StressorSpec("w", "hbm", BUF),), iters=iters,
                        max_stressors=k, **kw)


def test_fused_and_rung_dispatch_accounting():
    spec = ScenarioSpec(
        "acct", (ObserverSpec("r", "hbm", (BUF,)),
                 ObserverSpec("w", "hbm", (BUF,))),
        (StressorSpec("w", "hbm", BUF),), iters=3, max_stressors=2)
    depth = 3
    counts.reset()
    fused = _coord().run_matrix([spec])
    st = fused.stats
    assert (st.n_ladders, st.spmd_rungs) == (2, 2 * depth)
    assert st.measure_dispatches == 2
    assert st.host_sync_dispatches == 2 + st.noisy_remeasures
    assert counts.PLAIN["contention_ladder"] == st.host_sync_dispatches
    assert counts.LAUNCHES["contention_ladder"] == 0
    for run in fused.runs:
        ex = run.execution
        assert ex["timing_source"] == "host" and ex["activity"] == "plain"
        assert ex["fenced"] is True and ex["aot"] is False
        assert ex["dispatches"] == 1 + ex["remeasures"]
        assert len(ex["rung_time_spread_ns"]) == depth
        assert all(s.source == "executed" and s.main.elapsed_ns > 0
                   for s in run.scenarios)
    legacy = _coord(spmd_dispatch="rung").run_matrix([spec])
    st = legacy.stats
    assert st.spmd_rungs == st.measure_dispatches == 2 * depth
    assert st.host_sync_dispatches == 4 * 2 * depth      # warm + 3 timed
    for run in legacy.runs:
        assert run.execution["timing_source"] == "host"
        assert run.execution["dispatches"] == 4 * depth
        assert run.execution["fenced"] is True


def test_batched_and_packed_sweeps_account_one_launch_per_signature():
    specs = [_spec(n, iters=it, k=1) for n, it in
             (("a", 3), ("b", 3), ("c", 5), ("d", 5))]
    c = _coord(quality="off")
    res = c.run_matrix(specs)
    st = res.stats
    assert st.spmd_groups == 2 and st.host_sync_dispatches == 2
    assert st.programs_built == 2 and st.spmd_rungs == 8
    assert st.packed_ladders == 4 and st.subset_width == 2
    assert sorted(r.execution["subset_index"] for r in res.runs) == \
        [0, 0, 1, 1]
    again = c.run_matrix(specs)
    assert again.stats.program_cache_hits == 2
    assert again.stats.programs_built == 0
    off = _coord(quality="off", spmd_pack="off").run_matrix(specs)
    assert off.stats.packed_ladders == 0
    assert off.stats.host_sync_dispatches == 2
    unb = _coord(quality="off").run_matrix(specs, batched=False)
    assert unb.stats.host_sync_dispatches == 4 and unb.stats.spmd_groups == 0
    for a, b in zip(res.runs, unb.runs):
        assert a.key == b.key
        assert [s.main.bytes_moved for s in a.scenarios] == \
            [s.main.bytes_moved for s in b.scenarios]
        assert a.execution["fenced"] and b.execution["fenced"]


def test_lru_cap_one_under_rung_churn():
    c = _coord(spmd_dispatch="rung", spmd_cache_cap=1)
    for _ in range(2):
        res = c.run_matrix([_spec(k=2)])
        assert len(c._spmd_programs) == 1
        live = next(iter(c._spmd_programs.values()))
        assert live.xf is not None and live.xi is not None
        assert all(r.execution["fenced"] for r in res.runs)


def test_characterize_on_spmd_writes_executed_curves(tmp_path):
    c = _coord(quality="off")
    db = characterize(c, pools=["hbm", "host"], buffer_bytes=BUF,
                      obs_strategies=("r", "l"), stress_strategies=("w",),
                      iters=2)
    assert len(db.surfaces) == 8          # 2 x 2 observers x 2 stress pools
    for key, surf in db.surfaces.items():
        ex = surf.provenance["execution"]
        assert ex["backend"] == "spmd" and ex["fenced"] is True
        assert ex["executed_rungs"] == list(range(8))
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    db.save(a)
    CurveDB.load(a).save(b)
    assert open(a).read() == open(b).read()


def test_journal_resume_and_chaos_on_the_port(tmp_path):
    specs = [ScenarioSpec(f"jrn-{i}", ObserverSpec(o, "hbm", (BUF,)),
                          (StressorSpec("w", p, BUF),), iters=3,
                          max_stressors=1)
             for i, (o, p) in enumerate([("r", "hbm"), ("w", "hbm"),
                                         ("r", "host")])]
    jpath = str(tmp_path / "sweep.journal")
    real = exec_journal.SweepJournal.record

    def dying(self, planned, outcomes):
        real(self, planned, outcomes)
        raise KeyboardInterrupt("crash after the first group")
    coord = _coord(quality="off")
    exec_journal.SweepJournal.record = dying
    try:
        with pytest.raises(KeyboardInterrupt):
            characterize_matrix(coord, specs, journal=jpath)
    finally:
        exec_journal.SweepJournal.record = real
    db1 = characterize_matrix(coord, specs, journal=jpath)
    assert db1.meta["resumed_ladders"] >= 1
    db2 = characterize_matrix(coord, specs, journal=jpath)
    assert db2.meta["resumed_ladders"] == 3
    assert db2.meta["measure_dispatches"] == 0
    with pytest.raises(ValidationError):
        _coord(spmd_dispatch="rung").run_matrix(specs, journal=jpath)

    chaos = _coord(faults="mixed=0.35,seed=7", quality="off")
    res = chaos.run_matrix(
        [_spec(f"chaos-{o}", ostrat=o, k=1) for o in ("r", "w", "l", "c")])
    assert len(res.runs) == 4 and res.stats.faults_injected > 0
    for run in res.runs:
        assert run.execution["attempts"] >= 1
        assert all(s.modeled_bw_gbps > 0 for s in run.scenarios)
    meta = curvedb_from_result(res, "h100-sxm", backend="spmd").meta
    assert meta["faults_injected"] == res.stats.faults_injected


def test_env_fault_spec_reaches_the_dispatcher(monkeypatch):
    monkeypatch.setenv("REPRO_FAULT_SPEC", "mixed=0.3,seed=7")
    c = CoreCoordinator(PoolManager(H100_SXM, "cpu"), H100_SXM,
                        backend="spmd", device="cpu")
    assert c.fault_spec.seed == 7 and c._dispatcher.faults is not None
    off = CoreCoordinator(PoolManager(H100_SXM, "cpu"), H100_SXM,
                          backend="spmd", device="cpu", faults=False)
    assert off._dispatcher.faults is None


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------


def _skip_if_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the raise cannot be shown")


def test_spmd_without_a_card_raises():
    _skip_if_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CoreCoordinator(backend="spmd")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.kernels_supported("cuda")


def test_the_plain_activity_is_the_cpus_and_the_kernels_the_cards():
    # the device alone decides: there is no activity to ask for
    with pytest.raises(TypeError):
        _coord(spmd_activity="cuda")
    with pytest.raises(ValueError, match="probes a card"):
        compat.kernels_supported("cpu")
    assert compat.device_clock_source("cpu") == "host"
    assert _coord()._resolved_activity() == "plain"


def test_fewer_than_two_engines_raises_and_journal_needs_spmd():
    import dataclasses
    one = dataclasses.replace(H100_SXM, n_engines=1)
    c = CoreCoordinator(PoolManager(one, "cpu"), one, backend="spmd",
                        device="cpu")
    with pytest.raises(ValidationError, match=">= 2 engines"):
        c.run_matrix([ScenarioSpec("x", ObserverSpec("r", "hbm", (BUF,)),
                                   (StressorSpec("w", "hbm", BUF),),
                                   iters=2, max_stressors=0)])
    sim = CoreCoordinator(PoolManager(H100_SXM, "cpu"), H100_SXM,
                          backend="simulate", device="cpu")
    with pytest.raises(ValidationError, match="requires the spmd"):
        sim.run_matrix([_spec()], journal="x.journal")


# ---------------------------------------------------------------------------
# the coordinator's helpers, beside the reference's
# ---------------------------------------------------------------------------


def _grouping_specs(sc):
    """tests/test_scenarios.py's grouping grid, built by either package's
    scenario DSL (``sc``)."""
    specs = []
    for strat in ("r", "w"):
        for pool in ("hbm", "host"):
            for iters in (5, 9):
                for shape in (sc.TrafficShape.steady(),
                              sc.TrafficShape.burst(0.5)):
                    for buf in (64 << 10, 128 << 10):
                        specs.append(sc.ScenarioSpec(
                            f"g.{strat}.{pool}.{iters}."
                            f"{shape.tag() or 'steady'}.{buf}",
                            sc.ObserverSpec(strat, pool, (buf,), shape),
                            (sc.StressorSpec("w", "hbm", 64 << 10),),
                            iters=iters, max_stressors=2))
    return [(s, o, b) for s in specs for o in s.observers
            for b in o.buffers]


def _partition(keys):
    groups = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    return sorted(groups.values())


def test_spmd_group_key_matches_the_reference():
    """The signature part of every key equals the reference's.  The
    memory-kind part differs by design (ROADMAP queue 3, "hbm and pinned
    host never share a group on the card"): this JAX reports
    ``pinned_host`` for the reference's host pool on the CPU, so its
    hbm and host ladders split into 32 groups, while the port's host pool
    on ``device="cpu"`` holds ordinary memory (effective kind None) and
    merges with hbm into 16 — each port group the union of the reference
    groups that share its signature.  On the card the port's host pool
    is pinned and splits, as the reference's does here."""
    jc = jco.CoreCoordinator(backend="simulate")
    tc = _port_coord()
    jt = _grouping_specs(jsc)
    tt = _grouping_specs(tsc)
    jkeys = [jc._spmd_group_key(*t) for t in jt]
    tkeys = [tc._spmd_group_key(*t) for t in tt]
    assert [repr(k[0]) for k in tkeys] == [repr(k[0]) for k in jkeys]
    assert all(k[1] == (None, None) for k in tkeys)
    assert tkeys == [exec_plan.group_key(*t, tc.pools) for t in tt]
    sig = [repr(k[0]) for k in jkeys]
    assert _partition(tkeys) == _partition(sig)
    assert len(_partition(tkeys)) == 16
    assert len(_partition(jkeys)) == (
        16 if jc.pools.pool("hbm").effective_memory_kind()
        == jc.pools.pool("host").effective_memory_kind() else 32)


def test_program_cache_helpers_evict_and_drop_operands():
    c = _coord(spmd_cache_cap=1)
    e1, e2 = (exec_program.build_scenario_program(
        4, 1, ("r", None, 8, 1), ("w", None, 8, 1), device="cpu")
        for _ in range(2))
    c._program_cache_put(("k1",), e1)
    st = DispatchStats()
    assert c._program_cache_get(("k1",), st) is e1
    assert st.program_cache_hits == 1
    c._program_cache_put(("k2",), e2)
    assert list(c._spmd_programs) == [("k2",)]
    # the evicted entry's operands are gone now, not at collection time
    assert e1.xf is None and e1.xi is None and e1.dst is None
    assert e2.xf is not None and e2.xi is not None and e2.dst is not None
    assert c._program_cache_get(("k1",), st) is None
    assert c._program_cache_get(("k2",)) is e2
    assert st.program_cache_hits == 1


# ---------------------------------------------------------------------------
# build_scenario_program: one rung on the ladder kernel
# ---------------------------------------------------------------------------

ROWS = 16


def test_scenario_program_measured_region_is_fenced():
    """The reference's barrier-ordering regression, by stamps: every
    engine arrives before any begins, and the stop stamp follows every
    end; a launch whose start barrier does not wait, engines skewed, is
    refused."""
    prog = tco.build_scenario_program(
        8, 3, ("r", None, ROWS, 2), ("w", None, ROWS, 2), device="cpu")
    codes = [int(prog.roles[prog.table[0, e], 0]) for e in range(8)]
    assert codes == [contention.READ] + [contention.RMW] * 3 + \
        [contention.IDLE] * 4
    out = prog.launch()
    assert prog.is_fenced(out) and fence.stamps_fenced(out, prog.layout)
    bad = prog.launch(skip_start_wait=True, skew_ns=20_000)
    assert not fence.stamps_fenced(bad, prog.layout)
    assert not prog.is_fenced(bad)


def test_scenario_program_executes_each_role():
    """Engine 0 reads its rows, each stressor adds one a pass, the idle
    engines spin: the values of the roles as the ladder defines them."""
    prog = exec_program.build_scenario_program(
        4, 2, ("r", None, ROWS, 1), ("w", None, ROWS, 3),
        ("i", None, 1, 1), device="cpu")
    assert prog.table.shape == (1, 4)
    out = prog.launch()
    vals = out.outs.double().numpy()
    assert vals[0] == pytest.approx(
        [float(prog.xf[0, :ROWS].double().sum())], rel=1e-6)
    assert (vals[1:3] == float(prog.xf[1, 0, 0]) + 3).all()
    assert prog.is_fenced(out)
    # a mixed-stream stressor takes its read fraction from the shape
    mixed = exec_program.build_scenario_program(
        3, 2, ("l", None, ROWS, 1),
        ("b", TrafficShape.mixed(3, 1), ROWS, 1), device="cpu")
    assert int(mixed.roles[mixed.table[0, 1], 0]) == contention.MIXED
    assert int(mixed.roles[mixed.table[0, 0], 0]) == contention.CHASE_SHARED


def test_scenario_program_refuses_callables():
    with pytest.raises(TypeError, match="callable"):
        exec_program.build_scenario_program(
            2, 1, lambda m: m * 3.0, ("w", None, ROWS, 1), device="cpu")
    with pytest.raises(TypeError, match="callable"):
        exec_program.build_scenario_program(
            2, 1, ("r", None, ROWS, 1), ("w", None, ROWS, 1),
            idle=lambda s: s * 0.0, device="cpu")
    with pytest.raises(TypeError, match="tuple"):
        exec_program.build_scenario_program(2, 1, "r", ("w", None, ROWS, 1),
                                            device="cpu")
    with pytest.raises(ValueError, match="n_stressors"):
        exec_program.build_scenario_program(
            2, 2, ("r", None, ROWS, 1), ("w", None, ROWS, 1), device="cpu")

"""Port vs reference: the spmd execution pipeline, stage by stage (CPU).

* plan: ``build_plan``, ``pack_engine_subsets``, ``rung_roles``,
  ``group_key`` and ``probe_batch`` give equal tables in both packages on
  the contention-fidelity specs and the characterize grid;
* program: ``build_rung_operands`` byte-equal; every role letter's plain
  version equal to the JAX package's ``spmd_branch_fn(...,
  activity="pallas")`` (its Pallas kernels in interpret mode) on the same
  operands — rtol 2e-6 for the sums (float32 partials summed in another
  order), 1e-6 for the idle spin (fused vs separate multiply-add), exact
  for chase indices, writes, copies and rmw;
* fence: accepted and refused on hand-built stamps and layouts;
* resilience + journal: ``FaultSpec`` schedules byte-identical, journals
  restore across packages, and the reference's FakeDispatcher cases
  (retry, every degradation level, quality gate, crash-resume) re-run on
  the port.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import characterize as jchar
from repro.core import devicetree as jdt
from repro.core import pools as jpools
from repro.core import scenarios as jsc
from repro.core.exec import journal as jjournal
from repro.core.exec import plan as jplan
from repro.core.exec import program as jprogram
from repro.core.exec import resilience as jres
from repro.core.exec.dispatch import DispatchStats as JStats
from repro_torch.core import characterize as tchar
from repro_torch.core import convert, scenarios
from repro_torch.core.devicetree import H100_SXM
from repro_torch.core.exec import fence
from repro_torch.core.exec import journal as exec_journal
from repro_torch.core.exec import plan, program
from repro_torch.core.exec import dispatch
from repro_torch.core.exec import resilience as res
from repro_torch.core.exec.dispatch import DispatchStats, ProgramCache
from repro_torch.core.pools import PoolManager
from repro_torch.kernels import _build
from repro_torch.kernels import contention as kc
from repro_torch.kernels import ref

BUF = 1 << 16
NOOP = lambda _s: None          # noqa: E731 — retry backoff stub


def _trees(name):
    ref_plat = {"tpu-v5e": jdt.TPU_V5E, "zcu102": jdt.ZCU102}[name]
    plat = convert.platform_from_reference_json(ref_plat.to_json(),
                                                ref_plat.cache_node)
    return (ref_plat, jpools.PoolManager(ref_plat),
            plat, PoolManager(plat, "cpu"))


def _fidelity_specs(mod):
    """The scenarios of tests/test_contention_fidelity.py, in ``mod``."""
    O, S, T = mod.ObserverSpec, mod.StressorSpec, mod.TrafficShape
    b = 64 << 10
    return [
        mod.ScenarioSpec("consistency", O("r", "hbm", (b,)),
                         (S("w", "hbm", b),), iters=3, max_stressors=3),
        mod.ScenarioSpec("acct", (O("r", "hbm", (b,)), O("w", "hbm", (b,))),
                         (S("w", "hbm", b),), iters=3, max_stressors=2),
        mod.ScenarioSpec("coupled", (O("r", "hbm", (b,)),
                                     O("l", "hbm", (b,))),
                         (S("w", "hbm", b),
                          S("b", "hbm", b, T.mixed(1, 1))),
                         iters=10, max_stressors=3),
        mod.ScenarioSpec("uncoupled", (O("r", "hbm", (b,)),
                                       O("l", "hbm", (b,))),
                         (S("w", "hbm", b),), iters=3, max_stressors=2,
                         coupled=False),
        *[mod.ScenarioSpec(n, O("r", "hbm", (b,)), (S("w", "hbm", b),),
                           iters=it, max_stressors=2)
          for n, it in (("a", 3), ("c", 5))],
        *[mod.ScenarioSpec(f"pk{n}", O("r", "hbm", (b,)),
                           (S("w", "hbm", b),), iters=3, max_stressors=1)
          for n in "abcd"],
        mod.ScenarioSpec("shapes", (O("t", "hbm", (b,), T.strided(8)),
                                    O("r", "hbm", (b, 2 * b),
                                      T.mixed(2, 1)),
                                    O("c", "hbm", (b,)),
                                    O("i", "hbm", (0,))),
                         (S("y", "hbm", b), S("x", "hbm", b, T.burst(0.5))),
                         iters=4, max_stressors=3),
    ]


def _triples(specs):
    return [(s, o, b) for s in specs for o in s.observers for b in o.buffers]


def _role(r):
    strategy, shape, rows, iters = r
    return (strategy, None if shape is None else dataclasses.asdict(shape),
            rows, iters)


def _dispatch(d):
    return {
        "entries": [(e.index, e.spec.to_dict(),
                     dataclasses.asdict(e.observer), e.buffer_bytes)
                    for e in d.entries],
        "rungs": [[_role(r) for r in row] for row in d.rungs],
        "geometry": (d.n_scen, d.ladder_width, d.subset_width, d.n_subsets,
                     d.waves, d.kind, d.packed, d.probe, d.group,
                     d.subsets()),
    }


def _plans_equal(want, got):
    assert got.n_engines == want.n_engines
    assert [_dispatch(d) for d in got.dispatches] == \
        [_dispatch(d) for d in want.dispatches]


def _characterize_specs(monkeypatch, tree, **kw):
    """The specs ``characterize`` builds, captured in both packages."""
    ref_plat, jpm, plat, pm = _trees(tree)
    got = {}
    for name, mod, coord in (
            ("ref", jchar, type("C", (), {"platform": ref_plat,
                                          "pools": jpm})()),
            ("port", tchar, type("C", (), {"platform": plat,
                                           "pools": pm})())):
        monkeypatch.setattr(mod, "characterize_matrix",
                            lambda c, specs, n=name, **_k: got.update(
                                {n: specs}))
        mod.characterize(coord, **kw)
    assert [s.to_dict() for s in got["port"]] == \
        [s.to_dict() for s in got["ref"]]
    return got["ref"], got["port"], jpm, pm, ref_plat.n_engines


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_eng", [2, 4, 8])
@pytest.mark.parametrize("grouped", [True, False])
def test_build_plan_and_packing_match_the_reference(n_eng, grouped):
    _rp, jpm, _p, pm = _trees("tpu-v5e")
    jspecs, tspecs = _fidelity_specs(jsc), _fidelity_specs(scenarios)
    want = jplan.build_plan(_triples(jspecs), n_eng, jpm, 8,
                            grouped=grouped)
    got = plan.build_plan(_triples(tspecs), n_eng, pm, 8, grouped=grouped)
    _plans_equal(want, got)
    _plans_equal(jplan.pack_engine_subsets(want),
                 plan.pack_engine_subsets(got))
    for jd, td in zip(jplan.pack_engine_subsets(want).dispatches,
                      plan.pack_engine_subsets(got).dispatches):
        assert _dispatch(plan.unpack_dispatch(td)) == \
            _dispatch(jplan.unpack_dispatch(jd))
        assert [_dispatch(x) for x in plan.split_ladders(td)] == \
            [_dispatch(x) for x in jplan.split_ladders(jd)]
        for k in range(td.n_scen):
            assert [_role(r) for r in plan.rung_row(td, k, n_eng)] == \
                [_role(r) for r in jplan.rung_row(jd, k, n_eng)]


@pytest.mark.parametrize("tree,pools_", [("tpu-v5e", ["hbm"]),
                                         ("zcu102", None)])
def test_characterize_grid_plans_match(monkeypatch, tree, pools_):
    """The characterize grid (r/w/l observers x r/w/y stressors, as the
    card's smoke run drives it) plans to the same dispatches; the ZCU102
    grid covers its on-chip and second DRAM pools too."""
    jspecs, tspecs, jpm, pm, engines = _characterize_specs(
        monkeypatch, tree, pools=pools_, obs_strategies=("r", "w", "l"),
        stress_strategies=("r", "w", "y"), buffer_bytes=1 << 20, iters=2)
    for grouped in (True, False):
        want = jplan.build_plan(_triples(jspecs), engines, jpm, engines,
                                grouped=grouped)
        got = plan.build_plan(_triples(tspecs), engines, pm, engines,
                              grouped=grouped)
        _plans_equal(want, got)
        _plans_equal(jplan.pack_engine_subsets(want),
                     plan.pack_engine_subsets(got))


def test_rung_roles_group_keys_and_operand_kinds_match():
    _rp, jpm, _p, pm = _trees("tpu-v5e")
    for js, ts in zip(_fidelity_specs(jsc), _fidelity_specs(scenarios)):
        for jo, to in zip(js.observers, ts.observers):
            for b in jo.buffers:
                for k in range(4):
                    for width in (4, 8):
                        jr, jp = jplan.rung_roles(js, jo, b, k, width)
                        tr, tp = plan.rung_roles(ts, to, b, k, width)
                        assert [_role(r) for r in tr] == \
                            [_role(r) for r in jr]
                        assert tp == jp
                        assert plan.operand_kind(tp, pm) == \
                            jplan.operand_kind(jp, jpm)
                jk, tk = (jplan.group_key(js, jo, b, jpm),
                          plan.group_key(ts, to, b, pm))
                assert repr(tk[1]) == repr(jk[1])
                assert json.dumps(tk[0], default=repr) == \
                    json.dumps(jk[0], default=repr)
        assert plan.ladder_depth(ts, 8, 6) == jplan.ladder_depth(js, 8, 6)


@pytest.mark.parametrize("n_eng", [4, 8])
def test_probe_batch_matches_the_reference(n_eng):
    _rp, jpm, _p, pm = _trees("tpu-v5e")
    js, ts = _fidelity_specs(jsc), _fidelity_specs(scenarios)
    picks = [(0, 0), (0, 2), (4, 1), (6, 1), (7, 0), (5, 2)]
    jprobes = [(js[i], js[i].observers[0], js[i].observers[0].buffers[0], k)
               for i, k in picks]
    tprobes = [(ts[i], ts[i].observers[0], ts[i].observers[0].buffers[0], k)
               for i, k in picks]
    want = jplan.probe_batch(jprobes, n_eng, jpm, 8)
    got = plan.probe_batch(tprobes, n_eng, pm, 8)
    assert _dispatch(got) == _dispatch(want)
    assert [_dispatch(x) for x in plan.split_probes(got)] == \
        [_dispatch(x) for x in jplan.split_probes(want)]
    assert [_role(r) for r in plan.merge_probe_operand_roles(got.rungs)] \
        == [_role(r) for r in jplan.merge_probe_operand_roles(want.rungs)]
    with pytest.raises(ValueError):
        plan.probe_batch([(ts[0], ts[0].observers[0], BUF, 9)], n_eng, pm, 8)


# ---------------------------------------------------------------------------
# program: operands and roles
# ---------------------------------------------------------------------------

ROLE_CASES = [
    ("r", None), ("s", None), ("w", None), ("y", None), ("x", None),
    ("c", None), ("b", "mixed"), ("l", None), ("m", None),
    ("t", "strided"), ("i", None), ("r", "burst"),
]


def _shape(mod, kind):
    return {None: None, "mixed": mod.TrafficShape.mixed(2, 1),
            "strided": mod.TrafficShape.strided(8),
            "burst": mod.TrafficShape.burst(0.5)}[kind]


def test_build_rung_operands_are_byte_equal():
    roles = [("r", None, 64, 3), ("l", None, 48, 3),
             ("t", "strided", 32, 3), ("m", None, 64, 2), ("i", None, 1, 3)]
    jroles = [(s, _shape(jsc, k), r, i) for s, k, r, i in roles]
    troles = [(s, _shape(scenarios, k), r, i) for s, k, r, i in roles]
    jxf, jxi = jprogram.build_rung_operands(jroles, 5, 64)
    txf, txi = program.build_rung_operands(troles, 5, 64)
    assert txf.numpy().tobytes() == jxf.tobytes()
    assert txi.numpy().tobytes() == jxi.tobytes()


def _exact_stream_role(desc, xf):
    """The read / mixed role's recurrence in float64: acc = acc * 0.5 +
    sum(x[:read rows]) (+ the sum of one written row, 1 + x[0, 0] each,
    for the mixed stream)."""
    code, rows, n, read_rows = (int(v) for v in desc[:4])
    x = np.asarray(xf, np.float64)
    s = x[:rows].sum() if code == kc.READ else \
        x[:read_rows].sum() + 128 * (1.0 + x[0, 0])
    acc = 0.0
    for _ in range(n):
        acc = acc * 0.5 + s
    return acc


@pytest.mark.parametrize("rows", [16, 256, 512])
@pytest.mark.parametrize("letter,kind", ROLE_CASES)
def test_every_role_matches_the_reference_pallas_branch(letter, kind, rows):
    iters = 2
    jr = (letter, _shape(jsc, kind), rows, iters)
    tr = (letter, _shape(scenarios, kind), rows, iters)
    xf, xi = jprogram.build_rung_operands([jr], 1, rows)
    branch = jprogram.spmd_branch_fn(*jr, activity="pallas")
    desc = program.role_descriptor(*tr)
    want = float(branch(xf[0], xi[0]))
    got = float(ref.role_ref(desc, torch.from_numpy(xf[0]),
                             torch.from_numpy(xi[0])))
    strat = letter if kind is None else {"mixed": "b", "strided": "t",
                                         "burst": letter}[kind]
    if strat in ("r", "s", "b"):
        # the engine's operand is an arange reaching 6.6e4: the
        # reference's interpret pass sums its float32 values up to 6e-6
        # off the exact sum (at 256 and 512 rows), the plain version
        # within 2e-6 of it
        exact = _exact_stream_role(desc, xf[0])
        assert got == pytest.approx(exact, rel=2e-6)
        assert want == pytest.approx(exact, rel=1e-5)
        # on operands of unit size the two agree to 2e-6
        u = np.random.default_rng(rows).uniform(
            0.5, 1.5, (rows, 128)).astype(np.float32)
        assert float(ref.role_ref(desc, torch.from_numpy(u),
                                  torch.from_numpy(xi[0]))) == \
            pytest.approx(float(branch(u, xi[0])), rel=2e-6)
    elif strat == "i":
        assert got == pytest.approx(want, rel=1e-6)
    else:                       # chases, writes, copies, rmw: exact
        assert got == want


def test_role_descriptors_pick_the_kernels_of_the_reference():
    d = program.role_descriptor
    assert d("l", None, 64, 3)[0] == kc.CHASE_SHARED    # fits one SM
    assert d("l", None, 1024, 3)[0] == kc.CHASE_GLOBAL
    assert d("m", None, 64, 3)[0] == kc.CHASE_GLOBAL
    assert d("w", None, 64, 3)[0] == kc.RMW             # the spmd split
    assert d("i", scenarios.TrafficShape.mixed(1, 1), 1, 3)[0] == kc.IDLE
    # duty cycles scale the passes; the mixed split is the block rule
    assert d("r", scenarios.TrafficShape.burst(0.5), 64, 4)[2] == 2
    code, rows, n, rd, wr = d("r", scenarios.TrafficShape.mixed(2, 1),
                              64, 3)[:5]
    assert (code, rows, n, rd + wr) == (kc.MIXED, 64, 3, 64)
    assert ref.mixed_split(64, 2 / 3, 64)[1] * 8 == rd


def test_ladder_plain_version_runs_the_table_and_keeps_the_fence():
    """The plain ladder: every engine's value per step equals its role's
    plain version, and its host stamps satisfy the fence; with the start
    wait skipped they do not."""
    rows = [tuple(("r", None, 32, 2) if e == 0 else ("w", None, 64, 1)
                  for e in range(4)),
            tuple(("l", None, 16, 2) if e < 2 else ("i", None, 1, 2)
                  for e in range(4))]
    st = DispatchStats()
    prog = program.build_program(
        rows, 4, kind=None, samples=2, subsets=((0, 1), (2, 3)),
        op_roles=[("l", None, 16, 2)] * 2 + [("w", None, 64, 1)] * 2,
        rows_max=64, device="cpu", ctas_per_engine=1, stats=st)
    assert st.programs_built == 1 and prog.table.shape == (4, 4)
    assert prog.layout.groups == ((0, 1), (2, 3))
    out = prog.launch()
    for s in range(4):
        for e in range(4):
            want = ref.role_ref(prog.roles[prog.table[s, e]], prog.xf[e],
                                prog.xi[e])
            assert float(out.outs[e, s]) == float(want)
    assert prog.is_fenced(out)
    assert fence.measured_region_is_fenced(out, prog.layout,
                                           ((0, 1), (2, 3)))
    assert not prog.is_fenced(prog.launch(skip_start_wait=True))


# ---------------------------------------------------------------------------
# fence
# ---------------------------------------------------------------------------


def _out(arrive, begin, end, t1, leaders=(0,)):
    arrive, begin, end = (torch.tensor(a, dtype=torch.int64)
                          for a in (arrive, begin, end))
    n, steps = arrive.shape
    t1s = torch.zeros((n, steps, 2), dtype=torch.int32)
    for e in leaders:
        t1s[e, :, 1] = torch.tensor(t1, dtype=torch.int32)
    return kc.LadderOut(torch.zeros(n, steps), torch.zeros_like(t1s), t1s,
                        arrive, begin, end)


def test_fence_accepts_a_fenced_launch_and_refuses_the_rest():
    lay = program._subset_layout(3, None)
    ok = _out([[1, 10], [2, 11], [3, 12]], [[4, 13], [5, 14], [3, 12]],
              [[6, 15], [8, 16], [7, 17]], [8, 17])
    assert fence.stamps_fenced(ok, lay)
    # engine 2 arrives at step 1 after engine 0 began it
    early = _out([[1, 10], [2, 11], [3, 14]], [[4, 13], [5, 14], [3, 15]],
                 [[6, 15], [8, 16], [7, 17]], [8, 17])
    assert not fence.stamps_fenced(early, lay)
    # the leader's stop stamp before an engine ended
    late = _out([[1, 10], [2, 11], [3, 12]], [[4, 13], [5, 14], [3, 12]],
                [[6, 15], [9, 16], [7, 17]], [8, 17])
    assert not fence.stamps_fenced(late, lay)


def test_fence_checks_each_packed_subset_with_its_own_stamps():
    lay = program._subset_layout(4, ((0, 1), (2, 3)))
    assert list(lay.group_of) == [0, 0, 1, 1]
    assert list(lay.leaders) == [1, 0, 1, 0]
    # subset (2, 3) starts after subset (0, 1) ended: independent barriers
    out = _out([[1], [2], [20], [21]], [[3], [3], [22], [22]],
               [[5], [6], [25], [26]], [7], leaders=())
    out.t1s[0, 0, 1], out.t1s[2, 0, 1] = 7, 27
    assert fence.stamps_fenced(out, lay)
    out.t1s[2, 0, 1] = 24                  # subset 1's stop before its end
    assert not fence.stamps_fenced(out, lay)
    assert fence.groups_isolate(lay.groups, ((0, 1), (2, 3)))
    assert not fence.groups_isolate(lay.groups, ((0, 2), (1, 3)))
    assert not fence.groups_isolate(lay.groups, ((0, 1, 2, 3),))
    # one barrier over every engine is no fence for a packed launch...
    glob = program._subset_layout(4, None)
    assert not fence.groups_isolate(glob.groups, ((0, 1), (2, 3)))
    assert fence.groups_isolate(glob.groups, None)
    # ...and leftover engines may barrier among themselves
    lay6 = program._subset_layout(6, ((0, 1), (2, 3)))
    assert lay6.groups == ((0, 1), (2, 3), (4, 5))
    assert fence.groups_isolate(lay6.groups, ((0, 1), (2, 3)))


def test_program_cache_eviction_drops_operands():
    st = DispatchStats()
    mk = lambda: program.build_program(  # noqa: E731
        [(("r", None, 8, 1), ("i", None, 1, 1))], 2, kind=None, samples=1,
        subsets=None, op_roles=[("r", None, 8, 1), ("i", None, 1, 1)],
        rows_max=8, device="cpu", ctas_per_engine=1, stats=st)
    cache = ProgramCache(1)
    e1, e2 = mk(), mk()
    cache.put(("k1",), e1)
    cache.put(("k2",), e2)
    assert list(cache.entries) == [("k2",)]
    assert e1.xf is None and e1.xi is None and e1.dst is None
    assert e2.xf is not None and e2.xi is not None
    assert cache.get(("k2",), st) is e2 and st.program_cache_hits == 1


def test_program_cache_bounds_operand_bytes_before_a_build():
    """Entries go, oldest first and only from the same memory, until the
    new program fits; one that cannot fit alone raises before anything
    is built."""
    st = DispatchStats()
    mk = lambda: program.build_program(  # noqa: E731
        [(("r", None, 8, 1), ("i", None, 1, 1))], 2, kind=None, samples=1,
        subsets=None, op_roles=[("r", None, 8, 1), ("i", None, 1, 1)],
        rows_max=8, device="cpu", ctas_per_engine=1, stats=st)
    one = program.operand_bytes(2, 8)
    assert mk().nbytes == one and mk().place == "cpu"
    seen = []

    def capacity(place, held):
        seen.append((place, held))
        return 2 * one if place == "cpu" else None

    cache = ProgramCache(8, capacity)
    for k in ("a", "b"):
        cache.reserve("cpu", one)
        cache.put((k,), mk())
    other = mk()
    other.place = "pinned_host"
    cache.put(("p",), other)
    cache.reserve("cpu", one)           # a and b hold the room: a goes
    assert list(cache.entries) == [("b",), ("p",)]
    assert seen[-1] == ("cpu", 2 * one)
    cache.reserve("pinned_host", 100 * one)     # no bound there
    with pytest.raises(dispatch.ProgramMemoryError):
        cache.reserve("cpu", 3 * one)
    assert list(cache.entries) == [("p",)]
    assert dispatch.operand_capacity(torch.device("cpu"), "cpu", 0) is None


def test_dispatcher_reserves_before_it_builds():
    p = _plan(names=("solo",))
    d = dispatch.Dispatcher(4, 1, device="cpu", ctas_per_engine=1)
    need = program.operand_bytes(
        8, program.ladder_operand_rows(p.dispatches[0], 8))
    d.cache.capacity = lambda place, held: need - 1
    st = DispatchStats()
    with pytest.raises(dispatch.ProgramMemoryError):
        d.run_planned(p.dispatches[0], 8, "plain", "batched", st)
    assert st.programs_built == 0
    d.cache.capacity = lambda place, held: need
    d.run_planned(p.dispatches[0], 8, "plain", "batched", st)
    assert st.programs_built == 1
    (entry,) = d.cache.entries.values()
    assert entry.nbytes == need


# ---------------------------------------------------------------------------
# resilience + journal
# ---------------------------------------------------------------------------


def test_fault_schedules_are_byte_identical():
    for text in ("mixed=0.5,seed=11", "timeout=0.3,corrupt=0.2,seed=3",
                 "compile=1"):
        assert dataclasses.asdict(res.FaultSpec.parse(text)) == \
            dataclasses.asdict(jres.FaultSpec.parse(text))
        a = res.FaultSpec.parse(text).injector()
        b = jres.FaultSpec.parse(text).injector()
        visits = [(f"site{i % 7}", ph) for i in range(200)
                  for ph in ("compile", "dispatch", "decode")]
        assert json.dumps([a.check(s, p) for s, p in visits]) == \
            json.dumps([b.check(s, p) for s, p in visits])


class FakeDispatcher:
    """The reference's scripted Dispatcher stand-in, for the port (see
    tests/test_resilience.py): one behaviour per run_planned/run_rung
    call — "ok", "corrupt", ("noisy", spread), a fault kind (raised as
    an InjectedFault of ``mod``), or an exception instance."""

    def __init__(self, behaviors=(), default="ok", samples=3, mod=res):
        self.behaviors = list(behaviors)
        self.default = default
        self.samples = samples
        self.mod = mod
        self.planned_calls = []
        self.rung_calls = []

    def _next(self):
        b = self.behaviors.pop(0) if self.behaviors else self.default
        if isinstance(b, BaseException):
            raise b
        if isinstance(b, str) and b in self.mod.FAULT_KINDS:
            raise self.mod.InjectedFault(b, "fake-site")
        return b

    def run_planned(self, planned, n_eng, activity, mode, stats):
        self.planned_calls.append(planned)
        b = self._next()
        g, k = planned.group, planned.n_scen
        stats.host_sync_dispatches += 1
        stats.measure_dispatches += 1
        stats.spmd_rungs += g * k
        if planned.packed:
            stats.packed_ladders += g
        if b == "corrupt":
            return (np.full((g, k), -1.0), np.zeros((g, k)), True, False)
        spread = b[1] if isinstance(b, tuple) else 10.0
        return (np.full((g, k), 1000.0), np.full((g, k), float(spread)),
                True, False)

    def run_rung(self, roles, n_eng, activity, kind, stats):
        self.rung_calls.append(roles)
        b = self._next()
        stats.host_sync_dispatches += 1 + self.samples
        if b == "corrupt":
            return (-5.0, True, 3, False)
        return (2000.0, True, 3, False)


def _spec(name, buf=BUF, mod=scenarios):
    return mod.ScenarioSpec(name, mod.ObserverSpec("r", "hbm", (buf,)),
                            (mod.StressorSpec("w", "hbm", buf),), iters=3,
                            max_stressors=1)


def _plan(names=("a", "b", "c", "d"), packed=False, bufs=None):
    pm = PoolManager(H100_SXM, "cpu")
    bufs = bufs or [BUF] * len(names)
    specs = [_spec(n, b) for n, b in zip(names, bufs)]
    p = plan.build_plan([(s, s.observer, b) for s, b in zip(specs, bufs)],
                        8, pm, 8)
    return plan.pack_engine_subsets(p) if packed else p


def _run(disp, p, policy=None, gate=None, stats=None, activity="plain"):
    stats = stats or DispatchStats()
    outs = []
    for planned in p.dispatches:
        outs.extend(res.run_group(
            disp, planned, n_eng=p.n_engines, activity=activity,
            mode="batched", stats=stats,
            policy=policy or res.RetryPolicy(backoff_s=0, sleep=NOOP),
            gate=gate))
    return outs, stats


def test_zero_fault_path_exact_accounting():
    outs, st = _run(FakeDispatcher(), _plan(packed=True))
    assert len(outs) == 4
    for o in outs:
        assert o.med == [1000.0, 1000.0]
        t = o.timing
        assert t["timing_source"] == "device" and t["dispatches"] == 1
        assert t["attempts"] == 1 and t["degraded_from"] is None
    assert st.resilience_clean() and st.host_sync_dispatches == 1


def test_retry_and_corrupt_timing_recover_without_degradation():
    for first, kind in (("timeout", "timeout"),
                        ("corrupt", "corrupt_timing")):
        outs, st = _run(FakeDispatcher([first, "ok"]), _plan(packed=True))
        assert st.retried_dispatches == 1 and st.degraded_ladders == 0
        for o in outs:
            assert o.timing["attempts"] == 2
            assert o.timing["fault_kind"] == kind
            assert o.med == [1000.0, 1000.0]


def test_degradation_ladder_packed_batched_ladder_rung():
    pol = res.RetryPolicy(retries=0, backoff_s=0, sleep=NOOP)
    disp = FakeDispatcher(["runtime_error", "ok"])
    outs, st = _run(disp, _plan(packed=True), policy=pol)
    assert [d.packed for d in disp.planned_calls] == [True, False]
    assert all(o.timing["degraded_from"] == "packed" for o in outs)
    disp = FakeDispatcher(["runtime_error", "ok", "ok", "runtime_error",
                           "ok", "ok", "ok"])
    outs, st = _run(disp, _plan(), policy=pol)
    by = {o.entry.spec.name: o for o in outs}
    assert by["c"].timing["timing_source"] == "host"
    assert by["c"].timing["attempts"] == 4
    assert by["c"].med == [2000.0, 2000.0]
    assert all(by[n].timing["degraded_from"] == "batched" for n in "abcd")
    assert st.degraded_ladders == 4 and st.modeled_floor_ladders == 0


def test_full_ladder_to_modeled_floor_and_partial_rung_loss():
    outs, st = _run(FakeDispatcher(default="timeout"), _plan(packed=True))
    assert all(o.med == [None, None] and o.fenced is False for o in outs)
    assert st.modeled_floor_ladders == 4 and not st.resilience_clean()
    disp = FakeDispatcher(["runtime_error", "runtime_error", "ok",
                           "timeout", "timeout"])
    (o,), st = _run(disp, _plan(names=("solo",)))
    assert o.med == [2000.0, None]
    assert o.timing["degraded_from"] == "ladder"
    assert st.modeled_floor_ladders == 0 and st.degraded_ladders == 1


def test_degrade_off_floor_off_and_backoff():
    pol = res.RetryPolicy(retries=0, degrade=False, backoff_s=0, sleep=NOOP)
    disp = FakeDispatcher(default="timeout")
    outs, st = _run(disp, _plan(packed=True), policy=pol)
    assert len(disp.planned_calls) == 1 and st.modeled_floor_ladders == 4
    with pytest.raises(res.GroupExecutionError):
        _run(FakeDispatcher(default="timeout"), _plan(packed=True),
             policy=res.RetryPolicy(retries=0, degrade=False,
                                    modeled_floor=False, backoff_s=0,
                                    sleep=NOOP))
    slept = []
    _run(FakeDispatcher(["timeout"] * 4 + ["ok"]), _plan(names=("solo",)),
         policy=res.RetryPolicy(retries=4, backoff_s=0.05,
                                backoff_cap_s=0.15, sleep=slept.append))
    assert slept == [0.05, 0.1, 0.15, 0.15]


def test_non_retryable_error_names_its_group():
    disp = FakeDispatcher([ValueError("bad roles table")])
    with pytest.raises(res.GroupExecutionError) as ei:
        _run(disp, _plan(packed=True))
    assert all(f"'{n}'" in str(ei.value) for n in "abcd")
    assert isinstance(ei.value.cause, ValueError)
    assert len(disp.planned_calls) == 1


_CARD_FAILURES = (
    _build.KernelLaunchError("contention_ladder: CUDA error 720"),
    _build.KernelBuildError("nvcc failed on contention.cu"),
    torch.OutOfMemoryError("CUDA out of memory"),
    RuntimeError("CUDA error: unspecified launch failure"))


@pytest.mark.parametrize("err", _CARD_FAILURES,
                         ids=lambda e: type(e).__name__)
def test_card_failures_raise_instead_of_degrading(err):
    """On the card a failure of the card's own is raised at once: no
    retry, no degradation, no modeled floor.  The same error from the
    plain path on the CPU still walks the ladder."""
    disp = FakeDispatcher(default=err)
    with pytest.raises(res.GroupExecutionError) as ei:
        _run(disp, _plan(packed=True), activity="cuda")
    assert ei.value.cause is err and len(disp.planned_calls) == 1
    assert not disp.rung_calls
    pol = res.RetryPolicy(retries=0, backoff_s=0, sleep=NOOP)
    triples = [(s, s.observer, BUF) for s in (_spec("solo"),)]
    with pytest.raises(res.GroupExecutionError):
        exec_journal.execute_rung_path(
            FakeDispatcher(default=err), triples, n_eng=8,
            activity="cuda", stats=DispatchStats(), depth_fn=lambda s: 2,
            pools=PoolManager(H100_SXM, "cpu"), policy=pol)
    outs, st = _run(FakeDispatcher(default=err), _plan(packed=True),
                    activity="plain")
    assert st.modeled_floor_ladders == 4


def test_injected_faults_still_degrade_on_the_card():
    assert res.is_fatal(ValueError("x"), "plain")
    assert not res.is_fatal(res.InjectedFault("timeout", "s"), "cuda")
    pol = res.RetryPolicy(retries=0, backoff_s=0, sleep=NOOP)
    disp = FakeDispatcher(["runtime_error", "ok"])
    outs, st = _run(disp, _plan(packed=True), policy=pol, activity="cuda")
    assert [d.packed for d in disp.planned_calls] == [True, False]
    assert all(o.timing["degraded_from"] == "packed" for o in outs)
    outs, st = _run(FakeDispatcher(["corrupt", "ok"]), _plan(packed=True),
                    activity="cuda")
    assert st.retried_dispatches == 1 and st.degraded_ladders == 0


def test_quality_gate_remeasures_flags_and_can_be_off():
    gate = res.QualityGate(rel_spread=2.0, remeasure=2, min_spread_ns=1.0)
    outs, st = _run(FakeDispatcher([("noisy", 5000.0), "ok"]),
                    _plan(packed=True), gate=gate)
    assert st.noisy_remeasures == 1 and st.measure_dispatches == 1
    assert st.host_sync_dispatches == 2
    assert all(o.timing["remeasures"] == 1 for o in outs)
    outs, st = _run(FakeDispatcher(default=("noisy", 5000.0)),
                    _plan(packed=True), gate=gate)
    assert st.noisy_remeasures == 2 and st.noisy_rungs == 8
    assert all(o.timing["noisy_rungs"] == [0, 1] for o in outs)
    outs, st = _run(FakeDispatcher(default=("noisy", 1e9)),
                    _plan(packed=True), gate=None)
    assert st.noisy_remeasures == 0


def _exec(mod_journal, p, disp, jpath, stats):
    return mod_journal.execute_plan(
        disp, p, n_eng=p.n_engines, activity="plain", mode="batched",
        stats=stats, policy=(res if mod_journal is exec_journal
                             else jres).RetryPolicy(backoff_s=0,
                                                    sleep=NOOP),
        gate=None, journal=jpath)


def _jplan(names=("a", "b")):
    pm = jpools.PoolManager(jdt.TPU_V5E)
    specs = [_spec(n, mod=jsc) for n in names]
    return jplan.build_plan([(s, s.observer, BUF) for s in specs], 8, pm, 8)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_journal_written_by_either_package_restores_in_the_other(
        tmp_path, writer):
    jpath = str(tmp_path / "sweep.journal")
    port = (exec_journal, _plan(names=("a", "b")),
            FakeDispatcher(), DispatchStats)
    refp = (jjournal, _jplan(), FakeDispatcher(mod=jres), JStats)
    first, second = (port, refp) if writer == "port" else (refp, port)
    mod, p, disp, stats_cls = first
    maps1 = _exec(mod, p, disp, jpath, stats_cls())
    mod, p, _d, stats_cls = second
    idle = FakeDispatcher(default=RuntimeError("must not dispatch"),
                          mod=res if mod is exec_journal else jres)
    st = stats_cls()
    maps2 = _exec(mod, p, idle, jpath, st)
    assert idle.planned_calls == [] and st.resumed_ladders == 2
    assert maps2[1] == maps1[1] and maps2[2] == maps1[2]
    for k, v in maps1[0].items():
        w = maps2[0][k]
        assert (w.strategy, w.pool, w.buffer_bytes, w.iters, w.bytes_moved,
                w.elapsed_ns, w.transactions) == \
            (v.strategy, v.pool, v.buffer_bytes, v.iters, v.bytes_moved,
             v.elapsed_ns, v.transactions)


def test_journal_resume_foreign_torn_and_killed(tmp_path):
    jpath = str(tmp_path / "sweep.journal")
    p = _plan(names=("a", "b", "c"), bufs=[BUF, 2 * BUF, 4 * BUF])
    assert len(p.dispatches) == 3
    disp = FakeDispatcher(["ok", KeyboardInterrupt()])
    with pytest.raises(KeyboardInterrupt):
        _exec(exec_journal, p, disp, jpath, DispatchStats())
    st = DispatchStats()
    disp2 = FakeDispatcher()
    maps2 = _exec(exec_journal, p, disp2, jpath, st)
    assert st.resumed_ladders == 1 and len(disp2.planned_calls) == 2
    assert {i for i, _k in maps2[0]} == {0, 1, 2}
    with open(jpath, "a") as f:
        f.write('{"entries": [{"key": "torn')
    st = DispatchStats()
    _exec(exec_journal, p, FakeDispatcher(default=RuntimeError("no")),
          jpath, st)
    assert st.resumed_ladders == 3
    with pytest.raises(ValueError, match="different sweep"):
        _exec(exec_journal, _plan(names=("a", "zzz")), FakeDispatcher(),
              jpath, DispatchStats())

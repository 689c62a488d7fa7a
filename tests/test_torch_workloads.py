"""Port vs reference: the workload library, letter by letter (CPU).

The reference runs its Pallas kernels in interpret mode (its ``ops``
choose that off-TPU); the port, given ``device="cpu"``, runs the plain
versions.  Everything a WorkloadResult holds except ``elapsed_ns`` must be
equal.  The two packages put the on-chip residency threshold at different
sizes by design, so both are moved to 32 KiB here and every letter runs
at a size on each side of it.
"""
import dataclasses

import pytest

from repro.core import devicetree as jdt
from repro.core import pools as jpools
from repro.core import scenarios as jsc
from repro.core import workloads as jwl
from repro_torch.core import convert, pools, scenarios, workloads
from repro_torch.core.pools import PoolError
from repro_torch.kernels import counts

THRESHOLD = 32 << 10
SIZES = (16 << 10, 64 << 10)
LETTERS = ("r", "w", "s", "x", "y", "c", "b", "t", "l", "m")


@pytest.fixture
def pool_pair(monkeypatch):
    monkeypatch.setattr(jwl, "_EXEC_VMEM_CAP", THRESHOLD)
    monkeypatch.setattr(workloads, "SMEM_RESIDENT_BYTES", THRESHOLD)
    plat = convert.platform_from_reference_json(jdt.TPU_V5E.to_json())
    return (jpools.PoolManager(jdt.TPU_V5E),
            pools.PoolManager(plat, device="cpu"))


def _fields(res):
    d = dataclasses.asdict(res)
    d.pop("elapsed_ns")
    # the port's own mark; never set where the plain versions run
    assert not d.pop("launch_bound", False)
    return d


# which plain version the port must have gone through, by letter, below
# and above the residency threshold
EXPECT = {
    "r": ("read_vmem", "read_hbm"), "w": ("write_vmem", "write_hbm"),
    "s": ("read_hbm",) * 2, "x": ("rmw_hbm",) * 2, "y": ("write_hbm",) * 2,
    "c": ("copy_hbm",) * 2, "b": ("read_hbm",) * 2,
    "t": ("chase_hbm",) * 2, "l": ("chase_vmem", "chase_hbm"),
    "m": ("chase_hbm",) * 2,
}


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("letter", LETTERS)
def test_workload_result_equals_reference(pool_pair, letter, size):
    jm, tm = pool_pair
    jw = jwl.make_workload(letter, jm.pool("hbm"), size)
    tw = workloads.make_workload(letter, tm.pool("hbm"), size)
    assert tw.description == jw.description
    assert tm.pool("hbm").allocated == jm.pool("hbm").allocated > 0
    counts.reset()
    try:
        want, got = jw.run(2), tw.run(2)
    finally:
        jw.release()
        tw.release()
    assert _fields(got) == _fields(want)
    assert got.elapsed_ns > 0 and want.elapsed_ns > 0
    assert tm.pool("hbm").allocated == jm.pool("hbm").allocated == 0
    launches, plain = counts.snapshot()
    assert not any(launches.values())
    assert plain[EXPECT[letter][SIZES.index(size)]] > 0
    if letter == "b":
        assert plain["write_hbm_seeded"] > 0


@pytest.mark.parametrize("letter,size", [("r", 1 << 20), ("w", 1 << 20),
                                         ("l", 64 << 10)])
def test_vmem_kind_pool_forces_residency(letter, size):
    """With the packages' own thresholds: a 1 MiB stream in an on-chip
    pool is past both, and still takes the on-chip kernel (tiled over
    CTAs on the card)."""
    plat = convert.platform_from_reference_json(jdt.TPU_V5E.to_json())
    jm = jpools.PoolManager(jdt.TPU_V5E)
    tm = pools.PoolManager(plat, device="cpu")
    jw = jwl.make_workload(letter, jm.pool("vmem"), size)
    tw = workloads.make_workload(letter, tm.pool("vmem"), size)
    assert tw.alloc.array is None                    # a residency grant
    counts.reset()
    try:
        want, got = jw.run(2), tw.run(2)
    finally:
        jw.release()
        tw.release()
    assert _fields(got) == _fields(want)
    assert counts.PLAIN[EXPECT[letter][0]] > 0


def test_chase_too_large_for_one_sm_is_refused_in_a_vmem_pool():
    plat = convert.platform_from_reference_json(jdt.TPU_V5E.to_json())
    pool = pools.PoolManager(plat, device="cpu").pool("vmem")
    with pytest.raises(PoolError, match="shared memory of one SM"):
        workloads.make_workload("l", pool, 1 << 20)
    assert pool.allocated == 0


@pytest.mark.parametrize("kind,args,letter", [
    ("mixed", (2, 1), "b"), ("mixed", (1, 2), "b"),
    ("strided", (8,), "t"), ("burst", (0.25,), "r")])
def test_shaped_workloads_equal_reference(pool_pair, kind, args, letter):
    jm, tm = pool_pair
    jshape = getattr(jsc.TrafficShape, kind)(*args)
    tshape = getattr(scenarios.TrafficShape, kind)(*args)
    assert workloads.resolve_strategy("r", tshape) == \
        jwl.resolve_strategy("r", jshape) == letter
    jw = jwl.make_shaped_workload("r", jm.pool("hbm"), 64 << 10, jshape)
    tw = workloads.make_shaped_workload("r", tm.pool("hbm"), 64 << 10,
                                        tshape)
    assert tw.description == jw.description
    try:
        want, got = jw.run(2), tw.run(2)
    finally:
        jw.release()
        tw.release()
    assert _fields(got) == _fields(want)


def test_duty_cycle_scales_elapsed_as_the_reference_does(pool_pair):
    _, tm = pool_pair
    base = workloads.WorkloadResult("r", "hbm", 1024, 2, 2048, 1000.0, 0)
    jbase = jwl.WorkloadResult("r", "hbm", 1024, 2, 2048, 1000.0, 0)
    for duty in (0.25, 0.5, 1.0):
        tw = workloads.Workload("r", tm.pool("hbm"), 1024, "d",
                                lambda iters: base)
        jw = jwl.Workload("r", None, 1024, "d", lambda iters: jbase)
        got = workloads._duty_cycled(tw, duty).run(2)
        want = jwl._duty_cycled(jw, duty).run(2)
        assert got.elapsed_ns == want.elapsed_ns == 1000.0 / duty
        assert got.bandwidth_gbps == want.bandwidth_gbps
        assert tw.description == jw.description


@pytest.mark.parametrize("nbytes", [0, 1, 511, 512, 513, 4096, 100_000,
                                    262_143, 262_144, 262_145, 300_000,
                                    1 << 20, (1 << 20) + 777, 5 << 20,
                                    (1 << 30) + 12345])
def test_rows_truncates_as_the_reference_does(nbytes):
    assert workloads._rows(nbytes) == jwl._rows(nbytes)
    assert workloads.rows_for(nbytes) == jwl.rows_for(nbytes)


def test_registry_and_derived_properties_equal():
    assert sorted(workloads._REGISTRY) == sorted(jwl._REGISTRY)
    got, want = workloads.strategies(), jwl.strategies()
    assert set(got) == set(want)
    for k in set(want) - {"i"}:      # "i" names the TPU's matrix unit there
        assert got[k] == want[k]
    assert workloads.LINE_BYTES == jwl.LINE_BYTES
    a = workloads.WorkloadResult("m", "hbm", 1, 1, 4096, 200.0, 8)
    b = jwl.WorkloadResult("m", "hbm", 1, 1, 4096, 200.0, 8)
    assert (a.bandwidth_gbps, a.latency_ns) == (b.bandwidth_gbps,
                                                b.latency_ns)
    z = workloads.WorkloadResult("m", "hbm", 1, 1, 0, 0.0, 0)
    assert z.bandwidth_gbps == 0.0 and z.latency_ns == 0.0
    with pytest.raises(KeyError):
        workloads.make_workload("q", None, 1)


def test_residency_thresholds_are_the_cards():
    assert workloads.SMEM_RESIDENT_BYTES == 232_448
    assert workloads.CACHE_RESIDENT_BYTES == 50 << 20
    assert workloads._fits_vmem(128 << 10)
    assert not workloads._fits_vmem(256 << 10)
    assert workloads.models_as_vmem(16 << 20)
    assert not workloads.models_as_vmem(64 << 20)


def test_letter_i_as_main_waits_for_its_kernel(pool_pair):
    """Letter ``i`` as a main activity runs the compute probe: the same
    result as the reference's (no bytes, no transactions), through the
    probe's plain version on the CPU."""
    jm, tm = pool_pair
    jw = jwl.make_workload("i", jm.pool("hbm"), 0)
    wl = workloads.make_workload("i", tm.pool("hbm"), 0)
    assert wl.alloc is None and not wl.is_memory_bound
    assert wl.description == jw.description
    counts.reset()
    want, got = jw.run(2), wl.run(2)
    assert _fields(got) == _fields(want)
    assert got.elapsed_ns > 0 and got.bytes_moved == got.transactions == 0
    launches, plain = counts.snapshot()
    assert plain["mxu_probe"] == 1 + 3 * 2 and not any(launches.values())


def test_launch_bound_mark_shows_in_the_result_text(pool_pair):
    """On the card an on-chip kernel's time is the launch's; the result is
    marked and the interface says so.  Never on the CPU."""
    from repro_torch.core import interface
    from repro_torch.core.coordinator import (ActivitySpec, CoreCoordinator,
                                              ExperimentConfig)
    _, tm = pool_pair
    coord = CoreCoordinator(tm, tm.platform, backend="cuda", device="cpu")
    res = coord.run(ExperimentConfig(
        main=ActivitySpec("r", "hbm", 16 << 10),
        stress=ActivitySpec("w", "hbm", 16 << 10), iters=2, scenarios=2))
    assert not res.scenarios[0].main.launch_bound
    plain = interface.format_results(res)
    assert "# note" not in plain
    res.scenarios[0].main.launch_bound = True
    marked = interface.format_results(res)
    assert marked.startswith(plain + "\n# note:")
    assert "launch" in marked.splitlines()[-1]


@pytest.mark.parametrize("fixed,per_unit,want,marked", [
    (5_000.0, 100.0, 100.0, False),     # the slope: the memory's time
    (5_000.0, 0.0, 5_000.0 / 256, True),  # flat: launch-bound, as timed
    (5_000.0, -1.0, None, True),         # falling: launch-bound
    (200_000.0, 50.0, None, True),       # longer run < 2x the shorter
])
def test_on_chip_slope_rule(monkeypatch, fixed, per_unit, want, marked):
    """The on-chip rows on the card are timed by the slope between two
    work counts; the result is marked launch-bound only where the slope
    is not positive or the longer run did not take twice the shorter."""
    calls = []

    def fake_timed(fn, *args, iters, on, **kw):
        calls.append(kw["repeats"])
        return fixed + per_unit * kw["repeats"]
    monkeypatch.setattr(workloads, "_timed", fake_timed)
    lo, hi = workloads.WALK_COUNTS
    t, lb = workloads._slope_timed(None, work="repeats", counts=(lo, hi),
                                   iters=3, on=None)
    assert calls == [lo, hi] and lb == marked
    if want is not None:
        assert t == pytest.approx(want)
    if marked:
        assert t == pytest.approx((fixed + per_unit * lo) / lo)

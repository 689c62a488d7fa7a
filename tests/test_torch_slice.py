"""Port vs reference: the slice as a whole (CPU).

The same config strings go through both debugfs-style interfaces —
the reference with ``--backend interpret`` (its Pallas kernels in
interpret mode), the port with ``--backend cuda --device cpu`` (the plain
versions) — on the same device tree, converted through its JSON.  What a
user reads back must be the same text: the parsed experiment, every
command reply incl. the errors, and every modeled column of the results.
"""
import pytest

from repro.core import coordinator as jco
from repro.core import devicetree as jdt
from repro.core import interface as jif
from repro.core import pools as jpools
from repro_torch.core import convert, coordinator, interface, pools

TREES = {"tpu-v5e": jdt.TPU_V5E, "zcu102": jdt.ZCU102}


def _pair(tree="tpu-v5e", jbackend="interpret", tbackend="cuda"):
    ref_plat = TREES[tree]
    plat = convert.platform_from_reference_json(ref_plat.to_json(),
                                                ref_plat.cache_node)
    return (jif.MemscopeInterface(jco.CoreCoordinator(
                jpools.PoolManager(ref_plat), ref_plat, backend=jbackend)),
            interface.MemscopeInterface(coordinator.CoreCoordinator(
                pools.PoolManager(plat, "cpu"), plat, backend=tbackend,
                device="cpu")))


CONFIGS = [
    ("tpu-v5e", "r,hbm,64K w,hbm,64K iters=2"),
    ("tpu-v5e", "l,hbm,16K w,host,64K iters=2 scenarios=4"),
    ("tpu-v5e", "c,hbm,64K y,host,32K iters=1 scenarios=8"),
    ("tpu-v5e", "m,host,16K i,hbm,0 iters=2 scenarios=3"),
    ("tpu-v5e", "w,vmem,32K r,hbm,1M iters=2"),
    ("tpu-v5e", "b,hbm,64K x,hbm,64K iters=2 scenarios=2"),
    ("zcu102", "r,dram,64K w,dram,64K iters=2"),
    ("zcu102", "l,dram,32K y,pl-dram,64K iters=2 scenarios=4"),
    ("zcu102", "s,pl-dram,64K c,dram,1M iters=2"),
    ("zcu102", "x,dram,64K r,ocm,64K iters=1 scenarios=2"),
]


@pytest.mark.parametrize("tree,line", CONFIGS)
def test_same_text_through_both_interfaces(tree, line):
    ji, ti = _pair(tree)
    assert ti.read_experiment() == ji.read_experiment()
    assert ti.read_results() == ji.read_results() == "(no results)"
    assert ti.write_cmd("start") == ji.write_cmd("start")     # ERR: none yet
    ji.write_experiment(line)
    ti.write_experiment(line)
    assert ti.read_experiment() == ji.read_experiment()
    assert ti.read_pools() == ji.read_pools()
    assert ti.write_cmd("validate") == ji.write_cmd("validate") == "OK valid"
    assert ti.write_cmd("start") == ji.write_cmd("start") == "OK complete"
    assert ti.read_results() == ji.read_results()
    assert ti.read_pools() == ji.read_pools()                 # all released
    jm = ji._results.scenarios[0].main
    tm = ti.results.scenarios[0].main
    assert (tm.strategy, tm.pool, tm.buffer_bytes, tm.iters, tm.bytes_moved,
            tm.transactions) == (jm.strategy, jm.pool, jm.buffer_bytes,
                                 jm.iters, jm.bytes_moved, jm.transactions)
    assert tm.elapsed_ns > 0
    assert ti.write_cmd("erase") == ji.write_cmd("erase") == "OK erased"
    assert ti.read_results() == ji.read_results()


@pytest.mark.parametrize("line", [
    "q,hbm,64K w,hbm,64K",                   # unknown strategy
    "r,nope,64K w,hbm,64K",                  # pool absent
    "r,hbm,64K w,hbm,64K iters=0",           # iters not positive
    "r,hbm,64K w,hbm,64K scenarios=99",      # too many scenarios
    "r,vmem,1G w,hbm,64K",                   # exceeds the pool
    "r,hbm,64K w,hbm,999G",                  # stress exceeds the pool
])
def test_validate_errors_read_the_same(line):
    ji, ti = _pair(jbackend="simulate", tbackend="simulate")
    ji.write_experiment(line)
    ti.write_experiment(line)
    reply = ti.write_cmd("validate")
    assert reply == ji.write_cmd("validate")
    assert reply.startswith("ERR ")


@pytest.mark.parametrize("line", ["r,hbm,64K", "r,hbm w,hbm,64K",
                                  "r,hbm,64Q w,hbm,64K",
                                  "r,hbm,64K w,hbm,64K depth=3"])
def test_malformed_config_strings_raise_the_same(line):
    ji, ti = _pair(jbackend="simulate", tbackend="simulate")
    with pytest.raises(ValueError) as je:
        ji.write_experiment(line)
    with pytest.raises(ValueError) as te:
        ti.write_experiment(line)
    assert str(te.value) == str(je.value)


def test_unknown_command_and_perfcount_entries_equal():
    ji, ti = _pair(jbackend="simulate", tbackend="simulate")
    assert ti.write_cmd("reboot") == ji.write_cmd("reboot")
    assert ti.read_perfcount() == ji.read_perfcount()
    ji.write_perfcount("WALL_NS, HLO_BYTES")
    ti.write_perfcount("WALL_NS, HLO_BYTES")
    assert ti.read_perfcount() == ji.read_perfcount() == "WALL_NS,HLO_BYTES"
    with pytest.raises(KeyError):
        ti.write_perfcount("CYCLES")


@pytest.mark.parametrize("size", ["512", "4K", "3m", "1G"])
def test_parse_size_and_format_equal(size):
    assert interface.parse_size(size) == jif.parse_size(size)
    line = f"r,hbm,{size} w,host,{size} iters=7 scenarios=2"
    assert interface.format_experiment(interface.parse_experiment(line)) == \
        jif.format_experiment(jif.parse_experiment(line))


@pytest.mark.parametrize("argv,code", [
    (["--experiment", "r,dram,64K w,dram,64K iters=2"], 0),
    (["--experiment", "l,dram,16K y,pl-dram,64K iters=2 scenarios=2",
      "--cmd", "validate"], 0),
    (["--experiment", "r,nope,64K w,dram,64K", "--cmd", "validate"], 1),
    (["--pools"], 0),
])
def test_main_exit_codes_and_output(argv, code, capsys):
    want = jif.main(argv + ["--platform", "zcu102", "--backend", "interpret"])
    jout = capsys.readouterr().out
    got = interface.main(argv + ["--platform", "zcu102", "--backend", "cuda",
                                 "--device", "cpu"])
    tout = capsys.readouterr().out
    assert got == want == code
    assert tout == jout


def test_main_runs_the_h100_tree_on_the_cpu(capsys):
    assert interface.main(["--experiment", "r,hbm,64K w,hbm,64K iters=2",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "OK complete" and len(out) == 3 + 8
    assert interface.main(["--experiment", "i,hbm,0 w,hbm,64K iters=2",
                           "--backend", "simulate", "--device", "cpu"]) == 0
    with pytest.raises(NotImplementedError):
        interface.main(["--experiment", "i,hbm,0 w,hbm,64K iters=2",
                        "--device", "cpu"])
    with pytest.raises(SystemExit):
        interface.main(["--device", "cpu"])          # no --experiment

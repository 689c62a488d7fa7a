"""The dry-run's port (``repro_torch.launch.dryrun``) against the
reference's, on the CPU.

The reference lowers and compiles a cell for forced host devices in a
subprocess (``tests/test_distribution.py``'s shrunk qwen2-1.5b cell: two
layers, 128 tokens, a batch of 8, on a (2, 4) mesh put in place of the
production one).  The port runs the same cell as rank 0's call on
``meta`` tensors, bound through a ``fake`` process group, in a subprocess
of its own (one group a process); both run at once.  Limits, set
beforehand: the argument bytes equal to the byte (the dense decoder's
state blocks follow the same specs), the model FLOPs, microbatches and
loss chunk equal, the port's record keys a superset of the reference's,
``--list`` the same text.  The collectives of the same step on (2, 2)
are, in order, kind and bytes, those ``planned_collectives`` derives from
the specs.  The rest runs here in-process: the flash wrapper's ``meta``
route, the memory tracker, balanced MoE routing.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from test_torch_distribution import planned_collectives

from repro_torch.analysis import cost, memory
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import counts, flash_attention as fa
from repro_torch.launch import dryrun, mesh as mesh_mod
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe
from repro_torch.parallel import sharding
from repro_torch.train import step as step_mod

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
LIMIT = 240                  # seconds for each subprocess
SEQ, BATCH, LAYERS = 128, 8, 2
COLL_BATCH = 4               # the (2, 2) step's global batch

# the shrunk cell, on whatever mesh ``MESH`` names (set before each cell)
SHRINK = f"""
import dataclasses, json, sys
from {{pkg}}.configs.base import SHAPES, get_config
SHAPES["train_4k"] = dataclasses.replace(
    SHAPES["train_4k"], seq_len={SEQ}, global_batch={BATCH})
cfg = get_config("qwen2-1.5b")
object.__setattr__(cfg, "n_layers", {LAYERS})
"""

REFERENCE = SHRINK.format(pkg="repro") + """
import contextlib, io
import repro.launch.dryrun as dr
from repro import compat
def small_mesh(*, multi_pod=False):
    return compat.make_mesh((2, 4), ("data", "model"))
dr.make_production_mesh = small_mesh
lowered, compiled, meta = dr.lower_cell("qwen2-1.5b", "train_4k")
rec = dr.analyze_cell(compiled, meta, cfg, SHAPES["train_4k"])
listing = io.StringIO()
with contextlib.redirect_stdout(listing):
    dr.main(["--list"])
print("RESULT " + json.dumps({"rec": rec, "list": listing.getvalue()},
                             default=str))
"""

PORT = SHRINK.format(pkg="repro_torch") + f"""
from repro_torch.analysis import cost, profile
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import collectives
def on(shape):
    axes = ("pod", "data", "model")[-len(shape):]
    dr.make_production_mesh = lambda *, multi_pod=False: Mesh(axes, shape)
out = {{}}
on((2, 4))
fn, args, meta = dr.lower_cell("qwen2-1.5b", "train_4k")
out["pod"] = dr.analyze_cell(fn, args, meta, cfg, SHAPES["train_4k"])
p = profile.profile(fn, *args)
out["profile"] = [p["total_flops"], p["total_bytes"],
                  p["total_collective_bytes"]]
out["profile_cell"] = profile.profile_cell("qwen2-1.5b", "train_4k")
on((2, 2, 2))
fn, args, meta = dr.lower_cell("qwen2-1.5b", "train_4k", multi_pod=True)
out["multipod"] = dr.analyze_cell(fn, args, meta, cfg, SHAPES["train_4k"])
SHAPES["train_4k"] = dataclasses.replace(SHAPES["train_4k"],
                                         global_batch={COLL_BATCH})
on((2, 2))
fn, args, meta = dr.lower_cell("qwen2-1.5b", "train_4k")
c = cost.analyze(fn, *args)
out["coll"] = {{"meta": meta,
               "counted": [[o.kind, o.bytes_per_call, o.group_size]
                           for o in c.collectives]}}
collectives.teardown()
print("RESULT " + json.dumps(out))
"""


def _start(body: str, env_extra: dict) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2", **env_extra)
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(body)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(proc: subprocess.Popen) -> dict:
    try:
        out, err = proc.communicate(timeout=LIMIT)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, err[-3000:]
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def cells():
    """(the reference's record and listing, the port's records)."""
    ref = _start(REFERENCE, {
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    port = _start(PORT, {})
    try:
        return _result(ref), _result(port)
    finally:
        for p in (ref, port):
            if p.poll() is None:
                p.kill()


# ---------------------------------------------------------------------------
# Against the reference's compiled dry-run
# ---------------------------------------------------------------------------


def test_the_argument_bytes_equal_the_reference_to_the_byte(cells):
    ref, port = cells
    want = ref["rec"]["memory_analysis"]["argument_size_in_bytes"]
    got = port["pod"]["memory_analysis"]["argument_size_in_bytes"]
    assert got == want > 0


@pytest.mark.parametrize("key", ["model_flops", "microbatches",
                                 "loss_chunk", "n_devices", "mesh",
                                 "remat", "zero1"])
def test_the_cells_settings_equal_the_reference(cells, key):
    ref, port = cells
    assert port["pod"][key] == ref["rec"][key]


def test_the_record_holds_every_key_of_the_reference(cells):
    ref, port = cells
    for rec in (port["pod"], port["multipod"]):
        assert set(ref["rec"]) <= set(rec), set(ref["rec"]) - set(rec)
        assert set(ref["rec"]["memory_analysis"]) == \
            set(rec["memory_analysis"])
    # the keys the card's check holds every production cell's record to
    assert set(ref["rec"]) == set(dryrun.RECORD_KEYS + dryrun.TRAIN_KEYS)


def test_the_listing_equals_the_reference(cells, capsys):
    ref, _ = cells
    assert dryrun.main(["--list"]) == 0
    got = capsys.readouterr().out
    assert got == ref["list"]
    assert len(got.splitlines()) == 34


def test_long_500k_is_refused_for_full_attention():
    """The reference's refusal, before any group or mesh is made."""
    with pytest.raises(SystemExit, match="pure full-attention"):
        dryrun.lower_cell("qwen2-1.5b", "long_500k")
    assert not torch.distributed.is_initialized()


def test_a_cell_that_raises_is_tabled_with_its_reason(tmp_path,
                                                      monkeypatch):
    """``--all`` keeps a failing cell's last line of errors beside the
    records, and ``tools/dryrun_table.py`` lists the cell with it."""
    spec = importlib.util.spec_from_file_location(
        "dryrun_table", os.path.join(ROOT, "tools", "dryrun_table.py"))
    table = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(table)
    cell = ("qwen2-1.5b", "long_500k")
    monkeypatch.setattr(dryrun, "all_cells", lambda: iter([cell]))
    monkeypatch.setattr(table, "all_cells", lambda: iter([cell]))
    monkeypatch.setenv("PYTHONPATH", SRC)
    assert dryrun.main(["--all", "--out", str(tmp_path)]) == 1
    rows = list(table.rows(str(tmp_path)))
    assert len(rows) == 4
    for mesh, row in zip(("pod", "multipod"), rows[2:]):
        reason = (tmp_path / f"qwen2-1.5b_long_500k_{mesh}.error") \
            .read_text().strip()
        assert "pure full-attention" in reason
        assert row == (f"| qwen2-1.5b | long_500k | {mesh} | raised: "
                       f"{reason} |" + " |" * 8)


def test_the_record_is_the_rank_share(cells):
    """The rank's figures: work counted, both flash kernels modelled, the
    peak covering the arguments, the terms from the H100's constants."""
    _, port = cells
    rec = port["pod"]
    for key in ("hlo_flops", "hlo_bytes", "bytes_per_device",
                "collective_bytes"):
        assert rec[key] > 0, key
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["t_compile_s"] == 0.0
    assert rec["device"] == "meta" and rec["rank"] == 0
    ma = rec["memory_analysis"]
    assert rec["bytes_per_device"] >= ma["argument_size_in_bytes"]
    assert ma["temp_size_in_bytes"] >= 0
    assert ma["generated_code_size_in_bytes"] == 0
    # the state comes back updated in place: every output byte but the
    # metrics' is an argument's
    assert 0 < ma["output_size_in_bytes"] - ma["alias_size_in_bytes"] < 1024
    assert rec["while_trips"] == {} and rec["unknown_trip_whiles"] == []
    # remat: two forwards and one backward a layer and microbatch
    mb = rec["microbatches"]
    assert rec["kernels"]["flash_attention"][0] == 2 * LAYERS * mb
    assert rec["kernels"]["flash_attention_bwd"][0] == LAYERS * mb
    assert rec["xla_cost"] == {"flops": rec["hlo_flops"],
                               "bytes accessed": rec["hlo_bytes"]}


def test_profile_cell_totals_equal_analyze_cell(cells):
    _, port = cells
    rec = port["pod"]
    assert port["profile"] == [rec["hlo_flops"], rec["hlo_bytes"],
                               rec["collective_bytes"]]
    first = port["profile_cell"].splitlines()[0]
    assert first == (f"total: {rec['hlo_flops']:.3e} flops, "
                     f"{rec['hlo_bytes'] / 2**30:.2f} GiB moved, "
                     f"{rec['collective_bytes'] / 2**30:.2f} GiB collective")


def test_a_multipod_cell_makes_a_record(cells):
    """A (2, 2, 2) mesh: the batch over ("pod", "data"), the step's data
    sums and ZeRO-1's moments over both axes."""
    _, port = cells
    rec = port["multipod"]
    assert rec["mesh"] == "pod=2xdata=2xmodel=2" and rec["n_devices"] == 8
    assert rec["multi_pod"] is True
    groups = {g for _, _, g, _ in rec["collective_ops"]}
    assert 4 in groups, rec["collective_ops"]     # ("pod", "data")
    assert rec["bytes_per_device"] > 0


def test_the_counted_collectives_are_those_the_specs_imply(cells):
    """The shrunk step on (2, 2) under the ``fake`` group: its collectives,
    in order, kind and operand bytes, are the test oracle's."""
    _, port = cells
    meta = port["coll"]["meta"]
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=LAYERS)
    rules = sharding.make_rules(cfg, mesh_mod.Mesh(("data", "model"), (2, 2)),
                                global_batch=COLL_BATCH)
    tcfg = TrainConfig(microbatches=meta["microbatches"],
                       loss_chunk=meta["loss_chunk"], remat="layer",
                       zero1=True)
    plan = planned_collectives(
        rules, tcfg, step_mod.state_struct(cfg, tcfg)["params"], seq=SEQ,
        microbatches=meta["microbatches"])
    assert port["coll"]["counted"] == plan


# ---------------------------------------------------------------------------
# The flash wrapper's meta route
# ---------------------------------------------------------------------------


def _qkv(device, d=64, dtype=torch.bfloat16, grad=False):
    g = torch.Generator().manual_seed(0)
    shapes = ((2, 4, 64, d), (2, 2, 64, d), (2, 2, 64, d))
    out = [torch.randn(s, generator=g).to(dtype) for s in shapes]
    out = [t.to(device) for t in out]
    return [t.requires_grad_() if grad else t for t in out]


def test_the_meta_route_refuses_what_the_kernel_refuses():
    q, k, v = _qkv("meta", d=96)
    reason = fa.kernel_refusal(q, k, v)
    assert reason and "head dim 96" in reason
    with pytest.raises(ValueError, match="head dim 96"):
        fa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="head dim 96"):
        fa.flash_attention(*_qkv("meta", d=96, grad=True))


@pytest.mark.parametrize("window", [0, 24])
def test_the_meta_route_reports_the_plain_routes_work(window):
    """Forward and backward on ``meta`` count what the same call counts
    on CPU tensors, and launch nothing: ``counts.snapshot()`` and the
    instances stay as they were; ``MODELLED`` gets one a call."""
    def run(device):
        q, k, v = _qkv(device, grad=True)
        with cost.CostCounter() as c:
            out = fa.flash_attention(q, k, v, causal=True, window=window)
            out.backward(torch.ones_like(out))
        return c.cost.kernels, out, q.grad

    cpu, _, _ = run("cpu")
    before, inst = counts.snapshot(), dict(counts.INSTANCES)
    modelled = dict(counts.MODELLED)
    meta, out, dq = run("meta")
    assert meta == cpu
    assert counts.snapshot() == before and counts.INSTANCES == inst
    assert counts.MODELLED["flash_attention:wgmma_bf16"] == \
        modelled["flash_attention:wgmma_bf16"] + 1
    assert counts.MODELLED["flash_attention_bwd:wgmma_bf16"] == \
        modelled["flash_attention_bwd:wgmma_bf16"] + 1
    assert out.device.type == "meta" and out.dtype == torch.bfloat16
    assert out.shape == (2, 4, 64, 64) and dq.shape == (2, 4, 64, 64)


def test_a_launch_refuses_meta_tensors():
    """Only the entry points model a launch; the raw launches refuse."""
    q, k, v = _qkv("meta")
    with pytest.raises(ValueError, match="meta tensors"):
        fa.run_instance("wgmma_bf16", q, k, v)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="meta tensors"):
        fa.run_bwd_instance("wgmma_bf16", q, k, v, q, lse, q)


def test_the_meta_route_without_grad_and_in_float32():
    q, k, v = _qkv("meta", dtype=torch.float32)
    out = fa.flash_attention(q, k, v)
    assert out.shape == q.shape and out.dtype == torch.float32


def test_the_meta_backward_allocates_what_the_card_route_does():
    """dq, dk, dv and the rows' scratch, the scratch freed at the
    return: the tracker's peak over the call is the inputs, the three
    gradients and the scratch."""
    q, k, v = _qkv("meta")
    o = torch.empty_like(q)
    do = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device="meta")
    with memory.MemoryTracker() as t:
        args = t.track_external(q, k, v, o, lse, do)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do)
        live = t.live
    grads = sum(x.numel() * x.element_size() for x in (dq, dk, dv))
    scratch = 4 * fa.bwd_scratch_floats("wgmma_bf16", 2, 4, 64)
    assert scratch == 4 * 2 * 2 * 4 * 128
    assert t.peak == args + grads + scratch
    assert live == args + grads


# ---------------------------------------------------------------------------
# The memory tracker
# ---------------------------------------------------------------------------


def _reduced_step(cfg, device):
    tcfg = TrainConfig(loss_chunk=32, microbatches=2, remat="layer")
    rules = sharding.make_rules(cfg, make_host_mesh(1, 1), global_batch=4)
    if device == "meta":
        state = step_mod.state_struct(cfg, tcfg)
    else:
        state = step_mod.init_state(cfg, tcfg,
                                    torch.Generator().manual_seed(0))
    tokens = torch.zeros((4, 64), dtype=torch.int32, device=device)
    labels = torch.zeros((4, 64), dtype=torch.int32, device=device)
    return step_mod.make_train_step(cfg, rules, tcfg,
                                    microbatches=2), state, tokens, labels


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-370m"])
def test_the_peak_of_a_train_step_is_the_same_on_meta_and_cpu(arch):
    cfg = get_config(arch).reduced()
    peaks = {}
    for device in ("cpu", "meta"):
        step, *args = _reduced_step(cfg, device)
        with memory.MemoryTracker({torch.device(device)}) as tracker:
            tracker.track_external(args)
            step(*args)
        peaks[device] = tracker.peak
    assert peaks["cpu"] == peaks["meta"] > 0


def test_the_tracker_follows_frees():
    with memory.MemoryTracker() as t:
        a = torch.zeros(1024, device="meta")
        b = a + 1
        del a
        c = b.view(2, 512) * 2
        live = t.live
        d = c + 1
    assert live == 2 * 4096 and t.peak == 3 * 4096
    del b, c, d


# ---------------------------------------------------------------------------
# MoE on meta: balanced routing
# ---------------------------------------------------------------------------


def test_balanced_sizes_deal_evenly_under_the_cap():
    assert moe.balanced_sizes(2, 10, 4, 100) == [6, 6, 4, 4]
    assert moe.balanced_sizes(3, 10, 4, 2) == [6, 6, 6, 6]
    assert sum(moe.balanced_sizes(5, 64, 8, 64)) == 5 * 64


@pytest.mark.parametrize("dropless", [False, True])
def test_balanced_routing_gives_the_closed_form_expert_flops(dropless):
    """Reduced olmoe's MoE layer on ``meta``: the router's product and
    every expert's three GEMMs over its balanced share of the ``g·n·k``
    assignments, ``2·g·n·d·e + 6·g·n·k·d·f``."""
    cfg = get_config("olmoe-1b-7b").reduced()
    m = cfg.moe
    params = {
        "router": torch.empty((cfg.d_model, m.n_experts), device="meta"),
        **{n: torch.empty(s, dtype=torch.bfloat16, device="meta")
           for n, s in (("we_in", (m.n_experts, cfg.d_model, m.d_ff_expert)),
                        ("we_gate", (m.n_experts, cfg.d_model,
                                     m.d_ff_expert)),
                        ("we_out", (m.n_experts, m.d_ff_expert,
                                    cfg.d_model)))}}
    b, s = 4, 64
    x = torch.empty((b, s, cfg.d_model), dtype=torch.bfloat16, device="meta")
    with cost.CostCounter() as c:
        y, aux = moe.moe_apply(params, x, cfg, dropless=dropless)
    assert y.shape == x.shape and y.device.type == "meta"
    g, n, d, e, f = b, s, cfg.d_model, m.n_experts, m.d_ff_expert
    assert (g * n * m.top_k) % e == 0
    assert c.cost.flops == 2 * g * n * d * e + 6 * g * n * m.top_k * d * f

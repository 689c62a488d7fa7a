"""Port vs reference for the serving path, on the CPU.

The engine (``repro_torch.serve.engine``) against the JAX package's on
the reference's weights carried over (``models.convert``): the cache
accounting and pool choice equal, the logits of every prefill and decode
step within 1e-4 (float32, ``reduced()`` configs), the greedy tokens
equal, for the dense, local/global, moe, ssm and hybrid families.  A
prefill and decode through the caches agree with one forward over the
whole sequence (prefill mode for a MoE family: serving is dropless, train
mode drops by capacity).  The monitor (``repro_torch.serve.monitor``, a copy of the
reference's) is driven through tests/test_serve.py's drift, hysteresis,
rollback and re-advise cases beside the reference's, with the same inputs,
and must take the same actions.  The launcher, the example and the
straggler monitor run with ``--device cpu``.

A cache placed in pinned host memory exists only beside a card: on the
CPU the ``host`` pool holds ordinary tensors, so the PCIe path is held on
the card (tests/test_torch_cuda.py, chip_smoke.py's ``serve`` phase).
"""
import dataclasses
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.base import get_config as jget_config
from repro.core import characterize as jchar
from repro.core.devicetree import detect_platform as jdetect_platform
from repro.core.placement import ContentionSpec as JContentionSpec
from repro.core.placement import kv_cache_object as jkv_cache_object
from repro.launch.mesh import describe as jdescribe
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.models import lm as jlm
from repro.parallel.sharding import make_rules as jmake_rules
from repro.runtime import fault_tolerance as jft
from repro.serve import engine as jeng
from repro.serve import monitor as jmon
from repro_torch.configs import ServeConfig, get_config, list_configs
from repro_torch.core import characterize as tchar
from repro_torch.core.devicetree import H100_SXM
from repro_torch.core.exec.resilience import GroupExecutionError
from repro_torch.core.placement import ContentionSpec, kv_cache_object
from repro_torch.core.pools import PoolManager
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import describe, make_host_mesh
from repro_torch.models import convert, lm
from repro_torch.parallel.sharding import make_rules
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.serve import engine as eng
from repro_torch.serve import monitor as smon
from repro_torch.train.step import make_constrain

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PROMPT, NEW = 12, 4
LOGITS_ATOL = 1e-4
FAMILIES = ["olmoe-1b-7b", "mamba2-370m", "jamba-v0.1-52b"]
ALL_CONFIGS = list_configs()


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _engines(arch, seed=1, batch=2, **kw):
    """(reference engine, port engine) on the same weights."""
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jrules = jmake_rules(jcfg, jmake_host_mesh(1, 1), global_batch=batch,
                         shape_kind="decode")
    rules = make_rules(cfg, make_host_mesh(1, 1), global_batch=batch,
                       shape_kind="decode")
    return (jeng.ServeEngine(jcfg, jp, jrules, JServeConfig()),
            eng.ServeEngine(cfg, tp, rules, ServeConfig(), **kw))


def _prompts(cfg, batch=2):
    p = (np.arange(batch * PROMPT).reshape(batch, PROMPT) * 3) % \
        cfg.vocab_size
    return jnp.asarray(p, jnp.int32), torch.from_numpy(p)


# ---------------------------------------------------------------------------
# Cache accounting and the pool choice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-1b",
                                  "internvl2-26b"] + FAMILIES)
@pytest.mark.parametrize("full", [False, True])
def test_cache_bytes_equal_the_reference(arch, full):
    jcfg, cfg = jget_config(arch), get_config(arch)
    if not full:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    for batch, max_len in ((4, 64), (1, 5), (4, 2080)):
        assert eng.cache_bytes(cfg, batch, max_len) == \
            jeng.cache_bytes(jcfg, batch, max_len)
        assert eng.decode_rw_mix(batch, max_len) == \
            jeng.decode_rw_mix(batch, max_len)


def _flat_surface(mod, bw, lat=100.0):
    return mod.Surface(axes=(mod.SurfaceAxis(mod.AXIS_N, (0.0, 8.0)),),
                       bandwidth_gbps=[bw, bw], latency_ns=[lat, lat])


def _synth_db(mod, hbm_bw=1000.0, host_bw=100.0):
    """Offline surfaces in package ``mod``: hbm fast, host slow."""
    db = mod.CurveDB(platform="synthetic")
    for pool, bw in (("hbm", hbm_bw), ("host", host_bw)):
        for strat in ("r", "l"):
            db.surfaces[mod.SurfaceKey(pool, strat, "hbm", "b")] = \
                _flat_surface(mod, bw)
    return db


def _imprint_online(mod, db, hbm_bw, host_bw):
    """What a probe sweep would store: online-qualified cells."""
    keys = []
    for pool, bw in (("hbm", hbm_bw), ("host", host_bw)):
        for strat in ("r", "l"):
            k = mod.SurfaceKey(pool, strat, "hbm", "b",
                               qualifier=mod.ONLINE_QUALIFIER)
            db.surfaces[k] = _flat_surface(mod, bw)
            keys.append(k)
    return keys


@pytest.mark.parametrize("hbm_bw,host_bw,caps", [
    (1000.0, 100.0, None), (50.0, 100.0, None),
    (1000.0, 100.0, {"hbm": 1 << 10, "host": 1 << 30})])
def test_choose_kv_pool_equals_the_reference(hbm_bw, host_bw, caps):
    cfg, jcfg = get_config("qwen2-1.5b").reduced(), \
        jget_config("qwen2-1.5b").reduced()
    assert eng.choose_kv_pool(cfg, 4, 64) == "hbm"
    assert eng.choose_kv_pool(
        cfg, 4, 64, scfg=ServeConfig(kv_placement="host")) == "host"
    tadv = smon.ServeMonitor.online_advisor(
        _synth_db(tchar, hbm_bw, host_bw), H100_SXM, pools=["hbm", "host"])
    jadv = jmon.ServeMonitor.online_advisor(
        _synth_db(jchar, hbm_bw, host_bw), jdetect_platform(),
        pools=["hbm", "host"])
    hbm_free = caps and caps["hbm"]
    got = eng.choose_kv_pool(cfg, 4, 64, advisor=tadv, hbm_free_bytes=hbm_free)
    want = jeng.choose_kv_pool(jcfg, 4, 64, advisor=jadv,
                               hbm_free_bytes=hbm_free)
    assert got == want


def test_pool_capacities_come_from_live_accounting():
    pm = PoolManager(H100_SXM, "cpu")
    adv = smon.ServeMonitor.online_advisor(_synth_db(tchar), H100_SXM,
                                           pools=["hbm", "host"])
    caps = eng.pool_capacities(adv, pool_mgr=pm)
    assert caps == {p: pm.pool(p).available for p in ("hbm", "host")}
    caps = eng.pool_capacities(adv, hbm_free_bytes=123 << 20)
    assert caps["hbm"] == 123 << 20
    assert caps["host"] == H100_SXM.memories["host"].size_bytes


# ---------------------------------------------------------------------------
# Prefill / decode steps and generate against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-1b"] + FAMILIES)
def test_step_logits_and_greedy_tokens_match_the_reference(arch):
    jengine, tengine = _engines(arch)
    jcfg, cfg = jengine.cfg, tengine.cfg
    jprompts, tprompts = _prompts(cfg)
    steps = 3 * cfg.sliding_window if cfg.sliding_window else 8
    max_len = PROMPT + steps
    jc, jl = jeng.make_prefill_step(jcfg, jengine.rules, max_len=max_len)(
        jengine.params, jprompts, None)
    tc, tl = eng.make_prefill_step(cfg, tengine.rules, max_len=max_len)(
        tengine.params, tprompts, None)
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0, atol=LOGITS_ATOL)
    jdecode = jax.jit(jeng.make_decode_step(jcfg, jengine.rules))
    tdecode = eng.make_decode_step(cfg, tengine.rules)
    tok = np.array(jnp.argmax(jl, -1))[:, None]
    for i in range(steps - 1):        # past the window: the ring wraps
        jc, jl = jdecode(jengine.params, jc, jnp.asarray(tok, jnp.int32),
                         jnp.int32(PROMPT + i))
        tc, tl = tdecode(tengine.params, tc, torch.from_numpy(tok),
                         PROMPT + i)
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0,
                                   atol=LOGITS_ATOL, err_msg=f"step {i}")
        tok = np.array(jnp.argmax(jl, -1))[:, None]

    want = jengine.generate(jprompts, max_new_tokens=NEW, temperature=0.0)
    got = tengine.generate(tprompts, max_new_tokens=NEW, temperature=0.0)
    assert tuple(got.tokens.shape) == (2, NEW)
    assert got.kv_pool == want.kv_pool == "hbm"
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.host_read_bytes == got.host_written_bytes == 0


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-1b"] + FAMILIES)
def test_prefill_decode_matches_forward(arch):
    """The twin of tests/test_serve.py's: a prefill of the prompt and
    decode steps through the caches give the logits of one forward over the
    whole sequence, within the reference's 3e-3.  The oracle is train mode
    as there, and prefill mode for a MoE family (train mode drops by
    capacity, serving never does)."""
    cfg = get_config(arch).reduced()
    rules = make_rules(cfg, make_host_mesh(1, 1), global_batch=2,
                       shape_kind="decode")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    total = PROMPT + NEW
    tokens = (torch.arange(2 * total).reshape(2, total) * 7) % cfg.vocab_size
    mode = "prefill" if cfg.moe is not None else "train"
    h, _, _ = lm.forward(params, tokens, cfg=cfg, mode=mode)
    want = _f32(lm.unembed_logits(params, h, cfg))

    prefill = eng.make_prefill_step(cfg, rules, max_len=total)
    decode = eng.make_decode_step(cfg, rules)
    caches, logits = prefill(params, tokens[:, :PROMPT], None)
    np.testing.assert_allclose(_f32(logits), want[:, PROMPT - 1], atol=3e-3)
    for i in range(NEW - 1):
        pos = PROMPT + i
        caches, logits = decode(params, caches, tokens[:, pos:pos + 1], pos)
        np.testing.assert_allclose(_f32(logits), want[:, pos], atol=3e-3,
                                   err_msg=f"{arch} pos={pos}")


def test_timed_loop_matches_the_untimed_loop():
    """The monitored (timed) decode loop draws the same tokens as the
    untimed one — greedy and sampled from the seeded generator."""
    _, engine = _engines("qwen2-1.5b")
    _, prompts = _prompts(engine.cfg)
    for temp in (0.0, 0.7):
        ref = engine.generate(prompts, max_new_tokens=NEW, temperature=temp,
                              seed=3)
        steps = []
        out = engine.generate(
            prompts, max_new_tokens=NEW, temperature=temp, seed=3,
            on_step=lambda step, pool: steps.append((step, pool)))
        assert torch.equal(ref.tokens, out.tokens)
        assert steps == [(PROMPT + i, "hbm") for i in range(NEW - 1)]
        assert out.probe_sweeps == 0 and not out.drift_events
    again = engine.generate(prompts, max_new_tokens=NEW, temperature=0.7,
                            seed=3)
    assert torch.equal(again.tokens, out.tokens)
    with pytest.raises(ValueError, match="generator"):
        eng.sample_token(torch.zeros(2, 8), None, 0.7)


def test_host_placement_gives_the_same_tokens():
    """Through a pool manager on the CPU: the ``host`` pool holds ordinary
    tensors there, the tokens equal the ``hbm`` run's, for attention,
    Mamba and hybrid caches.  Every cache tensor stays the tensor it was
    placed as, in the memory it was placed in, and the step's host traffic
    counts a Mamba layer's ``ssm`` and ``conv`` whole."""
    pm = PoolManager(H100_SXM, "cpu")
    for arch in ("gemma3-1b", "mamba2-370m", "jamba-v0.1-52b"):
        _, engine = _engines(arch, pool_mgr=pm)
        _, prompts = _prompts(engine.cfg)
        hbm = engine.generate(prompts, max_new_tokens=NEW)
        engine.scfg = ServeConfig(kv_placement="host")
        seen, real = [], engine._decode

        def spy(params, caches, tok, pos):
            seen.append({id(t): (t.data_ptr(), t.device)
                         for t in lm.leaves(caches)})
            if len(seen) == 1:      # every leaf as if it lay off the device
                state = sum(t.numel() * t.element_size()
                            for name, t in lm.named_leaves(caches)
                            if name in ("ssm", "conv"))
                read, written = lm.host_traffic_bytes(caches,
                                                      torch.device("meta"))
                assert read == eng.cache_bytes(
                    engine.cfg, 2, PROMPT + NEW, torch.float32)
                # the attention caches' slots are what is left of written
                assert (state > 0) == (arch != "gemma3-1b")
                assert (written > state) == (arch != "mamba2-370m")
            return real(params, caches, tok, pos)

        engine._decode = spy
        host = engine.generate(prompts, max_new_tokens=NEW)
        assert host.kv_pool == "host"
        assert torch.equal(hbm.tokens, host.tokens), arch
        assert len(seen) == NEW - 1 and all(m == seen[0] for m in seen)


# ---------------------------------------------------------------------------
# The monitor: the reference's cases, in both packages
# ---------------------------------------------------------------------------


class _StubCoord:
    backend = "simulate"


def _drift_monitor(pkg, db, refresh, *, cooldown=24, cooldown_steps=10):
    mon_mod, platform = pkg
    adv = mon_mod.ServeMonitor.online_advisor(db, platform,
                                              pools=["hbm", "host"])
    rechar = mon_mod.OnlineRecharacterizer(_StubCoord(), db,
                                           pools=["hbm", "host"],
                                           refresh=refresh)
    mon = mon_mod.ServeMonitor(
        adv, rechar,
        watchdog=mon_mod.WatchdogConfig(band=1.5, rearm=1.2, sustain=3,
                                        warmup=4, cooldown=cooldown),
        guard=mon_mod.GuardConfig(min_gain_frac=0.1,
                                  cooldown_steps=cooldown_steps,
                                  verify_steps=4, regress_band=1.1),
        capacities={"hbm": 1 << 30, "host": 1 << 30})
    mon.bind(kv_bytes=1 << 20, rw_mix=0.9, pool="hbm", inject_rate=1.0)
    return mon


CALM_NS, DRIFT_NS = 1.0e6, 3.0e6
PACKAGES = {"port": (smon, tchar), "reference": (jmon, jchar)}


def _platform(name):
    return H100_SXM if name == "port" else jdetect_platform()


def _run_case(name, case):
    """Drive one case in package ``name``; return what it did."""
    mon_mod, char_mod = PACKAGES[name]
    db = _synth_db(char_mod)
    calls = []

    def refresh(coord, db_, **kw):
        calls.append(kw)
        if case == "faulted":
            raise RuntimeError("probe group online.hbm: injected")
        bw = {"migrate": (50.0, 100.0), "hysteresis": (95.0, 100.0),
              "rollback": (50.0, 100.0)}[case]
        return _imprint_online(char_mod, db_, *bw), {"stub": True}

    mon = _drift_monitor((mon_mod, _platform(name)), db, refresh)
    for _ in range(7):                       # warmup + calm
        assert mon.on_step(CALM_NS) is None
    acts, wall = [], DRIFT_NS
    for _ in range(14):
        a = mon.on_step(wall)
        acts.append(a and (a.kind, a.to_pool, a.record.to_dict()))
        if case == "rollback" and a is not None and a.kind == "migrate":
            wall = 5.0e6        # post-migration steps WORSE than drift
    return {"actions": acts, "pool": mon.pool,
            "drift": [e.to_dict() for e in mon.drift_events],
            "migrations": [m.to_dict() for m in mon.migrations],
            "refreshes": [(r.failed, "injected" in r.error)
                          for r in mon.refreshes],
            "held": mon.held,
            "sweep_kw": [{k: v for k, v in kw.items() if k != "drift"}
                         for kw in calls],
            "query_online": db.query(
                "hbm", 0, stress_strat="w", rw_ratio=0.9,
                qualifier=char_mod.ONLINE_QUALIFIER).bandwidth_gbps}


@pytest.mark.parametrize("case", ["migrate", "faulted", "hysteresis",
                                  "rollback"])
def test_monitor_takes_the_reference_actions(case):
    got, want = _run_case("port", case), _run_case("reference", case)
    assert got == want
    kinds = [a[0] for a in got["actions"] if a is not None]
    assert len(got["drift"]) == 1 and len(got["refreshes"]) == 1
    if case == "migrate":
        assert kinds == ["migrate"] and got["pool"] == "host"
        assert got["migrations"][0]["reason"].startswith("verified")
        assert got["sweep_kw"][0]["rw_ratio"] == 0.9
    elif case == "faulted":
        assert kinds == [] and got["refreshes"] == [(True, True)]
    elif case == "hysteresis":
        assert kinds == [] and "hysteresis floor" in got["held"][0][1]
    else:
        assert kinds == ["migrate", "rollback"] and got["pool"] == "hbm"
        assert got["migrations"][0]["rolled_back"]


def test_readvise_equals_the_reference():
    out = {}
    for name, (mon_mod, char_mod) in PACKAGES.items():
        db = _synth_db(char_mod)
        _imprint_online(char_mod, db, 50.0, 100.0)
        adv = mon_mod.ServeMonitor.online_advisor(db, _platform(name),
                                                  pools=["hbm", "host"])
        obj = (kv_cache_object if name == "port" else jkv_cache_object)(
            "kv", 1 << 20, bytes_read_per_token=float(1 << 20))
        spec = (ContentionSpec if name == "port" else JContentionSpec)(
            0, rw_ratio=0.9, inject_rate=1.0)
        caps = {"hbm": 1 << 30, "host": 1 << 30}
        rows = []
        for placed, floor in (("hbm", 0.1), ("host", 0.1), ("hbm", 0.6),
                              ("peer", 0.1)):
            d = adv.readvise([obj], spec, {"kv": placed}, capacities=caps,
                             min_gain_frac=floor)
            rows.append((d.moves, sorted(d.held), d.predicted_gain_frac))
        out[name] = rows
    assert out["port"] == out["reference"]
    assert out["port"][0][0] == {"kv": ("hbm", "host")}
    assert out["port"][0][2] == pytest.approx(0.5)


def test_faulted_sweep_flags_a_group_execution_error():
    def refresh(coord, db_, **kw):
        raise GroupExecutionError("probe group online.hbm",
                                  RuntimeError("injected"))

    mon = _drift_monitor((smon, H100_SXM), _synth_db(tchar), refresh)
    for _ in range(7):
        mon.on_step(CALM_NS)
    for _ in range(10):
        assert mon.on_step(DRIFT_NS) is None
    assert mon.refreshes[0].failed
    assert "GroupExecutionError" in mon.refreshes[0].error


def test_engine_monitored_drift_migrates_end_to_end():
    """The reference's end-to-end case on the port's engine: contention
    injected inside the timed step drifts the watchdog, the probe sweep
    flips the online surface, the engine moves the live caches through
    the pool manager, and the tokens stay those of an unmonitored run."""
    db = _synth_db(tchar)

    def refresh(coord, db_, **kw):
        return _imprint_online(tchar, db_, 2.0, 1000.0), {"stub": True}

    adv = smon.ServeMonitor.online_advisor(db, H100_SXM,
                                           pools=["hbm", "host"])
    rechar = smon.OnlineRecharacterizer(_StubCoord(), db,
                                        pools=["hbm", "host"],
                                        refresh=refresh)
    mon = smon.ServeMonitor(
        adv, rechar,
        watchdog=smon.WatchdogConfig(band=2.5, rearm=1.5, sustain=3,
                                     warmup=4, cooldown=64),
        guard=smon.GuardConfig(min_gain_frac=0.1, cooldown_steps=64,
                               verify_steps=3, regress_band=3.0),
        capacities={"hbm": 1 << 34, "host": 1 << 34})
    pm = PoolManager(H100_SXM, "cpu")
    jengine, engine = _engines("qwen2-1.5b", advisor=adv, monitor=mon,
                               pool_mgr=pm)
    jprompts, prompts = _prompts(engine.cfg)

    def contention(step, pool):
        if pool == "hbm" and step - PROMPT >= 8:
            time.sleep(0.3)

    res = engine.generate(prompts, max_new_tokens=17, on_step=contention)
    assert res.kv_pool == "host"
    assert len(res.drift_events) == 1 and res.probe_sweeps == 1
    assert len(res.migrations) == 1 and not res.migrations[0].rolled_back
    assert (res.migrations[0].from_pool, res.migrations[0].to_pool) == \
        ("hbm", "host")
    want = jengine.generate(jprompts, max_new_tokens=17)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(want.tokens))


# ---------------------------------------------------------------------------
# Mesh, rules, the straggler monitor
# ---------------------------------------------------------------------------


def test_one_device_mesh_and_rules():
    mesh = make_host_mesh(1, 1)
    assert describe(mesh) == jdescribe(jmake_host_mesh(1, 1))
    assert mesh.size == 1
    for data, model in ((2, 1), (1, 4)):
        # one process: the mesh shrinks to it, as the reference's shrinks
        # to the host's one device
        assert describe(make_host_mesh(data, model)) == \
            jdescribe(jmake_host_mesh(data, model)) == "data=1xmodel=1"
    cfg = get_config("qwen2-1.5b")
    rules = make_rules(cfg, mesh, global_batch=4)
    assert rules.mesh is mesh and rules.cfg is cfg
    x = torch.ones(2, 3)
    assert make_constrain(rules)(x, "hidden") is x


def test_straggler_monitor_matches_the_reference():
    rng = np.random.default_rng(5)
    walls = list(rng.uniform(0.9, 1.1, 40))
    walls[12] = walls[30] = 5.0
    mons = (ft.StragglerMonitor(window=8), jft.StragglerMonitor(window=8))
    for i, w in enumerate(walls):
        evs = [m.record(i, w) for m in mons]
        assert (evs[0] is None) == (evs[1] is None)
        if i == 20:
            for m in mons:
                m.reset()
    assert [(e.step, e.wall_s, e.median_s) for e in mons[0].events] == \
        [(e.step, e.wall_s, e.median_s) for e in mons[1].events]
    assert mons[0].median() == mons[1].median()
    assert mons[0].ewma_s == pytest.approx(mons[1].ewma_s, rel=1e-12)
    hook = ft.drill_at(3)
    hook(2)
    with pytest.raises(ft.InjectedFault):
        hook(3)
    hook(3)                               # one shot


# ---------------------------------------------------------------------------
# The launcher and the example
# ---------------------------------------------------------------------------


def test_launcher_serves_on_the_cpu(capsys):
    assert serve_cli.main(["--arch", "qwen2-1.5b", "--reduced", "--batch",
                           "2", "--prompt-len", "16", "--new-tokens", "6",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[serve] arch=qwen2-1.5b-reduced mesh=data=1xmodel=1" in out
    assert "kv_pool=hbm 12 tokens" in out
    r = serve_cli.run(["--arch", "gemma3-1b", "--reduced", "--batch", "2",
                       "--prompt-len", "24", "--new-tokens", "5",
                       "--kv-placement", "host", "--device", "cpu"])
    assert r.result.kv_pool == "host"
    toks = r.result.tokens
    assert tuple(toks.shape) == (2, 5)
    assert ((0 <= toks) & (toks < r.cfg.vocab_size)).all()
    assert r.kv_bytes == eng.cache_bytes(r.cfg, 2, 29)
    # one process: --data / --model shrink to its one device
    r = serve_cli.run(["--arch", "qwen2-1.5b", "--reduced", "--batch", "2",
                       "--prompt-len", "8", "--new-tokens", "2", "--data",
                       "2", "--model", "2", "--device", "cpu"])
    assert describe(r.mesh) == "data=1xmodel=1"


@pytest.mark.parametrize("arch", sorted(ALL_CONFIGS))
def test_launcher_serves_every_config_on_the_cpu(arch):
    """Every family through the entry point a user calls, at reduced():
    the tokens shaped and in the vocabulary, the cache in the advisor's
    pool, its bytes the cache's."""
    r = serve_cli.run(["--arch", arch, "--reduced", "--batch", "2",
                       "--prompt-len", "10", "--new-tokens", "3",
                       "--device", "cpu"])
    toks = r.result.tokens
    assert tuple(toks.shape) == (2, 3)
    assert ((0 <= toks) & (toks < r.cfg.vocab_size)).all()
    assert r.result.kv_pool == "hbm"
    assert r.kv_bytes == eng.cache_bytes(r.cfg, 2, 13)


def test_serve_serves_the_config_it_is_given():
    """``serve`` takes a config cut in depth (jamba's reduced() cut to its
    first two layers, a Mamba layer and an attention layer with experts)
    and serves that one, with the arguments' batch and lengths."""
    full = get_config("jamba-v0.1-52b").reduced()
    cfg = dataclasses.replace(full, n_layers=2)
    args = serve_cli.parser().parse_args(
        ["--arch", "jamba-v0.1-52b", "--batch", "2", "--prompt-len", "10",
         "--new-tokens", "3", "--device", "cpu"])
    r = serve_cli.serve(cfg, args)
    assert r.cfg is cfg
    toks = r.result.tokens
    assert tuple(toks.shape) == (2, 3)
    assert ((0 <= toks) & (toks < cfg.vocab_size)).all()
    assert r.kv_bytes == eng.cache_bytes(cfg, 2, 13) \
        < eng.cache_bytes(full, 2, 13)


def test_launcher_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the raise cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.run(["--arch", "qwen2-1.5b", "--reduced"])


def test_serve_batched_example_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch",
                                      "serve_batched.py"), "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "[serve] arch=gemma3-1b-reduced" in proc.stdout
    assert "96 tokens" in proc.stdout        # 4 sequences x 24

"""Serving cells: a prefill pool's engine under an open loop.

Set-up builds the serving system as ``repro_torch.launch.serve.serve``
does (the simulated pools characterised, the placement advisor, the
engine over the advisor's pool for the KV cache) on the benchmark's
weights, makes every prompt, and serves ``warmup_requests`` requests
of the mix's one shape.  The window then serves the requests due on the
mix's schedule in order, each through ``ServeEngine.generate``, its
first tokens copied to the host; a request waits until it is due, and is
served late when the engine is behind.  Requests due before the window's end and started
before it are served to their end; the window closes at the last one's
end or at its nominal end, whichever is later.

The traced run adds, after the window, a segment of back-to-back
requests under the profiler, with ranges around ``generate``, the
prefill call and ``moe_apply``, and host syncs counted in ``moe_apply``;
through the window it stamps ``generate`` and the prefill call (each
between two synchronisations).

The check draws from the seed a sample of ``check_requests`` of the
requests served in the window (all of the mix's one length, so the
longest among them) and runs the plain reference over their prompts once
the program's state is freed; the numbers it compares are taken over all
the sample's served tokens.
"""
from __future__ import annotations

import contextlib
import os
import random
import time

import torch

from portbench import compare, generator, harness, seeds
from portbench import trace as tr


def _setup(cell, seed, seconds, device):
    from repro_torch.core.characterize import characterize
    from repro_torch.core.coordinator import CoreCoordinator
    from repro_torch.core.placement import PlacementAdvisor
    from repro_torch.configs.base import ServeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.serve.engine import ServeEngine

    cfg, mix = cell.config, cell.traffic
    weights = harness.load_module("weights", cfg["family"])
    adapter = harness.load_module("adapters", cfg["family"])
    w = weights.make(cfg, seed, device)
    pc = adapter.port_config(cfg)
    params = adapter.port_params(cfg, w)
    coord = CoreCoordinator(backend="simulate", device=device)
    db = characterize(coord, pools=["hbm", "host"],
                      obs_strategies=("r", "l"), stress_strategies=("w",),
                      iters=10)
    advisor = PlacementAdvisor(db, coord.platform)
    rules = make_rules(pc, make_host_mesh(1, 1), global_batch=mix["batch"],
                       shape_kind="decode")
    engine = ServeEngine(pc, params, rules,
                         ServeConfig(kv_placement=mix["kv_placement"]),
                         advisor=advisor, pool_mgr=coord.pools)
    n = int(seconds * mix["arrival"]["rate_per_s"]) + 1
    prompts = generator.prompts(mix, seed, n, cfg["vocab_size"], device)
    warm = generator.prompts(mix, seed, mix["warmup_requests"],
                             cfg["vocab_size"], device, stream="warmup")
    return w, engine, prompts, warm


def _serve(engine, mix, prompt):
    res = engine.generate(prompt, max_new_tokens=mix["new_tokens"])
    res.tokens[:, 0].cpu()                  # the first tokens on the host
    return res


def run(cell, *, seed, seconds, trace: bool, device, t_start, program_ctx):
    cfg, mix = cell.config, cell.traffic
    record = harness.RunRecord(kind="serve", config=cfg, traffic=mix)
    probe = tr.Probe(device)
    ctx = program_ctx() if program_ctx else contextlib.nullcontext()
    served = []
    with ctx:
        w, engine, prompts, warm = _setup(cell, seed, seconds, device)
        patches = []
        if trace:
            from repro_torch.models import blocks
            from repro_torch.serve import engine as engine_mod

            def prefill_step(*a, **kw):
                return probe.wrap(real_step(*a, **kw), "prefill", stamp=True)

            real_step = engine_mod.make_prefill_step
            patches = [(engine_mod, "make_prefill_step", prefill_step),
                       (blocks, "moe_apply",
                        probe.wrap(blocks.moe_apply, "moe_apply",
                                   syncs=True))]
        with tr.instrument(patches):
            for p in warm:
                t = time.perf_counter()
                _serve(engine, mix, p)
                record.notes.setdefault("warmup_ms", []).append(
                    1e3 * (time.perf_counter() - t))
            tr.sync(device)
            record.setup_s = time.perf_counter() - t_start
            served, record.window_s = _window(engine, cfg, mix, prompts,
                                              seconds, probe, trace, record)
            if trace:
                _traced_segment(engine, mix, warm, cell, device, probe,
                                record)
        record.memory_peak_bytes = _peak(device)
        record.counts = dict(probe.syncs)
        del engine
    _check(cell, record, served, prompts, w, seed, device)
    return record


def _window(engine, cfg, mix, prompts, seconds, probe, traced, record):
    flops = harness.load_module("work", cfg["family"]).prefill_flops
    served = []
    t0 = time.perf_counter()
    end = t0 + seconds
    for i, prompt in enumerate(prompts):
        due = t0 + generator.due(mix, i)
        if due >= end or time.perf_counter() >= end:
            break
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        start = time.perf_counter()
        record.attempted += 1
        k = len(probe.stamps["prefill"])
        try:
            res = _serve(engine, mix, prompt)
        except Exception as exc:           # counted, and the run is wrong
            record.failed += 1
            record.notes["error"] = repr(exc)[:500]
            break
        done = time.perf_counter()
        record.requests.append({"due": due - t0, "start": start - t0,
                                "done": done - t0, "seqs": prompt.shape[0],
                                "tokens": prompt.numel(), "index": i,
                                "flops": flops(cfg, *prompt.shape)})
        if traced:
            record.requests[-1]["prefill_s"] = probe.stamps["prefill"][k]
        served.append((i, res.tokens[:, 0], res.logits))
    window = max(seconds, max((r["done"] for r in record.requests),
                              default=0.0))
    return served, window


def _traced_segment(engine, mix, warm, cell, device, probe, record):
    """Back-to-back requests traced twice: the card alone, then the host
    and the card with the benchmark's ranges and host syncs counted."""
    out = os.path.join(harness.ROOT, "portbench", "out")
    os.makedirs(out, exist_ok=True)
    prompts = [warm[i % len(warm)] for i in range(mix["trace_requests"])]
    with tr.profiled(os.path.join(out, f"{cell.name}.device.json"), device,
                     host=False) as held:
        for p in prompts:
            _serve(engine, mix, p)
    record.trace = held.trace
    with probe.sync_debug(), tr.profiled(
            os.path.join(out, f"{cell.name}.host.json"), device,
            host=True) as held:
        for p in prompts:
            with torch.profiler.record_function("portbench.generate"):
                _serve(engine, mix, p)
    record.host_trace = held.trace


def _peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated())


def _check(cell, record, served, prompts, w, seed, device):
    """The sample's served tokens and logits against the reference's."""
    cfg, mix = cell.config, cell.traffic
    ref = harness.load_module("reference", cfg["family"])
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    k = min(mix["check_requests"], len(served))
    if k == 0:
        return
    pick = random.Random(seeds.derive(seed, "check")).sample(
        range(len(served)), k)
    rows = []
    for j in pick:
        i, tokens, logits = served[j]
        r = ref.last_logits(cfg, w, prompts[i], block=mix["check_block"])
        rows.append(compare.served_rows(r, logits, tokens,
                                        cfg["vocab_size"]))
    readings = compare.served(torch.cat([g for g, _ in rows]),
                              torch.cat([e for _, e in rows]))
    record.checks = [(name, readings[name], cell.limits[name])
                     for name in sorted(readings) if name in cell.limits]
    record.notes["readings"] = readings
    record.notes["check_s"] = time.perf_counter() - t0
    record.notes["checked_requests"] = k

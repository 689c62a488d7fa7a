"""Training cells: the port's train step over a seeded batch stream.

Set-up builds one train state (the benchmark's weights mapped onto the
port's tree, AdamW's state) and one step, ``repro_torch.train.step.
make_train_step`` as ``repro_torch.launch.train`` builds it on one
device, and drives that same state through the mix's first
``checked_steps`` steps, each through the step the window calls, on
rows that all differ; they are the warm-up too.  After the first, the
first clipped gradient is read back from AdamW's first moment
(``m / (1 - beta1)``); after the last, each leaf's change from the
seed's weights, made again.  The window then runs steps until its
nominal end, each read back (its loss, as a training loop logs it); it
closes at the end of the last step started before the nominal end.

The traced run adds, after the window, ``trace_steps`` steps under the
profiler, with ranges around the step and ``adamw_update`` and host
syncs counted in the step.

The check runs the plain reference's steps from the seed's weights on
the same batches once the program's state is freed.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

from portbench import compare, generator, harness
from portbench import trace as tr


def _train_config(mix: dict):
    from repro_torch.configs.base import TrainConfig
    o = mix["optimizer"]
    return TrainConfig(learning_rate=o["learning_rate"],
                       warmup_steps=o["warmup_steps"],
                       total_steps=o["total_steps"],
                       weight_decay=o["weight_decay"], beta1=o["beta1"],
                       beta2=o["beta2"], eps=o["eps"],
                       grad_clip=o["grad_clip"],
                       microbatches=mix["microbatches"], remat=mix["remat"],
                       loss_chunk=mix["loss_chunk"])


def _norms(tree: dict) -> dict:
    out = {}
    for name, t in tree.items():
        out.update(compare.leaf_norms(name, t, name.startswith("layers.")))
    return out


def run(cell, *, seed, seconds, trace: bool, device, t_start, program_ctx):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train import step as step_mod

    cfg, mix = cell.config, cell.traffic
    record = harness.RunRecord(kind="train", config=cfg, traffic=mix)
    weights = harness.load_module("weights", cfg["family"])
    adapter = harness.load_module("adapters", cfg["family"])
    flops_mod = harness.load_module("work", cfg["family"])
    probe = tr.Probe(device)
    tokens_a_step = mix["batch"] * mix["seq_len"]
    flops_a_step = flops_mod.train_flops(cfg, mix["batch"], mix["seq_len"])
    n_checked = mix["checked_steps"]
    batches = generator.train_batches(mix, seed, mix["batch_pool"],
                                      cfg["vocab_size"], device)
    prog = {"loss": []}
    ctx = program_ctx() if program_ctx else contextlib.nullcontext()
    with ctx:
        w = weights.make(cfg, seed, device)
        pc = adapter.port_config(cfg)
        params = adapter.port_params(cfg, w)
        del w
        rules = make_rules(pc, make_host_mesh(1, 1),
                           global_batch=mix["batch"], shape_kind="train")
        state = {"params": params, "opt": adamw.init_opt_state(params)}
        step = step_mod.make_train_step(pc, rules, _train_config(mix),
                                        microbatches=mix["microbatches"])
        for t in range(n_checked):
            state, metrics = step(state, *batches[t])
            prog["loss"].append(float(metrics["loss"]))
            if t == 0:
                b1 = mix["optimizer"]["beta1"]
                prog["grad"] = {k: v / (1 - b1) for k, v in _norms(
                    adapter.canonical(state["opt"].m)).items()}
        w0 = weights.make(cfg, seed, device)
        now = adapter.canonical(state["params"])
        prog["change"] = _norms({k: now[k].float() - v.float()
                                 for k, v in adapter.flat(w0).items()})
        del w0, now
        tr.sync(device)
        record.setup_s = time.perf_counter() - t_start

        t0 = time.perf_counter()
        end = t0 + seconds
        i = n_checked
        while time.perf_counter() < end:
            start = time.perf_counter()
            record.attempted += 1
            try:
                state, metrics = step(state, *batches[i % len(batches)])
                loss = float(metrics["loss"])
            except Exception as exc:        # counted, and the run is wrong
                record.failed += 1
                record.notes["error"] = repr(exc)[:500]
                break
            if loss != loss:
                record.failed += 1
            record.steps.append({"start": start - t0,
                                 "done": time.perf_counter() - t0,
                                 "tokens": tokens_a_step,
                                 "flops": flops_a_step})
            i += 1
        record.window_s = max(seconds, max((s["done"] for s in record.steps),
                                           default=0.0))
        if trace:
            state = _traced_steps(cell, device, probe, step, state, batches,
                                  i, record)
            record.counts = dict(probe.syncs)
        record.memory_peak_bytes = (
            int(torch.cuda.max_memory_allocated())
            if torch.device(device).type == "cuda" else 0)
        del state, step, params, metrics
    _check(cell, record, prog, batches[:n_checked], seed, device)
    return record


def _traced_steps(cell, device, probe, step, state, batches, i, record):
    """Steps traced twice: the card alone, then the host and the card
    with the benchmark's ranges and host syncs counted."""
    from repro_torch.optim import adamw
    mix = cell.traffic
    out = os.path.join(harness.ROOT, "portbench", "out")
    os.makedirs(out, exist_ok=True)
    with tr.profiled(os.path.join(out, f"{cell.name}.device.json"), device,
                     host=False) as held:
        for j in range(mix["trace_steps"]):
            state, metrics = step(state, *batches[(i + j) % len(batches)])
            float(metrics["loss"])
    record.trace = held.trace
    timed = probe.wrap(step, "step", syncs=True)
    patches = [(adamw, "adamw_update",
                probe.wrap(adamw.adamw_update, "adamw_update"))]
    with tr.instrument(patches), probe.sync_debug(), tr.profiled(
            os.path.join(out, f"{cell.name}.host.json"), device,
            host=True) as held:
        for j in range(mix["trace_steps"]):
            state, metrics = timed(state, *batches[(i + j) % len(batches)])
            float(metrics["loss"])
    record.host_trace = held.trace
    return state


def _check(cell, record, prog, batches, seed, device):
    cfg, mix = cell.config, cell.traffic
    weights = harness.load_module("weights", cfg["family"])
    ref = harness.load_module("reference", cfg["family"])
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    w0 = weights.make(cfg, seed, device)
    r = ref.train(cfg, w0, batches, mix["optimizer"], steps=len(batches),
                  block=mix["check_block"])
    readings = compare.training(prog, r)
    record.checks = [(k, v, cell.limits[k]) for k, v in
                     sorted(readings.items()) if k in cell.limits]
    record.notes["readings"] = readings
    record.notes["check_s"] = time.perf_counter() - t0
    record.notes["loss"] = {"program": prog["loss"], "reference": r["loss"]}

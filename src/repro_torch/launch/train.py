"""End-to-end training entry point.

The port of ``repro/launch/train.py``: config -> mesh -> sharding rules
-> data pipeline -> microbatched train step (remat, chunked CE, AdamW,
ZeRO-1, optional int8-EF compression; attention through the flash kernel
and its backward kernel) -> resilient loop (checkpoint/restart, straggler
monitor), with the MEMSCOPE placement advisory for the optimizer state.
Runs on the card unless ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --reduced --steps 50 --batch 8 --seq 128 --device cpu

On several processes the mesh comes from the process group, ``nccl`` for
``--device cuda`` (one card a rank) and ``gloo`` for ``--device cpu``;
the state is sharded by ``state_specs`` and the batch by
``batch_specs``.  The opening line's ``model_axis`` says how the step
uses the model axis (``step.model_split``): ``arithmetic`` (every
family: each rank its share of the heads, MLP columns, experts and SSM
heads on its blocks) or ``none``::

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen2-1.5b --reduced --data 2 --model 2 --device cpu

A group made by the caller (``parallel.collectives.setup``) is used as it
is; one made from ``torchrun``'s environment here is destroyed at the end.
:func:`run` does the work and returns what it made (:class:`TrainRun`);
:func:`main` runs it and prints the reference's lines, on rank 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Dict, List

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.compat import resolve_device
from repro_torch.configs.base import (ModelConfig, ShapeSpec, TrainConfig,
                                      get_config)
from repro_torch.core.characterize import characterize
from repro_torch.core.coordinator import CoreCoordinator
from repro_torch.core.placement import (ContentionSpec, PlacementAdvisor,
                                        optimizer_state_object,
                                        params_object)
from repro_torch.data.pipeline import DataLoader
from repro_torch.launch.mesh import Mesh, describe, make_host_mesh
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import ShardingRules, make_rules
from repro_torch.runtime.fault_tolerance import (LoopResult, ResilientLoop,
                                                 StragglerMonitor, drill_at)
from repro_torch.train import step as step_mod


def advise_placement(cfg: ModelConfig, tcfg: TrainConfig,
                     verbose: bool = True, device="cuda"):
    """MEMSCOPE loop: characterize -> advise where optimizer state lives.

    The curve DB comes from the contention simulator (``simulate``), as in
    the reference, and the advisor solves the placement problem; the plan
    is advisory (the step keeps its state in device memory)."""
    coord = CoreCoordinator(backend="simulate", device=device)
    db = characterize(coord, pools=["hbm", "host"],
                      obs_strategies=("r", "l"),
                      stress_strategies=("w",), iters=10)
    advisor = PlacementAdvisor(db, coord.platform)
    n_params = cfg.n_params()
    objs = [
        params_object("params", 2 * n_params, reads_per_step=2.0),
        optimizer_state_object("opt_m", 4 * n_params),
        optimizer_state_object("opt_v", 4 * n_params),
    ]
    plan = advisor.advise(objs, ContentionSpec(n_stressors=0))
    if verbose:
        print("[memscope] placement plan:")
        print(plan.report())
    return plan


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="layer", choices=["none", "layer"])
    ap.add_argument("--no-zero1", action="store_true",
                    help="keep whole moments on every rank of the data "
                         "axis")
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--no-checkpoint", action="store_true",
                    help="write no checkpoint (a state too large for the "
                         "disk); a fault then restarts from the state as "
                         "it is")
    ap.add_argument("--inject-fault-at", type=int, default=-1,
                    help="raise InjectedFault at this step once (drill)")
    ap.add_argument("--no-advice", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def build(args):
    """(cfg, mesh, shape, rules, tcfg) from :func:`parser`'s arguments."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = make_host_mesh(args.data, args.model)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    rules = make_rules(cfg, mesh, global_batch=args.batch,
                       shape_kind="train")
    tcfg = TrainConfig(
        learning_rate=args.lr, total_steps=args.steps,
        warmup_steps=max(1, args.steps // 10),
        microbatches=args.microbatches, remat=args.remat,
        zero1=not args.no_zero1, grad_compression=args.compression,
        loss_chunk=min(1024, args.seq), seed=args.seed,
        checkpoint_every=args.checkpoint_every)
    return cfg, mesh, shape, rules, tcfg


@dataclass
class TrainRun:
    """What one :func:`run` made and measured."""
    cfg: ModelConfig
    mesh: Mesh
    rules: ShardingRules
    shape: ShapeSpec
    tcfg: TrainConfig
    device: torch.device
    result: LoopResult
    state: Dict[str, Any]           # the final state
    seconds: float                  # the loop, from its start to its end
    step_seconds: List[float] = dataclasses.field(default_factory=list)
    # the state's placement on a bound mesh (``state`` holds this rank's
    # blocks), None on one device
    shardings: Any = None

    @property
    def rank0(self) -> bool:
        return not self.mesh.bound or self.mesh.rank == 0


def run(argv=None, verbose: bool = True) -> TrainRun:
    """Train as ``main`` would and return what was made; ``verbose`` prints
    the reference's opening lines and the placement plan (on rank 0)."""
    args = parser().parse_args(argv)
    created = False
    if (not collectives.initialized()
            and int(os.environ.get("WORLD_SIZE", "1")) > 1):
        created = collectives.setup("nccl" if args.device == "cuda"
                                    else "gloo")
    try:
        return _run(args, verbose)
    finally:
        if created:
            collectives.teardown()


def _run(args, verbose: bool) -> TrainRun:
    if collectives.initialized():
        want = "nccl" if args.device == "cuda" else "gloo"
        have = torch.distributed.get_backend()
        if have != want:
            raise ValueError(f"--device {args.device} takes a {want} "
                             f"process group; this one is {have}")
    device = resolve_device(args.device)
    cfg, mesh, shape, rules, tcfg = build(args)
    world = (torch.distributed.get_world_size()
             if collectives.initialized() else 1)
    if mesh.size != world:
        raise ValueError(f"a mesh of {describe(mesh)} over a world of "
                         f"{world} ranks: --data x --model must use them all")
    rank0 = not mesh.bound or mesh.rank == 0
    if verbose and rank0:
        print(f"[train] arch={cfg.name} params={cfg.n_params() / 1e6:.1f}M "
              f"mesh={describe(mesh)} "
              f"model_axis={step_mod.model_split(cfg, rules)} "
              f"steps={args.steps} batch={args.batch}x{args.seq} "
              f"device={device}")
    if not args.no_advice:
        advise_placement(cfg, tcfg, verbose=verbose and rank0, device=device)

    gen = torch.Generator(device=device).manual_seed(tcfg.seed)
    state = step_mod.init_state(cfg, tcfg, gen)
    shardings = None
    if mesh.bound:
        struct = step_mod.state_struct(cfg, tcfg)
        specs = step_mod.state_specs(cfg, rules, tcfg, struct["params"])
        shardings = collectives.shardings_of(mesh, specs, struct)
        state = collectives.shard_tree(state, shardings)
    loader = DataLoader(cfg, shape, mesh=mesh, device=device, seed=tcfg.seed)
    step_fn = step_mod.make_train_step(cfg, rules, tcfg,
                                       microbatches=tcfg.microbatches)

    def wrapped_step(state, batch):
        return step_fn(state, batch.tokens, batch.labels, batch.frontend)

    ckpt = (None if args.no_checkpoint else
            CheckpointManager(args.ckpt_dir, keep=tcfg.keep_checkpoints,
                              shardings=shardings))
    monitor = StragglerMonitor()
    loop = ResilientLoop(
        wrapped_step, loader.device_batch, ckpt,
        checkpoint_every=tcfg.checkpoint_every,
        faults=None,  # resolve REPRO_FAULT_SPEC like the sweep dispatcher
        fault_hook=(drill_at(args.inject_fault_at)
                    if args.inject_fault_at >= 0 else None),
        monitor=monitor)
    t0 = time.perf_counter()
    result = loop.run(state, args.steps)
    seconds = time.perf_counter() - t0
    return TrainRun(cfg, mesh, rules, shape, tcfg, device, result,
                    result.state, seconds, list(monitor.times), shardings)


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    r = run(argv)
    if not r.rank0:
        return 0
    toks = args.steps * r.shape.tokens
    hist = r.result.metrics_history
    for i, m in enumerate(hist):
        if i % args.log_every == 0 or i == len(hist) - 1:
            print(f"  step {i:5d} loss={m.get('loss', float('nan')):.4f} "
                  f"gnorm={m.get('grad_norm', float('nan')):.3f}")
    print(f"[train] done: {r.result.final_step} steps in {r.seconds:.1f}s "
          f"({toks / r.seconds:.0f} tok/s), restarts={r.result.restarts}, "
          f"stragglers={len(r.result.straggler_events)}")
    first = next((m["loss"] for m in hist if "loss" in m), float("nan"))
    last = next((m["loss"] for m in reversed(hist) if "loss" in m),
                float("nan"))
    print(f"[train] loss {first:.4f} -> {last:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

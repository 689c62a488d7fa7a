"""The multi-pod dry-run: one rank's share of every (architecture x input
shape) cell on the production meshes, at full width and depth, with
nothing allocated.

The port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
every cell for 256 or 512 forced host devices, the 16x16 pod and the
2x16x16 pair of pods, and reads the roofline's inputs and the memory a
device needs from the compiled program.  The port has no compiler, so a
cell's "lowering" is the rank's own call: its share of the cell's train
step, prefill or decode (``train.step.make_train_step``,
``serve.engine.make_prefill_step`` / ``make_decode_step``), built on the
rank's blocks of the state or the parameters and caches as ``meta``
tensors, on the production mesh bound through a process group on torch's
``fake`` backend (``collectives.setup_dry``), whose collectives move no
data.  :func:`analyze_cell` runs that call once under the cost counter
(:mod:`repro_torch.analysis.cost`) and the memory tracker
(:mod:`repro_torch.analysis.memory`).  Nothing is allocated and no card is
needed; the dry-run never calls ``torch.cuda``.

Its figures model the H100 the port runs on, not the host: the roofline
terms take the H100's constants (:mod:`repro_torch.analysis.roofline`);
attention is charged as the work of the kernel instance the card would
launch (``flash_attention.INSTANCE`` / ``BWD_INSTANCE``, whose ``meta``
route also raises where the card's kernel would refuse the call); a MoE
layer routes in balance (``moe.balanced_sizes``; the record's
``"moe_routing": "balanced"``), since ``meta`` tensors hold no values.

``memory_analysis`` keeps the reference's keys, with these meanings:
``argument_size_in_bytes`` the rank's argument blocks (state or
parameters, caches, inputs); ``output_size_in_bytes`` the outputs'
storages; ``alias_size_in_bytes`` the outputs that are arguments updated
in place (the train state; the decode caches); ``temp_size_in_bytes`` the
peak of live bytes over the call less the arguments and the outputs that
are not aliases; ``generated_code_size_in_bytes`` 0.  So
``bytes_per_device`` (arguments + temporaries + outputs - aliases) is the
peak of live bytes over the call, the arguments included.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b \\
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   (every cell)
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.analysis import cost as cost_mod
from repro_torch.analysis import memory, roofline
from repro_torch.configs import ALL_ARCHS
from repro_torch.configs.base import (SHAPES, MeshConfig, ModelConfig,
                                      ShapeSpec, TrainConfig,
                                      default_microbatches, get_config)
from repro_torch.launch.mesh import describe, make_production_mesh
from repro_torch.models import lm
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import P, make_rules, mesh_axis_size
from repro_torch.serve import engine as serve_engine
from repro_torch.train import step as train_step_mod

DEFAULT_OUT = "experiments/dryrun_torch"
#: the keys of the reference's record of every cell, and those its train
#: cells add; the port's record holds them all
RECORD_KEYS = ("arch", "shape", "mesh", "multi_pod", "n_devices",
               "t_lower_s", "t_compile_s", "memory_analysis",
               "bytes_per_device", "xla_cost", "hlo_flops", "hlo_bytes",
               "movement_bytes", "collective_bytes", "collective_by_kind",
               "while_trips", "unknown_trip_whiles", "t_compute", "t_memory",
               "t_collective", "bottleneck", "model_flops", "useful_ratio",
               "roofline_fraction", "t_bound")
TRAIN_KEYS = ("microbatches", "loss_chunk", "remat", "zero1")


# ---------------------------------------------------------------------------
# input_specs: ``meta`` stand-ins for every model input
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def frontend_specs(cfg: ModelConfig, batch: int, seq: int,
                   kind: str) -> Optional[Dict[str, torch.Tensor]]:
    """Stub modality frontends: precomputed frame/patch embeddings."""
    if cfg.frontend == "audio":
        s = 1 if kind == "decode" else seq
        return {"frame_embeds": _meta((batch, s, cfg.d_model), torch.float32)}
    if cfg.frontend == "vlm" and kind != "decode":
        return {"prefix_embeds": _meta((batch, cfg.n_prefix_embeds,
                                        cfg.d_model), torch.float32)}
    return None


def input_specs(arch: str, shape_name: str) -> Dict[str, Any]:
    """Every model input for one cell, whole, as ``meta`` tensors (the
    decode step's ``write_pos`` is the last position of the cache)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        # two tensors: the reference's tokens and labels are two arguments
        return {"tokens": _meta((b, s), torch.int32),
                "labels": _meta((b, s), torch.int32),
                "frontend": frontend_specs(cfg, b, s, "train")}
    if shape.kind == "prefill":
        return {"tokens": _meta((b, s), torch.int32),
                "frontend": frontend_specs(cfg, b, s, "prefill")}
    # decode: one new token against a seq_len KV cache
    return {"token": _meta((b, 1), torch.int32),
            "caches": lm.cache_struct(cfg, b, s),
            "write_pos": s - 1,
            "frontend": frontend_specs(cfg, b, 1, "decode")}


# ---------------------------------------------------------------------------
# Per-cell training configuration (activation-residency knobs)
# ---------------------------------------------------------------------------


def pick_loss_chunk(cfg: ModelConfig, shape: ShapeSpec, mesh) -> int:
    """Bound the per-device logits chunk to ~256 MiB f32."""
    dp = 1
    for a in ("pod", "data"):
        dp *= mesh_axis_size(mesh, a)
    tp = mesh_axis_size(mesh, "model")
    b_dev = max(1, shape.global_batch // dp)
    v_dev = cfg.padded_vocab // tp if cfg.padded_vocab % tp == 0 \
        else cfg.padded_vocab
    budget = 256 << 20
    chunk = budget // max(1, b_dev * v_dev * 4)
    chunk = max(128, min(1024, (chunk // 128) * 128 or 128))
    return min(chunk, shape.seq_len)


def cell_train_config(cfg: ModelConfig, shape: ShapeSpec, mesh,
                      mesh_cfg: MeshConfig, *,
                      overrides: Optional[dict] = None) -> TrainConfig:
    tc = TrainConfig(
        microbatches=default_microbatches(cfg, shape, mesh_cfg),
        loss_chunk=pick_loss_chunk(cfg, shape, mesh),
        remat="layer", zero1=True)
    if overrides:
        tc = dataclasses.replace(tc, **overrides)
    return tc


# ---------------------------------------------------------------------------
# Cell lowering: the rank's call on ``meta`` blocks
# ---------------------------------------------------------------------------


def _dry_group(rank: int, world_size: int) -> None:
    """The process's ``fake`` group as ``rank`` of ``world_size``: the
    existing one, a new one in place of another dry-run's, or an error
    where a group of another backend exists."""
    if collectives.initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("lower_cell: a process group of another "
                               "backend exists; the dry-run binds its own")
        if (dist.get_rank(), dist.get_world_size()) == (rank, world_size):
            return
        collectives.teardown()
    collectives.setup_dry(rank, world_size)


def _rows(rules, mesh, x):
    """The rank's rows of a whole input (rows over the batch axes)."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _rows(rules, mesh, v) for k, v in x.items()}
    sl = collectives.block_slices((x.shape[0],), P(rules.batch or None),
                                  mesh)[0]
    return x if sl == slice(None) else x[sl].clone()


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               train_overrides: Optional[dict] = None, q_chunk: int = 256,
               rank: int = 0):
    """Build one cell's call for ``rank`` of the production mesh.  Returns
    (the call, its arguments as ``meta`` tensors, meta): ``t_lower_s`` is
    the build's seconds, ``t_compile_s`` 0 (nothing compiles).  Makes the
    process's ``fake`` group (``collectives.setup_dry``) if it has none;
    ``collectives.teardown()`` ends it."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        raise SystemExit(
            f"{arch} is pure full-attention: long_500k is skipped by "
            f"design (DESIGN.md §Arch-applicability)")
    t0 = time.time()
    desc = make_production_mesh(multi_pod=multi_pod)
    _dry_group(rank, desc.size)
    mesh = collectives.bind(desc)
    mesh_cfg = MeshConfig(pods=2 if multi_pod else 1)
    rules = make_rules(cfg, mesh, global_batch=shape.global_batch,
                       shape_kind=shape.kind)
    specs = input_specs(arch, shape_name)

    if shape.kind == "train":
        tcfg = cell_train_config(cfg, shape, mesh, mesh_cfg,
                                 overrides=train_overrides)
        struct = train_step_mod.state_struct(cfg, tcfg)
        sspecs = train_step_mod.state_specs(cfg, rules, tcfg,
                                            struct["params"])
        state = collectives.shard_tree(
            struct, collectives.shardings_of(mesh, sspecs, struct))
        fn = train_step_mod.make_train_step(
            cfg, rules, tcfg, microbatches=tcfg.microbatches)
        args = (state, _rows(rules, mesh, specs["tokens"]),
                _rows(rules, mesh, specs["labels"]),
                _rows(rules, mesh, specs["frontend"]))
        meta_extra = {"microbatches": tcfg.microbatches,
                      "loss_chunk": tcfg.loss_chunk,
                      "remat": tcfg.remat, "zero1": tcfg.zero1}
    else:
        params = serve_engine.rank_params(cfg, rules, lm.param_struct(cfg))
        fe = _rows(rules, mesh, specs["frontend"])
        if shape.kind == "prefill":
            fn = serve_engine.make_prefill_step(
                cfg, rules, max_len=shape.seq_len, q_chunk=q_chunk)
            args = (params, _rows(rules, mesh, specs["tokens"]), fe)
        else:  # decode
            fn = serve_engine.make_decode_step(cfg, rules)
            caches = lm.rank_cache_struct(cfg, shape.global_batch,
                                          shape.seq_len, torch.bfloat16,
                                          rules)
            args = (params, caches, _rows(rules, mesh, specs["token"]),
                    specs["write_pos"], fe)
        meta_extra = {"q_chunk": q_chunk}
    if cfg.moe is not None:
        meta_extra["moe_routing"] = "balanced"

    meta = {"arch": arch, "shape": shape_name,
            "mesh": describe(mesh), "multi_pod": multi_pod,
            "n_devices": mesh.size, "rank": rank,
            "t_lower_s": round(time.time() - t0, 1),
            "t_compile_s": 0.0, **meta_extra}
    return fn, args, meta


def _collective_ops(c: cost_mod.Cost) -> list:
    """[kind, bytes a call, group size, calls] for each distinct
    collective, sorted."""
    n: Dict[tuple, int] = {}
    for op in c.collectives:
        key = (op.kind, op.bytes_per_call, op.group_size)
        n[key] = n.get(key, 0) + op.trips
    return [[*k, v] for k, v in sorted(n.items())]


def analyze_cell(fn, args, meta, cfg: ModelConfig,
                 shape: ShapeSpec) -> Dict[str, Any]:
    """Runs the cell's call once under the cost counter and the memory
    tracker, on whatever device its arguments lie on (``meta`` for the
    dry-run), and returns its record: every key of the reference's, and
    the kernels' counted work and the collectives by kind, size and
    group."""
    devices = cost_mod.devices_of(args)
    with memory.MemoryTracker(devices) as tracker:
        arg_bytes = tracker.track_external(args)
        with cost_mod.CostCounter(devices=devices) as counter:
            out = fn(*args)
        peak = tracker.peak
    arg_keys = memory.storage_bytes(args, devices=devices)
    outs = memory.storage_bytes(out, devices=devices)
    del out
    out_bytes = sum(outs.values())
    alias = sum(n for k, n in outs.items() if k in arg_keys)
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": out_bytes,
           "temp_size_in_bytes": peak - arg_bytes - (out_bytes - alias),
           "alias_size_in_bytes": alias,
           "generated_code_size_in_bytes": 0}
    bytes_per_device = (mem["argument_size_in_bytes"]
                        + mem["temp_size_in_bytes"]
                        + mem["output_size_in_bytes"]
                        - mem["alias_size_in_bytes"])
    c = counter.cost
    terms = roofline.compute_terms(
        c, cfg=cfg, shape=shape, mesh_desc=meta["mesh"],
        n_devices=meta["n_devices"], bytes_per_device=bytes_per_device)
    rec = dict(meta)
    rec.update(
        device=",".join(sorted(str(d) for d in devices or ())),
        memory_analysis=mem,
        bytes_per_device=bytes_per_device,
        xla_cost={"flops": c.flops, "bytes accessed": c.bytes},
        hlo_flops=c.flops,
        hlo_bytes=c.bytes,
        movement_bytes=c.movement_bytes,
        collective_bytes=c.collective_bytes,
        collective_by_kind=c.collective_summary(),
        collective_ops=_collective_ops(c),
        kernels=c.kernels,
        while_trips=c.while_trips,
        unknown_trip_whiles=c.unknown_trip_whiles,
        t_compute=terms.t_compute,
        t_memory=terms.t_memory,
        t_collective=terms.t_collective,
        bottleneck=terms.bottleneck,
        model_flops=terms.model_flops,
        useful_ratio=terms.useful_ratio,
        roofline_fraction=terms.roofline_fraction,
        t_bound=terms.t_bound,
    )
    return rec


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: str, verbose: bool = True,
             train_overrides: Optional[dict] = None) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    fn, args, meta = lower_cell(arch, shape_name, multi_pod=multi_pod,
                                train_overrides=train_overrides)
    t0 = time.time()
    rec = analyze_cell(fn, args, meta, cfg, shape)
    rec["t_analyze_s"] = round(time.time() - t0, 1)
    os.makedirs(out_dir, exist_ok=True)
    tag = "multipod" if multi_pod else "pod"
    path = os.path.join(out_dir,
                        f"{arch}_{shape_name}_{tag}.json".replace("/", "-"))
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if verbose:
        ma = rec["memory_analysis"]
        print(f"[dryrun] {arch} {shape_name} {rec['mesh']}: "
              f"build {rec['t_lower_s']}s run {rec['t_analyze_s']}s  "
              f"mem/dev={rec['bytes_per_device'] / 2**30:.2f} GiB "
              f"(args {ma['argument_size_in_bytes'] / 2**30:.2f} "
              f"temp {ma['temp_size_in_bytes'] / 2**30:.2f})")
        print(f"  flops/dev={rec['hlo_flops']:.3e} "
              f"bytes/dev={rec['hlo_bytes']:.3e} "
              f"coll/dev={rec['collective_bytes']:.3e} "
              f"{rec['collective_by_kind']}")
        print(f"  C={rec['t_compute'] * 1e3:.2f}ms "
              f"M={rec['t_memory'] * 1e3:.2f}ms "
              f"X={rec['t_collective'] * 1e3:.2f}ms -> {rec['bottleneck']} "
              f"useful={rec['useful_ratio']:.3f} "
              f"roofline={rec['roofline_fraction']:.3f}")
    del fn, args
    gc.collect()
    return rec


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------


def all_cells():
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        for shape_name in cfg.shapes():
            yield arch, shape_name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="multi-pod dry-run (one rank's call on meta tensors, "
                    "no allocation)")
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--all", action="store_true",
                    help="run every cell (subprocess per cell)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for arch, shape in all_cells():
            print(arch, shape)
        return 0

    if args.all:
        os.makedirs(args.out, exist_ok=True)
        failures = []
        for arch, shape in all_cells():
            for mesh_kind in ("pod", "multipod"):
                tag = f"{arch}_{shape}_{mesh_kind}".replace("/", "-")
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {tag}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape,
                       "--mesh", mesh_kind, "--out", args.out]
                print(f"[run ] {tag}", flush=True)
                r = subprocess.run(cmd, stderr=subprocess.PIPE, text=True)
                sys.stderr.write(r.stderr)
                if r.returncode != 0:
                    failures.append(tag)
                    # the reason beside the record, for the table
                    lines = [ln for ln in r.stderr.splitlines()
                             if ln.strip()]
                    with open(os.path.join(args.out, tag + ".error"),
                              "w") as f:
                        f.write((lines[-1].strip() if lines else
                                 f"exit {r.returncode}") + "\n")
        if failures:
            print("FAILED cells:", failures)
            return 1
        print("all cells OK")
        return 0

    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all / --list)")
    try:
        run_cell(args.arch, args.shape, multi_pod=(args.mesh == "multipod"),
                 out_dir=args.out)
    finally:
        collectives.teardown()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Serving entry point: batched prefill+decode, MEMSCOPE-placed KV cache.

The port of ``repro/launch/serve.py``: characterize the memory pools (on
the ``simulate`` backend, as the reference does), let the placement
advisor place the KV cache, then serve random prompts on random weights
made from ``--seed``.  Runs on the card unless ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --reduced --batch 4 --prompt-len 32 --new-tokens 32 --device cpu

On a mesh, one process a rank: ``torchrun`` (or a caller's own
:func:`repro_torch.parallel.collectives.setup`) gives the process group,
``gloo`` with ``--device cpu`` and ``nccl`` on the cards, and ``--data`` x
``--model`` must use the whole world::

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch qwen2-1.5b --reduced --data 2 --model 2 --device cpu

Every rank serves its rows with its blocks of the weights and the cache
(:class:`repro_torch.serve.engine.ServeEngine`), and rank 0 prints.  A
model axis of more than one rank splits every family: attention heads,
MLP columns, experts and SSM heads.

:func:`run` does the work and returns what it made (:class:`ServeRun`);
:func:`main` runs it and prints the reference's lines.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs.base import ModelConfig, ServeConfig, get_config
from repro_torch.core.characterize import characterize
from repro_torch.core.coordinator import CoreCoordinator
from repro_torch.core.placement import PlacementAdvisor
from repro_torch.launch.mesh import Mesh, describe, make_host_mesh
from repro_torch.models import lm
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import make_rules
from repro_torch.serve.engine import GenerateResult, ServeEngine, cache_bytes


@dataclass
class ServeRun:
    """What one :func:`run` made and measured."""
    cfg: ModelConfig
    mesh: Mesh
    engine: ServeEngine
    prompts: torch.Tensor
    frontend: Optional[Dict[str, torch.Tensor]]
    result: GenerateResult
    kv_bytes: int
    seconds: float              # generate, from the call to a synchronise

    @property
    def rank0(self) -> bool:
        return not self.mesh.bound or self.mesh.rank == 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--kv-placement", default="auto",
                    choices=["auto", "hbm", "host"])
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def make_inputs(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
                device: torch.device):
    """Prompts (and the frontend's stub embeddings) from ``seed``."""
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len))).to(device)
    frontend: Optional[Dict[str, Any]] = None
    if cfg.frontend == "vlm":
        frontend = {"prefix_embeds": rng.standard_normal(
            (batch, cfg.n_prefix_embeds, cfg.d_model), dtype=np.float32)}
    elif cfg.frontend == "audio":
        frontend = {"frame_embeds": rng.standard_normal(
            (batch, prompt_len, cfg.d_model), dtype=np.float32)}
    if frontend is not None:
        frontend = {k: torch.from_numpy(v * 0.02).to(device)
                    for k, v in frontend.items()}
    return prompts, frontend


def run(argv=None) -> ServeRun:
    """Serve as ``main`` would; under ``torchrun`` (``WORLD_SIZE`` > 1)
    it makes the process group and destroys it after."""
    args = parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    created = False
    if (not collectives.initialized()
            and int(os.environ.get("WORLD_SIZE", "1")) > 1):
        created = collectives.setup("nccl" if args.device == "cuda"
                                    else "gloo")
    try:
        return serve(cfg, args)
    finally:
        if created:
            collectives.teardown()


def serve(cfg: ModelConfig, args: argparse.Namespace) -> ServeRun:
    """Serve ``cfg`` with the batch, lengths, placement, mesh, seed and
    device of ``args`` (:func:`parser`'s); ``--arch`` and ``--reduced``
    chose ``cfg`` in :func:`run` and are not read here."""
    if collectives.initialized():
        want = "nccl" if args.device == "cuda" else "gloo"
        have = torch.distributed.get_backend()
        if have != want:
            raise ValueError(f"--device {args.device} takes a {want} "
                             f"process group; this one is {have}")
    device = resolve_device(args.device)
    mesh = make_host_mesh(args.data, args.model)
    world = (torch.distributed.get_world_size()
             if collectives.initialized() else 1)
    if mesh.size != world:
        raise ValueError(f"a mesh of {describe(mesh)} over a world of "
                         f"{world} ranks: --data x --model must use them all")
    rules = make_rules(cfg, mesh, global_batch=args.batch,
                       shape_kind="decode")

    # MEMSCOPE: characterize, then let the advisor place the KV cache
    coord = CoreCoordinator(backend="simulate", device=device)
    db = characterize(coord, pools=["hbm", "host"],
                      obs_strategies=("r", "l"), stress_strategies=("w",),
                      iters=10)
    advisor = PlacementAdvisor(db, coord.platform)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init_params(cfg, gen)
    engine = ServeEngine(cfg, params, rules,
                         ServeConfig(kv_placement=args.kv_placement),
                         advisor=advisor, pool_mgr=coord.pools)
    prompts, frontend = make_inputs(cfg, args.batch, args.prompt_len,
                                    args.seed, device)

    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=args.new_tokens,
                          temperature=args.temperature, seed=args.seed,
                          frontend=frontend)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    return ServeRun(cfg, mesh, engine, prompts, frontend, out,
                    cache_bytes(cfg, args.batch,
                                args.prompt_len + args.new_tokens),
                    seconds)


def main(argv=None) -> int:
    r = run(argv)
    if not r.rank0:
        return 0
    total_new = r.result.tokens.numel()
    print(f"[serve] arch={r.cfg.name} mesh={describe(r.mesh)} "
          f"kv_cache={r.kv_bytes / 2**20:.2f} MiB "
          f"device={r.engine.device}")
    print(f"[serve] kv_pool={r.result.kv_pool} "
          f"{total_new} tokens in {r.seconds:.2f}s "
          f"({total_new / r.seconds:.1f} tok/s incl. prefill)")
    print(f"[serve] sample: {r.result.tokens[0, :16].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

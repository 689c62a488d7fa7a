"""Seeds for each stream a run draws from, derived from ``--seed``.

Every stream (weights, prompts, batches) has its own generator, seeded by
a hash of the run's seed and the stream's name, so that adding a stream
never shifts another's draws.  A seed is any whole number, negative or
above 64 bits included.
"""
from __future__ import annotations

import hashlib

import torch


def derive(seed: int, stream: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, stream))

"""The one generator of every traffic mix: a mix is data
(``traffic/<mix>.json``), read here.

Serving mixes (``"kind": "serve"``): each request is a batch of
``batch`` prompts of ``prompt_len`` ids, drawn uniformly from the
vocabulary; requests are due on
a fixed schedule, ``arrival.rate_per_s`` a second from the window's
start (an open loop).  Training mixes (``"kind": "train"``): each step a
batch of ``batch`` rows of ``seq_len + 1`` ids, every row different,
its first ``seq_len`` the inputs and its last ``seq_len`` the labels.
"""
from __future__ import annotations

from typing import List

import torch

from portbench import seeds


def prompts(mix: dict, seed: int, n: int, vocab: int, device,
            stream: str = "prompts") -> List[torch.Tensor]:
    """``n`` requests' prompts, (batch, prompt_len) int64 each, made on
    the device in one call."""
    gen = seeds.generator(seed, stream, device)
    ids = torch.randint(0, vocab, (n, mix["batch"], mix["prompt_len"]),
                        generator=gen, device=device)
    return list(ids)


def due(mix: dict, i: int) -> float:
    """Seconds from the window's start at which request ``i`` is due."""
    return i / mix["arrival"]["rate_per_s"]


def train_batches(mix: dict, seed: int, n: int, vocab: int, device):
    """``n`` steps' (tokens, labels), each (batch, seq_len), in one call."""
    gen = seeds.generator(seed, "batches", device)
    ids = torch.randint(0, vocab, (n, mix["batch"], mix["seq_len"] + 1),
                        generator=gen, device=device)
    return [(ids[i, :, :-1], ids[i, :, 1:]) for i in range(n)]

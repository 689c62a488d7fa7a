"""Token data pipeline: synthetic + memmap sources, prefetch.

The port of ``repro/data/pipeline.py``.  The sources are pure numpy and
give the reference's tokens bit for bit:

``SyntheticSource``  tokens of a step are a pure function of
                     ``(seed, step)`` — restart-safe.
``MemmapSource``     a flat binary token file (np.memmap, uint16/uint32),
                     sliced by step with wraparound.

``DataLoader`` assembles (tokens, labels) batches, synthesises the
frontend stubs (audio frames / VLM prefix embeddings) where the
architecture needs them, and puts a batch on the device through pinned
host memory with ``non_blocking`` copies, so the host does not wait for
the card; its iterator prefetches batches on a background thread.  With
``mesh=`` it yields this rank's rows of the global batch: the block that
``P(batch axes, None)`` places on the rank, the batch axes those
:func:`repro_torch.parallel.sharding.make_rules` picks for the global
batch, as the reference's batch sharding places rows on its devices.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeSpec


class SyntheticSource:
    """tokens[step] is a pure function of (seed, step) — restart-safe."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab = vocab_size
        self.seed = seed

    def batch(self, step: int, batch: int, seq_len: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        return rng.integers(0, self.vocab, (batch, seq_len + 1),
                            dtype=np.int32)


class MemmapSource:
    def __init__(self, path: str, vocab_size: int, dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.vocab = vocab_size

    def batch(self, step: int, batch: int, seq_len: int) -> np.ndarray:
        n = len(self.tokens)
        span = seq_len + 1
        out = np.empty((batch, span), np.int32)
        for b in range(batch):
            start = ((step * batch + b) * span) % max(n - span, 1)
            out[b] = self.tokens[start:start + span].astype(np.int32)
        return np.minimum(out, self.vocab - 1)


@dataclass
class Batch:
    tokens: Any
    labels: Any
    frontend: Optional[Dict[str, Any]] = None


class DataLoader:
    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, *,
                 source=None, mesh=None, device="cuda", seed: int = 0,
                 prefetch: int = 2):
        self.cfg = cfg
        self.shape = shape
        self.source = source or SyntheticSource(cfg.vocab_size, seed)
        self.rows = slice(None)         # this rank's rows of a batch
        if mesh is not None:
            from repro_torch.parallel.collectives import block_slices
            from repro_torch.parallel.sharding import P, make_rules
            b = shape.global_batch
            axes = make_rules(cfg, mesh, global_batch=b).batch
            self.rows = block_slices((b,), P(axes or None), mesh)[0]
        self.device = resolve_device(device)
        self.seed = seed
        self.prefetch = prefetch

    # -- one host-side batch -------------------------------------------------
    def host_batch(self, step: int) -> Batch:
        """numpy arrays: tokens, labels (the next tokens; -1 where no loss
        is taken) and the frontend's stub embeddings."""
        b, s = self.shape.global_batch, self.shape.seq_len
        raw = self.source.batch(step, b, s)
        tokens, labels = raw[:, :-1], raw[:, 1:].copy()
        frontend = None
        if self.cfg.frontend == "audio":
            rng = np.random.default_rng(self.seed + 7919 + step)
            frontend = {"frame_embeds": rng.standard_normal(
                (b, s, self.cfg.d_model)).astype(np.float32) * 0.02}
        elif self.cfg.frontend == "vlm":
            rng = np.random.default_rng(self.seed + 104729 + step)
            p = self.cfg.n_prefix_embeds
            frontend = {"prefix_embeds": rng.standard_normal(
                (b, p, self.cfg.d_model)).astype(np.float32) * 0.02}
            labels[:, :p] = -1          # no loss on image positions
        return Batch(tokens, labels, frontend)

    def _put(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cpu":
            return t
        # pinned, then an asynchronous copy in stream order: the caching
        # host allocator keeps the pinned block until the copy is done
        return t.pin_memory().to(self.device, non_blocking=True)

    def device_batch(self, step: int) -> Batch:
        """This rank's rows of the step's batch, on the device."""
        hb = self.host_batch(step)
        fe = None
        if hb.frontend is not None:
            fe = {k: self._put(v[self.rows]) for k, v in hb.frontend.items()}
        return Batch(self._put(hb.tokens[self.rows]),
                     self._put(hb.labels[self.rows]), fe)

    # -- prefetching iterator ---------------------------------------------
    def __iter__(self) -> Iterator[Batch]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            step = 0
            while not stop.is_set():
                try:
                    q.put(self.device_batch(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            t.join(timeout=5.0)

"""Checkpointing: manifest + per-leaf arrays, atomic, async, keep-N.

The port of ``repro/checkpoint/manager.py`` for one device:

* **the reference's layout**: a ``step_<n>/`` directory holds one ``.npy``
  a leaf and ``manifest.json`` with each leaf's file, global shape and
  dtype name, keyed by the leaf's path (:func:`repro_torch.tree.
  flatten_with_path`: dict keys sorted, ``.m`` for a named tuple's field).
  For the same tree the paths, files and manifest keys are the
  reference's, so a float32 checkpoint written by either package restores
  in the other.
* **bfloat16 leaves**: numpy has no bfloat16 without ``ml_dtypes``, which
  the card's machine may lack, so a bf16 leaf is stored as its 16-bit
  patterns (a ``uint16`` array) with ``"dtype": "bfloat16"`` in the
  manifest, and read back by its bits.
* **atomic**: writes go to ``step_<n>.tmp/`` and are renamed into place
  only after every leaf and the manifest are fsynced, so a killed job
  never leaves a half-checkpoint that restore would pick up.
* **async**: ``save_async`` copies the tensors to host memory, then writes
  on a background thread; the loop waits only for the copy.
* **keep-N GC**, the newest checkpoints kept.
* **on a mesh** (``shardings``, the state's placement: a tree of
  :class:`repro_torch.parallel.collectives.NamedSharding`): every rank
  gathers the whole state, rank 0 writes it, in the same files and
  manifest as on one device, and the ranks meet once it is on disk
  (:meth:`wait`); every rank reads a checkpoint back whole and keeps its
  block, so a checkpoint written on one mesh restores on any other.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch import tree

MANIFEST = "manifest.json"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy; bfloat16 by its bits (uint16)."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[1]


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = np.array(arr, order="C")      # a 0-d leaf stays 0-d
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, shardings=None):
        self.dir = directory
        self.keep = keep
        self.shardings = shardings
        self.writer = True
        if shardings is not None:
            mesh = tree.leaves(shardings)[0].mesh
            self.writer = mesh.bound and mesh.rank == 0
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, MANIFEST)):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # -- save ------------------------------------------------------------------
    def _snapshot(self, state):
        """(path, host array, dtype name) of every leaf, copied now; on a
        mesh the whole leaves (every rank gathers), None off rank 0."""
        if self.shardings is not None:
            from repro_torch.parallel.collectives import gather_tree
            state = gather_tree(state, self.shardings)
        if not self.writer:
            return None
        return [(path, _to_numpy(t), _dtype_name(t))
                for path, t in tree.flatten_with_path(state)]

    def save(self, state, step: int) -> None:
        host = self._snapshot(state)
        if host is not None:
            self._write(host, step)
        self._meet()

    def save_async(self, state, step: int) -> None:
        self.wait()                       # one in flight at a time
        host = self._snapshot(state)
        if host is None:
            return

        def work():
            try:
                self._write(host, step)
            except BaseException as e:    # noqa: BLE001 — re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        self._meet()

    def _meet(self) -> None:
        """On a mesh, every rank waits here until rank 0's writes are on
        disk."""
        if self.shardings is not None:
            from repro_torch.parallel.collectives import barrier
            barrier()

    def _write(self, items, step: int) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        for path, arr, dtype_name in items:
            fname = path.replace("/", ".") + ".npy"
            with open(os.path.join(tmp, fname), "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            manifest["leaves"][path] = {
                "file": fname, "shape": list(arr.shape),
                "dtype": dtype_name}
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)             # the atomic commit point
        self._gc()

    def _gc(self) -> None:
        if not self.writer:
            return
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -----------------------------------------------------------------
    def restore(self, target, step: Optional[int] = None,
                device=None) -> Any:
        """Restore into the structure of ``target`` (a tree of tensors, or
        of ``meta`` tensors for shapes and dtypes alone): each leaf in the
        target leaf's dtype, on ``device`` (default: the target leaf's
        device, the CPU for a meta leaf).  On a mesh ``target`` holds this
        rank's blocks, and each whole leaf read is cut to the block.  A
        leaf whose shape differs from the target's raises ``ValueError``;
        a missing leaf ``KeyError``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, MANIFEST)) as f:
            manifest = json.load(f)
        shardings = (tree.leaves(self.shardings) if self.shardings is not None
                     else None)
        leaves = []
        for i, (path, tgt) in enumerate(tree.flatten_with_path(target)):
            meta = manifest["leaves"].get(path)
            if meta is None:
                raise KeyError(
                    f"checkpoint step {step} missing leaf {path!r}")
            arr = np.load(os.path.join(d, meta["file"]))
            t = _from_numpy(arr, meta["dtype"])
            if shardings is not None:
                from repro_torch.parallel.collectives import shard
                sh = shardings[i]
                if tuple(arr.shape) != tuple(sh.shape):
                    raise ValueError(
                        f"leaf {path}: checkpoint shape {arr.shape} != "
                        f"placement's {sh.shape}")
                t = shard(t, sh.spec, sh.mesh)
            if list(t.shape) != list(tgt.shape):
                raise ValueError(
                    f"leaf {path}: checkpoint shape {tuple(t.shape)} != "
                    f"target {tuple(tgt.shape)}")
            dev = device or ("cpu" if tgt.is_meta else tgt.device)
            leaves.append(t.to(tgt.dtype).to(dev))
        return tree.unflatten_like(target, leaves)

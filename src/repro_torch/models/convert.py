"""Weights carried across from the JAX package.

The port keeps the reference's parameter tree: the same keys, the same
shapes, the same period stacking.  :func:`params_from_numpy` turns the
reference's tree, its leaves as numpy arrays (``np.asarray`` of each JAX
array), into the port's, on a given device, bit for bit.

A JAX bfloat16 array becomes an ``ml_dtypes`` bfloat16 numpy array, which
``torch.from_numpy`` does not take: its bits go across as ``uint16`` and
are viewed as ``torch.bfloat16`` on the other side.

:func:`train_state_from_numpy` carries a whole reference train state
across the same way: ``params``, the optimizer's ``OptState(m, v, step)``
as the port's :class:`repro_torch.optim.adamw.OptState`, and the int8-EF
error state ``err`` where there is one.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.optim.adamw import OptState


def tensor_from_numpy(arr, device) -> torch.Tensor:
    """One leaf: values, dtype and shape unchanged (bfloat16 by its bits)."""
    a = np.array(arr, order="C")                  # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The reference's parameter (or cache) tree as the port's, on
    ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return tensor_from_numpy(node, dev)

    return conv(tree)


def train_state_from_numpy(state: Dict[str, Any], device="cuda"
                           ) -> Dict[str, Any]:
    """The reference's ``TrainState`` (``{"params", "opt", ["err"]}``), its
    leaves as numpy arrays and ``opt`` its ``OptState`` named tuple, as the
    port's, on ``device``, bit for bit."""
    dev = resolve_device(device)
    opt = state["opt"]
    out = {"params": params_from_numpy(state["params"], dev),
           "opt": OptState(m=params_from_numpy(opt.m, dev),
                           v=params_from_numpy(opt.v, dev),
                           step=tensor_from_numpy(opt.step, dev))}
    if "err" in state:
        out["err"] = params_from_numpy(state["err"], dev)
    return out

"""State carried across from the JAX package.

The system has no weights: its state is the platform tree and the
buffers.  With these two functions a test gives both packages the same
tree and the same buffers, so that both compute the same thing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.devicetree import Platform
from repro_torch.core.pools import MemoryPool


def platform_from_reference_json(text: str,
                                 cache_node: Optional[str] = None) -> Platform:
    """The port's :class:`Platform` from the JAX package's
    ``Platform.to_json()`` text.

    That JSON drops ``cache_node`` (and so does the port's, to stay
    byte-identical), so the name of the transparent shared cache is
    passed beside the text: ``"l2"`` for the ZCU102 trees, None for a
    tree without one."""
    plat = Platform.from_json(text)
    if cache_node is not None:
        if cache_node not in plat.memories:
            raise KeyError(f"cache_node {cache_node!r} names no memory of "
                           f"{plat.name}; have {sorted(plat.memories)}")
        plat = dataclasses.replace(plat, cache_node=cache_node)
    return plat


def buffer_from_numpy(arr: np.ndarray, pool: MemoryPool) -> torch.Tensor:
    """Place a numpy buffer (``bw_buffer_init``'s values, a chain
    buffer) in ``pool``'s memory, values and dtype unchanged."""
    return pool.place(torch.from_numpy(np.ascontiguousarray(arr)))

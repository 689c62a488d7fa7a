"""Launch counters: how often each wrapper launched its CUDA kernel, and
how often it took the plain PyTorch version instead; and the work each
call reports to a cost counter.

A wrapper reports through :func:`launched` where it launches its kernel
and nowhere else, and through :func:`plain` where a CPU tensor made it
take the plain version.  The first adds one to ``LAUNCHES[name]``, the
second to ``PLAIN[name]``.  A run that must show it went through the
kernels sets both to zero before (``reset``) and reads them after
(``snapshot``).  ``INSTANCES`` splits the launches of a kernel built in
more than one design by the design that ran (``"<kernel>:<instance>"``);
``reset`` zeroes it too.

A call on ``meta`` tensors (the dry-run, :mod:`repro_torch.launch.dryrun`)
is the model of a launch, not one: the wrapper reports through
:func:`modelled`, which hands its work to the active counters and adds one
to ``MODELLED`` only, never to ``LAUNCHES``, ``PLAIN`` or ``INSTANCES``.

Both take the call's counted :class:`Work`, from the kernel module's own
function of its arguments (``flash_attention.forward_work``,
``stream.work``, ...).  A launch through ``ctypes`` is invisible to
:mod:`repro_torch.analysis.cost`'s dispatch mode, and a plain version
dispatches other operations than its kernel runs, so while a counter is
active (it is in :data:`SINKS`) each call hands it that work, and
:func:`plain` hides the plain version's operations from it: the same call
counts the same on CPU tensors and on the card.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

KERNELS = ("read_hbm", "write_hbm", "write_hbm_seeded", "rmw_hbm",
           "copy_hbm", "read_vmem", "write_vmem", "chase_vmem", "chase_hbm",
           "mxu_probe", "contention_ladder", "probe_add_one", "triad_hbm",
           "flash_attention", "flash_attention_bwd")

LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
PLAIN: Dict[str, int] = {k: 0 for k in KERNELS}
INSTANCES: Dict[str, int] = {"flash_attention:wgmma_bf16": 0,
                             "flash_attention:fma_f32": 0,
                             "flash_attention_bwd:wgmma_bf16": 0,
                             "flash_attention_bwd:fma_bf16": 0,
                             "flash_attention_bwd:fma_f32": 0}

#: the calls modelled on ``meta`` a kernel instance (``"<kernel>:<instance>"``)
MODELLED: Dict[str, int] = dict.fromkeys(INSTANCES, 0)

#: the least the device memory moves for a load (one sector), what a
#: chase's hop counts
SECTOR_BYTES = 32

#: the active cost counters (``analysis.cost``), innermost last; each has
#: ``kernel(name, work)`` and ``hidden()``
SINKS: List = []


class Work(NamedTuple):
    """A kernel call's counted work: the operations it must do and the
    bytes it must move (each input read once, each output written once),
    as its bound counts them."""
    flops: float
    bytes: float


def reset() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN[k] = 0
    for k in INSTANCES:
        INSTANCES[k] = 0
        MODELLED[k] = 0


def snapshot() -> Tuple[Dict[str, int], Dict[str, int]]:
    return dict(LAUNCHES), dict(PLAIN)


def _report(name: str, work: Optional[Work]) -> None:
    if not SINKS:
        return
    if work is None:
        raise RuntimeError(f"{name}: a call reached a cost counter with no "
                           "counted work")
    for sink in SINKS:
        sink.kernel(name, work)


def launched(name: str, work: Optional[Work],
             instance: Optional[str] = None) -> None:
    """Where ``name``'s kernel was launched: one launch (and one of its
    ``instance``), and its work to the active counters."""
    _report(name, work)
    LAUNCHES[name] += 1
    if instance is not None:
        INSTANCES[f"{name}:{instance}"] += 1


def modelled(name: str, work: Work, instance: str) -> None:
    """Where ``name``'s kernel ``instance`` was modelled on ``meta``
    tensors: its work to the active counters and one to ``MODELLED``; no
    launch and no plain call."""
    _report(name, work)
    MODELLED[f"{name}:{instance}"] += 1


@contextlib.contextmanager
def plain(name: str, work: Optional[Work]) -> Iterator[None]:
    """Around ``name``'s plain version: one plain call, its kernel's work
    to the active counters, and the block's own operations hidden from
    them."""
    _report(name, work)
    PLAIN[name] += 1
    with contextlib.ExitStack() as stack:
        for sink in SINKS:
            stack.enter_context(sink.hidden())
        yield

"""The counter's profile: attribute a step's bytes, flops and collectives
to the port's code.

The port of ``repro/analysis/profile.py``.  The reference groups the
instructions of a compiled program by their HLO ``op_name`` path, so that
a hypothesis can name the model line to change.  Here a site is the
innermost frame in ``repro_torch`` outside ``analysis/`` and
``kernels/`` that dispatched the operation, as
``models/mlp.py:<line> <function>`` (in the backward pass with its
autograd node in brackets), or the name of a hand-written kernel for the
work it reports: the line to change, which is what ``op_name`` was for.
:func:`profile_cell` profiles one rank's share of a production cell, as
the dry-run builds it (``launch/dryrun.lower_cell``), on ``meta`` tensors.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.analysis.cost import CostCounter, devices_of


def profile(fn, *args, top: int = 25, **kw) -> Dict:
    """Runs ``fn(*args, **kw)`` once under a counter that keeps sites;
    returns the ``top`` sites by bytes and by flops, the ``top``
    collectives, and the totals (which equal ``cost.analyze``'s)."""
    with CostCounter(devices=devices_of(args, kw), sites=True) as counter:
        fn(*args, **kw)
    by_site = counter.by_site
    rows = sorted(counter.collective_rows, reverse=True)
    return {
        "bytes_by_site": sorted(((k, v[0]) for k, v in by_site.items()),
                                key=lambda kv: -kv[1])[:top],
        "flops_by_site": sorted(((k, v[1]) for k, v in by_site.items()),
                                key=lambda kv: -kv[1])[:top],
        "collectives": rows[:top],
        "total_bytes": sum(v[0] for v in by_site.values()),
        "total_flops": sum(v[1] for v in by_site.values()),
        "total_collective_bytes": sum(r[0] for r in rows),
    }


def render(p: Dict, top: int = 20) -> str:
    out = []
    out.append(f"total: {p['total_flops']:.3e} flops, "
               f"{p['total_bytes'] / 2**30:.2f} GiB moved, "
               f"{p['total_collective_bytes'] / 2**30:.2f} GiB collective")
    out.append("\n-- top sites by bytes --")
    for name, b in p["bytes_by_site"][:top]:
        out.append(f"{b / 2**30:9.2f} GiB  {name[:110]}")
    out.append("\n-- top sites by flops --")
    for name, f in p["flops_by_site"][:top]:
        out.append(f"{f:9.3e}      {name[:110]}")
    out.append("\n-- top collectives --")
    for b, kind, name in p["collectives"][:top]:
        out.append(f"{b / 2**30:9.3f} GiB  {kind:18s} {name[:90]}")
    return "\n".join(out)


def profile_cell(arch: str, shape: str, *, multi_pod: bool = False,
                 top: int = 20, train_overrides: Optional[dict] = None
                 ) -> str:
    """Build one cell's call for rank 0 of the production mesh, as the
    dry-run does (on ``meta`` tensors, on the process's ``fake`` group),
    and render its profile."""
    from repro_torch.launch.dryrun import lower_cell
    fn, args, _ = lower_cell(arch, shape, multi_pod=multi_pod,
                             train_overrides=train_overrides)
    return render(profile(fn, *args, top=top), top=top)

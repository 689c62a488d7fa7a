"""Roofline terms of a counted step, on the NVIDIA H100 SXM.

The port of ``repro/analysis/roofline.py``, function for function, with
the H100's constants in place of the TPU's.  Three terms, all **seconds
per step, per device**:

  compute    = device_FLOPs / PEAK_FLOPS
  memory     = device_bytes / HBM_BW
  collective = device_collective_bytes / (NVLINK_BW * N_NVLINK_LINKS)

Inputs are the cost counter's count of the step
(:mod:`repro_torch.analysis.cost`: every aten operation it dispatches and
every hand-written kernel it launches), where the reference parses the
while-aware HLO of the compiled program.  ``model_flops`` provides the
"useful work" yardstick: MODEL_FLOPS / counted FLOPs < 1 exposes remat
recompute and redundancy; > 1 means the path skips products that
``n_active_params`` counts (a gather for the input embedding, logits
only at the last position) or the counter missed something —
investigate either way.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from repro_torch.analysis.cost import Cost
from repro_torch.configs.base import ModelConfig, ShapeSpec

# ---------------------------------------------------------------------------
# NVIDIA H100 SXM constants (per card), from NVIDIA's H100 SXM datasheet:
# dense rates, without sparsity, at the full 700 W power limit.
# ---------------------------------------------------------------------------

PEAK_FLOPS = 989e12          # bf16 FLOP/s on the tensor cores, dense
HBM_BW = 3.35e12             # bytes/s of HBM3
# NVLink 4: the datasheet's 900 GB/s counts both directions of 18 links,
# so one link moves 25 GB/s in ONE direction; a ring phase sends one way
# over every link of the card at once (all 18 reach the NVSwitches)
NVLINK_BW = 25e9             # bytes/s per link, one direction
N_NVLINK_LINKS = 18          # links a ring phase uses at once


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    # per-device program cost (the counter's count of the step)
    hlo_flops: float                  # the counted FLOPs (the reference's
    hlo_bytes: float                  # key names, kept for its JSON)
    collective_bytes: float
    collective_by_kind: Dict[str, float]
    # terms (seconds)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    # usefulness
    model_flops: float = 0.0          # global, analytic
    useful_ratio: float = 0.0         # model_flops / (hlo_flops * devices)
    # memory picture
    bytes_per_device: int = 0         # allocation (args+temp+out)
    # bookkeeping
    unknown_trip_whiles: int = 0
    note: str = ""

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline step time (perfect overlap of the three engines)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / bound time: 1.0 = the tensor cores
        saturated with zero overhead.  The score we hillclimb."""
        if self.t_bound <= 0:
            return 0.0
        t_useful = (self.model_flops / max(self.n_devices, 1)) / PEAK_FLOPS
        return t_useful / self.t_bound

    def row(self) -> str:
        return (f"{self.arch:22s} {self.shape:12s} {self.mesh:10s} "
                f"C={self.t_compute * 1e3:9.2f}ms "
                f"M={self.t_memory * 1e3:9.2f}ms "
                f"X={self.t_collective * 1e3:9.2f}ms "
                f"-> {self.bottleneck:10s} "
                f"useful={self.useful_ratio:6.3f} "
                f"roofline={self.roofline_fraction:6.3f}")


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """6·N·D (train) or 2·N_active·D (one forward token batch)."""
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    # decode: one token per sequence per step
    return 2.0 * n_active * shape.global_batch


# Read share of HBM line-touches per workload kind, for the surface's
# rw_ratio axis.  Train streams parameters+activations forward and
# writes gradients/optimizer state back (~2 reads per write); prefill
# reads weights and writes the full KV prefix; decode reads the whole
# cache + weights every token and writes a single KV slot.
WORKLOAD_RW_MIX = {"train": 2.0 / 3.0, "prefill": 0.75, "decode": 0.9}


def workload_rw_mix(shape) -> float:
    """The ``rw_ratio`` surface coordinate of a workload
    :class:`~repro_torch.configs.base.ShapeSpec` (by its ``kind``)."""
    return WORKLOAD_RW_MIX.get(getattr(shape, "kind", ""), 2.0 / 3.0)


def effective_hbm_bw(curve_db, *, n_stressors: int = 0,
                     stress_pool: str = "hbm", stress_strategy: str = "w",
                     shape_tag: str = "",
                     rw_ratio: Optional[float] = None,
                     inject_rate: Optional[float] = None) -> float:
    """HBM bandwidth under characterized contention, bytes/s.

    Consumes a CurveDB (v1/v2/v3, :mod:`repro_torch.core.characterize`):
    the roofline's memory term is only
    honest under load if it uses the *effective* bandwidth the
    characterization measured, not the datasheet peak.  On a v3
    surface database pass ``rw_ratio`` — e.g.
    ``workload_rw_mix(shape)`` for the workload's actual read/write
    mix — and ``inject_rate`` to interpolate the surface at the
    workload's real traffic coordinates."""
    bw_gbps = curve_db.effective_bw(
        "hbm", n_stressors, stress_pool=stress_pool,
        stress_strat=stress_strategy, shape_tag=shape_tag,
        rw_ratio=rw_ratio, inject_rate=inject_rate)
    return bw_gbps * 1e9


def compute_terms(
    cost: Cost,
    *,
    cfg: ModelConfig,
    shape: ShapeSpec,
    mesh_desc: str,
    n_devices: int,
    bytes_per_device: int = 0,
    note: str = "",
    hbm_bw: Optional[float] = None,     # e.g. effective_hbm_bw(curve_db)
) -> RooflineTerms:
    mf = model_flops(cfg, shape)
    total_hlo_flops = cost.flops * n_devices
    mem_bw = hbm_bw if hbm_bw else HBM_BW
    t = RooflineTerms(
        arch=cfg.name, shape=shape.name, mesh=mesh_desc,
        n_devices=n_devices,
        hlo_flops=cost.flops,
        hlo_bytes=cost.bytes,
        collective_bytes=cost.collective_bytes,
        collective_by_kind=cost.collective_summary(),
        t_compute=cost.flops / PEAK_FLOPS,
        t_memory=cost.bytes / mem_bw,
        t_collective=cost.collective_bytes / (NVLINK_BW * N_NVLINK_LINKS),
        model_flops=mf,
        useful_ratio=(mf / total_hlo_flops) if total_hlo_flops else 0.0,
        bytes_per_device=bytes_per_device,
        unknown_trip_whiles=len(cost.unknown_trip_whiles),
        note=note,
    )
    return t


# ---------------------------------------------------------------------------
# Persistence for the experiment log
# ---------------------------------------------------------------------------


def save_terms(terms: RooflineTerms, path: str) -> None:
    with open(path, "w") as f:
        d = asdict(terms)
        d["bottleneck"] = terms.bottleneck
        d["t_bound"] = terms.t_bound
        d["roofline_fraction"] = terms.roofline_fraction
        json.dump(d, f, indent=1)


def load_terms(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def table(rows: List[dict]) -> str:
    """The roofline table, in markdown, from saved dicts (the
    reference's columns; MODEL/HLO is model over counted FLOPs)."""
    hdr = (f"| arch | shape | mesh | compute (ms) | memory (ms) | "
           f"collective (ms) | bottleneck | MODEL/HLO | roofline |")
    sep = "|" + "---|" * 9
    lines = [hdr, sep]
    for d in rows:
        lines.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} "
            f"| {d['t_compute'] * 1e3:.2f} | {d['t_memory'] * 1e3:.2f} "
            f"| {d['t_collective'] * 1e3:.2f} | {d['bottleneck']} "
            f"| {d['useful_ratio']:.3f} | {d['roofline_fraction']:.3f} |")
    return "\n".join(lines)

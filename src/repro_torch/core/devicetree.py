"""Platform description + auto-detection — the device-tree analog.

MEMSCOPE discovers memory modules from the kernel device tree (DTB nodes
with ``compatible = "mempool"``).  Our platforms are described by the same
kind of declarative tree (a dict / JSON file with one node per memory
module), and ``detect_platform()`` builds the description for the card
it finds — exactly the role the DTB plays for the kernel module.

Each node records the *modeled* temporal characteristics used by the
queueing simulator (``repro_torch.core.simulate``).  The JSON form is
byte-identical to the JAX package's, so a tree written by one package
loads in the other (``repro_torch.core.convert``).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.compat import resolve_device
from repro_torch.kernels._build import SMEM_PER_BLOCK_BYTES

# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MemoryNode:
    """One memory module (a DTB ``mempool`` node)."""
    name: str                 # pool name, e.g. "hbm"
    kind: str                 # hbm | vmem | cache | host | peer
    size_bytes: int
    peak_bw_gbps: float       # sustained sequential bandwidth, GB/s
    base_latency_ns: float    # unloaded round-trip latency
    port: str = "noc"         # shared interconnect this module hangs off
    max_mlp: int = 16         # per-engine outstanding-transaction limit
    # where MemoryPool places tensors: "device" (the card's memory),
    # "pinned_host" (page-locked host memory the card reads over PCIe),
    # None (on-chip: a residency grant, no tensor)
    memory_kind: Optional[str] = None

    @property
    def reg(self) -> str:
        """DTS-style reg string (size only; PA base is virtualised)."""
        return f"<0x0 0x{self.size_bytes:x}>"


@dataclass(frozen=True)
class InterconnectNode:
    """A shared transaction port (the CCI analog)."""
    name: str
    bw_gbps: float
    queue_entries: int        # shared outstanding-transaction entries


@dataclass(frozen=True)
class Platform:
    name: str
    n_engines: int            # traffic-generating compute engines ("cores")
    line_bytes: int           # transaction granularity
    memories: Dict[str, MemoryNode]
    ports: Dict[str, InterconnectNode]
    peak_flops: float = 0.0   # per engine, FLOP/s (bf16)
    shared_port: str = "noc"  # the CCI analog every off-core Tx traverses
    # name of a *transparent shared cache* node (ZCU102: "l2", H100:
    # "l2").  None for a platform whose on-chip memory is a private
    # software-managed scratchpad only.
    cache_node: Optional[str] = None

    def node(self, name: str) -> MemoryNode:
        if name not in self.memories:
            raise KeyError(
                f"no memory node {name!r}; available: "
                f"{sorted(self.memories)}")
        return self.memories[name]

    def to_json(self) -> str:
        # ``cache_node`` is not serialised: the JAX package's JSON has no
        # such key, and the two forms are kept byte-identical.  Pass it
        # beside the text (``convert.platform_from_reference_json``).
        return json.dumps({
            "name": self.name,
            "n_engines": self.n_engines,
            "line_bytes": self.line_bytes,
            "peak_flops": self.peak_flops,
            "shared_port": self.shared_port,
            "memories": {k: dataclasses.asdict(v)
                         for k, v in self.memories.items()},
            "ports": {k: dataclasses.asdict(v)
                      for k, v in self.ports.items()},
        }, indent=2)

    @staticmethod
    def from_json(text: str) -> "Platform":
        d = json.loads(text)
        return Platform(
            name=d["name"], n_engines=d["n_engines"],
            line_bytes=d["line_bytes"],
            peak_flops=d.get("peak_flops", 0.0),
            shared_port=d.get("shared_port", "noc"),
            memories={k: MemoryNode(**v) for k, v in d["memories"].items()},
            ports={k: InterconnectNode(**v)
                   for k, v in d["ports"].items()},
        )


# ---------------------------------------------------------------------------
# The NVIDIA H100 SXM platform.
#
# PUBLISHED (NVIDIA's data sheet and the Hopper architecture white
# paper): 80 GB of device memory at 3.35 TB/s, 50 MB of L2, 227 KB of
# shared memory usable by one block on each of the 132 SMs, 989 TFLOP/s
# dense bf16, PCIe Gen5 x16 (64 GB/s each way), NVLink 450 GB/s each way.
#
# MEASURED (``chip_smoke.py``'s dependent-load chases on an NVIDIA H100
# 80GB HBM3 at a 700.00 W power limit, PERF.md): the ``base_latency_ns``
# of ``hbm`` (341 ns a hop over 256 MiB), ``l2`` (146 ns over 16 MiB),
# ``vmem`` (14.4 ns over 128 KiB staged in shared memory) and ``host``
# (1228 ns over 64 MiB of pinned host memory).
#
# MODELING ESTIMATES (not measured, not published): the ``peer`` latency,
# every ``max_mlp``, every port's ``queue_entries``, the bandwidth of the
# shared-memory and L2 nodes and of the "noc", "core" and "l2bank" ports,
# and the host pool's size.  They are chosen so that one engine reaches a
# plausible share of a module's peak and an 8-engine ladder saturates it.
# ``chip_smoke.py`` prints the measured chase latencies and stream rates
# of each memory; PERF.md records them.
#
# ``n_engines`` is the contention-ladder width (an engine is a group of
# SMs, 132 / 8 = 16.5 SMs each), not the SM count.  ``line_bytes`` is
# 512 — one (1, 128) float32 row — so bytes_moved, transactions and
# curve keys compare across the two packages.  The ``vmem`` node keeps
# the JAX package's pool name so that config strings port: here it is the
# shared memory of the SMs, which the on-chip read and write spread a
# buffer over (33 000 GB/s, about 132 SMs x 128 B a clock at 1.98 GHz),
# and of one SM for the on-chip chase.  Its size stays one SM's (227 KB):
# the residency threshold that picks the on-chip kernels.
# ---------------------------------------------------------------------------

SMEM_PER_SM_BYTES = SMEM_PER_BLOCK_BYTES     # 227 KB a block can use
L2_BYTES = 50 << 20

H100_SXM = Platform(
    name="h100-sxm",
    n_engines=8,
    line_bytes=512,
    peak_flops=989e12 / 8,
    memories={
        # base latencies measured (see above); the rest modeled
        "hbm": MemoryNode("hbm", "hbm", 80 * 10**9, 3350.0, 341.0,
                          port="noc", max_mlp=1024, memory_kind="device"),
        "vmem": MemoryNode("vmem", "vmem", SMEM_PER_SM_BYTES, 33_000.0,
                           14.4, port="core", max_mlp=64,
                           memory_kind=None),
        "l2": MemoryNode("l2", "cache", L2_BYTES, 7_000.0, 146.0,
                         port="l2bank", max_mlp=512, memory_kind=None),
        "host": MemoryNode("host", "host", 64 << 30, 64.0, 1_228.0,
                           port="pcie", max_mlp=64,
                           memory_kind="pinned_host"),
        "peer": MemoryNode("peer", "peer", 80 * 10**9, 450.0, 2_000.0,
                           port="nvlink", max_mlp=128, memory_kind=None),
    },
    ports={
        "noc": InterconnectNode("noc", 5_500.0, 4096),
        "core": InterconnectNode("core", 33_000.0, 64),
        "l2bank": InterconnectNode("l2bank", 7_000.0, 2048),
        "pcie": InterconnectNode("pcie", 64.0, 256),
        "nvlink": InterconnectNode("nvlink", 450.0, 512),
    },
    cache_node="l2",
)

# The ZCU102 platform from the paper (used to sanity-check the simulator
# against the paper's published curves — Fig. 4/5, Tables II/III, and the
# cache experiments Fig. 10-13: the shared L2 appears as a "cache"-kind
# node whose single bank port every cacheable access traverses).
ZCU102 = Platform(
    name="zcu102",
    n_engines=4,              # quad Cortex-A53
    line_bytes=64,
    peak_flops=12e9,
    memories={
        "dram": MemoryNode("dram", "hbm", 256 << 20, 4.8, 150.0,
                           port="cci", max_mlp=6, memory_kind="device"),
        "pl-dram": MemoryNode("pl-dram", "host", 256 << 20, 1.6, 380.0,
                              port="cci", max_mlp=6, memory_kind=None),
        "ocm": MemoryNode("ocm", "vmem", 128 << 10, 3.2, 120.0,
                          port="cci", max_mlp=4, memory_kind=None),
        "bram": MemoryNode("bram", "vmem", 1 << 20, 1.2, 200.0,
                           port="cci", max_mlp=4, memory_kind=None),
        # the unified 16-way 1 MiB LLC; single-banked on this SoC —
        # calibrated so 1 core extracts ~21 GB/s hitting in L2 and 4
        # contending cores see the paper's ~3.2x cycles/access blow-up
        "l2": MemoryNode("l2", "cache", 1 << 20, 27.0, 30.0,
                         port="l2bank", max_mlp=12, memory_kind=None),
    },
    ports={"cci": InterconnectNode("cci", 9.6, 16),
           # 12 writeback-buffer entries: one y-stream engine (posted MLP
           # 12) fits exactly — reproducing the paper's Fig. 13 boundary
           # (identical at 1 stressor, collapse at >= 2)
           "l2bank": InterconnectNode("l2bank", 27.0, 12)},
    shared_port="cci",
    cache_node="l2",
)


def zcu102_partitioned() -> Platform:
    """The Minerva-Jailhouse page-coloring setup of §IV-D: 1/4 of the LLC
    (256 KiB) exported as the *private cache pool* (pvtpool); the shared
    part shrinks to 768 KiB.  pvtpool is just another heterogeneous
    memory module from MEMSCOPE's point of view."""
    mems = dict(ZCU102.memories)
    mems["l2"] = dataclasses.replace(mems["l2"], size_bytes=768 << 10)
    mems["pvtpool"] = MemoryNode("pvtpool", "cache", 256 << 10, 27.0, 30.0,
                                 port="l2bank", max_mlp=12,
                                 memory_kind=None)
    return dataclasses.replace(ZCU102, name="zcu102-partitioned",
                               memories=mems)


def detect_platform(override: Optional[str] = None, *,
                    device="cuda") -> Platform:
    """Auto-detect like MEMSCOPE reads the DTB at module load.

    A named tree (``"h100-sxm"``, ``"zcu102"``) is returned as it is.
    With no name the card is looked for on ``device`` and its tree
    returned; this raises where ``device`` asks for a card that is not
    there.  ``device="cpu"`` returns the same H100 tree as a model only.
    """
    if override == "zcu102":
        return ZCU102
    if override == "h100-sxm":
        return H100_SXM
    if override is None:
        resolve_device(device)
        return H100_SXM
    raise KeyError(f"unknown platform {override!r}")

"""Config system for the repro framework.

Every assigned architecture is expressed as a :class:`ModelConfig`; the four
assigned input-shape sets are :data:`SHAPES`.  ``reduced()`` produces a tiny
same-family config for CPU smoke tests; full configs are exercised only via
the AOT dry-run (``repro.launch.dryrun``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Input shapes (assigned): seq_len x global_batch
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    # every `moe_every`-th layer is MoE (1 = all layers); offset selects which.
    moe_every: int = 1
    moe_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256  # SSD chunk length for training/prefill

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # --- attention flavour ---
    rope_theta: float = 10_000.0
    rope_theta_local: float = 0.0  # 0 -> use rope_theta everywhere
    qkv_bias: bool = False
    sliding_window: int = 0  # 0 -> no local attention layers
    global_every: int = 0  # e.g. 6 -> layers 5,11,.. are global (5:1 local)
    attn_logit_softcap: float = 0.0
    qk_norm: bool = False
    tie_embeddings: bool = False
    scale_embed: bool = False  # multiply embeddings by sqrt(d_model) (gemma)
    act_fn: str = "silu"  # silu | gelu
    norm_eps: float = 1e-6
    # --- mixture of experts ---
    moe: Optional[MoEConfig] = None
    # --- state-space layers ---
    ssm: Optional[SSMConfig] = None
    # hybrid interleave: layer i is attention iff i % attn_every == attn_offset
    # (only used when family == "hybrid"); ssm archs have attn_every == 0.
    attn_every: int = 0
    attn_offset: int = 0
    # --- modality frontend stub ---
    frontend: str = "none"  # none | audio | vlm
    n_prefix_embeds: int = 0  # e.g. 256 ViT patch embeddings prepended
    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # --- bookkeeping ---
    source: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ------------------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def padded_vocab(self) -> int:
        """Vocab padded for sharding (multiple of 256, Megatron-style)."""
        return _round_up(self.vocab_size, 256)

    def layer_kind(self, i: int) -> str:
        """'attn' | 'ssm' for layer index i."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid" and self.attn_every:
            return "attn" if i % self.attn_every == self.attn_offset else "ssm"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        if self.moe is None:
            return False
        return i % self.moe.moe_every == self.moe.moe_offset

    def layer_is_global_attn(self, i: int) -> bool:
        """Full-context attention (vs. sliding window) for layer i."""
        if self.sliding_window == 0 or self.global_every == 0:
            return True
        return (i + 1) % self.global_every == 0

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can run long_500k (no full-attention prefill over
        the whole context on every layer and O(<L^2) overall)."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            return True  # few attention layers; decode is O(L) per token
        return self.sliding_window > 0 and self.global_every > 0

    # ------------------------------------------------------------------
    def shapes(self) -> List[str]:
        """Assigned shapes runnable for this arch (skips noted in DESIGN.md)."""
        out = []
        for s in SHAPE_ORDER:
            if s == "long_500k" and not self.sub_quadratic:
                continue
            out.append(s)
        return out

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        kv = max(1, min(self.n_kv_heads, n_heads)) if n_heads else 0
        # keep GQA flavour: q:kv ratio > 1 when original had one
        if n_heads and self.n_kv_heads < self.n_heads:
            kv = max(1, n_heads // 2)
        moe = None
        if self.moe is not None:
            moe = replace(
                self.moe, n_experts=4, top_k=min(2, self.moe.top_k),
                d_ff_expert=64,
            )
        ssm = None
        if self.ssm is not None:
            ssm = replace(self.ssm, d_state=16, head_dim=16, chunk=8)
        n_layers = 2
        attn_every, attn_offset = self.attn_every, self.attn_offset
        if self.family == "hybrid":
            n_layers, attn_every, attn_offset = 4, 2, 1
        global_every = 2 if self.global_every else 0
        return replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=64,
            n_heads=n_heads,
            n_kv_heads=kv,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            moe=moe,
            ssm=ssm,
            attn_every=attn_every,
            attn_offset=attn_offset,
            global_every=global_every,
            sliding_window=8 if self.sliding_window else 0,
            n_prefix_embeds=4 if self.n_prefix_embeds else 0,
            param_dtype="float32",
            compute_dtype="float32",
        )

    # ------------------------------------------------------------------
    # Analytic parameter counts (used for MODEL_FLOPS in the roofline).
    # ------------------------------------------------------------------
    def param_counts(self) -> Dict[str, int]:
        d, hd = self.d_model, self.head_dim
        counts: Dict[str, int] = {}
        counts["embed"] = self.padded_vocab * d
        counts["unembed"] = 0 if self.tie_embeddings else self.padded_vocab * d
        per_layer_attn = 0
        if self.n_heads:
            q = d * self.n_heads * hd
            k = d * self.n_kv_heads * hd
            v = d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            bias = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
            per_layer_attn = q + k + v + o + bias
        per_layer_mlp = 3 * d * self.d_ff  # gated: w_in, w_gate, w_out
        per_layer_moe = 0
        if self.moe is not None:
            e, f = self.moe.n_experts, self.moe.d_ff_expert
            per_layer_moe = d * e + e * 3 * d * f  # router + experts
        per_layer_ssm = 0
        if self.ssm is not None:
            di = self.ssm.d_inner(d)
            nh = self.ssm.n_heads(d)
            ng, ds = self.ssm.n_groups, self.ssm.d_state
            zxbcdt = d * (2 * di + 2 * ng * ds + nh)
            conv = self.ssm.d_conv * (di + 2 * ng * ds)
            out = di * d
            per_layer_ssm = zxbcdt + conv + out + 2 * nh + di  # +A,dt_bias,norm
        attn_p = mlp_p = moe_p = ssm_p = norm_p = 0
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind == "attn":
                attn_p += per_layer_attn
                norm_p += 2 * d
            else:
                ssm_p += per_layer_ssm
                norm_p += 2 * d
            if self.layer_is_moe(i):
                moe_p += per_layer_moe
            elif kind == "attn" or self.family != "ssm":
                mlp_p += per_layer_mlp
                norm_p += d
        if self.family == "ssm":
            mlp_p = 0  # mamba blocks have no separate FFN (d_ff == 0)
        counts.update(attn=attn_p, mlp=mlp_p, moe=moe_p, ssm=ssm_p,
                      norm=norm_p + d)  # final norm
        return counts

    def n_params(self) -> int:
        return sum(self.param_counts().values())

    def n_active_params(self) -> int:
        """Params touched per token (MoE experts scaled by top_k/E)."""
        c = self.param_counts()
        total = sum(v for k, v in c.items() if k != "moe")
        if self.moe is not None and c["moe"]:
            e, k = self.moe.n_experts, self.moe.top_k
            router = self.d_model * e * sum(
                1 for i in range(self.n_layers) if self.layer_is_moe(i))
            experts = c["moe"] - router
            total += router + experts * k // e
        return total


# ---------------------------------------------------------------------------
# Train / serve configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1          # grad-accumulation steps inside train_step
    remat: str = "layer"           # none | layer | full
    zero1: bool = True             # shard optimizer state over data axis
    grad_compression: str = "none"  # none | int8_ef
    loss_chunk: int = 1024          # sequence chunk for cross-entropy
    seed: int = 0
    checkpoint_every: int = 100
    keep_checkpoints: int = 3


@dataclass(frozen=True)
class ServeConfig:
    max_seqs: int = 128
    prefill_chunk: int = 2048
    kv_cache_dtype: str = "bfloat16"
    kv_placement: str = "auto"      # auto | hbm | host (PlacementAdvisor)


@dataclass(frozen=True)
class MeshConfig:
    data: int = 16
    model: int = 16
    pods: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model * self.pods

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.pods > 1 else ("data", "model")

    @property
    def shape(self) -> Tuple[int, ...]:
        if self.pods > 1:
            return (self.pods, self.data, self.model)
        return (self.data, self.model)


# Default per (arch-size) microbatch ladder.  The thresholds are the JAX
# package's, kept unchanged for parity; they were not re-derived for the
# H100's memory.
def default_microbatches(cfg: ModelConfig, shape: ShapeSpec,
                         mesh: MeshConfig) -> int:
    if shape.kind != "train":
        return 1
    dp = mesh.data * mesh.pods
    batch_per_replica = max(1, shape.global_batch // dp)
    tokens_per_replica = batch_per_replica * shape.seq_len
    # aim for <= 8192 tokens per microbatch per replica for d_model >= 4096,
    # <= 16384 otherwise
    target = 8_192 if cfg.d_model >= 4_096 else 16_384
    mb = max(1, tokens_per_replica // target)
    while batch_per_replica % mb != 0:
        mb -= 1
    return mb


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from repro_torch import configs as _c  # noqa: F401  (ensure modules imported)
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> List[str]:
    from repro_torch import configs as _c  # noqa: F401
    return sorted(_REGISTRY)

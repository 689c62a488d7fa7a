"""jamba-v0.1-52b — hybrid Mamba + attention (1:7), MoE 16e top-2.

[arXiv:2403.19887; hf:ai21labs/Jamba-v0.1]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.

Layer pattern (period 8): attention at index 4 of each period, Mamba
elsewhere (1:7 attn:mamba). MoE replaces the FFN on every other layer
(odd indices). Jamba v0.1 uses Mamba-1 selective scan; we implement the
Mamba layers with the SSD scan (diagonal-A case) — see DESIGN.md
§Arch-applicability for the recorded adaptation.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    rope_theta=0.0,          # Jamba attention layers use no positional encoding
    tie_embeddings=False,
    act_fn="silu",
    attn_every=8,
    attn_offset=4,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336,
                  moe_every=2, moe_offset=1, capacity_factor=1.25),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1),
    source="arXiv:2403.19887",
))

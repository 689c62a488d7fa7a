"""olmoe-1b-7b — MoE decoder, 64 experts top-8.

[arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924]
16L d_model=2048 16H (kv=16, MHA) expert d_ff=1024 vocab=50304, 64e top-8.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=50304,
    rope_theta=10_000.0,
    tie_embeddings=False,
    act_fn="silu",
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024,
                  moe_every=1, capacity_factor=1.25),
    source="arXiv:2409.02060",
))

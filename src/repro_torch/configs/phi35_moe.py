"""phi3.5-moe-42b-a6.6b — MoE decoder, 16 experts top-2.

[hf:microsoft/Phi-3.5-MoE-instruct]
32L d_model=4096 32H (GQA kv=8) expert d_ff=6400 vocab=32064, 16e top-2.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,                   # every FFN is MoE
    vocab_size=32064,
    rope_theta=10_000.0,
    tie_embeddings=False,
    act_fn="silu",
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400,
                  moe_every=1, capacity_factor=1.25),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
))

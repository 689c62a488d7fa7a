"""glm4-9b — dense decoder, RoPE + GQA.

[hf:THUDM/glm-4-9b]
40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    rope_theta=10_000.0,
    qkv_bias=True,           # GLM-4 uses add_qkv_bias
    tie_embeddings=False,
    act_fn="silu",
    source="hf:THUDM/glm-4-9b",
))

"""qwen2-1.5b — dense decoder, GQA with QKV bias, full attention.

[arXiv:2407.10671; hf:Qwen/Qwen2-1.5B]
28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    tie_embeddings=True,
    act_fn="silu",
    source="arXiv:2407.10671",
))

"""musicgen-large — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf:facebook/musicgen-large]
48L d_model=2048 32H (kv=32, MHA) d_ff=8192 vocab=2048 (EnCodec codebook).

The EnCodec/conditioning frontend is a STUB per the assignment:
``input_specs()`` provides precomputed frame embeddings which are added to
the token embeddings (the backbone transformer is fully real).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    rope_theta=10_000.0,
    tie_embeddings=False,
    act_fn="gelu",
    frontend="audio",
    source="arXiv:2306.05284",
))

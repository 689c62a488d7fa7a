"""gemma3-1b — dense decoder, 5:1 local:global attention, 128k (32k native).

[hf:google/gemma-3-1b-pt; unverified tier per assignment]
26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    sliding_window=512,
    global_every=6,
    qk_norm=True,
    tie_embeddings=True,
    scale_embed=True,
    act_fn="gelu",
    source="hf:google/gemma-3-1b-pt",
))

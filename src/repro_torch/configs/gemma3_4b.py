"""gemma3-4b — dense decoder, 5:1 local:global attention, 128k context.

[hf:google/gemma-3-4b-pt; unverified tier per assignment]
34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,            # gemma3 uses 256, decoupled from d_model/n_heads
    d_ff=10240,
    vocab_size=262144,
    rope_theta=1_000_000.0,  # global layers
    rope_theta_local=10_000.0,
    sliding_window=1024,
    global_every=6,          # 5 local : 1 global
    attn_logit_softcap=0.0,
    qk_norm=True,
    tie_embeddings=True,
    scale_embed=True,
    act_fn="gelu",
    source="hf:google/gemma-3-4b-pt",
))

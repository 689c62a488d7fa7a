"""mamba2-370m — attention-free SSM (SSD, state-space duality).

[arXiv:2405.21060]
48L d_model=1024 d_ff=0 vocab=50280, ssm_state=128, expand=2, headdim=64.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,       # padded to 50432 for sharding
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1),
    source="arXiv:2405.21060",
))

"""internvl2-26b — VLM: InternViT frontend (STUB) + InternLM2-20B backbone.

[arXiv:2404.16821; hf:OpenGVLab/InternVL2-26B]
48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.

The InternViT vision tower is a STUB per the assignment: ``input_specs()``
provides 256 precomputed patch embeddings per sequence, prepended to the
text-token embeddings. The LM backbone is fully real.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,       # padded to 92672 for sharding (ModelConfig.padded_vocab)
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    act_fn="silu",
    frontend="vlm",
    n_prefix_embeds=256,
    source="arXiv:2404.16821",
))

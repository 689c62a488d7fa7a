"""Config registry — one module per assigned architecture."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES, SHAPE_ORDER, MeshConfig, ModelConfig, MoEConfig, SSMConfig,
    ServeConfig, ShapeSpec, TrainConfig, default_microbatches, get_config,
    list_configs, register,
)

# Import every arch module so registration side effects run.
from repro_torch.configs import (  # noqa: F401
    gemma3_4b, gemma3_1b, qwen2_1_5b, glm4_9b, phi35_moe, olmoe_1b_7b,
    musicgen_large, internvl2_26b, mamba2_370m, jamba_52b,
)

ALL_ARCHS = [
    "gemma3-4b",
    "qwen2-1.5b",
    "gemma3-1b",
    "glm4-9b",
    "phi3.5-moe-42b-a6.6b",
    "olmoe-1b-7b",
    "musicgen-large",
    "internvl2-26b",
    "mamba2-370m",
    "jamba-v0.1-52b",
]

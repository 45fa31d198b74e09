"""The reference's model configurations, copied (pure Python)."""
from repro_torch.configs.base import (  # noqa: F401
    MLAConfig,
    ModelConfig,
    MoEConfig,
    RecurrentConfig,
    SHAPES,
    ShapeConfig,
    get_config,
    list_archs,
    shape_applicable,
    smoke_config,
)

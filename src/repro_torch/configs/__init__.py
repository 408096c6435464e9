from repro_torch.configs.base import (
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    SharePrefillConfig,
    reduced_config,
)
from repro_torch.configs.registry import REGISTRY, get_config, get_smoke_config

__all__ = [
    "INPUT_SHAPES", "InputShape", "ModelConfig", "SharePrefillConfig",
    "reduced_config", "REGISTRY", "get_config", "get_smoke_config",
]

from repro_torch.configs.base import (
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    SharePrefillConfig,
    reduced_config,
)
from repro_torch.configs.registry import (
    ASSIGNED,
    PAPER_MODELS,
    REGISTRY,
    SKIP_PAIRS,
    dryrun_pairs,
    get_config,
    get_shape,
    get_smoke_config,
    list_archs,
)

__all__ = [
    "INPUT_SHAPES", "InputShape", "ModelConfig", "SharePrefillConfig",
    "reduced_config", "ASSIGNED", "PAPER_MODELS", "REGISTRY", "SKIP_PAIRS",
    "dryrun_pairs", "get_config", "get_shape", "get_smoke_config",
    "list_archs",
]

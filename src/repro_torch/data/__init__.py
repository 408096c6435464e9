from repro_torch.data.pipeline import (
    TASKS,
    DataConfig,
    batches,
    eval_batches,
    sample,
)

__all__ = ["TASKS", "DataConfig", "batches", "eval_batches", "sample"]

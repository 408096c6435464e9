from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_adamw,
)
from repro_torch.optim.schedule import (constant, inverse_sqrt,
                                        linear_warmup_cosine)

__all__ = [
    "AdamWConfig", "AdamWState", "adamw_update", "clip_by_global_norm",
    "global_norm", "init_adamw", "constant", "inverse_sqrt",
    "linear_warmup_cosine",
]

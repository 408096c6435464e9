from repro_torch.serving.decode_plan import (
    build_decode_plan,
    empty_decode_plan,
    plan_block_counts,
    plan_traffic_fraction,
    update_plan_slot,
)
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine
from repro_torch.serving.errors import RequestError
from repro_torch.serving.faults import (
    CancelAt,
    FaultInjector,
    HoldPages,
    NaNLogits,
    PrefillError,
    SlowQuantum,
)
from repro_torch.serving.paged_cache import (
    NULL_PAGE,
    PageAllocator,
    PageAllocatorError,
    init_paged_pool,
)
from repro_torch.serving.prefix_cache import (PrefixEntry, PrefixIndex,
                                              prefix_digest)
from repro_torch.serving.sampling import SamplingConfig, sample_token
from repro_torch.serving.scheduler import SchedulerHandle, SlotScheduler
from repro_torch.serving.width_policy import (auto_width_cap,
                                              population_width_cap)

__all__ = ["CancelAt", "EngineConfig", "FaultInjector", "HoldPages",
           "NULL_PAGE", "NaNLogits", "PageAllocator", "PageAllocatorError",
           "PrefillError", "PrefixEntry", "PrefixIndex", "Request",
           "RequestError", "SamplingConfig", "SchedulerHandle",
           "ServingEngine", "SlotScheduler", "SlowQuantum", "auto_width_cap",
           "build_decode_plan", "empty_decode_plan", "init_paged_pool",
           "plan_block_counts", "plan_traffic_fraction",
           "population_width_cap", "prefix_digest", "sample_token",
           "update_plan_slot"]

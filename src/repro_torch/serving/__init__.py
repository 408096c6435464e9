from repro_torch.serving.engine import EngineConfig, Request, ServingEngine
from repro_torch.serving.errors import RequestError
from repro_torch.serving.sampling import SamplingConfig
from repro_torch.serving.scheduler import SlotScheduler

__all__ = ["EngineConfig", "Request", "RequestError", "SamplingConfig",
           "ServingEngine", "SlotScheduler"]

from repro_torch.serving.engine import EngineConfig, Request, ServingEngine
from repro_torch.serving.sampling import SamplingConfig

__all__ = ["EngineConfig", "Request", "SamplingConfig", "ServingEngine"]

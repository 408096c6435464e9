from repro_torch.models.api import Model, build_model, resolve_device

__all__ = ["Model", "build_model", "resolve_device"]

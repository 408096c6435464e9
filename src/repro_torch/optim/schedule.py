"""Learning-rate schedules (port of ``repro/optim/schedule.py``): pure
functions of the step, computed in float32 as the reference computes
them.  ``step`` is an int or a tensor (the optimizer's int32 step, on its
device); the result is a float32 tensor on the step's device."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup_cosine(step, *, warmup_steps: int, total_steps: int,
                         min_ratio: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = (step + 1.0) / max(warmup_steps, 1)
    prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, value: float = 1.0) -> torch.Tensor:
    return torch.full_like(_f32(step), value)


def inverse_sqrt(step, *, warmup_steps: int) -> torch.Tensor:
    step = _f32(step)
    warm = (step + 1.0) / max(warmup_steps, 1)
    decay = torch.sqrt(warmup_steps / torch.clamp(step, min=warmup_steps))
    return torch.where(step < warmup_steps, warm, decay)

"""Jensen-Shannon distance (port of ``repro/core/jsd.py``).

Base-2 logarithms, so the divergence and the distance lie in [0, 1]; the
eps clamps are the reference's.
"""
from __future__ import annotations

import torch

_EPS = 1e-12
_LN2 = 0.6931471805599453


def _kl(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """KL(p‖q) in bits along the last axis."""
    p = torch.clamp(p, _EPS, 1.0)
    q = torch.clamp(q, _EPS, 1.0)
    return (p * (torch.log(p) - torch.log(q))).sum(dim=-1) / _LN2


def js_divergence(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    m = 0.5 * (p + q)
    return 0.5 * _kl(p, m) + 0.5 * _kl(q, m)


def js_distance(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """√JSD(p‖q) — the metric of d_sparse and d_sim."""
    return torch.sqrt(torch.clamp(js_divergence(p, q), min=0.0))


def js_distance_to_uniform(p: torch.Tensor) -> torch.Tensor:
    """d_sparse = √JSD(p‖u), u uniform over the last axis."""
    u = torch.full_like(p, 1.0 / p.shape[-1])
    return js_distance(p, u)


def normalize(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Project non-negative scores onto the simplex along ``axis``."""
    x = torch.clamp(x, min=0.0)
    return x / torch.clamp(x.sum(dim=axis, keepdim=True), min=_EPS)

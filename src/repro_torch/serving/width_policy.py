"""Width-cap policies: pick the sparse prefill kernel's block budget W
(port of ``repro/serving/width_policy.py``).

``attn_width=W`` bounds each (head, q-block) row of the block-sparse
prefill kernel at its W most recent kept blocks.  Two policies resolve W
from what earlier prefills of a bucket showed:

  * :func:`auto_width_cap` — a percentile of the observed mean block
    densities, times a safety factor (``width_policy="auto"``);
  * :func:`population_width_cap` — the observed kept-block populations
    themselves, the largest row by default (``width_policy="count"``).

Both keep each row's most recent blocks (:func:`~repro_torch.kernels.
indices.cap_block_mask`).  A third, ragged policy,
:func:`score_mass_budgets`, gives each (head, row) its own budget from
block scores: the smallest top-score prefix holding ``mass`` of the row's
total.  Decode-plan refresh (:mod:`repro_torch.serving.refresh`) feeds it
to :func:`~repro_torch.kernels.indices.ragged_top_mask`; the decode
kernels' ``counts`` guard takes ragged rows as they are.

The engine records each prefill's observable (mean density, largest row
population) and resolves W once per bucket, after the first observation.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def auto_width_cap(densities: Sequence[float], nb: int, *,
                   percentile: float = 95.0,
                   safety: float = 1.25) -> int:
    """W from observed mean block densities (fractions in [0, 1]) at ``nb``
    kv block columns: ``ceil(percentile density · nb · safety)``, clamped
    to [1, nb]."""
    if not len(densities):
        raise ValueError("auto_width_cap needs at least one density sample")
    d = float(np.percentile(np.asarray(densities, np.float64), percentile))
    w = int(np.ceil(d * nb * safety))
    return max(1, min(w, nb))


def population_width_cap(row_populations: Sequence[float], nb: int, *,
                         percentile: float = 100.0,
                         safety: float = 1.1) -> int:
    """W from observed kept-block row populations (one per mask row, or
    one largest row per prefill as the engine records them):
    ``ceil(percentile population · safety)``, clamped to [1, nb]."""
    if not len(row_populations):
        raise ValueError(
            "population_width_cap needs at least one population sample")
    p = float(np.percentile(np.asarray(row_populations, np.float64),
                            percentile))
    w = int(np.ceil(p * safety))
    return max(1, min(w, nb))


def score_mass_budgets(scores: torch.Tensor, *, mass: float,
                       min_width: int = 1,
                       max_width: Optional[int] = None) -> torch.Tensor:
    """Per-row ragged block budgets ``(…,)`` int32 from non-negative
    ``(…, NB)`` block scores: the smallest k whose k highest scores hold
    at least ``mass`` of the row's total, clamped to ``[min_width,
    max_width]`` (``max_width=None``: NB).  An all-zero row gets
    ``min_width``."""
    nb = scores.shape[-1]
    hi = nb if max_width is None else max(1, min(int(max_width), nb))
    lo = max(1, min(int(min_width), hi))
    desc = torch.sort(scores.float(), dim=-1, descending=True).values
    cum = torch.cumsum(desc, dim=-1)
    target = torch.tensor(mass, dtype=torch.float32) * cum[..., -1:]
    k = 1 + (cum < target).sum(dim=-1, dtype=torch.int32)
    return torch.clamp(k, lo, hi).to(torch.int32)

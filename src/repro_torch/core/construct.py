"""Pivotal pattern construction, paper Algorithm 2 (port of
``repro/core/construct.py``), batched over any leading axes.

From the block-averaged QK logits Ã of a head that ran dense attention:
row-softmax over kv blocks, the last row is the representative ã, and the
minimal block set with cumulative mass ≥ γ (plus the block diagonal) is the
pivotal mask M.  Skipped blocks carry −inf in Ã and so zero mass.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.patterns import cumulative_topk_mask


def block_softmax(a_tilde: torch.Tensor) -> torch.Tensor:
    """Row-wise softmax over kv blocks; rows with no finite entry → 0."""
    row_max = a_tilde.amax(dim=-1, keepdim=True)
    safe_max = torch.where(torch.isfinite(row_max), row_max, 0.0)
    e = torch.where(torch.isfinite(a_tilde), torch.exp(a_tilde - safe_max),
                    0.0)
    return e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-12)


def construct_pivotal_pattern(a_tilde: torch.Tensor, gamma: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(…, NB, NB)`` Ã → ``(mask (…, NB, NB) bool, rep (…, NB) f32)``."""
    scores = block_softmax(a_tilde.float())
    rep = scores[..., -1, :]
    nb = scores.shape[-1]
    flat = scores.reshape(*scores.shape[:-2], nb * nb)
    mask = cumulative_topk_mask(flat, gamma).reshape(scores.shape)
    diag = torch.eye(nb, dtype=torch.bool, device=a_tilde.device)
    return mask | diag, rep

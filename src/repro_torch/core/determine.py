"""Sparse-pattern determination, paper Algorithm 3 (port of
``repro/core/determine.py``), batched over any leading axes.

For each head, â is the block-pooled attention of the last query block;

    d_sparse = √JSD(â ‖ u),   d_sim = √JSD(â ‖ ã)

and the pattern source is

    shared_pivot    if d_sparse < δ ∧ d_sim < τ ∧ a pivot exists
    dense           if d_sparse < δ ∧ no pivot yet ∧ the head is its
                    cluster's first head in this layer
    vertical_slash  otherwise (noise clusters and highly sparse heads).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.jsd import js_distance, js_distance_to_uniform

PATTERN_SHARED = 0
PATTERN_DENSE = 1
PATTERN_VERTICAL_SLASH = 2


class PatternDecision(NamedTuple):
    use_shared: torch.Tensor    # (…, H) bool
    use_dense: torch.Tensor     # (…, H) bool
    use_vs: torch.Tensor        # (…, H) bool
    a_hat_blocks: torch.Tensor  # (…, H, NB)
    d_sparse: torch.Tensor      # (…, H)
    d_sim: torch.Tensor         # (…, H)


def pooled_block_estimate(strip: torch.Tensor,
                          block_size: int) -> torch.Tensor:
    """â from a ``(…, b, N)`` softmaxed strip: sum within kv blocks, mean
    over rows, normalized; ``(…, NB)``."""
    b, n = strip.shape[-2:]
    nb = n // block_size
    per_block = strip.reshape(*strip.shape[:-1], nb, block_size).sum(-1)
    a_hat = per_block.mean(dim=-2)
    return a_hat / torch.clamp(a_hat.sum(dim=-1, keepdim=True), min=1e-12)


def first_head_in_cluster(cluster_ids: torch.Tensor) -> torch.Tensor:
    """(H,) bool: the head is the lowest-indexed head of its cluster."""
    eq = (cluster_ids[:, None] == cluster_ids[None, :]).to(torch.int32)
    first_idx = torch.argmax(eq, dim=1)     # argmax returns the first max
    return torch.arange(cluster_ids.shape[0],
                        device=cluster_ids.device) == first_idx


def determine_sparse_pattern(
    a_hat_blocks: torch.Tensor,     # (…, H, NB)
    cluster_ids: torch.Tensor,      # (H,) int, -1 = noise
    pivot_reps: torch.Tensor,       # (…, H, NB)
    pivot_valid: torch.Tensor,      # (…, H) bool
    *,
    delta: float,
    tau: float,
) -> PatternDecision:
    """Algorithm 3, vectorized over heads (and any leading batch axes)."""
    d_sparse = js_distance_to_uniform(a_hat_blocks)
    d_sim = js_distance(a_hat_blocks, pivot_reps)
    noise = cluster_ids < 0
    not_sparse = d_sparse < delta
    similar = d_sim < tau
    first = first_head_in_cluster(cluster_ids)
    use_shared = not_sparse & similar & pivot_valid & ~noise
    use_dense = not_sparse & ~pivot_valid & first & ~noise
    use_vs = ~(use_shared | use_dense)
    return PatternDecision(use_shared, use_dense, use_vs, a_hat_blocks,
                           d_sparse, d_sim)

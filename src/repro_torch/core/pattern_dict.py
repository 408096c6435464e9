"""The pivotal-pattern dictionary (port of ``repro/core/pattern_dict.py``).

Each sample of a batch carries its own dictionary ``cluster → (M, ã)``;
the state's leaves have a leading batch axis.  Lookups gather by cluster id
and updates are one-hot sums thresholded at 0.5, as in the reference (at
most one head per cluster updates per layer: its first head, so the sums
are exact).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class PivotalState(NamedTuple):
    masks: torch.Tensor   # (B, C, NB, NB) bool — pivotal patterns M
    reps: torch.Tensor    # (B, C, NB) f32 — pivotal representatives ã
    valid: torch.Tensor   # (B, C) bool — a pivot exists for the cluster

    @property
    def num_clusters(self) -> int:
        return self.masks.shape[1]


def init_pivotal_state(num_clusters: int, nb: int, dtype=torch.float32, *,
                       device=None) -> PivotalState:
    """One sample's empty dictionary, leaves ``(C, NB, NB)``, ``(C, NB)``
    and ``(C,)``: no pivots, uniform representatives (the reference's
    layout; :func:`~repro_torch.core.share_attention.init_batched_state`
    stacks it per sample)."""
    return PivotalState(
        masks=torch.zeros((num_clusters, nb, nb), dtype=torch.bool,
                          device=device),
        reps=torch.full((num_clusters, nb), 1.0 / nb, dtype=dtype,
                        device=device),
        valid=torch.zeros((num_clusters,), dtype=torch.bool, device=device))


def lookup(state: PivotalState, cluster_ids: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-head ``(M (B, H, NB, NB), ã (B, H, NB), valid (B, H))``; noise ids
    (−1) read slot 0 but are invalid."""
    safe = cluster_ids.clamp(0, state.num_clusters - 1).long()
    valid = state.valid[:, safe] & (cluster_ids >= 0)
    return state.masks[:, safe], state.reps[:, safe], valid


def update(state: PivotalState,
           cluster_ids: torch.Tensor,     # (H,)
           new_masks: torch.Tensor,       # (B, H, NB, NB) bool
           new_reps: torch.Tensor,        # (B, H, NB)
           should_update: torch.Tensor,   # (B, H) bool — heads that ran dense
           ) -> PivotalState:
    c = state.num_clusters
    onehot = (torch.arange(c, device=cluster_ids.device)[None, :]
              == cluster_ids[:, None])                       # (H, C)
    onehot = (onehot[None] & should_update[..., None]
              & (cluster_ids >= 0)[None, :, None])            # (B, H, C)
    w = onehot.to(state.reps.dtype)
    touched = onehot.any(dim=1)                                # (B, C)
    upd_masks = torch.einsum("bhc,bhij->bcij", w,
                             new_masks.to(state.reps.dtype)) > 0.5
    upd_reps = torch.einsum("bhc,bhn->bcn", w, new_reps)
    return PivotalState(
        masks=torch.where(touched[..., None, None], upd_masks, state.masks),
        reps=torch.where(touched[..., None], upd_reps, state.reps),
        valid=state.valid | touched)


def merge_across_devices(state: PivotalState) -> PivotalState:
    """The identity, as in the reference: every rank of a heads-sharded
    serve computes the whole dictionary itself (the strips and decisions
    run replicated, and the gathered Ã is the same on every rank), so there
    is nothing to merge."""
    return state

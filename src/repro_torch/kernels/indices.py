"""Mask → ``(indices, counts)`` staging for the block-sparse kernels.

The port of ``repro/kernels/indices.py``; the contract is the same, and the
tables must equal the reference's exactly:

  * ``indices`` — ``(…, NBq, W)`` int32: each query-block row's active
    kv-block ids in ascending order, padded by repeating the last kept id;
  * ``counts`` — ``(…, NBq)`` int32: the number of kept ids per row;
  * ``W = width`` caps a row at its ``W`` highest-index (most recent)
    active blocks; ``width=None`` is lossless (``W = NBkv``).

The reference's ragged-schedule stats layout ``(B, T, H)`` and its
``scatter_schedule_stats`` inverse exist because the TPU grid runs in order;
the port's batched CUDA kernel writes Ã in place, so neither is ported.  The
single-sample kernel returns its stats compact per table slot, and
:func:`scatter_block_stats` is their inverse.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def compact_block_mask(block_mask: torch.Tensor,
                       width: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…, NBq, NBkv) bool mask → ``(indices (…, NBq, W), counts (…, NBq))``."""
    nb_kv = block_mask.shape[-1]
    w = nb_kv if width is None else max(1, min(int(width), nb_kv))
    cols = torch.arange(nb_kv, dtype=torch.int32, device=block_mask.device)
    # active columns sort before inactive ones, each group ascending; the
    # keys are unique, so any sort gives the reference's order
    key = torch.where(block_mask, cols, cols + nb_kv)
    order = torch.argsort(key, dim=-1).to(torch.int32)
    counts = block_mask.sum(dim=-1, dtype=torch.int32)
    kept = torch.clamp(counts, max=w)
    # under a cap, keep the W highest-index actives: ranks [counts-W, counts)
    start = torch.clamp(counts - w, min=0)
    ws = torch.arange(w, dtype=torch.int32, device=block_mask.device)
    pos = torch.clamp(start[..., None] + ws, max=nb_kv - 1)
    gathered = torch.gather(order, -1, pos.long())
    last_kept = torch.gather(order, -1,
                             torch.clamp(counts - 1, min=0)[..., None].long())
    indices = torch.where(ws < kept[..., None], gathered, last_kept)
    return indices.to(torch.int32), kept.to(torch.int32)


def cap_block_mask(block_mask: torch.Tensor, width: int) -> torch.Tensor:
    """Boolean form of the W cap: keep each row's ``width`` highest-index
    active blocks — the truncation :func:`compact_block_mask` applies."""
    w = max(1, min(int(width), block_mask.shape[-1]))
    counts = block_mask.sum(dim=-1, keepdim=True)
    rank = torch.cumsum(block_mask.to(torch.int32), dim=-1)
    return block_mask & (rank > counts - w)


def ragged_top_mask(scores: torch.Tensor,
                    widths: torch.Tensor) -> torch.Tensor:
    """(…, NB) scores and (…,) per-row budgets → the bool mask keeping each
    row's ``widths`` highest-scoring blocks.  Ties break toward the higher
    block index (the recent band), as the reference's ``lexsort`` does:
    two stable sorts give its order — index descending, then score
    descending."""
    nb = scores.shape[-1]
    flip = torch.arange(nb - 1, -1, -1, device=scores.device)
    s = scores.float().index_select(-1, flip)        # index descending
    order = flip[torch.sort(s, dim=-1, descending=True, stable=True)
                 .indices]
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(nb, device=scores.device)
                  .expand_as(order).contiguous())
    return rank < widths[..., None]


def ragged_cap_block_mask(block_mask: torch.Tensor,
                          widths: torch.Tensor) -> torch.Tensor:
    """Ragged :func:`cap_block_mask`: keep each row's ``widths``
    highest-index active blocks; rows with fewer actives are unchanged."""
    counts = block_mask.sum(dim=-1, keepdim=True)
    rank = torch.cumsum(block_mask.to(torch.int32), dim=-1)
    return block_mask & (rank > counts - widths[..., None])


def table_block_mask(indices: torch.Tensor, counts: torch.Tensor,
                     nb_kv: int) -> torch.Tensor:
    """``(indices, counts)`` → the (…, NBq, NBkv) bool mask of the blocks
    the tables list (entries at ranks ≥ ``counts`` are padding)."""
    w = indices.shape[-1]
    live = torch.arange(w, device=indices.device) < counts[..., None]
    cols = torch.arange(nb_kv, device=indices.device)
    hit = (indices[..., None] == cols) & live[..., None]   # (…, W, NBkv)
    return hit.any(dim=-2)


def build_block_tables(block_mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lossless (uncapped) :func:`compact_block_mask`."""
    return compact_block_mask(block_mask, width=None)


def scatter_block_stats(stats_compact: torch.Tensor, indices: torch.Tensor,
                        nb_kv: int) -> torch.Tensor:
    """Compact per-slot stats ``(…, NBq, W)`` → the full ``(…, NBq, NBkv)``
    f32 Ã with a −inf background.  A max-scatter: padded slots repeat the
    last kept id and carry −inf, so they never overwrite its value."""
    full = torch.full((*stats_compact.shape[:-1], nb_kv), float("-inf"),
                      dtype=torch.float32, device=stats_compact.device)
    return full.scatter_reduce(-1, indices.long(),
                               stats_compact.to(torch.float32), reduce="amax")

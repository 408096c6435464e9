"""Block-sparse pattern algebra (port of ``repro/core/patterns.py``).

Patterns are block-granular boolean masks ``(…, NBq, NBkv)`` with True =
"compute this (q block, kv block) tile"; q blocks index rows, kv blocks
columns, and "slash" diagonals are indexed by offset ``o = i − j``.  Every
function takes any leading batch axes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def num_blocks(seq_len: int, block_size: int) -> int:
    if seq_len % block_size:
        raise ValueError(
            f"seq_len {seq_len} not divisible by block_size {block_size}; "
            "pad sequences to a block multiple before attention")
    return seq_len // block_size


def causal_block_mask(nb_q: int, nb_kv: Optional[int] = None, *,
                      device=None) -> torch.Tensor:
    """Lower-triangular block mask (diagonal blocks included)."""
    nb_kv = nb_q if nb_kv is None else nb_kv
    i = torch.arange(nb_q, device=device)[:, None]
    j = torch.arange(nb_kv, device=device)[None, :]
    return j <= i + (nb_kv - nb_q)


def dense_block_mask(nb_q: int, nb_kv: Optional[int] = None,
                     causal: bool = True, *, device=None) -> torch.Tensor:
    """Every block of the grid: the causal ones, or all of them."""
    nb_kv = nb_q if nb_kv is None else nb_kv
    if causal:
        return causal_block_mask(nb_q, nb_kv, device=device)
    return torch.ones((nb_q, nb_kv), dtype=torch.bool, device=device)


def sliding_window_block_mask(nb: int, window_blocks: int,
                              sink_blocks: int = 1, *,
                              device=None) -> torch.Tensor:
    """Causal sliding window of ``window_blocks`` diagonals (0 … w−1) plus
    the first ``sink_blocks`` kv-block columns (attention sinks)."""
    i = torch.arange(nb, device=device)[:, None]
    j = torch.arange(nb, device=device)[None, :]
    return (j <= i) & (((i - j) < window_blocks) | (j < sink_blocks))


def segment_block_mask(nb: int, seg_blocks: int, *,
                       device=None) -> torch.Tensor:
    """Block-diagonal isolation mask of a packed prefill: ``nb`` blocks in
    contiguous segments of ``seg_blocks``, and a q block sees only the kv
    blocks of its own segment."""
    if seg_blocks <= 0 or nb % seg_blocks:
        raise ValueError(
            f"segment of {seg_blocks} blocks does not tile {nb} blocks")
    seg = torch.arange(nb, device=device) // seg_blocks
    return seg[:, None] == seg[None, :]


def vertical_block_mask(nb: int, col_active: torch.Tensor) -> torch.Tensor:
    """Active kv-block columns ``(…, NB)`` → causal ``(…, NB, NB)`` mask."""
    causal = causal_block_mask(nb, device=col_active.device)
    return col_active[..., None, :] & causal


def slash_block_mask(nb: int, offset_active: torch.Tensor) -> torch.Tensor:
    """Active block diagonals ``(…, NB)`` (offset o = i − j) → mask."""
    i = torch.arange(nb, device=offset_active.device)[:, None]
    j = torch.arange(nb, device=offset_active.device)[None, :]
    off = i - j
    valid = off >= 0
    return offset_active[..., off.clamp(0, nb - 1)] & valid


def a_shape_block_mask(nb: int, sink_blocks: int, local_blocks: int, *,
                       device=None) -> torch.Tensor:
    """MInference's "A-shape": attention-sink columns plus a local window."""
    return sliding_window_block_mask(nb, local_blocks, sink_blocks,
                                     device=device)


def block_mask_density(mask: torch.Tensor) -> torch.Tensor:
    """Fraction of *causal* blocks that are computed, per leading index."""
    nb_q, nb_kv = mask.shape[-2:]
    causal = causal_block_mask(nb_q, nb_kv, device=mask.device)
    total = causal.sum()
    return (mask & causal).sum(dim=(-2, -1)) / total


def expand_block_mask(mask: torch.Tensor, block_size: int) -> torch.Tensor:
    """Block mask ``(…, NBq, NBkv)`` → token mask ``(…, NBq·bs, NBkv·bs)``."""
    return mask.repeat_interleave(block_size, dim=-2).repeat_interleave(
        block_size, dim=-1)


def cumulative_topk_mask(scores: torch.Tensor, gamma: float) -> torch.Tensor:
    """The minimal set of entries whose mass reaches ``gamma`` (last axis).

    Sort descending, keep the shortest prefix whose cumulative sum reaches
    γ.  The sort is stable on ``-s``, as the reference's ``jnp.argsort``
    is, so equal scores keep index order on both sides.
    """
    s = scores / torch.clamp(scores.sum(dim=-1, keepdim=True), min=1e-12)
    order = torch.argsort(-s, dim=-1, stable=True)
    sorted_s = torch.gather(s, -1, order)
    csum = torch.cumsum(sorted_s, dim=-1)
    # keep entries strictly before the threshold crossing, plus the crosser
    keep_sorted = (csum - sorted_s) < gamma
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)


def indices_to_mask(indices: torch.Tensor, size: int) -> torch.Tensor:
    """The paper's index_to_mask: an index set scattered into a ``(size,)``
    bool mask."""
    mask = torch.zeros((size,), dtype=torch.bool, device=indices.device)
    mask[indices.long()] = True
    return mask


def active_block_table(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-q-block active kv-block lists of a ``(NBq, NBkv)`` mask, on the
    host (numpy in and out): ``(indices, counts)`` with ``indices[i,
    :counts[i]]`` the kv blocks of row i, padded with the row's last index
    (block 0 for an empty row) and at least one column wide."""
    mask = np.asarray(mask, bool)
    nb_q = mask.shape[0]
    counts = mask.sum(axis=1).astype(np.int32)
    width = int(max(counts.max(), 1))
    indices = np.zeros((nb_q, width), dtype=np.int32)
    for i in range(nb_q):
        idx = np.nonzero(mask[i])[0]
        if len(idx) == 0:
            idx = np.array([0])
        indices[i, :len(idx)] = idx
        indices[i, len(idx):] = idx[-1]
    return indices, counts

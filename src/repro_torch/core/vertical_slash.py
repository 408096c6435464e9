"""Cumulative-threshold vertical-slash search, paper Algorithm 5 (port of
``repro/core/vertical_slash.py``), batched over any leading axes.

From a (bs, N) strip of attention scores, vertical (column) and slash
(diagonal) directions are summed, normalized, and the minimal sets covering
mass γ are selected, quantized to block columns / block diagonals, and
expanded into a causal block mask.  :func:`search_vertical_slash_pattern`
is the reference's single-head form, from q and k.
"""
from __future__ import annotations

import torch

from repro_torch.core.patterns import (
    cumulative_topk_mask,
    slash_block_mask,
    vertical_block_mask,
)
# the strip lives with its kernel (re-exported, as in the reference); the
# kernels package does not depend on repro_torch.core
from repro_torch.kernels.strip import compute_strips
from repro_torch.kernels.strip import strip_scores  # noqa: F401


def vertical_slash_direction_scores(a_hat: torch.Tensor):
    """Column mass ``a_v (…, N)`` and diagonal mass ``a_s (…, N)`` of a
    ``(…, b, N)`` strip; diagonal offset ``o = query_pos − key_pos``."""
    b, n = a_hat.shape[-2:]
    a_v = a_hat.sum(dim=-2)
    offs = torch.arange(n, device=a_hat.device)
    rows = torch.arange(b, device=a_hat.device)
    cols = (n - b) + rows[:, None] - offs[None, :]          # (b, N)
    valid = (cols >= 0) & (cols < n)
    idx = cols.clamp(0, n - 1).expand(a_hat.shape)
    gathered = torch.gather(a_hat, -1, idx)
    a_s = torch.where(valid, gathered, 0.0).sum(dim=-2)
    return a_v, a_s


def token_sets_to_block_sets(v_keep: torch.Tensor, s_keep: torch.Tensor,
                             block_size: int):
    """Token-level column/diagonal selections → block granularity."""
    n = v_keep.shape[-1]
    nb = n // block_size
    col_active = v_keep.reshape(*v_keep.shape[:-1], nb, block_size).any(-1)
    # a token diagonal straddles two block diagonals: mark both
    lo = s_keep.reshape(*s_keep.shape[:-1], nb, block_size).any(-1)
    hi = torch.cat([lo[..., 1:], torch.zeros_like(lo[..., :1])], dim=-1)
    return col_active, lo | hi


def search_vertical_slash_from_strip(a_hat: torch.Tensor, gamma: float,
                                     block_size: int) -> torch.Tensor:
    """``(…, b, N)`` strip → ``(…, NB, NB)`` causal block mask."""
    n = a_hat.shape[-1]
    nb = n // block_size
    a_v, a_s = vertical_slash_direction_scores(a_hat)
    v_keep = cumulative_topk_mask(a_v, gamma)
    s_keep = cumulative_topk_mask(a_s, gamma)
    col_active, off_active = token_sets_to_block_sets(v_keep, s_keep,
                                                      block_size)
    # always keep the local block diagonal and the sink column, so every
    # query row has a well-defined softmax
    off_active[..., 0] = True
    col_active[..., 0] = True
    return (vertical_block_mask(nb, col_active)
            | slash_block_mask(nb, off_active))


def search_vertical_slash_pattern(q: torch.Tensor, k: torch.Tensor,
                                  gamma: float,
                                  block_size: int) -> torch.Tensor:
    """Algorithm 5 for one head (q, k: ``(N, D)``): the strip of the last
    query block (the strip kernel for CUDA tensors, its plain version for
    CPU tensors), then :func:`search_vertical_slash_from_strip` →
    ``(NB, NB)`` causal block mask."""
    strip = compute_strips(q[None, None].contiguous(),
                           k[None, None].contiguous(),
                           block_size=block_size)[0, 0]
    return search_vertical_slash_from_strip(strip, gamma, block_size)

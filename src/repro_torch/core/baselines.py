"""The sparse-attention baselines the paper compares against (port of
``repro/core/baselines.py``).

  * FlashAttention-2 — exact dense attention (the causal mask itself).
  * MInference — per-head vertical-slash pattern, its indices re-estimated
    from the last query block each call (its default configuration, as in
    the paper, §6.1).
  * FlexPrefill — query-aware block estimate from mean-pooled Q and K with
    a cumulative-γ selection per query block (Lai et al., 2025).

They produce block masks for the same block-sparse kernels SharePrefill
uses, so a comparison isolates the pattern policy, as in the paper.

The per-head functions keep the reference's signatures (q, k ``(N, D)``;
the ``*_masks`` forms over heads).  The model runs the batched, GQA-native
builders instead, :func:`minference_block_masks` and
:func:`flexprefill_block_masks` over q ``(B, H, N, D)`` and k ``(B, Hkv,
N, D)``: each equals :func:`~repro_torch.kernels.ops.gqa_head_vmap` of its
per-head function exactly, and neither repeats K.  MInference's strip is
the strip kernel for CUDA tensors (its plain version for CPU tensors); the
rest are plain PyTorch ops on every device, as in the reference, where no
Pallas kernel computes them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.patterns import (
    causal_block_mask,
    cumulative_topk_mask,
    dense_block_mask,
)
from repro_torch.core.vertical_slash import (
    search_vertical_slash_from_strip,
    search_vertical_slash_pattern,
)
from repro_torch.kernels import compute_strips
from repro_torch.kernels.ops import gqa_head_vmap

# the prefill methods whose masks this module builds
BASELINE_METHODS = ("vertical_slash", "flex")


def flash_attention_mask(num_heads: int, nb: int, *,
                         device=None) -> torch.Tensor:
    """The dense (causal) pattern for every head: ``(H, NB, NB)``."""
    return dense_block_mask(nb, device=device)[None].expand(num_heads, nb,
                                                            nb)


def minference_head_mask(qh: torch.Tensor, kh: torch.Tensor, *,
                         gamma: float, block_size: int) -> torch.Tensor:
    """MInference's default configuration for one head (qh, kh ``(N, D)``)
    → ``(NB, NB)``."""
    return search_vertical_slash_pattern(qh, kh, gamma, block_size)


def minference_masks(q: torch.Tensor, k: torch.Tensor, *, gamma: float,
                     block_size: int) -> torch.Tensor:
    """MInference per head: vertical-slash indices estimated from the last
    query block (q ``(H, N, D)``, k ``(H or Hkv, N, D)``)."""
    return gqa_head_vmap(lambda qh, kh: minference_head_mask(
        qh, kh, gamma=gamma, block_size=block_size), q, k)


def _pool(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """Mean over each block of ``block_size`` rows: ``(…, N, D)`` →
    ``(…, NB, D)``."""
    *lead, n, d = x.shape
    return x.reshape(*lead, n // block_size, block_size, d).mean(dim=-2)


def _pooled_scores(pq: torch.Tensor, pk: torch.Tensor) -> torch.Tensor:
    """Causal row softmax of pooled ``pq pkᵀ/√d``: ``(…, NB, D)`` pairs
    (pk broadcast over q's extra axes) → ``(…, NB, NB)`` float32, zero
    above the diagonal."""
    nb, d = pq.shape[-2:]
    logits = (pq @ pk.transpose(-1, -2)).float() / math.sqrt(d)
    causal = causal_block_mask(nb, device=pq.device)
    logits = logits.masked_fill(~causal, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(causal, torch.exp(logits - m), 0.0)
    return p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)


def pooled_block_scores(q: torch.Tensor, k: torch.Tensor,
                        block_size: int) -> torch.Tensor:
    """FlexPrefill's estimator for one head (q, k ``(N, D)``):
    softmax(pool(Q)·pool(K)ᵀ/√d) over the causal kv blocks, ``(NB, NB)``
    row-stochastic."""
    return _pooled_scores(_pool(q, block_size), _pool(k, block_size))


def _flex_keep(scores: torch.Tensor, gamma: float) -> torch.Tensor:
    """Cumulative-γ selection per row, the local block, causal."""
    nb = scores.shape[-1]
    keep = cumulative_topk_mask(scores, gamma)
    keep = keep | torch.eye(nb, dtype=torch.bool, device=scores.device)
    return keep & causal_block_mask(nb, device=scores.device)


def flexprefill_head_mask(qh: torch.Tensor, kh: torch.Tensor, *,
                          gamma: float, block_size: int) -> torch.Tensor:
    """FlexPrefill's block mask for one head (qh, kh ``(N, D)``)."""
    return _flex_keep(pooled_block_scores(qh, kh, block_size), gamma)


def flexprefill_masks(q: torch.Tensor, k: torch.Tensor, *, gamma: float,
                      block_size: int) -> torch.Tensor:
    """FlexPrefill per head: a cumulative-γ selection per query block over
    pooled block scores (q ``(H, N, D)``, k ``(H or Hkv, N, D)``)."""
    return gqa_head_vmap(lambda qh, kh: flexprefill_head_mask(
        qh, kh, gamma=gamma, block_size=block_size), q, k)


# ------------------------------------------------ batched, GQA-native

def minference_block_masks(q: torch.Tensor, k: torch.Tensor, *,
                           gamma: float, block_size: int) -> torch.Tensor:
    """MInference for a batch: q ``(B, H, N, D)``, k ``(B, Hkv, N, D)`` →
    ``(B, H, NB, NB)``.  One strip launch for the batch (the same ops as
    SharePrefill's vertical-slash branch)."""
    return search_vertical_slash_from_strip(
        compute_strips(q, k, block_size=block_size), gamma, block_size)


def flexprefill_block_masks(q: torch.Tensor, k: torch.Tensor, *,
                            gamma: float, block_size: int) -> torch.Tensor:
    """FlexPrefill for a batch: q ``(B, H, N, D)``, k ``(B, Hkv, N, D)`` →
    ``(B, H, NB, NB)``.  K is pooled once per kv head and its group's
    pooled queries are scored against it (no ``repeat_kv``)."""
    b, h, n, d = q.shape
    hkv = k.shape[1]
    nb = n // block_size
    pq = _pool(q, block_size).reshape(b, hkv, h // hkv, nb, d)
    pk = _pool(k, block_size)[:, :, None]
    keep = _flex_keep(_pooled_scores(pq, pk), gamma)
    return keep.reshape(b, h, nb, nb)


def baseline_block_masks(method: str, q: torch.Tensor, k: torch.Tensor, *,
                         gamma: float, block_size: int) -> torch.Tensor:
    """The batched masks of a baseline ``method`` (:data:`BASELINE_METHODS`)
    → ``(B, H, NB, NB)``."""
    if method == "vertical_slash":
        fn = minference_block_masks
    elif method == "flex":
        fn = flexprefill_block_masks
    else:
        raise ValueError(f"unknown baseline method {method!r}; expected one "
                         f"of {BASELINE_METHODS}")
    return fn(q, k, gamma=gamma, block_size=block_size)

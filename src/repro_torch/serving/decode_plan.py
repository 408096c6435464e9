"""Build-once block tables for sparse decode (port of
``repro/serving/decode_plan.py::build_decode_plan`` and its plan counters).

The tables cover the *grown* cache (prefill bucket + decode headroom):
blocks past the prefill region form a dense recent tail every head keeps, so
post-prefill tokens are always visible and the plan serves every decode step
of the batch without a rebuild.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import SharePrefill
from repro_torch.kernels.decode_attn import DecodePlan
from repro_torch.kernels.indices import cap_block_mask, compact_block_mask
from repro_torch.serving.sparse_decode import decode_keep_blocks


def build_decode_plan(sp: SharePrefill, sp_state, cfg: ModelConfig, *,
                      prefill_len: int, cache_len: int,
                      width: Optional[int] = None) -> DecodePlan:
    """Post-prefill dictionaries → a DecodePlan with ``(L, B, Hkv, …)``
    leaves.  ``width`` caps each table row at its W most recent blocks (the
    prefill kernel's truncation)."""
    bs = sp.cfg.block_size
    if prefill_len % bs or cache_len % bs:
        raise ValueError(
            f"prefill_len {prefill_len} / cache_len {cache_len} must be "
            f"multiples of the pattern block size {bs}")
    nbp, nb = prefill_len // bs, cache_len // bs
    num_layers, num_heads = cfg.num_layers, cfg.num_heads
    hkv = max(cfg.num_kv_heads, 1)
    g = num_heads // hkv
    keep = decode_keep_blocks(sp, sp_state, num_layers, num_heads)
    batch = keep.shape[1]
    kh = keep.reshape(num_layers, batch, hkv, g, nbp)
    if nb > nbp:                         # dense recent tail absorbs growth
        tail = torch.ones(kh.shape[:-1] + (nb - nbp,), dtype=torch.bool,
                          device=kh.device)
        kh = torch.cat([kh, tail], dim=-1)
    union = kh.any(dim=3)                # (L, B, Hkv, NB)
    if width is not None:
        union = cap_block_mask(union, width)
        kh = kh & union[:, :, :, None, :]
    indices, counts = compact_block_mask(union, width=width)
    keep_heads = kh.movedim(3, -1).contiguous()   # (L, B, Hkv, NB, G)
    return DecodePlan(indices.contiguous(), counts.contiguous(), keep_heads)


def plan_traffic_fraction(plan: DecodePlan) -> float:
    """Modeled KV-cache read fraction vs dense decode: the fraction of kv
    blocks the kernel streams."""
    nb = plan.keep_heads.shape[-2]
    return float(plan.counts.float().mean()) / nb


def plan_block_counts(plan: DecodePlan) -> Tuple[int, int]:
    """(total, streamed) kv blocks per decode step across all (layer,
    batch, kv-head) table rows."""
    nb = plan.keep_heads.shape[-2]
    return plan.counts.numel() * nb, int(plan.counts.sum())

"""Wrappers around the attention kernels: table staging, GQA expansion."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.block_sparse_attn import (
    block_sparse_attention_batched,
)
from repro_torch.kernels.indices import compact_block_mask


def expand_kv(k: torch.Tensor, v: torch.Tensor, num_q_heads: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Repeat K/V over the GQA group on the head axis (dim −3: ``(Hkv, N,
    D)`` or ``(B, Hkv, N, D)``) — for the dense paths only; the sparse
    kernels read kv head ``h // G`` directly."""
    h_kv = k.shape[-3]
    if h_kv == num_q_heads:
        return k, v
    group = num_q_heads // h_kv
    return (k.repeat_interleave(group, dim=-3),
            v.repeat_interleave(group, dim=-3))


def batched_block_sparse_attention(
    q: torch.Tensor,            # (B, H, N, D)
    k: torch.Tensor,            # (B, Hkv, Nkv, D)
    v: torch.Tensor,            # (B, Hkv, Nkv, Dv)
    block_mask: torch.Tensor,   # (B, H, NBq, NBkv) bool
    *,
    block_size: int,
    causal: bool = True,
    width: Optional[int] = None,
    stats_gate: Optional[torch.Tensor] = None,   # (B, H)
    q_block_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block masks → ``(indices, counts)`` tables → one kernel launch for
    the whole batch → ``(out (B, H, N, Dv), Ã (B, H, NBq, NBkv))``."""
    indices, counts = compact_block_mask(block_mask, width=width)
    return block_sparse_attention_batched(
        q, k, v, indices.contiguous(), counts.contiguous(),
        block_size=block_size, causal=causal, stats_gate=stats_gate,
        q_block_offset=q_block_offset)

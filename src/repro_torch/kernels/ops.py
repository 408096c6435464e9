"""Wrappers around the attention kernels: table staging, GQA helpers,
and the per-sample AttentionFn behind ``attn_impl="kernel"`` / ``"ref"``."""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import ref as ref_ops
from repro_torch.kernels.block_sparse_attn import (
    block_sparse_attention_batched,
    block_sparse_attention_kernel,
)
from repro_torch.kernels.indices import compact_block_mask, scatter_block_stats

BLOCK_SPARSE_IMPLS = ("kernel", "ref")


def gqa_head_vmap(fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                  q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``fn(q_head, kv_head)`` over the query heads without repeating K:
    q is ``(H, …)``, k ``(Hkv, …)``, and query head h reads kv head
    ``h // (H // Hkv)`` (each kv head shared, not copied, across its
    group); the results come back stacked over H.  A loop over heads: it
    serves the per-head API and the tests, while the model's path builds
    every head in one batched op."""
    h, h_kv = q.shape[0], k.shape[0]
    if h % h_kv:
        raise ValueError(f"{h} query heads do not group over {h_kv} kv "
                         "heads")
    group = h // h_kv
    return torch.stack([fn(q[i], k[i // group]) for i in range(h)])


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


def block_sparse_attention(
    q: torch.Tensor,            # (H, N, D)
    k: torch.Tensor,            # (Hkv or H, N, D)
    v: torch.Tensor,            # (Hkv or H, N, Dv)
    block_mask: torch.Tensor,   # (H, NBq, NBkv) bool
    *,
    block_size: int,
    causal: bool = True,
    impl: str = "kernel",
    width: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-sparse attention + Ã for one sample: ``(out (H, N, Dv), Ã (H,
    NBq, NBkv))``.  ``kernel`` stages the mask's tables (capped at
    ``width``), runs the single-sample kernel and scatters its compact
    stats; ``ref`` expands K/V and runs the oracle (which, as in the
    reference, takes no ``width``)."""
    if impl == "ref":
        k, v = expand_kv(k, v, q.shape[0])
        return ref_ops.block_sparse_attention_ref(
            q, k, v, block_mask, block_size=block_size, causal=causal)
    if impl != "kernel":
        raise ValueError(f"unknown block-sparse impl {impl!r}; expected one "
                         f"of {BLOCK_SPARSE_IMPLS}")
    indices, counts = compact_block_mask(block_mask, width=width)
    out, stats = block_sparse_attention_kernel(
        q, k, v, indices.contiguous(), counts.contiguous(),
        block_size=block_size, causal=causal)
    return out, scatter_block_stats(stats, indices, block_mask.shape[-1])


def make_attention_fn(*, block_size: int, impl: str = "ref",
                      causal: bool = True, width: Optional[int] = None):
    """Bind :func:`block_sparse_attention` as a per-sample AttentionFn
    ``(q, k, v, masks) -> (out, Ã)``."""
    def fn(q, k, v, masks):
        return block_sparse_attention(q, k, v, masks, block_size=block_size,
                                      causal=causal, impl=impl, width=width)
    return fn

"""The port's attention kernels: hand-written CUDA for Hopper, each beside
its plain PyTorch version.

  strip.py              strip-score kernel (Algorithm-3 estimation pass)
  block_sparse_attn.py  block-sparse prefill attention + fused Ã: batched,
                        through a page table, and single-sample
  decode_attn.py        sparse decode over DecodePlan tables, on a
                        contiguous cache or a block-paged pool, and the
                        single-sample decodes under a token mask
  indices.py            mask ⇄ (indices, counts) staging + Ã scatter
  chunked.py            dense attention in plain PyTorch (with block
                        masks and Ã: the ``attn_impl="chunked"`` path)
  ops.py                table staging, GQA helpers, per-sample AttentionFn
  ref.py                plain oracles (``attn_impl="ref"``)
  _build.py             nvcc build of ``csrc/*.cu`` and ctypes loading

Every kernel wrapper takes its plain version for CPU tensors and launches
its kernel, or raises, for CUDA tensors; none falls back.
:data:`KERNELS` lists the wrappers with their launch counters.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.block_sparse_attn import (
    block_sparse_attention_batched,
    block_sparse_attention_batched_paged,
    block_sparse_attention_cuda,
    block_sparse_attention_kernel,
    block_sparse_attention_paged_cuda,
    block_sparse_attention_paged_plain,
    block_sparse_attention_plain,
    block_sparse_attention_single_cuda,
    block_sparse_attention_single_plain,
)
from repro_torch.kernels.decode_attn import (
    DecodePlan,
    decode_block_table,
    decode_plan_einsum,
    decode_plan_einsum_sliced,
    flash_decode,
    flash_decode_cuda,
    flash_decode_plain,
    flash_decode_plan,
    flash_decode_sparse,
    flash_decode_sparse_batched,
    flash_decode_sparse_cuda,
    flash_decode_sparse_paged_cuda,
    flash_decode_sparse_plain,
    flash_decode_sparse_single_cuda,
    resolve_decode_impl,
)
from repro_torch.kernels.indices import (
    build_block_tables,
    cap_block_mask,
    compact_block_mask,
    ragged_cap_block_mask,
    ragged_top_mask,
    scatter_block_stats,
    table_block_mask,
)
from repro_torch.kernels.ops import (
    batched_block_sparse_attention,
    block_sparse_attention,
    expand_kv,
    gqa_head_vmap,
    make_attention_fn,
)
from repro_torch.kernels.ref import (
    block_sparse_attention_ref,
    decode_attention_ref,
    dense_attention_ref,
)
from repro_torch.kernels.strip import (
    compute_strips,
    compute_strips_paged,
    strip_scores,
    strip_scores_cuda,
)

# name → CUDA wrapper (each carries a ``launches`` counter)
KERNELS = {
    "strip": strip_scores_cuda,
    "block_sparse_attn": block_sparse_attention_cuda,
    "decode_attn": flash_decode_sparse_cuda,
    "decode_attn_paged": flash_decode_sparse_paged_cuda,
    "block_sparse_attn_single": block_sparse_attention_single_cuda,
    "block_sparse_attn_paged": block_sparse_attention_paged_cuda,
    "decode_attn_dense": flash_decode_cuda,
    "decode_attn_sparse": flash_decode_sparse_single_cuda,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def _check_grid(nbq: int, nbkv: int, n_q: int, n_kv: int,
                block_size: int) -> None:
    if nbq * block_size != n_q or nbkv * block_size != n_kv:
        raise ValueError(
            f"mask grid ({nbq}, {nbkv}) at block {block_size} does not "
            f"tile q {n_q} / kv {n_kv} tokens")


def sparse_attention_fn(*, block_size: int, causal: bool = True,
                        width: Optional[int] = None):
    """Bind the single-sample sparse path as a per-sample AttentionFn:
    ``(q (H,N,D), k (Hkv,N,D), v (Hkv,N,Dv), masks (H,NBq,NBkv)) -> (out
    (H,N,Dv), Ã (H,NBq,NBkv))`` through the single-sample kernel.  As in
    :func:`batched_sparse_attention_fn`, a mask grid that does not tile q
    and k/v at exactly ``block_size`` raises ``ValueError``."""

    def fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        _check_grid(masks.shape[-2], masks.shape[-1], q.shape[1], k.shape[1],
                    block_size)
        return block_sparse_attention(
            q, k, v, masks, block_size=block_size, causal=causal,
            impl="kernel", width=width)

    return fn


def batched_sparse_attention_fn(*, block_size: int,
                                width: Optional[int] = None,
                                q_block_offset: Optional[int] = None,
                                mesh=None, shard_axis: str = "model"):
    """Bind the batched causal sparse execution path as a batched
    AttentionFn: ``(q (B,H,N,D), k (B,Hkv,Nkv,D), v (B,Hkv,Nkv,Dv), masks
    (B,H,NBq,NBkv), stats_gate=None) -> (out (B,H,N,Dv), Ã
    (B,H,NBq,NBkv))``, marked ``fn.batched = True``.  The mask grid must
    tile q and k/v at exactly ``block_size``; anything else raises
    ``ValueError`` (the reference's dense-chunked fallback for misaligned
    grids is not ported: on the main path ``SharePrefill.applicable``
    guarantees alignment).

    ``q_block_offset`` binds a rectangular chunk launch (chunked prefill):
    q holds only the chunk's rows, k/v the full prefix, ``NBq < NBkv``,
    and the causal bounds anchor at the chunk's first block.  Without it,
    q ends where k/v end (``NBkv − NBq``; the one-shot launch).

    ``mesh`` runs a one-shot launch per head shard over ``shard_axis``
    (:func:`repro_torch.distributed.sharding.
    sharded_batched_block_sparse_attention`, each rank's tables built from
    its own masks) where the head counts shard over it, the single-device
    launch otherwise.  Chunk launches never take the mesh (chunked
    admission is single-device)."""

    def fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           masks: torch.Tensor, stats_gate: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
        _check_grid(masks.shape[-2], masks.shape[-1], q.shape[2], k.shape[2],
                    block_size)
        if mesh is not None and q_block_offset is None:
            from repro_torch.distributed import sharding
            if sharding.head_shard_count(mesh, shard_axis, q.shape[1],
                                         k.shape[1]) > 1:
                return sharding.sharded_batched_block_sparse_attention(
                    q, k, v, masks, mesh=mesh, axis=shard_axis,
                    block_size=block_size, width=width,
                    stats_gate=stats_gate)
        return batched_block_sparse_attention(
            q, k, v, masks, block_size=block_size, width=width,
            stats_gate=stats_gate, q_block_offset=q_block_offset)

    fn.batched = True
    return fn


__all__ = [
    "DecodePlan", "KERNELS", "batched_block_sparse_attention",
    "batched_sparse_attention_fn", "block_sparse_attention",
    "block_sparse_attention_batched", "block_sparse_attention_batched_paged",
    "block_sparse_attention_cuda", "block_sparse_attention_kernel",
    "block_sparse_attention_paged_cuda", "block_sparse_attention_paged_plain",
    "block_sparse_attention_plain", "block_sparse_attention_ref",
    "block_sparse_attention_single_cuda",
    "block_sparse_attention_single_plain", "build_block_tables",
    "cap_block_mask", "compact_block_mask", "compute_strips",
    "compute_strips_paged",
    "decode_attention_ref", "decode_block_table", "decode_plan_einsum",
    "decode_plan_einsum_sliced", "dense_attention_ref", "expand_kv",
    "flash_decode", "flash_decode_cuda", "flash_decode_plain",
    "flash_decode_plan", "flash_decode_sparse", "flash_decode_sparse_batched",
    "flash_decode_sparse_cuda", "flash_decode_sparse_paged_cuda",
    "flash_decode_sparse_plain", "flash_decode_sparse_single_cuda",
    "gqa_head_vmap", "launch_counts", "make_attention_fn",
    "ragged_cap_block_mask", "ragged_top_mask", "reset_launch_counts",
    "resolve_decode_impl", "scatter_block_stats", "sparse_attention_fn",
    "strip_scores", "strip_scores_cuda", "table_block_mask",
]

"""The port's attention kernels: hand-written CUDA for Hopper, each beside
its plain PyTorch version.

  strip.py              strip-score kernel (Algorithm-3 estimation pass)
  block_sparse_attn.py  batched block-sparse prefill attention + fused Ã
  decode_attn.py        batched sparse decode over DecodePlan tables, on a
                        contiguous cache or a block-paged pool
  indices.py            mask → (indices, counts) staging
  chunked.py            dense attention in plain PyTorch
  ops.py                table staging and GQA helpers
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
    block_sparse_attention_cuda,
    block_sparse_attention_plain,
)
from repro_torch.kernels.decode_attn import (
    DecodePlan,
    decode_plan_einsum,
    decode_plan_einsum_sliced,
    flash_decode_plan,
    flash_decode_sparse_batched,
    flash_decode_sparse_cuda,
    flash_decode_sparse_paged_cuda,
    resolve_decode_impl,
)
from repro_torch.kernels.indices import (
    cap_block_mask,
    compact_block_mask,
    table_block_mask,
)
from repro_torch.kernels.ops import batched_block_sparse_attention, expand_kv
from repro_torch.kernels.strip import (
    compute_strips,
    strip_scores,
    strip_scores_cuda,
)

# name → CUDA wrapper (each carries a ``launches`` counter)
KERNELS = {
    "strip": strip_scores_cuda,
    "block_sparse_attn": block_sparse_attention_cuda,
    "decode_attn": flash_decode_sparse_cuda,
    "decode_attn_paged": flash_decode_sparse_paged_cuda,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def batched_sparse_attention_fn(*, block_size: int,
                                width: Optional[int] = None):
    """Bind the batched causal sparse execution path as a batched
    AttentionFn: ``(q (B,H,N,D), k (B,Hkv,N,D), v (B,Hkv,N,Dv), masks
    (B,H,NBq,NBkv), stats_gate=None) -> (out (B,H,N,Dv), Ã
    (B,H,NBq,NBkv))``, marked ``fn.batched = True``.  The mask grid must
    tile q and k/v at exactly ``block_size``; anything else raises
    ``ValueError`` (the reference's dense-chunked fallback for misaligned
    grids is not ported: on the main path ``SharePrefill.applicable``
    guarantees alignment)."""

    def fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           masks: torch.Tensor, stats_gate: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
        nbq, nbkv = masks.shape[-2], masks.shape[-1]
        if nbq * block_size != q.shape[2] or nbkv * block_size != k.shape[2]:
            raise ValueError(
                f"mask grid ({nbq}, {nbkv}) at block {block_size} does not "
                f"tile q {q.shape[2]} / kv {k.shape[2]} tokens")
        return batched_block_sparse_attention(
            q, k, v, masks, block_size=block_size, width=width,
            stats_gate=stats_gate)

    fn.batched = True
    return fn


__all__ = [
    "DecodePlan", "KERNELS", "batched_block_sparse_attention",
    "batched_sparse_attention_fn", "block_sparse_attention_batched",
    "block_sparse_attention_cuda", "block_sparse_attention_plain",
    "cap_block_mask", "compact_block_mask", "compute_strips",
    "decode_plan_einsum", "decode_plan_einsum_sliced", "expand_kv",
    "flash_decode_plan", "flash_decode_sparse_batched",
    "flash_decode_sparse_cuda", "flash_decode_sparse_paged_cuda",
    "launch_counts", "reset_launch_counts",
    "resolve_decode_impl", "strip_scores", "strip_scores_cuda",
    "table_block_mask",
]

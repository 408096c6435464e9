"""Build-once block tables for sparse decode (port of
``repro/serving/decode_plan.py``: ``build_decode_plan``, the plan counters
and the slot scheduler's row helpers).

The tables cover the *grown* cache (prefill bucket + decode headroom):
blocks past the prefill region form a dense recent tail every head keeps, so
post-prefill tokens are always visible and the plan serves every decode step
without a rebuild.

Under the slot scheduler the plan's batch axis is a set of slots: it starts
as :func:`empty_decode_plan` (inert slots stream nothing and output zeros),
and each admission splices its own single-row plan in with
:func:`update_plan_slot` — padded first to the shared table width with
:func:`pad_plan_row` when buckets mix under paging.  An admission without a
pattern dictionary gets the all-keep :func:`dense_decode_plan` row.

A heads-sharded serve uses these same functions.  The reference builds
one plan per kv-head range and stitches them; here every rank holds the
whole pattern dictionary (its strips and decisions run replicated), so
each builds the global plan itself, equal to the single-device plan, and
:func:`repro_torch.distributed.sharding.sharded_flash_decode` slices its
kv-head range out of it.

Decode-pattern refresh replaces a slot's row in flight:
:func:`build_refresh_plan_row` re-estimates it from the slot's paged K/V
(the strip kernel over gathered pages, ragged per-head budgets, a bounded
dense horizon), :func:`extend_plan_row_horizon` widens that horizon
without a strip pass, and :func:`set_plan_width` with
:func:`bucket_plan_width` keep the live plan's table width at the
power-of-two bucket of its widest row.
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
                      width: Optional[int] = None,
                      keep_blocks: Optional[torch.Tensor] = None
                      ) -> DecodePlan:
    """Post-prefill dictionaries → a DecodePlan with ``(L, B, Hkv, …)``
    leaves.  ``width`` caps each table row at its W most recent blocks (the
    prefill kernel's truncation).  ``keep_blocks (L, B, H, prefill_len /
    bs)`` replaces the dictionaries' keep-sets (one segment of a packed
    prefill: :func:`~repro_torch.serving.sparse_decode.
    packed_decode_keep_blocks`)."""
    bs = sp.cfg.block_size
    if prefill_len % bs or cache_len % bs:
        raise ValueError(
            f"prefill_len {prefill_len} / cache_len {cache_len} must be "
            f"multiples of the pattern block size {bs}")
    nbp, nb = prefill_len // bs, cache_len // bs
    num_layers, num_heads = cfg.num_layers, cfg.num_heads
    hkv = max(cfg.num_kv_heads, 1)
    g = num_heads // hkv
    keep = (decode_keep_blocks(sp, sp_state, num_layers, num_heads)
            if keep_blocks is None else keep_blocks)
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


def _slot_shape(cfg: ModelConfig, batch: int, cache_len: int,
                block_size: int):
    if cache_len % block_size:
        raise ValueError(f"cache_len {cache_len} must be a multiple of the "
                         f"pattern block size {block_size}")
    hkv = max(cfg.num_kv_heads, 1)
    return ((cfg.num_layers, batch, hkv), cache_len // block_size,
            cfg.num_heads // hkv)


def empty_decode_plan(cfg: ModelConfig, *, batch: int, cache_len: int,
                      block_size: int, device=None) -> DecodePlan:
    """All-masked slot plan, the scheduler's initial decode state: zero
    counts and no keep bits, so an unoccupied slot streams nothing and
    outputs zeros.  W == NB, the width :func:`build_decode_plan` gives."""
    shape, nb, g = _slot_shape(cfg, batch, cache_len, block_size)
    return DecodePlan(
        torch.zeros(shape + (nb,), dtype=torch.int32, device=device),
        torch.zeros(shape, dtype=torch.int32, device=device),
        torch.zeros(shape + (nb, g), dtype=torch.bool, device=device))


def dense_decode_plan(cfg: ModelConfig, *, cache_len: int, block_size: int,
                      device=None) -> DecodePlan:
    """Single-row all-keep plan: the per-request dense fallback for an
    admission whose prefill gave no pattern dictionary."""
    shape, nb, g = _slot_shape(cfg, 1, cache_len, block_size)
    idx = torch.arange(nb, dtype=torch.int32, device=device)
    return DecodePlan(
        idx.expand(shape + (nb,)).contiguous(),
        torch.full(shape, nb, dtype=torch.int32, device=device),
        torch.ones(shape + (nb, g), dtype=torch.bool, device=device))


def update_plan_slot(plan: DecodePlan, new: DecodePlan,
                     slot: int) -> DecodePlan:
    """Replace batch row ``slot`` of every leaf with the single-row plan
    ``new``, in place (the reference returns a copy); the other slots'
    tables are untouched."""
    if new.indices.shape[-1] != plan.indices.shape[-1]:
        raise ValueError(
            f"plan width mismatch: slot plan W={new.indices.shape[-1]} vs "
            f"batch plan W={plan.indices.shape[-1]} (same prefill_len / "
            f"cache_len / width required)")
    for dst, src in zip(plan, new):
        dst[:, slot] = src[:, 0].to(dst.dtype)
    return plan


def pad_plan_row(plan: DecodePlan, nb_target: int) -> DecodePlan:
    """Widen a plan built at a shorter cache to ``nb_target`` blocks without
    changing what it streams: ``indices`` repeat each row's last entry,
    keep bits pad False, ``counts`` stay — the padded blocks are never
    streamed, so a slot's table never reaches pages it does not hold."""
    w, nb = plan.indices.shape[-1], plan.keep_heads.shape[-2]
    if nb_target < w or nb_target < nb:
        raise ValueError(f"cannot narrow plan (W={w}, NB={nb}) "
                         f"to {nb_target}")
    idx = plan.indices
    if nb_target > w:
        idx = torch.cat([idx, idx[..., -1:].expand(
            idx.shape[:-1] + (nb_target - w,))], dim=-1)
    keep = plan.keep_heads
    if nb_target > nb:
        keep = torch.cat([keep, keep.new_zeros(
            keep.shape[:-2] + (nb_target - nb, keep.shape[-1]))], dim=-2)
    return DecodePlan(idx.contiguous(), plan.counts, keep.contiguous())


def plan_row_tail_stats(row: DecodePlan, *, prefill_blocks: int,
                        num_blocks: Optional[int] = None
                        ) -> Tuple[float, float]:
    """``(tail_fraction, traffic_fraction)`` of one slot's plan row: the
    share of its streamed blocks at or past ``prefill_blocks`` (the dense
    decode tail), and its streamed-block fraction against ``num_blocks``
    (default: the row's own NB)."""
    w = row.indices.shape[-1]
    live = (torch.arange(w, device=row.counts.device)
            < row.counts[..., None])
    in_tail = live & (row.indices >= prefill_blocks)
    streamed = max(int(row.counts.sum()), 1)
    nb = num_blocks if num_blocks else row.keep_heads.shape[-2]
    traffic = float(row.counts.float().mean()) / nb
    return int(in_tail.sum()) / streamed, traffic


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


def set_plan_width(plan: DecodePlan, width: int) -> DecodePlan:
    """Re-bucket a plan's table width W without changing what it streams.
    Widening repeats each row's last entry; narrowing truncates
    ``indices[…, :width]`` and is refused (one host sync) when a row keeps
    more than ``width`` blocks.  ``counts`` and ``keep_heads`` stay."""
    w = plan.indices.shape[-1]
    if width == w:
        return plan
    if width < w:
        mx = int(plan.counts.max())
        if width < mx:
            raise ValueError(
                f"cannot narrow plan to W={width}: a row keeps {mx} blocks")
        idx = plan.indices[..., :width]
    else:
        idx = torch.cat([plan.indices, plan.indices[..., -1:].expand(
            plan.indices.shape[:-1] + (width - w,))], dim=-1)
    return DecodePlan(idx.contiguous(), plan.counts, plan.keep_heads)


def bucket_plan_width(need: int, nb: int, *, slack: int = 0) -> int:
    """The power-of-two width covering ``need + slack`` blocks, clamped to
    ``[1, nb]``: a refreshed plan takes one of O(log NB) widths."""
    want = max(1, min(need + slack, nb))
    w = 1
    while w < want:
        w <<= 1
    return min(w, nb)


def build_refresh_plan_row(
    q_hat: torch.Tensor,          # (L, H, bs, D) captured recent queries
    pool_k,                       # L layers of (P, Hkv, ps, D) page pools
    page_table_row: torch.Tensor,  # (NB,) the slot's page map
    cfg: ModelConfig,
    *,
    block_size: int,
    num_blocks: int,              # live (block-aligned) blocks to re-score
    table_blocks: int,            # NB of the live batch plan
    horizon_blocks: int,          # dense lookahead for the next appends
    mass: float,
    min_width: int = 1,
    max_width: Optional[int] = None,
) -> DecodePlan:
    """Re-estimate one slot's pattern from its paged KV.

    Per layer, :func:`~repro_torch.kernels.strip.compute_strips_paged`
    scores the slot's first ``num_blocks`` pages against the query window
    (the strip kernel on CUDA tensors); the strip is pooled to attention
    mass per (query head, block), and :func:`~repro_torch.serving.
    width_policy.score_mass_budgets` with :func:`~repro_torch.kernels.
    indices.ragged_top_mask` turn it into ragged per-head keep-sets.
    Blocks ``[num_blocks − 1, num_blocks + horizon_blocks)`` are kept for
    every head: the local band and the bounded horizon the next appends
    land in, in place of a frozen row's unbounded dense tail.

    Returns a one-row plan ``(L, 1, Hkv, …)`` at full width ``W ==
    table_blocks`` (:func:`set_plan_width` re-buckets it)."""
    from repro_torch.kernels.indices import ragged_top_mask
    from repro_torch.kernels.strip import compute_strips_paged
    from repro_torch.serving.width_policy import score_mass_budgets

    num_layers, h = q_hat.shape[:2]
    hkv = max(cfg.num_kv_heads, 1)
    g = h // hkv
    dev = q_hat.device
    lo = max(0, num_blocks - 1)
    hi = min(num_blocks + horizon_blocks, table_blocks)
    cols = torch.arange(table_blocks, device=dev)
    forced = (cols >= lo) & (cols < hi)
    per_layer = []
    for layer in range(num_layers):
        strips = compute_strips_paged(
            q_hat[layer], pool_k[layer], page_table_row,
            block_size=block_size, num_blocks=num_blocks)
        # softmax rows: sums within blocks (and over the window's rows)
        # are each head's attention mass per kv block
        scores = strips.reshape(h, block_size, num_blocks,
                                block_size).sum(dim=(1, 3))
        budgets = score_mass_budgets(scores, mass=mass, min_width=min_width,
                                     max_width=max_width)
        kh = ragged_top_mask(scores, budgets)            # (H, num_blocks)
        kh = torch.cat([kh, kh.new_zeros((h, table_blocks - num_blocks))],
                       dim=-1) | forced[None, :]
        per_layer.append(kh.reshape(hkv, g, table_blocks))
    kh = torch.stack(per_layer)[:, None]                 # (L, 1, Hkv, G, NB)
    indices, counts = compact_block_mask(kh.any(dim=3), width=None)
    return DecodePlan(indices.contiguous(), counts.contiguous(),
                      kh.movedim(3, -1).contiguous())


def extend_plan_row_horizon(row: DecodePlan, lo: int, hi: int) -> DecodePlan:
    """Keep blocks ``[lo, hi)`` for every head of one full-width plan row
    (no strip pass): the cheap extension that keeps a refreshed row's
    horizon ahead of its appends.  Returns a row with ``W == NB``."""
    nb = row.keep_heads.shape[-2]
    cols = torch.arange(nb, device=row.keep_heads.device)
    forced = (cols >= lo) & (cols < hi)
    kh = row.keep_heads | forced[:, None]
    indices, counts = compact_block_mask(kh.any(dim=-1), width=None)
    return DecodePlan(indices.contiguous(), counts.contiguous(),
                      kh.contiguous())

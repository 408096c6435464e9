"""GQA attention layer: prefill and decode (port of
``repro/models/attention.py`` for ``method in ("dense", "share")``).

Prefill ``method="share"`` runs SharePrefill through the block-sparse
kernels whenever pattern sharing applies to the sequence length; ``dense``,
and lengths it does not apply to, attend densely (plain PyTorch).  The
baseline policies (``vertical_slash``, ``flex``) come with a later slice
(ROADMAP.md queue A.3).

``attn_impl`` picks the attention function:
  * ``auto`` and ``sparse``: the batched path, one launch per layer for the
    whole batch.  ``auto`` resolves to it on every device: the CUDA kernels
    for CUDA tensors, their plain versions for CPU tensors.  (The
    reference's ``auto`` picks dense-chunked attention off the TPU, a
    different function; equivalence tests call the reference with
    ``attn_impl="sparse"``.)
  * ``kernel``: the per-sample path through the single-sample kernel, one
    launch per sample and layer;
  * ``ref``: the per-sample path through the plain oracle on expanded K/V.
``chunked`` is not ported yet (ROADMAP.md A.8).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import share_attention as sa
from repro_torch.core.api import SharePrefill
from repro_torch.kernels import (
    batched_sparse_attention_fn,
    cap_block_mask,
    expand_kv,
    make_attention_fn,
)
from repro_torch.kernels.chunked import chunked_attention
from repro_torch.kernels.decode_attn import (
    DecodePlan, flash_decode_plan, flash_decode_plan_paged, gather_pages)
from repro_torch.models import common

PREFILL_METHODS = ("dense", "share")
PREFILL_ATTN_IMPLS = ("auto", "sparse", "ref", "kernel")


def resolve_attention_fn(attn_impl: str, block_size: int,
                         width: Optional[int] = None) -> sa.AttentionFn:
    """``auto`` and ``sparse`` → the batched sparse attention function;
    ``kernel`` and ``ref`` → the per-sample one, with the W cap applied as
    the boolean :func:`cap_block_mask` (numerically the truncation the
    sparse path's tables apply)."""
    if attn_impl == "chunked":
        raise NotImplementedError("attn_impl 'chunked' comes with chunked "
                                  "prefill (ROADMAP.md A.8)")
    if attn_impl not in PREFILL_ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; expected one of "
                         f"{PREFILL_ATTN_IMPLS}")
    if attn_impl in ("auto", "sparse"):
        return batched_sparse_attention_fn(block_size=block_size, width=width)
    base = make_attention_fn(block_size=block_size, impl=attn_impl)
    if width is None:
        return base
    return lambda q, k, v, masks: base(q, k, v, cap_block_mask(masks, width))


class AttnStats(NamedTuple):
    num_shared: torch.Tensor
    num_dense: torch.Tensor
    num_vs: torch.Tensor
    block_density: torch.Tensor
    max_row_pop: torch.Tensor

    @staticmethod
    def zero(device=None) -> "AttnStats":
        z = torch.zeros((), device=device)
        return AttnStats(z, z, z, torch.ones((), device=device), z)

    @staticmethod
    def reduce_layers(stats: Sequence["AttnStats"]) -> "AttnStats":
        """Means over layers, except ``max_row_pop`` (a max)."""
        cols = [torch.stack(list(f)) for f in zip(*stats)]
        means = AttnStats(*(c.float().mean() for c in cols))
        return means._replace(max_row_pop=cols[4].max())


def rope_qk(q, k, positions, cfg: ModelConfig):
    """Rotate q/k by RoPE; positions (B, S) broadcast over heads."""
    pos = positions[:, None, :]
    return (common.apply_rope(q, pos, cfg.rope_theta),
            common.apply_rope(k, pos, cfg.rope_theta))


def attention_prefill(
    params,
    x: torch.Tensor,                    # (B, S, d)
    cfg: ModelConfig,
    positions: torch.Tensor,            # (B, S)
    *,
    method: str,
    sp: SharePrefill,
    sp_state,                           # batched PivotalState or None
    cluster_ids: Optional[torch.Tensor],   # (H,) for this layer
    attn_impl: str = "auto",
    attn_width: Optional[int] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor], object,
           AttnStats]:
    """Returns ``(out (B, S, d), (k, v) (B, Hkv, S, hd), new sp_state,
    stats)``."""
    if method not in PREFILL_METHODS:
        raise ValueError(f"unknown prefill method {method!r}; the port has "
                         f"{PREFILL_METHODS} (baselines: ROADMAP.md A.3)")
    n = x.shape[1]
    q, k, v = common.gqa_qkv(params, x)
    q, k = rope_qk(q, k, positions, cfg)

    bs = min(sp.cfg.block_size if sp.cfg.enabled else 128, n)
    if method == "dense" or not sp.applicable(n):
        kx, vx = expand_kv(k, v, q.shape[1])
        out = chunked_attention(q, kx, vx, block_size=bs, causal=True)
        return (common.gqa_out(params, out), (k, v), sp_state,
                AttnStats.zero(x.device))

    attention_fn = resolve_attention_fn(attn_impl, bs, width=attn_width)
    out, new_state, lstats = sa.batched_share_prefill_attention_layer(
        q, k, v, sp_state, cluster_ids, sp.cfg, attention_fn)
    stats = AttnStats(lstats.num_shared, lstats.num_dense, lstats.num_vs,
                      lstats.block_density, lstats.max_row_pop)
    return common.gqa_out(params, out), (k, v), new_state, stats


def row_positions(pos, b: int, device) -> torch.Tensor:
    """``pos`` (an int, a 0-d or a (B,) tensor) as a (B, 1) column."""
    p = torch.as_tensor(pos, device=device)
    return (p[:, None] if p.dim() else p.expand(b, 1)).long()


def attention_decode(
    params,
    x: torch.Tensor,                    # (B, 1, d)
    cfg: ModelConfig,
    cache_k: torch.Tensor,              # (B, Hkv, S, hd), written in place
    cache_v: torch.Tensor,
    pos,                                # int, or (B,) per-slot write index
    positions: torch.Tensor,            # (B, 1) rope positions
    *,
    valid_mask: Optional[torch.Tensor] = None,   # (B, S) slot validity
    plan: Optional[DecodePlan] = None,  # this layer's sparse-decode tables
    decode_impl: str = "auto",
    page_table: Optional[torch.Tensor] = None,   # (B, NB) int32
) -> torch.Tensor:
    """One decode step; returns ``(B, 1, d)``.

    ``pos`` is the cache write index: an int for the lockstep batch path,
    or a ``(B,)`` tensor for the slot scheduler, where each row writes and
    masks at its own position.  The new token's K/V are written in place
    (the reference returns an updated copy; writing in place saves copying
    the whole cache every step).  ``valid_mask`` marks the visible slots
    (length ∧ not right-pad); without it every slot ≤ ``pos`` of the row is
    visible.  With ``plan`` the step streams only the plan's blocks through
    :func:`repro_torch.kernels.decode_attn.flash_decode_plan`; without it
    the step attends densely (plain PyTorch).

    ``page_table`` switches to the block-paged pool: ``cache_k``/``cache_v``
    are then one layer's ``(P, Hkv, page_size, hd)`` pool slice and ``pos``
    must be the per-slot vector (see :func:`_attention_decode_paged`)."""
    b = x.shape[0]
    q, k, v = common.gqa_qkv(params, x)
    q, k = rope_qk(q, k, positions, cfg)
    if page_table is not None:
        return _attention_decode_paged(
            params, q, k, v, cache_k, cache_v, pos, page_table,
            valid_mask=valid_mask, plan=plan, decode_impl=decode_impl)
    if isinstance(pos, torch.Tensor) and pos.dim():
        rows = torch.arange(b, device=x.device)    # per-row writes
        cache_k[rows, :, pos] = k[:, :, 0]
        cache_v[rows, :, pos] = v[:, :, 0]
    else:
        cache_k[:, :, pos] = k[:, :, 0]
        cache_v[:, :, pos] = v[:, :, 0]
    s = cache_k.shape[2]
    if valid_mask is None:
        mask = (torch.arange(s, device=x.device)[None, :]
                <= row_positions(pos, b, x.device))
    else:
        mask = valid_mask
    if plan is not None:
        out = flash_decode_plan(q[:, :, 0].contiguous(), cache_k, cache_v,
                                plan, mask.contiguous(), impl=decode_impl)
        return common.gqa_out(params, out[:, :, None, :])
    return _dense_decode(params, q, cache_k, cache_v, mask)


def _dense_decode(params, q, cache_k, cache_v, mask) -> torch.Tensor:
    """Grouped masked-softmax decode over a contiguous cache (plain)."""
    b, h, _, hd = q.shape
    hkv = cache_k.shape[1]
    g = h // hkv
    qg = q[:, :, 0].reshape(b, hkv, g, hd).float()
    logits = torch.einsum("bkgd,bksd->bkgs", qg, cache_k.float())
    logits = logits * (1.0 / hd ** 0.5)
    logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p.to(cache_v.dtype).float(),
                       cache_v.float())
    out = out.to(q.dtype).reshape(b, h, 1, hd)
    return common.gqa_out(params, out)


def _attention_decode_paged(params, q, k, v, pool_k, pool_v, pos,
                            page_table, *, valid_mask, plan, decode_impl):
    """Block-paged half of :func:`attention_decode` (after QKV and rope).

    The append is a sliver scatter: row b's K/V land at ``pool[page_table[b,
    pos // ps], :, pos % ps]`` and nothing else in the pool changes.
    Attention then reads the pool through the page table — the paged kernel
    with a plan, the gathered contiguous view without — with masks and
    tables in *logical* coordinates over ``NB · page_size`` slots."""
    if not (isinstance(pos, torch.Tensor) and pos.dim()):
        raise ValueError("paged decode requires per-slot (vector) pos")
    b = q.shape[0]
    ps = pool_k.shape[2]
    sv = page_table.shape[1] * ps
    rows = torch.arange(b, device=q.device)
    pg = page_table[rows, pos // ps].long()
    within = pos % ps
    pool_k[pg, :, within] = k[:, :, 0].to(pool_k.dtype)
    pool_v[pg, :, within] = v[:, :, 0].to(pool_v.dtype)
    if valid_mask is None:
        mask = torch.arange(sv, device=q.device)[None, :] <= pos[:, None]
    else:
        mask = valid_mask
    if plan is not None:
        out = flash_decode_plan_paged(
            q[:, :, 0].contiguous(), pool_k, pool_v, page_table, plan,
            mask.contiguous(), impl=decode_impl)
        return common.gqa_out(params, out[:, :, None, :])
    return _dense_decode(params, q, gather_pages(pool_k, page_table),
                         gather_pages(pool_v, page_table), mask)

"""GQA attention layer: prefill and decode (port of
``repro/models/attention.py``).

Prefill ``method`` is the pattern policy: ``share`` runs SharePrefill
through the block-sparse kernels whenever pattern sharing applies to the
sequence length; the paper's baselines ``vertical_slash`` (MInference) and
``flex`` (FlexPrefill) build their masks per head
(:mod:`repro_torch.core.baselines`) and run the same block-sparse kernels,
with no dictionary and no Ã; ``dense``, and lengths pattern sharing does
not apply to, attend densely (plain PyTorch).

``attn_impl`` picks the attention function:
  * ``auto`` and ``sparse``: the batched path, one launch per layer for the
    whole batch.  ``auto`` resolves to it on every device: the CUDA kernels
    for CUDA tensors, their plain versions for CPU tensors.  (The
    reference's ``auto`` picks dense-chunked attention off the TPU, a
    different function; equivalence tests call the reference with
    ``attn_impl="sparse"``.)
  * ``kernel``: the per-sample path through the single-sample kernel, one
    launch per sample and layer;
  * ``ref``: the per-sample path through the plain oracle on expanded K/V;
  * ``chunked``: the per-sample path through dense attention under the
    block masks, Ã included (:func:`repro_torch.kernels.chunked.
    chunked_attention_fn`; plain PyTorch, as in the reference).

A config's ``sliding_window`` (Mixtral) is applied as the reference
applies it: on the sparse paths at **block** granularity, the causal
window block mask of ``max(window // bs, 1)`` diagonals (and the first
block column) ANDed into every method's masks (so the oldest block in the
window keeps tokens a little past ``window``); on the dense path at token
granularity; and in decode as a token band of the validity mask
(:func:`repro_torch.models.transformer.window_valid_mask`).

:func:`attention_train` is the differentiable training attention: dense,
or banded by the window at token granularity, through the plain chunked
attention (the reference's train path is pure JAX, no Pallas kernel).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.core import share_attention as sa
from repro_torch.core.api import SharePrefill
from repro_torch.core.baselines import baseline_block_masks
from repro_torch.core.patterns import (block_mask_density, causal_block_mask,
                                       segment_block_mask,
                                       sliding_window_block_mask)
from repro_torch.distributed.sharding import (active_model_mesh, shard,
                                              shardable_model_mesh,
                                              sharded_flash_decode,
                                              sharded_flash_decode_paged)
from repro_torch.kernels import (
    batched_sparse_attention_fn,
    cap_block_mask,
    expand_kv,
    make_attention_fn,
)
from repro_torch.kernels.chunked import chunked_attention, chunked_attention_fn
from repro_torch.kernels.decode_attn import (
    DecodePlan, flash_decode_plan, flash_decode_plan_paged, gather_pages)
from repro_torch.models import common

PREFILL_METHODS = ("dense", "share", "vertical_slash", "flex")
PREFILL_ATTN_IMPLS = ("auto", "sparse", "chunked", "ref", "kernel")


def resolve_attention_fn(attn_impl: str, block_size: int,
                         width: Optional[int] = None) -> sa.AttentionFn:
    """``auto`` and ``sparse`` → the batched sparse attention function,
    per head shard under an active model mesh (the mesh-active routing
    rule, :func:`repro_torch.distributed.sharding.active_model_mesh`,
    shared with sparse decode); ``kernel``, ``ref`` and ``chunked`` → a
    per-sample one, with the W cap applied as the boolean
    :func:`cap_block_mask` (numerically the truncation the sparse path's
    tables apply)."""
    if attn_impl not in PREFILL_ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; expected one of "
                         f"{PREFILL_ATTN_IMPLS}")
    if attn_impl in ("auto", "sparse"):
        return batched_sparse_attention_fn(block_size=block_size, width=width,
                                           mesh=active_model_mesh())
    base = (chunked_attention_fn(block_size=block_size)
            if attn_impl == "chunked"
            else make_attention_fn(block_size=block_size, impl=attn_impl))
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
    """Rotate q/k ``(B, H, S, D)`` by RoPE at positions ``(B, S)``, or by
    M-RoPE at ``(3, B, S)`` when the config is a VLM (the reference's rule:
    a VLM given 2-D positions takes plain RoPE); positions broadcast over
    heads."""
    if cfg.vlm.enabled and positions.dim() == 3:
        pos = positions[:, :, None, :]              # (3, B, 1, S)
        return (common.apply_mrope(q, pos, cfg.rope_theta,
                                   cfg.vlm.mrope_sections),
                common.apply_mrope(k, pos, cfg.rope_theta,
                                   cfg.vlm.mrope_sections))
    pos = positions[:, None, :]
    return (common.apply_rope(q, pos, cfg.rope_theta),
            common.apply_rope(k, pos, cfg.rope_theta))


def attention_train(params, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor,
                    block_size: int = 128) -> torch.Tensor:
    """The training attention of one layer: x (B, S, d) → (B, S, d).  GQA
    projections, (M-)RoPE, K/V expanded over the group, causal chunked
    attention in blocks of ``min(block_size, S)`` queries under the
    config's ``sliding_window`` (no sink), as the reference's."""
    q, k, v = common.gqa_qkv(params, x)
    q, k = rope_qk(q, k, positions, cfg)
    kx, vx = expand_kv(k, v, q.shape[1])
    out = chunked_attention(q, kx, vx, block_size=min(block_size, x.shape[1]),
                            causal=True, window=cfg.sliding_window, sink=0)
    out = shard(out, "batch", "heads")
    return common.gqa_out(params, out)


def prefill_block_size(sp: SharePrefill, n: int) -> int:
    """The prefill block size at length ``n``: the pattern config's (128
    with pattern sharing off), capped at ``n``."""
    return min(sp.cfg.block_size if sp.cfg.enabled else 128, n)


def resolved_attn_impl(attn_impl: str) -> str:
    """``auto`` is the batched sparse path on every device in the port."""
    return "sparse" if attn_impl == "auto" else attn_impl


# the attention functions with a launch over a run of query rows at an
# offset (chunked prefill); ``kernel``/``ref`` attend whole samples
ROW_ATTN_IMPLS = ("sparse", "chunked")


class LayerStage(NamedTuple):
    """What :func:`attention_prefill_begin` stages for the attention rows
    and :func:`attention_prefill_end`: post-rope q ``(B, H, S, D)``, k/v
    ``(B, Hkv, S, D)`` and, where a sparse method applies, the masks
    ``(B, H, NB, NB)`` and the stats gate ``(B, H)``; for ``share`` also
    the decision and, for the batched kernel, the head permutation (a
    baseline stages neither, and a gate of zeros: it consumes no Ã).  The
    dense path stages the token window of its attention rows."""
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    masks: Optional[torch.Tensor] = None
    decision: object = None
    gate: Optional[torch.Tensor] = None
    perm: Optional[torch.Tensor] = None
    window: int = 0


def _qkv_rope(params, x, cfg: ModelConfig, positions, method: str):
    if method not in PREFILL_METHODS:
        raise ValueError(f"unknown prefill method {method!r}; expected one "
                         f"of {PREFILL_METHODS}")
    with tracing.span("attn.qkv"):
        q, k, v = common.gqa_qkv(params, x)
        q, k = rope_qk(q, k, positions, cfg)
    return q, k, v


def extra_block_mask(cfg: ModelConfig, nb: int, bs: int,
                     seg_blocks: Optional[int] = None, *, device=None
                     ) -> Optional[torch.Tensor]:
    """The ``(NB, NB)`` mask ANDed into a sparse prefill's masks: the
    sliding window's block mask (``max(window // bs, 1)`` diagonals) and a
    packed row's block-diagonal segment mask, or None."""
    extra = None
    if cfg.sliding_window:
        extra = sliding_window_block_mask(
            nb, max(cfg.sliding_window // bs, 1), device=device)
    if seg_blocks is not None:
        seg = segment_block_mask(nb, seg_blocks, device=device)
        extra = seg if extra is None else extra & seg
    return extra


def attention_prefill_begin(
    params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor, *,
    method: str, sp: SharePrefill, sp_state,
    cluster_ids: Optional[torch.Tensor], attn_impl: str = "auto",
    seg_blocks: Optional[int] = None,
) -> LayerStage:
    """QKV, rope and the full-length mask staging (strips, decision,
    dictionary lookup, head permutation; a baseline's masks) of one layer:
    the ops whose inputs cannot be cut into query rows without changing the
    masks.  :func:`extra_block_mask` (the sliding window, and with
    ``seg_blocks`` the block-diagonal segment mask of a packed row of
    ``seg_blocks``-block segments) is ANDed into the masks."""
    q, k, v = _qkv_rope(params, x, cfg, positions, method)
    n = x.shape[1]
    if method == "dense" or not sp.applicable(n):
        return LayerStage(q, k, v, window=cfg.sliding_window)
    with tracing.span("share.masks"):
        return _stage_masks(q, k, v, cfg, method=method, sp=sp,
                            sp_state=sp_state, cluster_ids=cluster_ids,
                            attn_impl=attn_impl, seg_blocks=seg_blocks)


def _stage_masks(q, k, v, cfg: ModelConfig, *, method: str,
                 sp: SharePrefill, sp_state, cluster_ids, attn_impl: str,
                 seg_blocks: Optional[int]) -> LayerStage:
    """:func:`attention_prefill_begin`'s mask staging."""
    n, dev = q.shape[2], q.device
    bs = prefill_block_size(sp, n)
    nb = n // bs
    extra = extra_block_mask(cfg, nb, bs, seg_blocks, device=dev)
    if method != "share":
        masks = baseline_block_masks(method, q, k, gamma=sp.cfg.gamma,
                                     block_size=bs)
        masks = masks & causal_block_mask(nb, device=dev)
        if extra is not None:
            masks = masks & extra
        gate = torch.zeros(masks.shape[:2], dtype=torch.int32, device=dev)
        return LayerStage(q, k, v, masks, gate=gate)
    masks, decision = sa.build_share_masks(q, k, sp_state, cluster_ids,
                                           sp.cfg, extra)
    perm = None
    if resolved_attn_impl(attn_impl) == "sparse":
        perm = sa.pattern_sharing_head_perm(decision, cluster_ids,
                                            q.shape[1] // k.shape[1])
    return LayerStage(q, k, v, masks, decision, decision.use_dense, perm)


def attention_prefill_rows(
    sp: SharePrefill, stage: LayerStage, *, attn_impl: str = "auto",
    attn_width: Optional[int] = None, chunk_start: int = 0,
    chunk_blocks: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Attention output of the query blocks ``[chunk_start, chunk_start +
    chunk_blocks)`` (to the end when ``chunk_blocks`` is None) against the
    FULL K/V, with their Ã rows where ``share`` staged masks (a baseline
    consumes no Ã: None).  The batched kernel launches at
    ``q_block_offset = chunk_start`` with the staged head permutation (a
    baseline has none) and stats gate; its per-row arithmetic depends on
    the row's tables alone, so chunks assemble bitwise into the whole
    launch.  The whole launch (no chunk) is :func:`resolve_attention_fn`'s,
    per head shard under an active model mesh.  Returns ``(out (B, H, cn, Dv), Ã (B, H, cnb, NB) | None)``."""
    with tracing.span("attn.rows"):
        return _prefill_rows(sp, stage, attn_impl, attn_width, chunk_start,
                             chunk_blocks)


def _prefill_rows(sp: SharePrefill, stage: LayerStage, attn_impl: str,
                  attn_width: Optional[int], chunk_start: int,
                  chunk_blocks: Optional[int]):
    q, k, v = stage.q, stage.k, stage.v
    bs = prefill_block_size(sp, q.shape[2])
    off = chunk_start * bs
    stop = None if chunk_blocks is None else chunk_start + chunk_blocks
    q_c = q[:, :, off:None if stop is None else stop * bs]
    if stage.masks is None:
        kx, vx = expand_kv(k, v, q.shape[1])
        return chunked_attention(q_c, kx, vx, block_size=bs, causal=True,
                                 window=stage.window, q_offset=off), None
    impl = resolved_attn_impl(attn_impl)
    if impl not in ROW_ATTN_IMPLS:
        raise ValueError(
            f"attention over query rows supports attn_impl "
            f"{ROW_ATTN_IMPLS}, got {impl!r}")
    m_c = stage.masks[:, :, chunk_start:stop]
    baseline = stage.decision is None
    if impl == "sparse":
        if chunk_start == 0 and chunk_blocks is None:    # one-shot
            fn = resolve_attention_fn(impl, bs, width=attn_width)
        else:
            fn = batched_sparse_attention_fn(block_size=bs, width=attn_width,
                                             q_block_offset=chunk_start)
        if baseline:
            out, _ = fn(q_c.contiguous(), k, v, m_c, stats_gate=stage.gate)
            return out, None
        return sa.head_permuted_attention(fn, q_c, k, v, m_c, stage.gate,
                                          stage.perm)
    # "chunked": dense attention under the masks over the whole batch (the
    # reference vmaps it over the samples), every head's Ã (no gate)
    if attn_width is not None:
        m_c = cap_block_mask(m_c, attn_width)
    kx, vx = expand_kv(k, v, q.shape[1])
    out, a_tilde = chunked_attention(
        q_c, kx, vx, block_size=bs, causal=True, block_mask=m_c,
        collect_stats=True, q_offset=off)
    return out, None if baseline else a_tilde


def _attn_stats(ls: sa.LayerStats) -> AttnStats:
    return AttnStats(ls.num_shared, ls.num_dense, ls.num_vs,
                     ls.block_density, ls.max_row_pop)


def baseline_stats(masks: torch.Tensor) -> AttnStats:
    """A baseline layer's stats from its masks ``(B, H, NB, NB)``: no
    shared or dense-construction heads, ``num_vs = H``, the mean density
    and the largest row population."""
    z = torch.zeros((), device=masks.device)
    return AttnStats(z, z, torch.tensor(float(masks.shape[1]),
                                        device=masks.device),
                     block_mask_density(masks).float().mean(),
                     masks.float().sum(dim=-1).max())


def attention_prefill_end(
    stage: LayerStage, a_tilde: Optional[torch.Tensor], *,
    sp: SharePrefill, sp_state, cluster_ids: Optional[torch.Tensor],
) -> Tuple[object, AttnStats]:
    """The dictionary update from the assembled Ã and the layer's stats:
    ``(new sp_state, stats)``.  Many small ops: a caller that synchronises
    after the layer enqueues the layer's gemms first, so the device runs
    them while the host issues these.  A baseline leaves ``sp_state``
    untouched and reports every head as vertical-slash, as the reference
    does."""
    if stage.masks is None:
        return sp_state, AttnStats.zero(stage.q.device)
    with tracing.span("share.update"):
        if stage.decision is None:
            return sp_state, baseline_stats(stage.masks)
        sp_state = sa.update_share_state(a_tilde, sp_state, cluster_ids,
                                         stage.decision, sp.cfg)
        return sp_state, _attn_stats(
            sa.layer_pattern_stats(stage.masks, stage.decision))


def attention_prefill(
    params,
    x: torch.Tensor,                    # (B, S, d)
    cfg: ModelConfig,
    positions: torch.Tensor,            # (B, S), or M-RoPE (3, B, S)
    *,
    method: str,
    sp: SharePrefill,
    sp_state,                           # batched PivotalState or None
    cluster_ids: Optional[torch.Tensor],   # (H,) for this layer
    attn_impl: str = "auto",
    attn_width: Optional[int] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor], object,
           AttnStats]:
    """One-shot prefill attention: :func:`attention_prefill_begin`, the
    rows of every query block, :func:`attention_prefill_end` (the pieces
    chunked prefill runs in quanta).  The per-sample ``kernel``/``ref``
    paths run the attention sample by sample instead: ``share`` its whole
    layer, a baseline the attention function on each sample's masks (the
    reference's ``vmap``).  Returns ``(out (B, S, d), (k, v) (B, Hkv, S,
    hd), new sp_state, stats)``."""
    n = x.shape[1]
    per_sample = (resolved_attn_impl(attn_impl) not in ROW_ATTN_IMPLS
                  and method != "dense" and sp.applicable(n))
    if per_sample and method == "share":
        bs = prefill_block_size(sp, n)
        attention_fn = resolve_attention_fn(attn_impl, bs, width=attn_width)
        q, k, v = _qkv_rope(params, x, cfg, positions, method)
        out, new_state, ls = sa.batched_share_prefill_attention_layer(
            q, k, v, sp_state, cluster_ids, sp.cfg, attention_fn,
            extra_block_mask(cfg, n // bs, bs, device=x.device))
        return (prefill_out_proj(params, out), (k, v), new_state,
                _attn_stats(ls))
    stage = attention_prefill_begin(
        params, x, cfg, positions, method=method, sp=sp, sp_state=sp_state,
        cluster_ids=cluster_ids, attn_impl=attn_impl)
    if per_sample:
        attention_fn = resolve_attention_fn(
            attn_impl, prefill_block_size(sp, n), width=attn_width)
        with tracing.span("attn.rows"):
            out = torch.stack([
                attention_fn(stage.q[i], stage.k[i], stage.v[i],
                             stage.masks[i])[0]
                for i in range(x.shape[0])])
        a_tilde = None
    else:
        out, a_tilde = attention_prefill_rows(sp, stage, attn_impl=attn_impl,
                                              attn_width=attn_width)
    sp_state, stats = attention_prefill_end(stage, a_tilde, sp=sp,
                                            sp_state=sp_state,
                                            cluster_ids=cluster_ids)
    return prefill_out_proj(params, out), (stage.k, stage.v), sp_state, stats


def prefill_out_proj(params, out: torch.Tensor) -> torch.Tensor:
    """The o-projection of a prefill's heads ``(B, H, S, Dv)``."""
    with tracing.span("attn.out"):
        return common.gqa_out(params, shard(out, "batch", "heads"))


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
    positions: torch.Tensor,            # (B, 1) or M-RoPE (3, B, 1)
    *,
    valid_mask: Optional[torch.Tensor] = None,   # (B, S) slot validity
    plan: Optional[DecodePlan] = None,  # this layer's sparse-decode tables
    decode_impl: str = "auto",
    page_table: Optional[torch.Tensor] = None,   # (B, NB) int32
    return_q: bool = False,
):
    """One decode step; returns ``(B, 1, d)``, and with ``return_q`` also
    the step's post-rope queries ``(B, H, hd)`` (refresh's window capture).
    ``positions`` are the rope positions (:func:`rope_qk`), apart from the
    cache slot ``pos``.

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
    with tracing.span("attn.qkv"):
        q, k, v = common.gqa_qkv(params, x)
        q, k = rope_qk(q, k, positions, cfg)
    with tracing.span("attn.decode"):
        out = _attend_decode(q, k, v, cache_k, cache_v, pos,
                             valid_mask=valid_mask, plan=plan,
                             decode_impl=decode_impl, page_table=page_table)
    with tracing.span("attn.out"):
        out = common.gqa_out(params, out)
    return (out, q[:, :, 0]) if return_q else out


def _attend_decode(q, k, v, cache_k, cache_v, pos, *, valid_mask, plan,
                   decode_impl, page_table) -> torch.Tensor:
    """:func:`attention_decode` after QKV and rope: the cache append and
    the attention, ``(B, H, 1, hd)`` before the o-projection."""
    b = q.shape[0]
    if page_table is not None:
        return _attention_decode_paged(
            q, k, v, cache_k, cache_v, pos, page_table,
            valid_mask=valid_mask, plan=plan, decode_impl=decode_impl)
    if isinstance(pos, torch.Tensor) and pos.dim():
        rows = torch.arange(b, device=q.device)    # per-row writes
        cache_k[rows, :, pos] = k[:, :, 0]
        cache_v[rows, :, pos] = v[:, :, 0]
    else:
        cache_k[:, :, pos] = k[:, :, 0]
        cache_v[:, :, pos] = v[:, :, 0]
    # head_dim stays model-sharded where the kv heads cannot shard ("heads"
    # is dropped by the dedupe where "kv_heads" took the model axis)
    cache_k = shard(cache_k, "batch", "kv_heads", "seq", "heads")
    cache_v = shard(cache_v, "batch", "kv_heads", "seq", "heads")
    s = cache_k.shape[2]
    if valid_mask is None:
        mask = (torch.arange(s, device=q.device)[None, :]
                <= row_positions(pos, b, q.device))
    else:
        mask = valid_mask
    if plan is not None:
        # the mesh-active routing rule, as the prefill's: per head shard
        # where a model mesh is active and the head counts shard over it
        mesh = shardable_model_mesh(q.shape[1], cache_k.shape[1])
        if mesh is not None:
            out = sharded_flash_decode(
                q[:, :, 0].contiguous(), cache_k, cache_v, plan,
                mask.contiguous(), mesh=mesh, impl=decode_impl)
        else:
            out = flash_decode_plan(q[:, :, 0].contiguous(), cache_k,
                                    cache_v, plan, mask.contiguous(),
                                    impl=decode_impl)
        return out[:, :, None, :]
    return _dense_decode(q, cache_k, cache_v, mask)


def _dense_decode(q, cache_k, cache_v, mask) -> torch.Tensor:
    """Grouped masked-softmax decode over a contiguous cache (plain):
    ``(B, H, 1, hd)``."""
    b, h, _, hd = q.shape
    hkv = cache_k.shape[1]
    g = h // hkv
    # the GQA grouping splits the heads by kv head: heads replicated first
    # (a DTensor cannot split a heads axis sharded finer than the kv heads)
    q = shard(q, "batch")
    qg = q[:, :, 0].reshape(b, hkv, g, hd).float()
    logits = torch.einsum("bkgd,bksd->bkgs", qg, cache_k.float())
    logits = logits * (1.0 / hd ** 0.5)
    logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p.to(cache_v.dtype).float(),
                       cache_v.float())
    return out.to(q.dtype).reshape(b, h, 1, hd)


def _attention_decode_paged(q, k, v, pool_k, pool_v, pos, page_table, *,
                            valid_mask, plan, decode_impl):
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
    # the pool's heads axis shards as the contiguous cache's
    pool_k = shard(pool_k, None, "kv_heads", None, "heads")
    pool_v = shard(pool_v, None, "kv_heads", None, "heads")
    if valid_mask is None:
        mask = torch.arange(sv, device=q.device)[None, :] <= pos[:, None]
    else:
        mask = valid_mask
    if plan is not None:
        mesh = shardable_model_mesh(q.shape[1], pool_k.shape[1])
        if mesh is not None:
            out = sharded_flash_decode_paged(
                q[:, :, 0].contiguous(), pool_k, pool_v, page_table, plan,
                mask.contiguous(), mesh=mesh, impl=decode_impl)
        else:
            out = flash_decode_plan_paged(
                q[:, :, 0].contiguous(), pool_k, pool_v, page_table, plan,
                mask.contiguous(), impl=decode_impl)
        return out[:, :, None, :]
    return _dense_decode(q, gather_pages(pool_k, page_table),
                         gather_pages(pool_v, page_table), mask)

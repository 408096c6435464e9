"""SharePrefill per-layer orchestration, paper Algorithm 1 (port of the
batched path of ``repro/core/share_attention.py``).

For a batch and one layer's heads:

  1. strips of the last query block, one kernel launch for the batch, and
     â per head (Algorithm 3);
  2. the cluster's pivotal pattern and representative (Algorithm 4);
  3. the shared / dense / vertical-slash decision per head;
  4. the selected block masks (causal ∧ extra applied);
  5. block-sparse attention → output and block-averaged QK logits Ã, one
     kernel launch for the batch, with heads permuted within their GQA group
     so heads sharing a pivot are adjacent (the output is unchanged: on the
     TPU this elided K/V copies, here it keeps shared heads adjacent for a
     later kernel that reuses K/V tiles), and Ã stats gated to the heads
     that consume them (the dense-construction heads);
  6. dense heads build pivots (Algorithm 2) and update each sample's
     dictionary.

K/V stay un-expanded ``(B, Hkv, N, D)`` throughout.  Each sample carries its
own dictionary; the reference's per-sample ``vmap`` is a batch axis here.

A per-sample attention function (no ``fn.batched``; ``attn_impl="kernel"``
or ``"ref"``) takes the reference's other branch instead: the whole layer
runs once per sample (:func:`share_prefill_attention_layer`, a Python loop
for the reference's ``vmap``), with no head permutation and no stats gate,
and the per-sample stats are reduced by :func:`_reduce_layer_stats`.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import SharePrefillConfig
from repro_torch.core import pattern_dict as pdict
from repro_torch.core.construct import construct_pivotal_pattern
from repro_torch.core.determine import (
    PatternDecision,
    determine_sparse_pattern,
    pooled_block_estimate,
)
from repro_torch.core.patterns import block_mask_density, causal_block_mask
from repro_torch.core.vertical_slash import search_vertical_slash_from_strip
from repro_torch.kernels import (
    batched_sparse_attention_fn,
    compute_strips,
    sparse_attention_fn,
)
from repro_torch.kernels.ops import gqa_head_vmap  # noqa: F401 (re-export)

# batched AttentionFn (fn.batched = True): (q (B,H,N,D), k (B,Hkv,N,D),
# v (B,Hkv,N,Dv), masks (B,H,NB,NB), stats_gate=(B,H)) -> (out, Ã)
# per-sample AttentionFn: (q (H,N,D), k (Hkv,N,D), v (Hkv,N,Dv),
# masks (H,NB,NB)) -> (out (H,N,Dv), Ã (H,NB,NB))
AttentionFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


class LayerStats(NamedTuple):
    """Per-layer pattern statistics (0-d tensors)."""

    num_shared: torch.Tensor
    num_dense: torch.Tensor
    num_vs: torch.Tensor
    block_density: torch.Tensor   # computed fraction of causal blocks
    d_sparse_mean: torch.Tensor
    d_sim_mean: torch.Tensor
    max_row_pop: torch.Tensor     # max kept blocks in any (head, q-block) row


def init_batched_state(batch: int, num_clusters: int, nb: int, *,
                       device=None) -> pdict.PivotalState:
    """Empty dictionaries for a batch: no pivots, uniform representatives."""
    one = pdict.init_pivotal_state(num_clusters, nb, device=device)
    return pdict.PivotalState(*(x.expand(batch, *x.shape).clone()
                                for x in one))


def build_share_masks(
    q: torch.Tensor,                # (B, H, N, D)
    k: torch.Tensor,                # (B, Hkv, N, D)
    state: pdict.PivotalState,
    cluster_ids: torch.Tensor,      # (H,)
    cfg: SharePrefillConfig,
    extra_mask: Optional[torch.Tensor] = None,    # (NB, NB)
) -> Tuple[torch.Tensor, PatternDecision]:
    """Algorithms 3-5: estimate, decide, and build the per-head causal
    block masks ``(B, H, NB, NB)``, ANDed with ``extra_mask`` (a packed
    prefill's segment isolation) where given."""
    bs = cfg.block_size
    nb = q.shape[2] // bs
    strips = compute_strips(q, k, block_size=bs)         # (B, H, bs, N)
    a_hat = pooled_block_estimate(strips, bs)            # (B, H, NB)
    pivot_masks, pivot_reps, pivot_valid = pdict.lookup(state, cluster_ids)
    decision = determine_sparse_pattern(
        a_hat, cluster_ids, pivot_reps, pivot_valid,
        delta=cfg.delta, tau=cfg.tau)
    vs_masks = search_vertical_slash_from_strip(strips, cfg.gamma, bs)
    causal = causal_block_mask(nb, device=q.device)
    masks = torch.where(decision.use_shared[..., None, None], pivot_masks,
                        vs_masks)
    masks = torch.where(decision.use_dense[..., None, None], causal, masks)
    masks = masks & causal
    if extra_mask is not None:
        masks = masks & extra_mask
    return masks, decision


def update_share_state(a_tilde: torch.Tensor, state: pdict.PivotalState,
                       cluster_ids: torch.Tensor, decision: PatternDecision,
                       cfg: SharePrefillConfig) -> pdict.PivotalState:
    """Algorithm 2: the dense-construction heads build pivots and update the
    dictionary; other heads' Ã rows are ignored (they may be all −inf when
    the kernel's stats gate skipped them)."""
    new_masks, new_reps = construct_pivotal_pattern(a_tilde, cfg.gamma)
    return pdict.update(state, cluster_ids, new_masks, new_reps,
                        decision.use_dense)


def pattern_sharing_head_perm(decision: PatternDecision,
                              cluster_ids: torch.Tensor,
                              group: int) -> torch.Tensor:
    """``(B, H)`` permutation making heads that share a pivot adjacent
    within their GQA group (``h // group`` stays invariant).  The sort is
    stable, so it is the identity when no two heads of a group share one.
    Position p of the launch runs original head ``perm[b, p]``."""
    use_shared = decision.use_shared                      # (B, H)
    b, h = use_shared.shape
    hkv = h // group
    ar = torch.arange(h, dtype=torch.int64, device=use_shared.device)
    key = torch.where(use_shared, cluster_ids.long(), (1 << 30) + ar)
    order = torch.argsort(key.reshape(b, hkv, group), dim=-1, stable=True)
    base = (torch.arange(hkv, device=use_shared.device) * group)[:, None]
    return (base + order).reshape(b, h)


def layer_pattern_stats(masks: torch.Tensor,
                        decision: PatternDecision) -> LayerStats:
    """LayerStats of a batch: means over samples, ``max_row_pop`` a max."""
    f32 = lambda x: x.to(torch.float32)
    count = lambda flag: f32(flag).sum(dim=-1).mean()
    return LayerStats(
        num_shared=count(decision.use_shared),
        num_dense=count(decision.use_dense),
        num_vs=count(decision.use_vs),
        block_density=block_mask_density(masks).mean(),
        d_sparse_mean=decision.d_sparse.mean(),
        d_sim_mean=decision.d_sim.mean(),
        max_row_pop=f32(masks).sum(dim=-1).max(),
    )


def _take_heads(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``x[b, perm[b, p], …]`` for a (B, H, …) tensor."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, perm]


def head_permuted_attention(
    attention_fn: AttentionFn, q: torch.Tensor, k: torch.Tensor,
    v: torch.Tensor, masks: torch.Tensor, gate: torch.Tensor,
    perm: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A batched ``attention_fn`` launched with the heads in ``perm``'s
    order (:func:`pattern_sharing_head_perm`); out and Ã come back in the
    original order.  q and masks may hold a chunk of the query rows (the
    gather copies q's rows contiguous)."""
    out_p, a_p = attention_fn(
        _take_heads(q, perm).contiguous(), k, v,
        _take_heads(masks, perm), stats_gate=_take_heads(gate, perm))
    inv = torch.argsort(perm, dim=1)
    return _take_heads(out_p, inv), _take_heads(a_p, inv)


def share_prefill_attention_layer(
    q: torch.Tensor,                # (H, N, D)
    k: torch.Tensor,                # (Hkv, N, D)
    v: torch.Tensor,
    state: pdict.PivotalState,      # one sample's: no batch axis
    cluster_ids: torch.Tensor,      # (H,)
    cfg: SharePrefillConfig,
    attention_fn: Optional[AttentionFn] = None,
    extra_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, pdict.PivotalState, LayerStats]:
    """One layer of SharePrefill for a single sample.  A batched
    ``attention_fn`` gets the sample as a batch of one, with the stats
    gate; a per-sample one (the default, :func:`repro_torch.kernels.
    sparse_attention_fn`) gets every head's masks and returns every head's
    Ã."""
    if attention_fn is None:
        attention_fn = sparse_attention_fn(block_size=cfg.block_size)
    state_b = pdict.PivotalState(*(x[None] for x in state))
    masks, decision = build_share_masks(q[None], k[None], state_b,
                                        cluster_ids, cfg, extra_mask)
    if getattr(attention_fn, "batched", False):
        out, a_tilde = attention_fn(q[None], k[None], v[None], masks,
                                    stats_gate=decision.use_dense)
    else:
        out, a_tilde = attention_fn(q, k, v, masks[0])
        out, a_tilde = out[None], a_tilde[None]
    new_state = update_share_state(a_tilde, state_b, cluster_ids, decision,
                                   cfg)
    return (out[0], pdict.PivotalState(*(x[0] for x in new_state)),
            layer_pattern_stats(masks, decision))


def _reduce_layer_stats(stats: Sequence[LayerStats]) -> LayerStats:
    """Per-sample LayerStats reduced over the batch: means, except
    ``max_row_pop`` (a bound: the max over samples)."""
    cols = [torch.stack(list(f)) for f in zip(*stats)]
    means = LayerStats(*(c.mean() for c in cols))
    return means._replace(max_row_pop=cols[-1].max())


def batched_share_prefill_attention_layer(
    q: torch.Tensor,                # (B, H, N, D)
    k: torch.Tensor,                # (B, Hkv, N, D)
    v: torch.Tensor,
    state: pdict.PivotalState,      # leaves with a leading B axis
    cluster_ids: torch.Tensor,      # (H,)
    cfg: SharePrefillConfig,
    attention_fn: Optional[AttentionFn] = None,
    extra_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, pdict.PivotalState, LayerStats]:
    """One layer of SharePrefill over a batch (module docstring).  A
    per-sample ``attention_fn`` runs the layer sample by sample, each
    sample with its own dictionary."""
    if attention_fn is None:
        attention_fn = batched_sparse_attention_fn(block_size=cfg.block_size)
    if not getattr(attention_fn, "batched", False):
        outs, states, stats = [], [], []
        for i in range(q.shape[0]):
            o, st, ls = share_prefill_attention_layer(
                q[i], k[i], v[i], pdict.PivotalState(*(x[i] for x in state)),
                cluster_ids, cfg, attention_fn, extra_mask)
            outs.append(o)
            states.append(st)
            stats.append(ls)
        return (torch.stack(outs),
                pdict.PivotalState(*(torch.stack(f) for f in zip(*states))),
                _reduce_layer_stats(stats))
    group = q.shape[1] // k.shape[1]
    masks, decision = build_share_masks(q, k, state, cluster_ids, cfg,
                                        extra_mask)
    perm = pattern_sharing_head_perm(decision, cluster_ids, group)
    out, a_tilde = head_permuted_attention(attention_fn, q, k, v, masks,
                                           decision.use_dense, perm)
    new_state = update_share_state(a_tilde, state, cluster_ids, decision,
                                   cfg)
    return out, new_state, layer_pattern_stats(masks, decision)

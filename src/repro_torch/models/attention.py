"""GQA attention layer: prefill and decode (port of
``repro/models/attention.py`` for ``method in ("dense", "share")``).

Prefill ``method="share"`` runs SharePrefill through the batched sparse
kernels whenever pattern sharing applies to the sequence length; ``dense``,
and lengths it does not apply to, attend densely (plain PyTorch).  The
baseline policies (``vertical_slash``, ``flex``) come with a later slice
(ROADMAP.md queue A.3).

``attn_impl="auto"`` resolves to the sparse path on every device: the CUDA
kernels for CUDA tensors, their plain versions for CPU tensors.  (The
reference's ``auto`` picks dense-chunked attention off the TPU, a different
function; equivalence tests call the reference with ``attn_impl="sparse"``.)
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import share_attention as sa
from repro_torch.core.api import SharePrefill
from repro_torch.kernels import batched_sparse_attention_fn, expand_kv
from repro_torch.kernels.chunked import chunked_attention
from repro_torch.kernels.decode_attn import DecodePlan, flash_decode_plan
from repro_torch.models import common

PREFILL_METHODS = ("dense", "share")
PREFILL_ATTN_IMPLS = ("auto", "sparse")


def resolve_attention_fn(attn_impl: str, block_size: int,
                         width: Optional[int] = None) -> sa.AttentionFn:
    """``auto`` and ``sparse`` → the batched sparse attention function."""
    if attn_impl not in PREFILL_ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; expected one of "
                         f"{PREFILL_ATTN_IMPLS}")
    return batched_sparse_attention_fn(block_size=block_size, width=width)


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


def attention_decode(
    params,
    x: torch.Tensor,                    # (B, 1, d)
    cfg: ModelConfig,
    cache_k: torch.Tensor,              # (B, Hkv, S, hd), written in place
    cache_v: torch.Tensor,
    pos: int,                           # cache write index (lockstep)
    positions: torch.Tensor,            # (B, 1) rope positions
    *,
    valid_mask: Optional[torch.Tensor] = None,   # (B, S) slot validity
    plan: Optional[DecodePlan] = None,  # this layer's sparse-decode tables
    decode_impl: str = "auto",
) -> torch.Tensor:
    """One decode step; returns ``(B, 1, d)``.

    The new token's K/V are written into ``cache_k``/``cache_v`` at ``pos``
    in place (the reference returns an updated copy; writing in place saves
    copying the whole cache every step).  ``valid_mask`` marks the visible
    slots (length ∧ not right-pad); without it every slot ≤ ``pos`` is
    visible.  With ``plan`` the step streams only the plan's blocks through
    :func:`repro_torch.kernels.decode_attn.flash_decode_plan`; without it the
    step attends densely (plain PyTorch)."""
    b = x.shape[0]
    q, k, v = common.gqa_qkv(params, x)
    q, k = rope_qk(q, k, positions, cfg)
    cache_k[:, :, pos] = k[:, :, 0]
    cache_v[:, :, pos] = v[:, :, 0]
    s = cache_k.shape[2]
    if valid_mask is None:
        mask = (torch.arange(s, device=x.device) <= pos).expand(b, s)
    else:
        mask = valid_mask
    hkv, hd = cache_k.shape[1], q.shape[-1]
    g = q.shape[1] // hkv

    if plan is not None:
        out = flash_decode_plan(q[:, :, 0].contiguous(), cache_k, cache_v,
                                plan, mask.contiguous(), impl=decode_impl)
        return common.gqa_out(params, out[:, :, None, :])

    qg = q[:, :, 0].reshape(b, hkv, g, hd).float()
    logits = torch.einsum("bkgd,bksd->bkgs", qg, cache_k.float())
    logits = logits * (1.0 / hd ** 0.5)
    logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p.to(cache_v.dtype).float(),
                       cache_v.float())
    out = out.to(x.dtype).reshape(b, hkv * g, 1, hd)
    return common.gqa_out(params, out)

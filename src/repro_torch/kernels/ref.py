"""Plain PyTorch oracles of the attention kernels (port of
``repro/kernels/ref.py``).

They are the plain side of ``attn_impl="ref"`` and oracles in the tests;
each keeps the reference's guards (a non-finite row max is replaced by 0 in
the block-sparse oracle, denominators are ``max(l, 1e-30)``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = float("-inf")


def _token_masks(block_mask: torch.Tensor, n_q: int, n_kv: int,
                 block_q: int, block_kv: int, causal: bool) -> torch.Tensor:
    """Expand an (…, NBq, NBkv) block mask to token level, with causality
    (query row ``i`` is position ``n_kv − n_q + i``)."""
    tok = block_mask.repeat_interleave(block_q, dim=-2) \
        .repeat_interleave(block_kv, dim=-1)
    if causal:
        dev = block_mask.device
        qpos = torch.arange(n_q, device=dev)[:, None] + (n_kv - n_q)
        kpos = torch.arange(n_kv, device=dev)[None, :]
        tok = tok & (kpos <= qpos)
    return tok


def block_sparse_attention_ref(
    q: torch.Tensor,            # (H, N, Dqk)
    k: torch.Tensor,            # (H, N, Dqk)
    v: torch.Tensor,            # (H, N, Dv)
    block_mask: torch.Tensor,   # (H, NB, NB) bool
    *,
    block_size: int,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle of block-sparse attention on expanded K/V: ``(out (H, N, Dv)
    in q's dtype, Ã (H, NB, NB) f32)``, Ã the block-averaged scaled logits
    over the valid (mask ∧ causal) positions, −inf where a block has
    none."""
    h, n, d = q.shape
    nb = n // block_size
    scale = 1.0 / d ** 0.5
    logits = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * scale
    tok = _token_masks(block_mask, n, n, block_size, block_size, causal)
    masked = logits.masked_fill(~tok, NEG_INF)
    m = masked.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(tok, torch.exp(masked - m), 0.0)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("hqk,hkd->hqd", p / denom, v.float())

    valid = tok.reshape(h, nb, block_size, nb, block_size)
    lg = logits.reshape(h, nb, block_size, nb, block_size)
    cnt = valid.sum(dim=(2, 4))
    s = torch.where(valid, lg, 0.0).sum(dim=(2, 4))
    a_tilde = torch.where(cnt > 0, s / torch.clamp(cnt, min=1), NEG_INF)
    return out.to(q.dtype), a_tilde


def dense_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """Exact dense attention, ``(…, Nq, D)`` against ``(…, Nkv, D)``."""
    d = q.shape[-1]
    logits = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) \
        * (1.0 / d ** 0.5)
    if causal:
        n_q, n_kv = logits.shape[-2:]
        qpos = torch.arange(n_q, device=q.device)[:, None] + (n_kv - n_q)
        kpos = torch.arange(n_kv, device=q.device)[None, :]
        logits = logits.masked_fill(kpos > qpos, NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("...qk,...kd->...qd", p, v.float())
    return out.to(q.dtype)


def decode_attention_ref(q: torch.Tensor,      # (H, 1, D) or (H, D)
                         k: torch.Tensor,      # (H, S, D)
                         v: torch.Tensor,      # (H, S, Dv)
                         *,
                         length_mask: Optional[torch.Tensor] = None,  # (S,)
                         window: int = 0,
                         sink: int = 0) -> torch.Tensor:
    """Single-token decode against a KV cache, with an optional sliding
    window and sink."""
    squeeze = q.dim() == 2
    if squeeze:
        q = q[:, None, :]
    d = q.shape[-1]
    s = k.shape[-2]
    logits = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) \
        * (1.0 / d ** 0.5)
    mask = torch.ones((s,), dtype=torch.bool, device=q.device)
    if length_mask is not None:
        mask = mask & length_mask
    if window > 0:
        pos = torch.arange(s, device=q.device)
        last = (length_mask.sum() - 1) if length_mask is not None else s - 1
        mask = mask & ((pos > (last - window)) | (pos < sink))
    logits = logits.masked_fill(~mask[None, None, :], NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("hqk,hkd->hqd", p, v.float()).to(q.dtype)
    return out[:, 0, :] if squeeze else out

"""Exact dense attention in plain PyTorch, one query chunk at a time.

The port of ``repro/kernels/chunked.py::chunked_attention`` for the paths
that attend densely: ``method="dense"`` prefill and prompt lengths for which
pattern sharing does not apply.  It is not a Pallas kernel in the reference
either.  Query rows are processed ``block_size`` at a time only to bound the
(B, H, chunk, Nkv) float32 logits; a row's softmax never depends on other
rows, so a ragged last chunk needs no padding.
"""
from __future__ import annotations

import torch

NEG_INF = float("-inf")


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      block_size: int = 128,
                      causal: bool = True) -> torch.Tensor:
    """q (B, H, N, D) against pre-expanded k/v (B, H, Nkv, D) → (B, H, N, Dv)
    in q's dtype.  Query row ``i`` is global position ``Nkv − N + i``."""
    n, d = q.shape[2], q.shape[3]
    nkv = k.shape[2]
    scale = 1.0 / (d ** 0.5)
    kf, vf = k.float(), v.float()
    kpos = torch.arange(nkv, device=q.device)
    outs = []
    for start in range(0, n, block_size):
        qb = q[:, :, start:start + block_size].float()
        logits = torch.einsum("bhqd,bhkd->bhqk", qb, kf) * scale
        qpos = nkv - n + start + torch.arange(qb.shape[2], device=q.device)
        valid = torch.ones((qb.shape[2], nkv), dtype=torch.bool,
                           device=q.device)
        if causal:
            valid &= kpos[None, :] <= qpos[:, None]
        masked = logits.masked_fill(~valid, NEG_INF)
        m = masked.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.where(valid, torch.exp(masked - m), 0.0)
        denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p / denom,
                                 vf).to(q.dtype))
    return torch.cat(outs, dim=2)

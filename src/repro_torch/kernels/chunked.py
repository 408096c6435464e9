"""Exact dense attention in plain PyTorch, one query block at a time.

The port of ``repro/kernels/chunked.py``: the attention of ``method="dense"``
prefill and of prompt lengths pattern sharing does not apply to, and, with
a block mask and ``collect_stats``, the dense backend of SharePrefill
(``attn_impl="chunked"``: every block's FLOPs are issued, masked blocks
contribute nothing and carry −inf in Ã, as in the block-sparse kernels).
It is not a Pallas kernel in the reference either.  Query rows are
processed ``block_size`` at a time to bound the (B, H, block, Nkv) float32
logits; a row's softmax never depends on other rows, so without a mask or
stats a ragged last block needs no padding.  Every block's arithmetic
depends on that block's rows and ``q_offset`` alone, so a chunk of query
blocks at its offset gives bitwise the rows of the whole launch (chunked
prefill relies on it).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.ops import expand_kv

NEG_INF = float("-inf")


def largest_divisor_block(n: int, nkv: int, block_size: int) -> int:
    """Largest common divisor of ``n`` and ``nkv`` that is ≤
    ``block_size``."""
    g = math.gcd(n, nkv)
    for bs in range(min(block_size, g), 0, -1):
        if g % bs == 0:
            return bs
    return 1


def chunked_attention(
    q: torch.Tensor,                    # (B, H, N, D)
    k: torch.Tensor,                    # (B, H, Nkv, D), kv pre-expanded
    v: torch.Tensor,                    # (B, H, Nkv, Dv)
    *,
    block_size: int = 128,
    causal: bool = True,
    block_mask: Optional[torch.Tensor] = None,   # (B, H, NBq, NBkv) bool
    window: int = 0,                    # sliding window in tokens (0: off)
    sink: int = 0,                      # always-visible prefix tokens
    collect_stats: bool = False,
    q_offset: Optional[int] = None,     # global position of q row 0
):
    """Exact attention over query blocks.

    Returns ``out (B, H, N, Dv)`` in q's dtype, or ``(out, Ã (B, H, NBq,
    NBkv) f32)`` with ``collect_stats``: every block's mean scaled logit
    over its valid entries, −inf where it has none.  Query row ``i`` is
    global position ``q_offset + i`` (default ``Nkv − N``: the suffix
    alignment of one-shot prefill).  A block mask or stats need ``N`` and
    ``Nkv`` to be multiples of ``block_size``.  On ``DTensor`` arguments
    each rank computes only its own (batch, heads) shard
    (:func:`_per_shard`)."""
    if type(q) is not torch.Tensor:
        from torch.distributed.tensor import DTensor
        if isinstance(q, DTensor):
            return _per_shard(q, k, v, block_mask, dict(
                block_size=block_size, causal=causal, window=window,
                sink=sink, collect_stats=collect_stats, q_offset=q_offset))
    b, h, n, d = q.shape
    nkv = k.shape[2]
    gridded = block_mask is not None or collect_stats
    if gridded and (n % block_size or nkv % block_size):
        raise ValueError(f"a block mask or stats need block-aligned lengths "
                         f"(N={n}, Nkv={nkv}, bs={block_size})")
    nbkv = nkv // block_size
    offset = nkv - n if q_offset is None else int(q_offset)
    scale = 1.0 / (d ** 0.5)
    kf, vf = k.float(), v.float()
    kpos = torch.arange(nkv, device=q.device)
    outs, stats = [], []
    for i, start in enumerate(range(0, n, block_size)):
        qb = q[:, :, start:start + block_size].float()
        rows = qb.shape[2]
        logits = torch.einsum("bhqd,bhkd->bhqk", qb, kf) * scale
        qpos = offset + start + torch.arange(rows, device=q.device)
        valid = torch.ones((rows, nkv), dtype=torch.bool, device=q.device)
        if causal:
            valid &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            in_win = (qpos[:, None] - kpos[None, :]) < window
            valid &= in_win | (kpos[None, :] < sink)
        if block_mask is not None:
            tok = block_mask[:, :, i].repeat_interleave(block_size, dim=-1)
            valid = valid[None, None] & tok[:, :, None, :]
        masked = logits.masked_fill(~valid, NEG_INF)
        m = masked.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.where(valid, torch.exp(masked - m), 0.0)
        denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p / denom,
                                 vf).to(q.dtype))
        if collect_stats:
            vd = valid.expand(b, h, rows, nkv).reshape(
                b, h, rows, nbkv, block_size)
            lg = logits.reshape(b, h, rows, nbkv, block_size)
            cnt = vd.sum(dim=(2, 4))
            s = torch.where(vd, lg, 0.0).sum(dim=(2, 4))
            stats.append(torch.where(cnt > 0, s / torch.clamp(cnt, min=1),
                                     NEG_INF))
    out = torch.cat(outs, dim=2)
    if collect_stats:
        return out, torch.stack(stats, dim=2)
    return out


def _per_shard(q, k, v, block_mask, kw):
    """:func:`chunked_attention` of ``DTensor`` arguments, run by each rank
    on its own (batch, heads) shard: q, k, v and the block mask are placed
    as q's batch and head axes are (any other split of q gathered; a
    replicated argument is sliced in place, with no collective), the block
    loop runs on the local shards (``local_map``), and its outputs come
    back so placed.  Attention reduces nothing across (batch, head) pairs.
    ``DTensor``'s own einsum flattens batch × heads into one product axis,
    which cannot carry two mesh axes, and so computes every head on every
    rank."""
    from torch.distributed.tensor import (
        DTensor,
        Replicate,
        Shard,
        distribute_tensor,
    )
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    # one tensor's placements: a list (local_map reads a tuple as one
    # entry per output)
    place = [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
             for p in q.placements]

    def placed(x):
        if isinstance(x, DTensor):
            return x.redistribute(mesh, place)
        return distribute_tensor(x, mesh, place, src_data_rank=None)

    masked = block_mask is not None
    fn = local_map(
        lambda q_, k_, v_, m_: chunked_attention(q_, k_, v_, block_mask=m_,
                                                 **kw),
        out_placements=(place, place) if kw["collect_stats"] else place,
        in_placements=(place, place, place, place if masked else None),
        device_mesh=mesh)
    return fn(placed(q), placed(k), placed(v),
              placed(block_mask) if masked else None)


def chunked_attention_fn(*, block_size: int, causal: bool = True):
    """Per-sample AttentionFn of the dense path (``attn_impl="chunked"``):
    ``(q (H, N, D), k (Hkv, N, D), v (Hkv, N, Dv), masks (H, NB, NB)) ->
    (out (H, N, Dv), Ã (H, NB, NB))``, K/V expanded over the GQA group."""
    def fn(q, k, v, masks):
        k, v = expand_kv(k, v, q.shape[0])
        out, a_tilde = chunked_attention(
            q[None], k[None], v[None], block_size=block_size, causal=causal,
            block_mask=masks[None], collect_stats=True)
        return out[0], a_tilde[0]
    return fn

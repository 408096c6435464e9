"""Decode-phase pattern sharing (port of
``repro/serving/sparse_decode.py``: ``decode_keep_blocks``,
``packed_decode_keep_blocks``, ``keep_blocks_to_token_mask`` and
``decode_traffic_fraction``).

A head whose cluster has a pivot keeps, during decode, the pivot's last
query-block row (a decode query is a "future last row") plus the final
prefill block; heads without a valid pivot keep every block.
:func:`repro_torch.serving.decode_plan.build_decode_plan` compacts these
keep-sets into the decode kernel's tables once per served batch.
"""
from __future__ import annotations

import torch

from repro_torch.core.api import SharePrefill
from repro_torch.core.pattern_dict import PivotalState


def decode_keep_blocks(sp: SharePrefill, sp_state: PivotalState,
                       num_layers: int, num_heads: int) -> torch.Tensor:
    """(L, B, H, NB) bool keep-sets from the post-prefill dictionaries
    (``sp_state`` leaves ``(B, C, …)``)."""
    device = sp_state.masks.device
    ids = torch.as_tensor(sp.cluster_ids[:num_layers, :num_heads],
                          device=device).long()                  # (L, H)
    safe = ids.clamp(0, sp_state.masks.shape[1] - 1)
    cover = sp_state.masks[:, :, -1, :].clone()                  # (B, C, NB)
    cover[..., -1] = True
    keep = cover[:, safe]                                        # (B, L, H, NB)
    ok = sp_state.valid[:, safe] & (ids >= 0)                    # (B, L, H)
    out = torch.where(ok[..., None], keep, True)
    return out.transpose(0, 1)                                   # (L, B, H, NB)


def packed_decode_keep_blocks(sp: SharePrefill, sp_state: PivotalState,
                              num_layers: int, num_heads: int, *,
                              num_segs: int, seg_blocks: int,
                              segment: int) -> torch.Tensor:
    """Keep-sets of ONE segment of a packed prefill, ``(L, B, H, NBseg)``
    (B the packed batch, 1).  The dictionary's masks live on the packed
    ``(P · NBseg)²`` grid; segment ``j``'s decode queries sit at its own
    tail, so its keep-set is the pivot's row ``(j + 1) · NBseg − 1``
    restricted to its own kv-block columns, with its final block kept."""
    del num_segs                        # the grid's extent, implied
    device = sp_state.masks.device
    ids = torch.as_tensor(sp.cluster_ids[:num_layers, :num_heads],
                          device=device).long()                  # (L, H)
    safe = ids.clamp(0, sp_state.masks.shape[1] - 1)
    row = (segment + 1) * seg_blocks - 1
    lo = segment * seg_blocks
    cover = sp_state.masks[:, :, row, lo:lo + seg_blocks].clone()
    cover[..., -1] = True                                   # (B, C, NBseg)
    keep = cover[:, safe]                                   # (B, L, H, NBseg)
    ok = sp_state.valid[:, safe] & (ids >= 0)               # (B, L, H)
    out = torch.where(ok[..., None], keep, True)
    return out.transpose(0, 1)                              # (L, B, H, NBseg)


def keep_blocks_to_token_mask(keep: torch.Tensor, block_size: int,
                              cache_len: int,
                              prefill_len: int) -> torch.Tensor:
    """(…, NB) block keep-set → (…, cache_len) token mask; positions written
    after prefill are always visible."""
    tok = torch.repeat_interleave(keep, block_size, dim=-1)    # (…, NB·bs)
    pad = cache_len - tok.shape[-1]
    if pad > 0:
        tok = torch.cat([tok, tok.new_ones(tok.shape[:-1] + (pad,))], dim=-1)
    post = torch.arange(cache_len, device=keep.device) >= prefill_len
    return tok | post


def decode_traffic_fraction(keep: torch.Tensor) -> float:
    """Modeled KV-cache read fraction vs dense decode (the memory-term
    lever: decode_32k roofline × this fraction): the kept count times the
    float32 reciprocal of the size, the reference's float32 mean."""
    inv = torch.tensor(1.0 / keep.numel(), dtype=torch.float32,
                       device=keep.device)
    return float(keep.float().sum() * inv)

"""Per-axis slice and copy primitives for KV-cache upkeep (port of
``repro/serving/cache_ops.py``).

``ServingEngine.grow_cache`` and ``cache_insert`` and the block-paged pool
share one convention:

* a tensor axis is a *sequence axis* iff its size equals the current cache
  length and it is not the trailing (feature) axis;
* a slot write copies ``src`` into the addressed block of ``dst`` and leaves
  every other slot's values as they were.  The reference returns an updated
  copy; here the write is in place (``dst`` is returned), which saves
  copying the whole cache per admission.
"""
from __future__ import annotations

from typing import Dict

import torch


def seq_grow_pads(shape, old_len: int, extra: int):
    """Pad widths growing every non-trailing axis whose size == old_len."""
    nd = len(shape)
    return [(0, extra) if (s == old_len and i < nd - 1) else (0, 0)
            for i, s in enumerate(shape)]


def grow_leaf(x, old_len: int, extra: int):
    """Zero-extend a tensor's sequence axes from ``old_len`` to ``old_len +
    extra``; tensors without a sequence axis (and non-tensors) pass
    through."""
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    pads = seq_grow_pads(x.shape, old_len, extra)
    if not any(p for _, p in pads):
        return x
    out = x.new_zeros([s + p for s, (_, p) in zip(x.shape, pads)])
    out[tuple(slice(0, s) for s in x.shape)] = x
    return out


def write_slot(dst: torch.Tensor, src: torch.Tensor,
               starts: Dict[int, int]) -> torch.Tensor:
    """Copy ``src`` into ``dst`` at the given per-axis starts, in place.

    ``starts`` maps axis → start index (unlisted axes start at 0); the
    write touches only the addressed block."""
    idx = [slice(0, n) for n in src.shape]
    for ax, ix in starts.items():
        idx[ax] = slice(ix, ix + src.shape[ax])
    dst[tuple(idx)] = src.to(dst.dtype)
    return dst


def slice_segment(x: torch.Tensor, offset: int, length: int,
                  axis: int) -> torch.Tensor:
    """One packed segment ``[offset, offset + length)`` along ``axis``."""
    return x.narrow(axis, offset, length)

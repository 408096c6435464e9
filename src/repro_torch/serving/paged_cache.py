"""Block-paged KV cache: a shared page pool plus per-slot page tables (port
of ``repro/serving/paged_cache.py``).

Decode state lives in one pool of fixed-size pages

    K, V : (num_layers, num_pages, Hkv, page_size, head_dim)

with a host-side free-list allocator and an int32 page table ``(nslots,
table_blocks)`` mapping each slot's *logical* KV block to the page that
holds it.  ``page_size == block_size``, so a DecodePlan block id is a page
table column and a head's keep-set is a set of resident pages.

Conventions, as in the reference:

* **Page 0 is the reserved null page.**  It is never allocated; unused
  page-table entries point at it.  An inert slot's decode append lands
  there too (its table row is nulled on release), which is harmless because
  validity and the inert slot's empty plan row keep every read of it out
  of a softmax.
* Per-slot allocation is ``(bucket + decode tail) // page_size`` pages, so
  slots of different buckets coexist in one ``(nslots, table_blocks)``
  decode batch.
* **Pages are refcounted**; :meth:`PageAllocator.release` recycles a page
  at refcount 0, and validates the whole id list before any mutation (a
  double free raises :class:`PageAllocatorError` and changes nothing).

The pool tensors are updated in place (the reference returns updated
copies): a 148-page llama3-8b pool is 2.3 GiB, too much to copy per
admission.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch

NULL_PAGE = 0

Pool = Tuple[torch.Tensor, torch.Tensor]


class PageAllocatorError(ValueError):
    """Allocator misuse: releasing or sharing a page the allocator does not
    consider allocated, or an out-of-range id.  Raised before any
    mutation."""


class PageAllocator:
    """Refcounted host-side free list over a page pool (page 0 reserved).
    ``acquire`` grants fresh pages at refcount 1, ``share`` adds
    references, ``release`` drops them and recycles at zero."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least one allocatable page "
                             "(page 0 is the reserved null page)")
        self.num_pages = num_pages
        # pop() hands out ascending ids
        self._free = list(range(num_pages - 1, 0, -1))
        # per-page reference count; 0 = free (or the null page)
        self._refs = np.zeros((num_pages,), np.int32)
        self.peak_in_use = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def refcount(self, page) -> int:
        return int(self._refs[int(page)])

    def acquire(self, n: int) -> Optional[np.ndarray]:
        """``n`` fresh page ids at refcount 1, or None when the pool lacks
        headroom (never a partial grant)."""
        if n > len(self._free):
            return None
        ids = np.asarray([self._free.pop() for _ in range(n)], np.int32)
        self._refs[ids] = 1
        self.peak_in_use = max(self.peak_in_use, self.used_pages)
        return ids

    def share(self, ids) -> None:
        """One extra reference on each already-allocated page; the whole
        list is validated first."""
        arr = [int(i) for i in ids]
        for i in arr:
            if not 0 < i < self.num_pages:
                raise PageAllocatorError(f"sharing invalid page id {i}")
            if self._refs[i] <= 0:
                raise PageAllocatorError(
                    f"sharing unallocated page {i} (refcount 0)")
        for i in arr:
            self._refs[i] += 1

    def release(self, ids) -> None:
        """Drop one reference per listed page; a page returns to the free
        list at refcount 0.  An out-of-range id or an over-release raises
        :class:`PageAllocatorError` with every refcount and the free list
        unchanged."""
        counts = Counter(int(i) for i in ids)
        for i, c in counts.items():
            if not 0 < i < self.num_pages:
                raise PageAllocatorError(f"releasing invalid page id {i}")
            if self._refs[i] < c:
                raise PageAllocatorError(
                    f"over-release of page {i}: {c} release(s) against "
                    f"refcount {int(self._refs[i])} — double free")
        for i, c in counts.items():
            self._refs[i] -= c
            if self._refs[i] == 0:
                self._free.append(i)

    # single-owner aliases, as in the reference
    def alloc(self, n: int) -> Optional[np.ndarray]:
        return self.acquire(n)

    def free(self, ids) -> None:
        self.release(ids)

    def hold(self, n: int) -> np.ndarray:
        """Take up to ``n`` pages out of circulation (whatever headroom
        exists, possibly none); return them with :meth:`release`."""
        n = min(n, len(self._free))
        if n <= 0:
            return np.zeros((0,), np.int32)
        return self.acquire(n)

    def utilization(self) -> float:
        return self.used_pages / max(1, self.num_pages - 1)

    def check_consistency(self) -> None:
        """Audit the free-list/refcount partition; raises
        :class:`PageAllocatorError` on the first violated invariant (null
        page referenced, negative refcount, duplicate or referenced free
        ids, a page neither free nor referenced)."""
        if self._refs[NULL_PAGE] != 0:
            raise PageAllocatorError("null page has a nonzero refcount")
        if (self._refs < 0).any():
            bad = int(np.argmin(self._refs))
            raise PageAllocatorError(
                f"negative refcount on page {bad}: {int(self._refs[bad])}")
        if len(set(self._free)) != len(self._free):
            raise PageAllocatorError("duplicate ids on the free list")
        for i in self._free:
            if not 0 < i < self.num_pages:
                raise PageAllocatorError(f"invalid id {i} on the free list")
            if self._refs[i] != 0:
                raise PageAllocatorError(
                    f"page {i} is on the free list with refcount "
                    f"{int(self._refs[i])}")
        allocated = int((self._refs[1:] > 0).sum())
        if len(self._free) + allocated != self.num_pages - 1:
            raise PageAllocatorError(
                f"page accounting broken: {len(self._free)} free + "
                f"{allocated} allocated != {self.num_pages - 1} pages")


def init_paged_pool(cfg, *, num_pages: int, page_size: int,
                    dtype=torch.float32, device=None) -> Pool:
    """Zeroed pools ``(L, num_pages, Hkv, page_size, hd)`` for K and V; the
    layer axis leads, so one layer's pool is a contiguous slice."""
    if cfg.mla.enabled:
        raise ValueError("paged KV cache requires GQA stack caches "
                         "(MLA latent layouts keep the contiguous path)")
    shape = (cfg.num_layers, num_pages, cfg.num_kv_heads, page_size,
             cfg.resolved_head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def insert_prefill(cache: Pool, new: Pool, pages) -> Pool:
    """Write a freshly prefilled request's K/V (``(L, 1, Hkv, S, hd)``
    each) into its ``S // page_size`` pages, in place."""
    pages = torch.as_tensor(np.asarray(pages), dtype=torch.long,
                            device=cache[0].device)
    for pool, val in zip(cache, new):
        l, _, hkv, s, hd = val.shape
        ps = pool.shape[3]
        tiles = val[:, 0].reshape(l, hkv, s // ps, ps, hd).transpose(1, 2)
        pool[:, pages] = tiles.to(pool.dtype)
    return cache


def insert_prefill_layer(cache: Pool, layer: int, k: torch.Tensor,
                         v: torch.Tensor, pages, *, offset: int = 0,
                         length: Optional[int] = None) -> Pool:
    """Write one layer's prefill K/V (``(1, Hkv, S, hd)`` each) into its
    ``S // page_size`` pages, in place: chunked admission's counterpart of
    :func:`insert_prefill`, called as each layer's K/V becomes final.  A
    packed segment is cut out with ``offset``/``length`` first."""
    if length is not None:
        k = k.narrow(2, offset, length)
        v = v.narrow(2, offset, length)
    pages = torch.as_tensor(np.asarray(pages), dtype=torch.long,
                            device=cache[0].device)
    for pool, val in zip(cache, (k, v)):
        _, hkv, s, hd = val.shape
        ps = pool.shape[3]
        tiles = val[0].reshape(hkv, s // ps, ps, hd).transpose(0, 1)
        pool[layer, pages] = tiles.to(pool.dtype)
    return cache


def copy_page(cache: Pool, src: int, dst: int) -> Pool:
    """Copy page ``src``'s K/V to page ``dst`` in every layer, in place:
    the copy half of copy-on-write at the decode boundary (a slot about to
    append into a shared page moves onto a private copy first)."""
    for pool in cache:
        pool[:, dst] = pool[:, src]
    return cache


def page_bytes(cfg, page_size: int, itemsize: int = 4) -> int:
    """Bytes one page holds across all layers, K and V."""
    return (2 * cfg.num_layers * cfg.num_kv_heads * page_size
            * cfg.resolved_head_dim * itemsize)


def contiguous_kv_bytes(cfg, batch: int, cache_len: int,
                        itemsize: int = 4) -> int:
    """Bytes the contiguous scheduler holds for the same decode batch."""
    return (2 * cfg.num_layers * batch * cfg.num_kv_heads * cache_len
            * cfg.resolved_head_dim * itemsize)

"""Prompt-prefix index of the paged scheduler: prefill once, share many
(port of ``repro/serving/prefix_cache.py``).

When a cold prefill completes, the scheduler publishes the request's page
run here under a digest of its **clipped** prompt at its bucket; when a
later request with the same digest reaches admission, the scheduler maps
the published pages into the new slot's page table read-only
(``PageAllocator.share``: one more reference a page), skips the prefill
launch and replays the donor's first-token logits and DecodePlan row.

**Full-prompt hits only.**  Under ``method="share"`` the masks at every
row depend on the last query block's strip over the whole padded sequence
and on a dictionary updated from all rows, so a prefix's K/V depend on the
tail tokens: a tail-only prefill over a donor's partial prefix would not be
the cold serve.  A full clipped-prompt hit has no such term: the donor's
prefill and the hit's would-be cold prefill are the same deterministic
computation on the same input, so replaying the donor's pages, logits and
plan row IS the cold result, bitwise, greedy or sampled (the sampling
generator is seeded from the hit's own uid).

**Clipped, not raw.**  A prompt longer than the largest bucket is served as
``prompt[-bucket:]`` (``Request.truncated``), so two prompts differing only
in the clipped-away head are the same prompt, and a preempted truncated
request re-enters the index under the digest of what was prefilled.
:func:`prefix_digest` hashes the clipped tokens, the bucket, the length and
a model salt, byte for byte as the reference does, so both packages give
the same hex string.

**Liveness.**  The index holds ONE reference on every page of a published
run, so a donor finishing or being preempted does not recycle pages under
the index or its hits.  Published runs are read-only: the scheduler's
copy-on-write guard at the decode boundary moves any writer (the donor
included) onto a fresh page first.  Entries are LRU; the capacity bound and
memory pressure (:meth:`PrefixIndex.evict_one`) release the cold end, and
:meth:`PrefixIndex.clear` drops every reference at the end of a serve.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np


def prefix_digest(prompt, bucket: int, salt: str = "") -> str:
    """blake2b (16 bytes, hex) over ``salt``, the bucket and the length as
    int64, and the clipped prompt ``prompt[-bucket:]`` as int32."""
    p = np.asarray(prompt, np.int32)[-int(bucket):]
    h = hashlib.blake2b(digest_size=16)
    h.update(salt.encode())
    h.update(np.int64(bucket).tobytes())
    h.update(np.int64(len(p)).tobytes())
    h.update(np.ascontiguousarray(p).tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class PrefixEntry:
    """One published prefill: the donor's page run and what a hit needs to
    skip the prefill and still be bitwise the cold serve."""
    digest: str
    bucket: int                 # the donor's bucket (also in the digest)
    plen: int                   # effective (clipped) prompt length
    pages: np.ndarray           # the whole run: prompt pages + decode tail
    prompt_pages: int           # how many of ``pages`` hold prefill K/V
    logits: Any                 # (1, V) last-prompt-token logits (device)
    plan_row: Any               # the padded one-slot DecodePlan row, or None
    stats: Dict[str, float]     # pattern stats, incl. the width-policy
                                # observation a hit replays
    width: Optional[int]        # the prefill width cap the donor ran under:
                                # a hit is valid only while the cap matches
    hits: int = 0


class PrefixIndex:
    """LRU map ``digest → PrefixEntry`` holding one page reference per
    published page.  Every method takes the serve's allocator."""

    def __init__(self, max_entries: int = 32):
        self.max_entries = max(1, int(max_entries))
        self._entries: "OrderedDict[str, PrefixEntry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.pages_saved = 0    # pages hits mapped instead of acquiring
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, digest: str) -> Optional[PrefixEntry]:
        """The entry for ``digest`` (moved to the warm end), or None; the
        caller counts hits and misses (admission peeks several times)."""
        e = self._entries.get(digest)
        if e is not None:
            self._entries.move_to_end(digest)
        return e

    def publish(self, entry: PrefixEntry, alloc) -> bool:
        """Pin ``entry.pages`` (one reference each) and insert the entry,
        evicting from the cold end past ``max_entries``.  An entry of the
        same digest and width is kept (same prompt, same content); one of
        another width cap is replaced."""
        old = self._entries.get(entry.digest)
        if old is not None:
            if old.width == entry.width:
                return False
            alloc.release(old.pages)
            del self._entries[entry.digest]
        alloc.share(entry.pages)
        self._entries[entry.digest] = entry
        while len(self._entries) > self.max_entries:
            self.evict_one(alloc)
        return True

    def evict_one(self, alloc) -> bool:
        """Release the coldest entry's references (a page frees only if no
        slot still maps it)."""
        if not self._entries:
            return False
        _, old = self._entries.popitem(last=False)
        alloc.release(old.pages)
        self.evictions += 1
        return True

    def clear(self, alloc) -> None:
        """Drop every entry's references (end of serve); the counters stay
        readable."""
        while self._entries:
            _, old = self._entries.popitem(last=False)
            alloc.release(old.pages)

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {
            "prefix_hits": float(self.hits),
            "prefix_misses": float(self.misses),
            "prefix_hit_rate": self.hits / total if total else 0.0,
            "prefix_pages_saved": float(self.pages_saved),
            "prefix_entries": float(len(self._entries)),
            "prefix_evictions": float(self.evictions),
        }

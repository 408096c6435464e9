"""Slot-based continuous-batching scheduler (port of
``repro/serving/scheduler.py``).

A request walks

    waiting → prefilling → decode → {done, failed, cancelled}
                  ▲                      │
                  └──── preempted ◄──────┘   (paged pool starvation)

over a fixed set of ``max_batch`` decode *slots*:

  * **Admission** (:meth:`SlotScheduler._admit`): the FIFO head is admitted
    into a free slot once its arrival time has passed.  It is prefilled
    alone at its own bucket (one-shot, under the bucket's width cap
    :meth:`ServingEngine._width_cap`), its first token is sampled, its K/V
    are written into the slot — a row of the contiguous cache
    (:meth:`ServingEngine.cache_insert`) or pages of the shared pool
    (:func:`paged_cache.insert_prefill`) — and under ``decode_sparse`` its
    DecodePlan row is spliced into the live plan.
  * **Per-slot decode** (:meth:`SlotScheduler._decode_step`): every slot,
    occupied or not, decodes at its own position (the ``(B,)`` ``pos``
    contract of ``transformer.decode_step``); greedy rows take ``argmax``
    on one host copy of the step's logits.  A slot that finishes (stop
    token or ``max_new_tokens``) is vacated at once and refilled by the
    next admission.
  * **Inert slots** keep decoding with the empty plan row, and validity
    hides whatever their cache rows hold, so occupied rows do not depend on
    slot churn: greedy tokens match the batch path's.  Their appends land
    at ``pos[slot]``: in the null page once a vacated slot's pages are
    returned, and while a chunked run fills the slot, at the run's first
    decode position, which its first decode step overwrites.
  * **Block-paged pool** (``paged=True``): one pool ``(L, P, Hkv, ps, hd)``
    with page 0 reserved null and a per-slot page table ``(nslots,
    table_blocks)``.  Admission takes ``(bucket + decode tail) / ps`` pages
    and waits — FIFO, counted in ``engine.pages_exhausted_steps`` and the
    request's ``waiting_deferred_steps`` — while the pool lacks them.  One
    paged scheduler serves every bucket: each slot keeps its own prefill
    length (``pflens``), and its plan row, built at its own allocation, is
    padded to the shared table width.
  * **Chunked admission** (``EngineConfig.prefill_chunk > 0``,
    :meth:`SlotScheduler._run_chunked`): the admission runs as a
    :class:`~repro_torch.serving.chunked_prefill.ChunkedPrefillRun`, one
    quantum per scheduler step followed by one decode step; each layer's
    K/V is written into the admitted slot(s) as it becomes final
    (:meth:`_insert_kv`), and the run's completion samples the first
    tokens and splices the plan rows (:meth:`_complete_run`).  A quantum
    that runs while slots are occupied is charged to the admitting
    request(s) as ``prefill_stall_s``.  With ``prefill_pack > 1`` up to
    that many arrived same-bucket prompts share one run
    (:meth:`_pack_limit`, :meth:`_assemble_run`).

**Lifecycle.**  Every step begins with a reap pass (:meth:`_reap`):
requests cancelled through the serve's :class:`SchedulerHandle` (or an
injected :class:`~repro_torch.serving.faults.CancelAt`) and requests past
their ``deadline_s`` end where they stand — a waiting request finishes
inert, a decoding slot is vacated (pages freed, plan row emptied before the
next step), and an in-flight chunked run aborts between quanta once every
segment is doomed (:meth:`ChunkedPrefillRun.abort`).

**Preemption** (``EngineConfig.preempt_after_steps``, paged): once the
queue head has waited on pool headroom for more than that many consecutive
steps, the lowest-priority decoding slot (``Request.priority``, ties: the
fewest generated tokens) is evicted — pages returned, plan row emptied —
and re-queued with its tokens carried in ``resume_tokens``.  A later
admission re-prefills the original prompt at its own bucket and replays the
carry as forced decode tokens; decode rows share nothing across the batch
axis and the request's ``torch.Generator`` restarts from the same seed and
is drawn in the same order, so the resumed stream is the unpreempted one.
A slot is evictable only once its stream is longer than the carry it was
admitted with, so every eviction nets a token (no livelock).

**Quarantine**: a prefill that raises (or an injected
:class:`~repro_torch.serving.faults.PrefillError`) or gives non-finite
logits fails only its request (a raising quantum fails its whole run:
packed segments share the launch), and so do non-finite decode logits in
one row (``finish_reason="failed"``, the :class:`RequestError` in
``Request.error``, the slot vacated).  Pages an injected
:class:`~repro_torch.serving.faults.HoldPages` still holds return at the
end of the serve, before the pool summary (``pages_in_use_at_end``).

**Adaptive pattern refresh** (``EngineConfig.refresh_every``, paged and
sparse): a frozen plan row keeps every appended block, so its dense tail
grows with the decode.  With refresh on, the decode step also returns each
layer's query (``collect_queries``), each occupied slot rings up its last
``block_size`` of them (:class:`~repro_torch.serving.refresh.
RefreshState`), and every ``refresh_every`` steps at a block boundary (or
once the row's tail share reaches ``refresh_tail_threshold``) the row is
re-estimated from the slot's pages
(:func:`~repro_torch.serving.decode_plan.build_refresh_plan_row`, the strip
kernel over the gathered pages) with a bounded dense horizon in place of
the tail; :meth:`_horizon_guard` extends a horizon an append would
outrun.  :meth:`_splice_row` then keeps the live plan's table width at the
power-of-two bucket of its widest row.  The decode kernels' split depends
on the plan's block count, not its width
(:func:`~repro_torch.kernels.decode_attn.decode_splits`), so narrowing the
table moves no row's rounding: a slot's logits are bitwise the frozen
serve's until its own first refresh.  Refresh state is dropped on vacate
and on preemption (a resume re-warms a cold window); a slot holding a page
shared with another holder defers its refresh (:meth:`_refresh_fenced`).
With ``refresh_every=0`` nothing is captured and every splice is the
frozen path's.

**Prefix sharing with copy-on-write** (``EngineConfig.prefix_sharing``,
paged): a completed solo prefill publishes the request's whole page run
(prompt pages and decode tail) to a :class:`~repro_torch.serving.
prefix_cache.PrefixIndex` under the digest of its clipped prompt at its
bucket; the index holds one reference a page, so the run is read-only from
then on.  A queued request with the same digest (and the same width cap)
skips its prefill (:meth:`_start_from_prefix`): its table maps the
published pages (``PageAllocator.share``, no page acquired, no headroom
gate), and the donor's first-token logits, plan row and width-policy
observation are replayed.  The donor's prefill and the hit's would-be cold
prefill are the same deterministic computation on the same input, so the
hit's stream is bitwise the serve's without sharing, greedy or sampled
(the generator is seeded from the hit's uid).  Before each decode step a
slot about to append into a page of refcount > 1 (a hit's or the donor's
published tail) moves onto a fresh copy (:meth:`_cow_append_page`).  The
index is a cache: a starved cold admission (:meth:`_shed_index_for`) and a
copy that finds no free page evict its coldest entries first, and a copy
that still finds none preempts its own slot (resumed bitwise).  Packed
runs are never published, and the index is cleared before the pool
summary.

Sampled (temperature > 0) streams draw from one ``torch.Generator`` per
request, seeded from ``(seed, uid)``; they are not held against the
reference, whose JAX key chains cannot be reproduced.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
import types
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.serving import decode_plan as dplan
from repro_torch.serving import paged_cache, prefix_cache, sparse_decode
from repro_torch.serving import refresh as refresh_mod
from repro_torch.serving.chunked_prefill import ChunkedPrefillRun
from repro_torch.serving.errors import RequestError
from repro_torch.serving.sampling import sample_token

logger = logging.getLogger(__name__)


class SchedulerHandle:
    """Thread-safe cancellation for an in-flight ``serve(handle=...)``:
    :meth:`cancel` ends the request at the scheduler's next step, wherever
    it stands.  An unknown or finished uid is a no-op."""

    def __init__(self):
        self._lock = threading.Lock()
        self._uids: set = set()

    def cancel(self, uid: int) -> None:
        with self._lock:
            self._uids.add(uid)

    def cancelled(self) -> frozenset:
        with self._lock:
            return frozenset(self._uids)


@dataclasses.dataclass
class _Slot:
    """One occupied decode slot: the request and its live decode state."""
    req: object                         # engine.Request
    gen: Optional[torch.Generator]      # the request's sampling stream
    outs: List[int]
    last_tok: int
    t_first: float                      # wall time of the first token
    replay: List[int] = dataclasses.field(default_factory=list)
                                        # preemption carry still to feed:
                                        # decode steps force these tokens
    carry_len: int = 0                  # carry length at admission (the
                                        # eviction progress guard)


class _Phase:
    """One timed stretch of the scheduler: on exit, raising or not, its
    wall time (``s``) is added to ``phase_s[name]``; while tracing is on it
    is also the span it was given."""
    __slots__ = ("phase_s", "name", "span", "t", "s")

    def __init__(self, phase_s: dict, name: str, span):
        self.phase_s, self.name, self.span = phase_s, name, span
        self.s = 0.0

    def __enter__(self) -> "_Phase":
        self.span.__enter__()
        self.t = tracing.now()
        return self

    def __exit__(self, *exc):
        self.s = tracing.now() - self.t
        self.phase_s[self.name] += self.s
        return self.span.__exit__(*exc)


class SlotScheduler:
    """Continuous-batching serve of one bucket's requests (contiguous), or
    of every bucket's (``paged=True``)."""

    def __init__(self, engine, requests, seq: int, *, seed: int = 0,
                 t0: Optional[float] = None, paged: bool = False):
        self.eng = engine
        self.seq = seq
        self.seed = seed
        self.paged = bool(paged and engine.ecfg.paged)
        self.t0 = tracing.now() if t0 is None else t0
        # FIFO in arrival order (stable for equal arrivals)
        self.queue = deque(sorted(requests, key=lambda r: r.arrival_s))

        ecfg = engine.ecfg
        self.nslots = ecfg.max_batch
        blk = max(engine.sp.cfg.block_size, 1)

        # the serve's cancellation handle and fault injector (either may be
        # None), the 1-based step counter they key on, the consecutive
        # starvation count behind preemption, and the doomed segments of
        # the chunked run in flight (uid → terminal reason)
        self.handle = getattr(engine, "handle", None)
        self.faults = getattr(engine, "faults", None)
        self.step_i = 0
        self._starved = 0
        self._doomed: dict = {}
        self.preempt_after = (ecfg.preempt_after_steps
                              if self.paged and ecfg.preempt_after_steps > 0
                              else 0)

        # one decode headroom for the whole serve, a block multiple so the
        # plan tables tile it (the batch path's rounding)
        extra = max(max(r.max_new_tokens for r in requests),
                    ecfg.decode_extra)
        self.cache_len = seq + ((extra + blk - 1) // blk) * blk

        self.slots: List[Optional[_Slot]] = [None] * self.nslots
        self.pos = np.full((self.nslots,), seq, np.int64)
        self.plens = np.full((self.nslots,), seq, np.int64)
        # per-slot prefill length: ``seq`` everywhere in contiguous mode,
        # each slot's own bucket under paging
        self.pflens = np.full((self.nslots,), seq, np.int64)
        # created at the first admission, in the prefill cache's dtype
        self.cache = None

        self.page_size = blk
        self.extra_len = self.cache_len - seq   # block-rounded decode tail
        if self.paged:
            if seq % blk:
                raise ValueError(
                    f"paged serving needs block-aligned seq buckets; got "
                    f"bucket {seq} with page_size {blk}")
            self.table_blocks = self.cache_len // blk
            # auto-sized: a full run for every slot and, with prefix
            # sharing, one run the index pins plus one copied tail page a
            # slot (else every shared decode preempts instead of copying)
            share_extra = ((self.table_blocks + self.nslots)
                           if ecfg.prefix_sharing else 0)
            cap = ecfg.num_pages or (1 + self.nslots * self.table_blocks
                                     + share_extra)
            if cap - 1 < self.table_blocks:
                raise ValueError(
                    f"num_pages={cap} cannot hold one max-length request "
                    f"({self.table_blocks} pages + the null page): "
                    "admission would deadlock")
            self.num_pages = cap
            self.alloc = paged_cache.PageAllocator(cap)
            self.page_table = np.full((self.nslots, self.table_blocks),
                                      paged_cache.NULL_PAGE, np.int32)
            self.slot_pages: dict = {}
        # prompt-prefix sharing: the index, the copy-on-write count and the
        # model part of the digest
        self.prefix = None
        self._cow_copies = 0
        if self.paged and ecfg.prefix_sharing:
            self.prefix = prefix_cache.PrefixIndex(ecfg.prefix_max_entries)
            mcfg = engine.model.cfg
            self._prefix_salt = (
                f"{mcfg.name}/{mcfg.family}/{mcfg.num_layers}/"
                f"{mcfg.num_heads}/{mcfg.resolved_head_dim}")
        # paged mode drops the bucket-wide applicability term: a bucket
        # whose prefill gives no dictionary gets the dense row per request
        self.use_sparse = (ecfg.decode_sparse and ecfg.method == "share"
                           and engine._supports_sparse_decode()
                           and engine.sp.cfg.enabled
                           and (self.paged or engine.sp.applicable(seq)))
        self.plan = None
        self._empty_row = None
        self._stale_slots = set()       # vacated, plan row not yet emptied
        if self.use_sparse:
            kw = dict(cache_len=self.cache_len, block_size=blk,
                      device=engine.device)
            self.plan = dplan.empty_decode_plan(
                engine.model.cfg, batch=self.nslots, **kw)
            # spliced over a vacated slot so it streams nothing
            self._empty_row = dplan.empty_decode_plan(
                engine.model.cfg, batch=1, **kw)

        # adaptive pattern refresh (paged + sparse): each slot's query
        # ring, its last spliced full-width row, and each slot's widest
        # row (the live plan's width bucket)
        self.refresh_on = bool(self.paged and self.use_sparse
                               and ecfg.refresh_every > 0)
        self.refresh: dict = {}         # slot → refresh_mod.RefreshState
        self._slot_rows: dict = {}
        self._row_need: dict = {}
        self.horizon_blocks = 0
        if self.refresh_on:
            self.horizon_blocks = (ecfg.refresh_horizon_blocks
                                   or ecfg.refresh_every // blk + 1)

        # step-cadence chunked admission (0: one-shot)
        self.chunk = engine._chunk_tokens(seq)
        self.run_: Optional[ChunkedPrefillRun] = None
        self._run_wall = 0.0

    def _phase(self, name: str, span: str) -> _Phase:
        """The stretch behind ``engine.phase_s[name]`` and the span
        ``sched.<span>``: ``prefill`` is ``admit`` and ``quantum``,
        ``decode`` is ``decode_step``, ``idle`` is ``wait`` and
        ``refresh`` is ``refresh``."""
        return _Phase(self.eng.phase_s, name,
                      tracing.span("sched." + span))

    def _wait_for(self, r) -> None:
        """Fully idle: sleep until ``r`` arrives."""
        wait = (self.t0 + r.arrival_s) - tracing.now()
        if wait > 0:
            with self._phase("idle", "wait"):
                time.sleep(wait)

    # -- lifecycle ------------------------------------------------------
    def run(self) -> None:
        try:
            if self.chunk:
                self._run_chunked()
                return
            while self.queue or any(s is not None for s in self.slots):
                self._step_begin()
                self._admit()
                self._flush_stale_slots()
                if any(s is not None for s in self.slots):
                    self._decode_step()
            self._flush_stale_slots()   # unoccupied slots' rows are empty
        finally:
            # the index's page references and injected page holds never
            # outlive the serve, and the pool summary publishes even if the
            # serve raised
            if self.prefix is not None:
                self.prefix.clear(self.alloc)
            if self.faults is not None and self.paged:
                self.faults.release_pages(self.alloc)
            self._pool_summary()

    def _run_chunked(self) -> None:
        """The chunked loop: one prefill quantum, then one decode step."""
        while (self.queue or self.run_ is not None
               or any(s is not None for s in self.slots)):
            self._step_begin()
            self._prefill_step()
            if (self.run_ is not None and self.paged and self.queue
                    and (self.t0 + self.queue[0].arrival_s) <= tracing.now()
                    and self._prefix_entry(self.queue[0]) is None):
                self._shed_index_for(self.queue[0])
                if (self.alloc.free_pages
                        < self._pages_needed(self.queue[0])):
                    # the arrived head would wait on pages even once the
                    # run in flight lands: the starvation clock keeps
                    # running, so a decoding victim can be evicted
                    # mid-admission
                    self._note_starved(self.queue[0])
            self._flush_stale_slots()
            if any(s is not None for s in self.slots):
                self._decode_step()
        self._flush_stale_slots()

    def _step_begin(self) -> None:
        """Advance the step counter, let the fault injector act (due
        cancellations, page holds), then reap."""
        self.step_i += 1
        if self.faults is not None:
            self.faults.on_step(self.step_i,
                                alloc=self.alloc if self.paged else None)
        self._reap()

    def _reap(self) -> None:
        """End cancelled and deadline-expired requests where they stand:
        waiting (finished inert), in the chunked run in flight (doomed; the
        run aborts between quanta once no live segment is left) or
        decoding (vacated)."""
        cancelled = set()
        if self.handle is not None:
            cancelled |= self.handle.cancelled()
        if self.faults is not None:
            cancelled |= self.faults.cancelled()
        now = tracing.now()

        def doom_reason(r):
            if r.uid in cancelled:
                return "cancelled"
            if (r.deadline_s > 0
                    and now - (self.t0 + r.arrival_s) > r.deadline_s):
                return "timeout"
            return None

        for r in list(self.queue):
            reason = doom_reason(r)
            if reason is not None:
                self.queue.remove(r)
                self._finish_inert(r, reason)
        run = self.run_
        if run is not None:
            for r in run.requests:
                if r.uid not in self._doomed:
                    reason = doom_reason(r)
                    if reason is not None:
                        self._doomed[r.uid] = reason
            if all(r.uid in self._doomed for r in run.requests):
                self._abort_run(run)
        for i, s in enumerate(self.slots):
            if s is not None:
                reason = doom_reason(s.req)
                if reason is not None:
                    self._vacate(i, s, reason)

    def _request_generator(self, uid: int) -> torch.Generator:
        gen = torch.Generator(device=self.eng.device)
        gen.manual_seed(int(np.random.SeedSequence(
            [self.seed, uid]).generate_state(1)[0]))
        return gen

    def _finish_inert(self, r, reason: str, error=None) -> None:
        """Finish a request that holds no slot; a preempted request's
        carried tokens are its output so far."""
        if error is not None and r.error is None:
            r.error = error
        self._finish(_Slot(req=r, gen=None, outs=list(r.resume_tokens),
                           last_tok=0, t_first=tracing.now()), reason)

    def _abort_run(self, run: ChunkedPrefillRun) -> None:
        """Abort the chunked run in flight between quanta: its pages
        return, every segment finishes with its doom reason, its device
        state is dropped.  Callers doom every live segment first (packed
        segments share the launch)."""
        if self.paged:
            for slot in run.slot_ids:
                self._release_pages(slot)
        for r in run.requests:
            reason = self._doomed.pop(r.uid, "cancelled")
            if not r.finish_reason:
                self._finish_inert(r, reason)
        run.abort()
        self.run_ = None

    def _pool_summary(self) -> None:
        """Publish the pool's capacity, peak and end-of-serve use on the
        engine (``pages_in_use_at_end`` is 0 after a drained serve)."""
        if not self.paged:
            return
        stats = {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "table_blocks": self.table_blocks,
            "peak_pages": self.alloc.peak_in_use,
            "peak_utilization": (self.alloc.peak_in_use
                                 / max(1, self.num_pages - 1)),
            "pages_in_use_at_end": self.alloc.used_pages,
        }
        if self.prefix is not None:
            pstats = self.prefix.stats()
            pstats["prefix_cow_copies"] = float(self._cow_copies)
            stats.update(pstats)
            self.eng.prefix_stats = pstats
        self.eng.page_pool_stats = stats

    def _flush_stale_slots(self) -> None:
        """Empty the plan rows of slots vacated since the last decode step
        (deferred from :meth:`_vacate`, so a slot refilled at once is
        spliced once, not twice)."""
        for slot in sorted(self._stale_slots):
            self._splice_row(slot, self._empty_row)
        self._stale_slots.clear()

    def _splice_row(self, slot: int, row) -> None:
        """Splice one slot's full-width plan row into the live plan: the
        one path of every row replacement.  With refresh off it is the
        plain splice.  With refresh on it also keeps the plan's table width
        at the power-of-two bucket of its widest row: widened before a row
        that keeps more blocks than W, narrowed once every row fits a
        smaller bucket (:func:`dplan.set_plan_width`, lossless both
        ways)."""
        if not self.refresh_on:
            self.plan = dplan.update_plan_slot(self.plan, row, slot)
            return
        need = int(row.counts.max())
        self._row_need[slot] = need
        cur = self.plan.indices.shape[-1]
        if need > cur:
            self.plan = dplan.set_plan_width(
                self.plan, dplan.bucket_plan_width(need, self.table_blocks))
            cur = self.plan.indices.shape[-1]
        self.plan = dplan.update_plan_slot(
            self.plan, dplan.set_plan_width(row, cur), slot)
        target = dplan.bucket_plan_width(
            max(self._row_need.values(), default=1), self.table_blocks)
        if target < cur:
            self.plan = dplan.set_plan_width(self.plan, target)

    # -- paged-pool bookkeeping -----------------------------------------
    def _bucket_of(self, r) -> int:
        """A request's prefill length: the scheduler's bucket in contiguous
        mode, its own bucket under paging (a resumed request re-buckets at
        its original prompt: its footprint never grows)."""
        if not self.paged:
            return self.seq
        b = self.eng._bucket(len(r.prompt))
        if b % self.page_size:
            raise ValueError(
                f"seq bucket {b} is not a multiple of page_size "
                f"{self.page_size}; paged serving needs block-aligned "
                "buckets (page_size == pattern block_size)")
        return b

    def _pages_needed(self, r) -> int:
        """Pages one admission holds: its bucket plus the decode tail."""
        return (self._bucket_of(r) + self.extra_len) // self.page_size

    def _alloc_slot_pages(self, slot: int, n: int) -> np.ndarray:
        """Grant ``n`` pages to ``slot`` and map them in its table row
        (callers check the headroom first)."""
        pages = self.alloc.alloc(n)
        if pages is None:
            raise RuntimeError("page allocation after headroom check")
        self.slot_pages[slot] = pages
        self.page_table[slot, :n] = pages
        return pages

    def _release_pages(self, slot: int) -> None:
        """Return a vacated slot's pages and null its table row.  The inert
        slot's appends then land in the null page, and its plan row is
        emptied before the next decode step, so recycled pages are never
        read through a stale table."""
        pages = self.slot_pages.pop(slot, None)
        if pages is not None:
            self.alloc.free(pages)
            self.page_table[slot, :] = paged_cache.NULL_PAGE

    def _shed_index_for(self, r) -> None:
        """Memory pressure at admission: the prefix index's pinned runs
        yield, coldest first, before the head waits on headroom (else a
        cold request could wait forever on pages only the index holds,
        with no decoding slot to preempt)."""
        if self.prefix is None:
            return
        while (len(self.prefix)
               and self.alloc.free_pages < self._pages_needed(r)):
            self.prefix.evict_one(self.alloc)

    def _note_starved(self, r) -> None:
        """The queue head waited on pool headroom this step; past the
        starvation window a decoding victim is preempted."""
        self.eng.pages_exhausted_steps += 1
        r.waiting_deferred_steps += 1
        self._starved += 1
        if self.preempt_after and self._starved > self.preempt_after:
            self._preempt_victim()

    def _preempt_victim(self) -> None:
        """Evict the lowest-priority decoding slot (ties: the fewest
        generated tokens, then the lowest slot) — unless its stream is not
        yet longer than the carry it was admitted with, in which case the
        eviction waits (its replay drains a token a step), rather than
        falling through to a higher-priority slot."""
        cands = [i for i, s in enumerate(self.slots) if s is not None]
        if not cands:
            return
        victim = min(cands, key=lambda i: (self.slots[i].req.priority,
                                           len(self.slots[i].outs), i))
        s = self.slots[victim]
        if len(s.outs) + len(s.replay) <= s.carry_len:
            return
        self._preempt_slot(victim, "pool starvation")

    def _preempt_slot(self, victim: int, why: str) -> None:
        """decode → waiting: vacate the slot, return its pages, drop its
        refresh state, stale its plan row and re-queue the request with its
        stream so far carried in ``resume_tokens``."""
        s = self.slots[victim]
        r = s.req
        npages = len(self.slot_pages.get(victim, ()))
        self.slots[victim] = None
        self._release_pages(victim)
        self._drop_refresh_slot(victim)
        if self.use_sparse:
            self._stale_slots.add(victim)
        r.resume_tokens = list(s.outs) + list(s.replay)
        r.preempted_count += 1
        r.state = "waiting"
        self.eng.preemptions += 1
        self.queue.append(r)
        self._starved = 0
        logger.info("preempted request %s after %d generated tokens (%s, "
                    "%d pages reclaimed); re-queued with its tokens",
                    r.uid, len(s.outs), why, npages)

    # -- prompt-prefix sharing --------------------------------------------
    def _prefix_digest(self, r) -> str:
        """The (model, bucket, clipped prompt) digest: a truncated request
        hashes what is prefilled, before and after a preemption."""
        return prefix_cache.prefix_digest(r.prompt, self._bucket_of(r),
                                          self._prefix_salt)

    def _prefix_entry(self, r):
        """The published entry matching ``r``, or None.  A hit needs the
        donor's width cap: under a width policy not yet frozen the cold
        prefill would run under another cap, with other masks and K/V."""
        if self.prefix is None:
            return None
        e = self.prefix.lookup(self._prefix_digest(r))
        if e is None or e.width != self.eng._width_cap(e.bucket):
            return None
        return e

    def _publish_prefix(self, r, slot: int, logits, plan_row, stats,
                        plen: int, seq: int, width) -> None:
        """Publish a cold prefill just completed: the slot's whole page run
        is pinned (one reference a page) and becomes read-only, so the
        donor's own next append copies its tail page, and a later identical
        prompt maps the run instead of prefilling."""
        if self.prefix is None:
            return
        self.prefix.publish(prefix_cache.PrefixEntry(
            digest=self._prefix_digest(r), bucket=seq, plen=plen,
            pages=np.array(self.slot_pages[slot], np.int32),
            prompt_pages=seq // self.page_size, logits=logits,
            plan_row=plan_row, stats=dict(stats), width=width), self.alloc)

    def _cow_append_page(self, slot: int) -> None:
        """Copy-on-write at the decode boundary: when the page holding
        ``pos[slot]`` is shared (refcount > 1), move the slot onto a fresh
        copy of it — table entry rewritten, shared reference dropped — so
        the other holders keep it bit for bit.  No free page: evict index
        entries until one frees; still none: preempt this slot (resumed
        bitwise) rather than append into a shared page."""
        b = int(self.pos[slot]) // self.page_size
        old = int(self.page_table[slot, b])
        if old == paged_cache.NULL_PAGE or self.alloc.refcount(old) <= 1:
            return
        fresh = self.alloc.acquire(1)
        while fresh is None and self.prefix is not None and len(self.prefix):
            self.prefix.evict_one(self.alloc)
            fresh = self.alloc.acquire(1)
        if fresh is None:
            self._preempt_slot(slot, "no page to copy a shared page into")
            return
        new = int(fresh[0])
        paged_cache.copy_page(self.cache, old, new)
        self.page_table[slot, b] = new
        pages = self.slot_pages[slot]
        pages[pages == old] = new
        self.alloc.release([old])
        self._cow_copies += 1

    # -- adaptive pattern refresh ---------------------------------------
    def _init_refresh_slot(self, slot: int, row, pos: int) -> None:
        """A just-admitted slot's refresh state: a cold query ring (on the
        card in the pool's dtype, float32 on the CPU) and its spliced
        full-width row."""
        cfg, dev = self.eng.model.cfg, self.eng.device
        dtype = self.cache[0].dtype if dev.type == "cuda" else torch.float32
        self.refresh[slot] = refresh_mod.make_refresh_state(
            cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim,
            self.page_size, pos, dtype=dtype, device=dev)
        self._slot_rows[slot] = row

    def _drop_refresh_slot(self, slot: int) -> None:
        """Discard a vacated or preempted slot's refresh state."""
        self.refresh.pop(slot, None)
        self._slot_rows.pop(slot, None)

    def _slot_tail_stats(self, slot: int):
        """(tail_fraction, traffic_fraction) of the slot's current row,
        against its own page allocation."""
        row = self._slot_rows.get(slot)
        if row is None:
            return 0.0, 0.0
        return dplan.plan_row_tail_stats(
            row, prefill_blocks=int(self.pflens[slot]) // self.page_size,
            num_blocks=len(self.slot_pages.get(slot, ())) or None)

    def _refresh_fenced(self, slot: int) -> bool:
        """A slot holding a page that another holder shares (refcount > 1)
        defers its refresh; counted, re-tried at the next boundary.  Only
        prefix sharing shares pages, so without it this never fires."""
        return any(int(pg) != paged_cache.NULL_PAGE
                   and self.alloc.refcount(int(pg)) > 1
                   for pg in self.slot_pages.get(slot, ()))

    def _horizon_guard(self) -> None:
        """Before a decode step's kernels: a refreshed row about to append
        past its dense horizon gets a cheap extension
        (:func:`dplan.extend_plan_row_horizon`, no strip pass), so the
        appended block is visible.  Frozen rows keep their whole tail."""
        for i, s in enumerate(self.slots):
            st = self.refresh.get(i) if s is not None else None
            if st is None or st.horizon_end <= 0:
                continue
            blk = int(self.pos[i]) // self.page_size
            if blk < st.horizon_end:
                continue
            alloc_blocks = (len(self.slot_pages.get(i, ()))
                            or self.table_blocks)
            hi = min(blk + 1 + self.horizon_blocks, alloc_blocks)
            row = dplan.extend_plan_row_horizon(
                self._slot_rows[i], st.horizon_end, hi)
            self._slot_rows[i] = row
            self._splice_row(i, row)
            st.horizon_end = hi
            st.extensions += 1
            self.eng.refresh_stats["horizon_extensions"] += 1

    def _refresh_tick(self) -> None:
        """After a decode step: re-estimate every occupied slot whose
        cadence is due (or whose tail share crossed the threshold) at a
        block boundary with a warm window."""
        ecfg = self.eng.ecfg
        for i, s in enumerate(self.slots):
            st = self.refresh.get(i) if s is not None else None
            if st is None:
                continue
            pos = int(self.pos[i])
            if not st.window_ready(pos):
                continue
            due = pos - st.last_refresh_pos >= ecfg.refresh_every
            if not due and ecfg.refresh_tail_threshold > 0:
                due = (self._slot_tail_stats(i)[0]
                       >= ecfg.refresh_tail_threshold)
            if not due:
                continue
            if self._refresh_fenced(i):
                st.deferred_cow += 1
                self.eng.refresh_stats["deferred_cow"] += 1
                continue
            self._refresh_slot(i, s, st, pos)

    def _refresh_slot(self, slot: int, s: _Slot, st, pos: int) -> None:
        """Re-estimate one slot's row from its paged KV and splice it."""
        eng = self.eng
        ecfg = eng.ecfg
        bs = self.page_size
        nblk = pos // bs
        alloc_blocks = len(self.slot_pages.get(slot, ()))
        if nblk <= 0 or not alloc_blocks:
            return
        with self._phase("refresh", "refresh"):
            horizon = max(min(self.horizon_blocks, alloc_blocks - nblk), 0)
            row = dplan.build_refresh_plan_row(
                st.window(), self.cache[0],
                torch.as_tensor(self.page_table[slot], device=eng.device),
                eng.model.cfg, block_size=bs, num_blocks=nblk,
                table_blocks=self.table_blocks, horizon_blocks=horizon,
                mass=ecfg.refresh_mass, min_width=ecfg.refresh_min_width)
            self._slot_rows[slot] = row
            self._splice_row(slot, row)
            st.last_refresh_pos = pos
            st.horizon_end = nblk + horizon
            r = s.req
            r.refreshes += 1
            eng.refresh_stats["refreshes"] += 1
            r.tail_fraction, r.plan_traffic_fraction = \
                dplan.plan_row_tail_stats(
                    row, prefill_blocks=int(self.pflens[slot]) // bs,
                    num_blocks=alloc_blocks)
            if r.pattern_stats is not None:
                r.pattern_stats["decode_traffic_fraction"] = \
                    r.plan_traffic_fraction

    # -- admission --------------------------------------------------------
    def _admit(self) -> None:
        """waiting → prefilling: fill free slots from the FIFO."""
        while self.queue:
            free = [i for i, s in enumerate(self.slots) if s is None]
            if not free:
                return
            r = self.queue[0]
            if self.paged and self._prefix_entry(r) is None:
                self._shed_index_for(r)
                if self.alloc.free_pages < self._pages_needed(r):
                    # the head waits until a finishing (or preempted) slot
                    # frees pages; later, smaller requests do not jump the
                    # queue.  A prefix hit maps pages instead: no gate.
                    self._note_starved(r)
                    return
            if (self.t0 + r.arrival_s) > tracing.now():
                if any(s is not None for s in self.slots):
                    return              # keep decoding, admit it later
                self._wait_for(r)       # fully idle: jump to next arrival
            self.queue.popleft()
            self._start(r, free[0])

    def _first_token(self, r, logits):
        """The request's generator and first token: sampled from the
        prefill logits, or the first carried token of a resume (sampled
        all the same, so the generator is drawn as in the first
        admission)."""
        carry = list(r.resume_tokens)
        gen = self._request_generator(r.uid)
        tok0 = int(sample_token(logits, r.sampling, gen)[0])
        t_first = tracing.now()
        if carry:
            tok0 = carry[0]             # carried tokens are verbatim
        else:                           # TTFT is the first-ever token's
            r.ttft_s = max(t_first - (self.t0 + r.arrival_s), 0.0)
        return _Slot(req=r, gen=gen, outs=[tok0], last_tok=tok0,
                     t_first=t_first, replay=carry[1:],
                     carry_len=len(carry))

    @staticmethod
    def _first_token_ends(s: _Slot) -> Optional[str]:
        """The finish reason of a request done with its first token (a
        stop token, or ``max_new_tokens`` of 1), or None."""
        if s.req.sampling.is_stop(s.outs[0]):
            return "stop"
        return "length" if len(s.outs) >= s.req.max_new_tokens else None

    def _occupy(self, slot: int, s: _Slot, plen: int, seq: int,
                row) -> None:
        """prefilling → decode: the slot decodes from its prefill boundary
        ``seq`` (``row``: its spliced plan row, for refresh)."""
        self.pos[slot] = seq
        self.plens[slot] = plen
        self.pflens[slot] = seq
        self.slots[slot] = s
        s.req.state = "decode"
        if self.refresh_on:
            self._init_refresh_slot(slot, row, seq)

    def _quarantine_prefill(self, r, e: Exception) -> None:
        """An admission's prefill (or an injected fault) raised: only this
        request fails — no slot is occupied and no page granted yet."""
        err = (e if isinstance(e, RequestError) else RequestError(
            r.uid, f"prefill raised {type(e).__name__}: {e}",
            kind="prefill"))
        logger.warning("quarantined: %s", err, exc_info=True)
        self._finish_inert(r, "failed", error=err)

    def _start(self, r, slot: int) -> None:
        """prefilling → decode: prefill one request alone, sample its first
        token, write its K/V and splice its plan row (or, on a prefix hit,
        :meth:`_start_from_prefix`); a prefill under prefix sharing is
        published.  The whole admission is ``phase_s["prefill"]``."""
        with self._phase("prefill", "admit"):
            self._start_one(r, slot)

    def _start_one(self, r, slot: int) -> None:
        eng, seq = self.eng, self._bucket_of(r)
        entry = self._prefix_entry(r)
        if entry is not None:
            self._start_from_prefix(r, slot, entry)
            return
        if self.prefix is not None:
            self.prefix.misses += 1
        self._starved = 0               # the head is admitted
        r.state = "prefilling"
        toks = np.zeros((1, seq), np.int64)
        plen = eng._pad_prompt(r, seq, toks[0])
        width = eng._width_cap(seq)
        tp = tracing.now()
        r.queue_s = max(tp - (self.t0 + r.arrival_s), 0.0)
        try:
            if self.faults is not None:
                self.faults.check_prefill([r.uid])
            r.prefill_positions += seq
            result = eng.model.prefill(
                eng.params, torch.as_tensor(toks, device=eng.device), eng.sp,
                method=eng.ecfg.method, attn_impl=eng.ecfg.attn_impl,
                attn_width=width,
                prompt_lens=torch.tensor([plen], device=eng.device))
            finite = bool(torch.isfinite(result.last_logits).all())
        except Exception as e:          # noqa: BLE001 — quarantine wall
            r.prefill_s = tracing.now() - tp
            self._quarantine_prefill(r, e)
            return
        r.prefill_s = tracing.now() - tp
        if any(s is not None for s in self.slots):
            # the whole prefill ran while other slots waited to decode
            r.prefill_stall_s = r.prefill_s
        if not finite:
            err = RequestError(r.uid, "non-finite prefill logits",
                               kind="prefill")
            logger.warning("quarantined: %s", err)
            self._finish_inert(r, "failed", error=err)
            return

        stats = eng._record_prefill_stats(result, width, seq)
        r.pattern_stats = stats
        if r.max_new_tokens <= 0:       # prefill-only: no token is emitted
            self._finish_inert(r, "length")
            return

        s = self._first_token(r, result.last_logits)
        reason = self._first_token_ends(s)
        if reason is not None:
            self._finish(s, reason)
            return                      # the slot stays free

        # decode: occupy the slot (a request that finished on its first
        # token never pays for the plan build)
        if self.cache is None:
            dt = result.cache[0].dtype
            self.cache = (paged_cache.init_paged_pool(
                              eng.model.cfg, num_pages=self.num_pages,
                              page_size=self.page_size, dtype=dt,
                              device=eng.device)
                          if self.paged else
                          eng.model.init_cache(self.nslots, self.cache_len,
                                               dtype=dt))
        if self.paged:
            # the prefill fills the first seq // ps pages; the rest are the
            # decode tail the appends grow into
            pages = self._alloc_slot_pages(slot, self._pages_needed(r))
            paged_cache.insert_prefill(self.cache, result.cache,
                                       pages[: seq // self.page_size])
        else:
            eng.cache_insert(self.cache, result.cache, slot)
        prow = None
        if self.use_sparse:
            # built at the request's own allocation; under paging, padded to
            # the shared table width
            alloc_len = seq + self.extra_len
            if result.sp_state is not None:
                rplan = dplan.build_decode_plan(
                    eng.sp, result.sp_state, eng.model.cfg,
                    prefill_len=seq, cache_len=alloc_len)
            else:
                rplan = dplan.dense_decode_plan(
                    eng.model.cfg, cache_len=alloc_len,
                    block_size=self.page_size, device=eng.device)
            stats.update(eng._plan_stats(rplan, alloc_len))
            r.tail_fraction, r.plan_traffic_fraction = \
                dplan.plan_row_tail_stats(
                    rplan, prefill_blocks=seq // self.page_size)
            if self.paged:
                rplan = dplan.pad_plan_row(rplan, self.table_blocks)
            self._splice_row(slot, rplan)
            self._stale_slots.discard(slot)    # the refill replaced the row
            prow = rplan
        self._occupy(slot, s, plen, seq, prow)
        self._publish_prefix(r, slot, result.last_logits, prow, stats, plen,
                             seq, width)

    def _start_from_prefix(self, r, slot: int, entry) -> None:
        """Prefix hit → decode: map the donor's page run into this slot's
        table read-only (one more reference a page, no page acquired), skip
        the prefill and replay the donor's logits, plan row and width-policy
        observation.  Injected prefill faults still apply, so a poisoned
        request fails whether or not its prompt is cached."""
        eng, seq = self.eng, self._bucket_of(r)
        self._starved = 0               # the head is admitted
        r.state = "prefilling"
        # the hit never reaches _pad_prompt, so the clip is flagged here
        r.truncated = len(np.asarray(r.prompt)) > seq
        tp = tracing.now()
        r.queue_s = max(tp - (self.t0 + r.arrival_s), 0.0)
        try:
            if self.faults is not None:
                self.faults.check_prefill([r.uid])
        except Exception as e:          # noqa: BLE001 — quarantine wall
            self._quarantine_prefill(r, e)
            return
        r.prefill_s = tracing.now() - tp  # ≈ 0: no prefill runs
        r.prefix_hit = True
        entry.hits += 1
        self.prefix.hits += 1
        r.pattern_stats = eng._replay_prefill_stats(entry.stats, seq)
        if r.max_new_tokens <= 0:       # prefill-only: no token is emitted
            self._finish_inert(r, "length")
            return

        # the donor's logits ARE this prompt's: the cold admission's carry
        # and generator contract, unchanged
        s = self._first_token(r, entry.logits)
        reason = self._first_token_ends(s)
        if reason is not None:
            self._finish(s, reason)
            return                      # no page is mapped yet

        # decode: map the run (same bucket, the serve's one decode tail)
        if len(entry.pages) != self._pages_needed(r):
            raise RuntimeError("prefix entry geometry mismatch")
        self.prefix.pages_saved += len(entry.pages)
        self.alloc.share(entry.pages)
        self.slot_pages[slot] = np.array(entry.pages, np.int32)
        self.page_table[slot, : len(entry.pages)] = entry.pages
        if self.use_sparse:
            r.tail_fraction, r.plan_traffic_fraction = \
                dplan.plan_row_tail_stats(
                    entry.plan_row, prefill_blocks=seq // self.page_size,
                    num_blocks=len(entry.pages))
            self._splice_row(slot, entry.plan_row)
            self._stale_slots.discard(slot)
        self._occupy(slot, s, entry.plen, seq, entry.plan_row)

    # -- chunked admission ----------------------------------------------
    def _pack_limit(self, seq: int) -> int:
        """The most prompts one chunked run may pack at segment length
        ``seq``: packing needs a mask-carrying prefill (the segment mask
        has nowhere to go on the dense path), a pattern config applicable
        at the packed length and no sliding window (whose width would be
        measured on packed positions)."""
        eng = self.eng
        p = max(eng.ecfg.prefill_pack, 1)
        if p <= 1 or eng.ecfg.method == "dense" or not eng.sp.cfg.enabled:
            return 1
        if eng.model.cfg.sliding_window:
            return 1
        if seq % max(eng.sp.cfg.block_size, 1):
            return 1
        while p > 1 and not eng.sp.applicable(seq * p):
            p -= 1
        return p

    def _assemble_run(self) -> Optional[ChunkedPrefillRun]:
        """The next chunked run from the arrived queue heads: one segment
        per free slot, up to the pack limit.  The paged pool's FIFO
        headroom gate and the arrival wait are the one-shot loop's; a
        prefix hit at the head needs no run (admitted at once) and never
        rides in a packed one."""
        eng = self.eng
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free or not self.queue:
            return None
        head_hit = self._prefix_entry(self.queue[0]) is not None
        if self.paged and not head_hit and (
                self.alloc.free_pages < self._pages_needed(self.queue[0])):
            self._note_starved(self.queue[0])
            return None
        if (self.t0 + self.queue[0].arrival_s) > tracing.now():
            if any(s is not None for s in self.slots):
                return None             # keep decoding, admit it later
            self._wait_for(self.queue[0])   # fully idle: next arrival
        if head_hit:
            self._start(self.queue.popleft(), free[0])
            return None

        seq = self._bucket_of(self.queue[0])
        chunk = self.chunk if not self.paged else eng._chunk_tokens(seq)
        if self.paged and not chunk:
            # this bucket has no chunked decomposition: admit it one-shot
            self._start(self.queue.popleft(), free[0])
            return None
        limit = min(self._pack_limit(seq), len(free))
        group, now = [], tracing.now()
        reserve = self.alloc.free_pages if self.paged else 0
        while (self.queue and len(group) < limit
               and (self.t0 + self.queue[0].arrival_s) <= now):
            if self.paged:
                r = self.queue[0]
                if self._bucket_of(r) != seq:
                    break       # packing needs one segment length
                if group and self._prefix_entry(r) is not None:
                    break       # a hit is admitted without a run next
                need = self._pages_needed(r)
                if need > reserve:
                    break       # the rest of the group waits for headroom
                reserve -= need
            group.append(self.queue.popleft())
        if not group:
            return None
        if self.prefix is not None:
            self.prefix.misses += len(group)
        self._starved = 0               # the head is admitted
        for r in group:
            r.queue_s = max(now - (self.t0 + r.arrival_s), 0.0)
            r.state = "prefilling"
            r.prefill_positions += seq      # its segment of the run
        # a packed run prefills uncapped: a width is resolved for one
        # bucket geometry, not the packed grid
        width = eng._width_cap(seq) if len(group) == 1 else None
        for r, slot in zip(group, free):
            if self.paged:
                # granted now, so the run's per-layer inserts have
                # somewhere to land; an early finish at completion returns
                # them
                self._alloc_slot_pages(slot, self._pages_needed(r))
            # the decode steps between quanta append the inert slot's K/V
            # at pos[slot] in every layer: park it at the run's first
            # decode position, which decode overwrites before reading it,
            # not where the slot's last occupant (of another bucket) left it
            self.pos[slot] = seq
        self._run_wall = 0.0
        return ChunkedPrefillRun(eng, group, free[: len(group)], seq, chunk,
                                 width)

    def _prefill_step(self) -> None:
        """Advance admission by ONE quantum (assembling a run first if none
        is in flight): the prefill share of a chunked scheduler step."""
        if self.run_ is None:
            self.run_ = self._assemble_run()
            if self.run_ is None:
                return
        run = self.run_
        occupied = any(s is not None for s in self.slots)
        quantum = self._phase("prefill", "quantum")
        try:
            with quantum:
                if self.faults is not None:
                    # injected faults land between quanta: a PrefillError
                    # quarantines the run, a SlowQuantum stretches it
                    uids = [r.uid for r in run.requests]
                    self.faults.check_prefill(uids)
                    d = self.faults.quantum_delay(uids)
                    if d > 0:
                        time.sleep(d)
                ev = run.step()
        except Exception as e:          # noqa: BLE001 — quarantine wall
            self._quarantine_run(run, e)
            return
        dt = quantum.s
        self._run_wall += dt
        if occupied:
            # this quantum ran instead of a decode step: the stall is
            # charged to the admitting request(s), split across segments
            for r in run.requests:
                r.prefill_stall_s += dt / len(run.requests)
        if ev == "kv":
            self._insert_kv(run)
        elif ev == "done":
            self._complete_run(run)
            self.run_ = None

    def _insert_kv(self, run: ChunkedPrefillRun) -> None:
        """Write the layer just finalised into the admitted slot(s), while
        the other slots keep decoding."""
        eng = self.eng
        k, v = run.kv
        if self.cache is None:
            self.cache = (paged_cache.init_paged_pool(
                              eng.model.cfg, num_pages=self.num_pages,
                              page_size=self.page_size, dtype=k.dtype,
                              device=eng.device)
                          if self.paged else
                          eng.model.init_cache(self.nslots, self.cache_len,
                                               dtype=k.dtype))
        for j, slot in enumerate(run.slot_ids):
            # a packed run's segment j is cut out of the packed row
            seg = (dict(offset=j * run.seq, length=run.seq) if run.P > 1
                   else {})
            if self.paged:
                pages = self.slot_pages[slot][: run.seq // self.page_size]
                paged_cache.insert_prefill_layer(
                    self.cache, run.kv_layer, k, v, pages, **seg)
            else:
                eng.cache_insert_layer(self.cache, run.kv_layer, slot, k, v,
                                       **seg)

    def _plan_row(self, run: ChunkedPrefillRun, j: int):
        """One slot's DecodePlan row for segment ``j`` of a finished run,
        at the run's own allocation."""
        eng = self.eng
        cfg = eng.model.cfg
        alloc_len = run.seq + self.extra_len
        if run.sp_state is None:        # the per-request dense row
            return dplan.dense_decode_plan(
                cfg, cache_len=alloc_len, block_size=self.page_size,
                device=eng.device)
        keep = None
        if run.P > 1:
            keep = sparse_decode.packed_decode_keep_blocks(
                eng.sp, run.sp_state, cfg.num_layers, cfg.num_heads,
                num_segs=run.P, seg_blocks=run.seg_blocks, segment=j)
        return dplan.build_decode_plan(
            eng.sp, run.sp_state, cfg, prefill_len=run.seq,
            cache_len=alloc_len, keep_blocks=keep)

    def _complete_run(self, run: ChunkedPrefillRun) -> None:
        """The last quantum ran: sample each segment's first token, splice
        its plan row and occupy its slot (prefilling → decode).  The K/V
        rows are in the cache already, inserted layer by layer.  A segment
        doomed mid-run (its packed neighbours stayed live) finishes here."""
        eng, seq = self.eng, run.seq
        stats = eng._record_prefill_stats(
            types.SimpleNamespace(stats=run.attn_stats), run.width, seq)
        logits_h = run.logits.float().cpu().numpy()
        for j, (r, slot) in enumerate(zip(run.requests, run.slot_ids)):
            reason = self._doomed.pop(r.uid, None)
            if reason is not None:
                if self.paged:
                    self._release_pages(slot)
                self._finish_inert(r, reason)
                continue
            r.prefill_s = self._run_wall
            rstats = dict(stats)
            r.pattern_stats = rstats
            done = None
            if not np.isfinite(logits_h[j]).all():
                # a poisoned segment fails alone; its neighbours go on
                done = ("failed", RequestError(
                    r.uid, "non-finite prefill logits", kind="prefill"))
                logger.warning("quarantined: %s", done[1])
            elif r.max_new_tokens <= 0:   # prefill-only: no token
                done = ("length", None)
            if done is not None:
                if self.paged:
                    self._release_pages(slot)
                self._finish_inert(r, done[0], error=done[1])
                continue

            s = self._first_token(r, run.logits[j: j + 1])
            reason = self._first_token_ends(s)
            if reason is not None:
                if self.paged:
                    self._release_pages(slot)
                self._finish(s, reason)
                continue                # the slot stays free
            prow = None
            if self.use_sparse:
                rplan = self._plan_row(run, j)
                rstats.update(eng._plan_stats(rplan, seq + self.extra_len))
                r.tail_fraction, r.plan_traffic_fraction = \
                    dplan.plan_row_tail_stats(
                        rplan, prefill_blocks=seq // self.page_size)
                if self.paged:
                    rplan = dplan.pad_plan_row(rplan, self.table_blocks)
                self._splice_row(slot, rplan)
                self._stale_slots.discard(slot)
                prow = rplan
            self._occupy(slot, s, run.plens[j], seq, prow)
            if run.P == 1:
                # a packed segment is never published: its logits and K/V
                # carry the packed row's shared strip and dictionary, not
                # the solo prefill a hit must replay
                self._publish_prefix(r, slot, run.logits[j: j + 1], prow,
                                     rstats, int(run.plens[j]), seq,
                                     run.width)

    def _quarantine_run(self, run: ChunkedPrefillRun, exc: Exception
                        ) -> None:
        """A quantum raised: every live segment of the run fails (packed
        segments share the launch), its pages return and its device state
        is dropped; the rest of the serve goes on."""
        for r in run.requests:
            if r.finish_reason or r.uid in self._doomed:
                continue
            if isinstance(exc, RequestError) and exc.uid == r.uid:
                err = exc
            elif isinstance(exc, RequestError):
                err = RequestError(
                    r.uid, f"packed run failed alongside request "
                    f"{exc.uid}", kind="prefill")
            else:
                err = RequestError(
                    r.uid, f"prefill quantum raised {type(exc).__name__}: "
                    f"{exc}", kind="prefill")
            self._doomed[r.uid] = "failed"
            r.error = err
            logger.warning("quarantined: %s", err)
        self._abort_run(run)

    # -- decode ----------------------------------------------------------
    def _decode_step(self) -> None:
        """One decode step over all slots (occupied or inert), then per-slot
        sampling, early exit and slot freeing; with refresh on, the query
        capture before and the refresh pass after."""
        with self._phase("decode", "decode_step"):
            self._decode_slots()
        if self.refresh_on:
            self._refresh_tick()

    def _decode_slots(self) -> None:
        eng = self.eng
        if self.prefix is not None:
            # copy-on-write before the append: no shared page is written
            # (a slot preempted for want of a page sits this step out)
            for i, s in enumerate(self.slots):
                if s is not None:
                    self._cow_append_page(i)
        if self.refresh_on:
            self._horizon_guard()
        occ = [i for i, s in enumerate(self.slots) if s is not None]
        eng.slot_steps += self.nslots
        eng.active_slot_steps += len(occ)

        toks = np.zeros((self.nslots,), np.int64)
        for i in occ:
            toks[i] = self.slots[i].last_tok
        dev = eng.device
        as_dev = lambda a: torch.as_tensor(a, device=dev)
        kw = dict(plan=self.plan, prompt_lens=as_dev(self.plens),
                  decode_impl=eng.ecfg.decode_impl)
        if self.paged:
            kw.update(prefill_len=as_dev(self.pflens),
                      page_table=as_dev(self.page_table))
        else:
            kw.update(prefill_len=self.seq)
        if self.refresh_on:
            logits, self.cache, qs = eng.model.decode(
                eng.params, as_dev(toks)[:, None], self.cache,
                as_dev(self.pos), collect_queries=True, **kw)
            # ring up this step's queries (at the pre-increment positions)
            for i in occ:
                st = self.refresh.get(i)
                if st is not None:
                    st.record(int(self.pos[i]), qs[:, i])
        else:
            logits, self.cache = eng.model.decode(
                eng.params, as_dev(toks)[:, None], self.cache,
                as_dev(self.pos), **kw)

        with tracing.span("sample"):
            self._sample_slots(occ, logits)

    def _sample_slots(self, occ: List[int], logits: torch.Tensor) -> None:
        """Each occupied slot's token from the step's logits; a slot that
        finishes is vacated."""
        # one device→host copy for the step; greedy rows take np.argmax on
        # it (the first maximum, as torch.argmax)
        logits_h = logits.float().cpu().numpy()
        for i in occ:
            self.pos[i] += 1            # this step wrote at the old pos
            s = self.slots[i]
            row = logits_h[i]
            if self.faults is not None:
                row = self.faults.corrupt_logits(s.req.uid, len(s.outs),
                                                 row)
            if not np.isfinite(row).all():
                # only this slot fails: decode rows share nothing
                err = RequestError(s.req.uid, "non-finite decode logits",
                                   kind="decode")
                logger.warning("quarantined: %s", err)
                if s.req.error is None:
                    s.req.error = err
                self._vacate(i, s, "failed")
                continue
            if s.req.sampling.temperature <= 0.0:
                tok = int(np.argmax(row))
            else:
                tok = int(sample_token(logits[i: i + 1], s.req.sampling,
                                       s.gen)[0])
            if s.replay:
                # preemption carry: the token generated before the eviction
                # (sampled above all the same, so the generator stays
                # aligned for the stream after the replay)
                tok = s.replay.pop(0)
            s.outs.append(tok)
            s.last_tok = tok
            if s.req.sampling.is_stop(tok):
                self._vacate(i, s, "stop")
            elif len(s.outs) >= s.req.max_new_tokens:
                self._vacate(i, s, "length")

    def _vacate(self, slot: int, s: _Slot, reason: str) -> None:
        """Free a slot mid-decode: finish its request, return its pages,
        drop its refresh state and mark its plan row stale (emptied before
        the next decode step unless a refill splices a new row first)."""
        self.slots[slot] = None
        if self.paged:
            self._release_pages(slot)
        self._drop_refresh_slot(slot)
        if self.use_sparse:
            self._stale_slots.add(slot)
        self._finish(s, reason)

    # terminal Request.state per finish_reason
    _TERMINAL_STATE = {"stop": "done", "length": "done",
                       "cancelled": "cancelled", "timeout": "cancelled",
                       "failed": "failed", "rejected": "failed"}

    def _finish(self, s: _Slot, reason: str) -> None:
        """Finalize the request's output, metrics and terminal state."""
        r = s.req
        now = tracing.now()
        r.output_tokens = np.asarray(s.outs, np.int32)
        r.finish_reason = reason
        r.state = self._TERMINAL_STATE[reason]
        r.decode_s = max(now - s.t_first, 0.0)
        r.decode_tokens_per_s = self.eng._decode_rate(len(s.outs),
                                                      r.decode_s)

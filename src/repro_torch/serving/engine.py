"""Serving engine (port of ``repro/serving/engine.py``): the batch path and
the continuous-batching slot scheduler.

``scheduler=False`` (the default) serves batch-at-a-time: requests are
grouped by sequence bucket and served ``max_batch`` at a time; prompts are
left-aligned and right-padded to the bucket, the padded batch is prefilled
once under ``EngineConfig.method`` (SharePrefill, a baseline or dense),
and the batch then decodes in lockstep until every row has its tokens or a
stop token.  Per-request prompt lengths are threaded into prefill (each
row's first token comes from its own last prompt token) and into every
decode step as slot validity (right-pad K/V is never attended).  With
``decode_sparse=True`` and ``method="share"`` the prefill pattern
dictionaries are compiled into a
:class:`~repro_torch.kernels.decode_attn.DecodePlan` once per batch, and
every decode step streams only the plan's blocks; other methods decode
densely.  An MLA config (DeepSeek-V2) serves through this path only, with
no plan, and its absorbed decode attends the right-pad slots too (the
latent cache carries no validity mask), as in the reference.  The
attention-free ``ssm`` family (Mamba-2), the RG-LRU ``hybrid``
(RecurrentGemma) and the ``encdec`` family (Whisper, with stub zero frames)
serve through this path only, with the families' plain prefill and decode
signatures: no width cap, no prompt lengths (each row's first token
follows the padded final position, as in the reference), no plan.

``scheduler=True`` serves each bucket through a
:class:`~repro_torch.serving.scheduler.SlotScheduler`: ``max_batch`` slots
decode at their own positions, a finished slot is refilled during the serve
(its prefill K/V inserted with :meth:`ServingEngine.cache_insert`, its plan
row spliced), and ``paged=True`` replaces the per-bucket contiguous caches
by one block-paged pool, so ONE scheduler serves every bucket and admission
waits on pool headroom.  Requests are validated first
(:meth:`ServingEngine.validate_request`); a malformed one finishes
``rejected`` with its :class:`~repro_torch.serving.errors.RequestError`.

``prefill_chunk > 0`` makes the scheduler admit through chunked prefill
(:class:`~repro_torch.serving.chunked_prefill.ChunkedPrefillRun`): each
admission runs as quanta (one layer's mask staging, one chunk of its
attention rows, one layer's FFN), one quantum between two decode steps, so
an admission stalls the occupied slots for one quantum at a time; each
layer's K/V lands in the slot as soon as it is final
(:meth:`ServingEngine.cache_insert_layer`,
:func:`~repro_torch.serving.paged_cache.insert_prefill_layer`).
``prefill_pack > 1`` packs up to that many same-bucket prompts into one
run under a block-diagonal segment mask.

The scheduler's request lifecycle: ``serve(handle=)`` takes a
:class:`~repro_torch.serving.scheduler.SchedulerHandle` whose ``cancel``
ends a request at the next step, ``Request.deadline_s`` a wall budget from
arrival, ``preempt_after_steps`` evicts a decoding victim for a queue head
starved of pages (its tokens carried and replayed on resume), and
``serve(faults=)`` a :class:`~repro_torch.serving.faults.FaultInjector`.
``refresh_every`` re-estimates each paged slot's decode pattern from its
live KV (:mod:`repro_torch.serving.refresh`), and ``width_policy="auto"``
/ ``"count"`` resolve the prefill width cap per bucket from the first
prefill's observation (:mod:`repro_torch.serving.width_policy`).  The
batch path ignores handles, faults, deadlines and preemption, as in the
reference.  ``prefix_sharing`` (paged) lets a request whose clipped prompt
a completed prefill already published skip its prefill and map the
published pages copy-on-write (:mod:`repro_torch.serving.prefix_cache`);
``prefix_stats`` holds the serve's hits, misses, pages saved and copies.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.api import SharePrefill
from repro_torch.distributed.sharding import active_model_mesh
from repro_torch.models.api import TRANSFORMER_FAMILIES, Model
from repro_torch.models.attention import (ROW_ATTN_IMPLS,
                                         prefill_block_size,
                                         resolved_attn_impl)
from repro_torch.serving import cache_ops
from repro_torch.serving import decode_plan as dplan
from repro_torch.serving.errors import RequestError
from repro_torch.serving.sampling import SamplingConfig, sample_token
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.width_policy import (auto_width_cap,
                                              population_width_cap)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # (prompt_len,) int
    max_new_tokens: int = 16
    sampling: SamplingConfig = dataclasses.field(
        default_factory=SamplingConfig)
    arrival_s: float = 0.0              # arrival offset from serve() start
                                        # (the scheduler admits after it)
    deadline_s: float = 0.0             # wall budget from arrival (0: none);
                                        # past it → finish_reason "timeout"
    priority: int = 0                   # preemption victim order: lowest
                                        # first (ties: fewest tokens)
    allow_truncation: bool = True       # False: a prompt longer than the
                                        # largest bucket is rejected
    # filled by the engine:
    output_tokens: Optional[np.ndarray] = None
    prefill_s: float = 0.0              # this request's (or its batch's)
                                        # prefill wall time
    decode_s: float = 0.0               # first token → last token
    queue_s: float = 0.0                # arrival → prefill start
    ttft_s: float = 0.0                 # arrival → first token
    decode_tokens_per_s: float = 0.0    # (n_tokens − 1) / decode_s
    prefill_stall_s: float = 0.0        # decode wall time other slots lost
                                        # to this request's admission
    prefill_positions: int = 0          # token positions its prefills
                                        # computed (bucket, or packed
                                        # segment; 0 on a prefix hit),
                                        # summed over its admissions
    truncated: bool = False             # prompt clipped to the largest bucket
    finish_reason: str = ""             # "stop" | "length" | "timeout" |
                                        # "cancelled" | "failed" | "rejected"
    state: str = "waiting"              # waiting | prefilling | decode |
                                        # done | cancelled | failed
    error: Optional[Exception] = None   # the RequestError behind "failed"
                                        # or "rejected"
    waiting_deferred_steps: int = 0     # scheduler steps this request's
                                        # admission waited on pool headroom
    preempted_count: int = 0            # evictions (pages reclaimed, tokens
                                        # carried, re-queued)
    prefix_hit: bool = False            # admitted on a prefix hit: pages
                                        # mapped from a published run, no
                                        # prefill
    tail_fraction: float = 0.0          # share of its plan row's streamed
                                        # blocks in the dense decode tail
    plan_traffic_fraction: float = 0.0  # its plan row's streamed-block
                                        # fraction against dense
    refreshes: int = 0                  # pattern refreshes of its slot
    # preemption carry: the tokens generated before an eviction, replayed
    # as forced decode tokens after the resume re-prefills the prompt
    resume_tokens: List[int] = dataclasses.field(default_factory=list)
    pattern_stats: Optional[Dict[str, float]] = None

    def metrics(self) -> Dict[str, float]:
        return {"queue_s": self.queue_s, "ttft_s": self.ttft_s,
                "prefill_s": self.prefill_s, "decode_s": self.decode_s,
                "decode_tokens_per_s": self.decode_tokens_per_s,
                "prefill_stall_s": self.prefill_stall_s,
                "waiting_deferred_steps": self.waiting_deferred_steps,
                "preempted_count": self.preempted_count,
                "prefix_hit": float(self.prefix_hit),
                "tail_fraction": self.tail_fraction,
                "plan_traffic_fraction": self.plan_traffic_fraction,
                "refreshes": float(self.refreshes)}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 8
    method: str = "share"               # prefill pattern policy
    attn_impl: str = "auto"             # auto | sparse (batched) | kernel |
                                        # ref | chunked (per sample)
    seq_buckets: tuple = (512, 2048, 8192, 32768)
    decode_extra: int = 128             # decode headroom beyond the prompt
    decode_sparse: bool = False         # decode through a DecodePlan
    decode_impl: str = "auto"           # auto | kernel | einsum
    prefill_width: Optional[int] = None  # static per-row block budget W
    width_policy: str = "off"           # off: prefill_width | auto: a
                                        # density percentile | count: the
                                        # largest row population, resolved
                                        # per bucket after one prefill
    width_percentile: float = 95.0
    width_safety: float = 1.25
    scheduler: bool = False             # continuous batching over slots
    prefill_chunk: int = 0              # tokens per admission quantum
                                        # (0: one-shot admission)
    prefill_pack: int = 1               # prompts per chunked run
    paged: bool = False                 # one block-paged pool, one
                                        # scheduler for every bucket
    num_pages: int = 0                  # pool pages incl. the null page;
                                        # 0 = enough for max_batch slots
    preempt_after_steps: int = 0        # paged: a queue head starved of
                                        # pages this many steps evicts a
                                        # decoding victim (0: never)
    prefix_sharing: bool = False        # paged: a completed solo prefill
                                        # publishes its page run; the same
                                        # clipped prompt later maps it
                                        # copy-on-write and skips prefill
    prefix_max_entries: int = 32        # LRU capacity of the prefix index
    refresh_every: int = 0              # paged sparse decode: re-estimate
                                        # a slot's plan row every this many
                                        # steps at block boundaries (0: off)
    refresh_mass: float = 0.95          # score mass each head's blocks keep
    refresh_tail_threshold: float = 0.0  # refresh early once the row's
                                        # dense-tail share reaches this
    refresh_min_width: int = 1
    refresh_horizon_blocks: int = 0     # dense lookahead after a refresh
                                        # (0: refresh_every // bs + 1)
    refresh_strip_impl: str = "auto"    # the reference's strip switch; the
                                        # port's strip follows the tensors'
                                        # device


class ServingEngine:
    """Serves requests through ``model`` on ``model.device``."""

    def __init__(self, model: Model, params, sp: SharePrefill,
                 ecfg: EngineConfig = EngineConfig()):
        self.model = model
        self.params = params
        self.sp = sp
        self.ecfg = ecfg
        self.device = model.device
        # width-policy observations per bucket and the caps they froze
        self._density_obs: Dict[int, List[float]] = {}
        self._pop_obs: Dict[int, List[float]] = {}
        self._width_frozen: Dict[int, Optional[int]] = {}
        self._reset_counters()

    def _reset_counters(self, handle=None, faults=None) -> None:
        """Per-serve accounting: decode slot capacity and the slots that
        emitted a token (both paths), the scheduler's wall time by phase,
        admissions deferred on pool headroom, the paged pool's end-of-serve
        summary, the prefix index's counters, preemptions and refresh
        counters; and the serve's cancellation handle and fault
        injector."""
        self.slot_steps = 0
        self.active_slot_steps = 0
        self.phase_s: Dict[str, float] = {"prefill": 0.0, "decode": 0.0,
                                          "idle": 0.0, "refresh": 0.0}
        self.pages_exhausted_steps = 0
        self.page_pool_stats: Dict[str, float] = {}
        self.prefix_stats: Dict[str, float] = {}
        self.preemptions = 0
        self.refresh_stats: Dict[str, float] = {
            "refreshes": 0, "deferred_cow": 0, "horizon_extensions": 0}
        self.handle = handle
        self.faults = faults

    def slot_occupancy(self) -> float:
        """Mean fraction of decode slot capacity that emitted a token
        during the last :meth:`serve`."""
        return (self.active_slot_steps / self.slot_steps
                if self.slot_steps else 0.0)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _bucket(self, n: int) -> int:
        for b in self.ecfg.seq_buckets:
            if n <= b:
                return b
        return self.ecfg.seq_buckets[-1]

    def validate_request(self, r: Request) -> None:
        """Raise :class:`RequestError` for a malformed request: an empty,
        non-1-D or non-integer prompt, a negative ``max_new_tokens`` (0 is
        prefill-only) or ``deadline_s``, a prompt longer than the largest bucket with
        ``allow_truncation=False``, or stop tokens that are not
        non-negative ints."""
        p = np.asarray(r.prompt)
        if p.ndim != 1 or p.size == 0:
            raise RequestError(
                r.uid, f"prompt must be a non-empty 1-D token array "
                f"(got shape {p.shape})")
        if not np.issubdtype(p.dtype, np.integer):
            raise RequestError(
                r.uid, f"prompt dtype {p.dtype} is not an integer type")
        if r.max_new_tokens < 0:
            raise RequestError(
                r.uid, f"max_new_tokens={r.max_new_tokens} is negative "
                "(0 means prefill-only)")
        if r.deadline_s < 0:
            raise RequestError(r.uid, f"deadline_s={r.deadline_s} is "
                               "negative (0 means no deadline)")
        top = max(self.ecfg.seq_buckets)
        if p.size > top and not r.allow_truncation:
            raise RequestError(
                r.uid, f"prompt of {p.size} tokens exceeds the largest "
                f"bucket ({top}) and allow_truncation=False")
        try:
            bad = [t for t in r.sampling.stop_tokens
                   if not (isinstance(t, (int, np.integer))
                           and not isinstance(t, bool) and int(t) >= 0)]
        except TypeError:
            raise RequestError(
                r.uid, f"stop_tokens {r.sampling.stop_tokens!r} is not "
                "iterable") from None
        if bad:
            raise RequestError(
                r.uid, f"malformed stop_tokens {r.sampling.stop_tokens!r}: "
                "entries must be non-negative integers")

    def _validate_all(self, requests: List[Request]) -> List[Request]:
        """Malformed requests finish ``rejected`` (empty output, the error
        attached); the rest are returned for scheduling."""
        live = []
        for r in requests:
            try:
                self.validate_request(r)
            except RequestError as e:
                r.error = e
                r.finish_reason = "rejected"
                r.state = "failed"
                r.output_tokens = np.zeros((0,), np.int32)
                logger.warning("rejected: %s", e)
            else:
                live.append(r)
        return live

    def serve(self, requests: List[Request], *, seed: int = 0,
              handle=None, faults=None) -> List[Request]:
        """Serve ``requests``: batch-at-a-time per bucket, through one
        slot scheduler per bucket (``scheduler=True``), or through one
        paged scheduler for all buckets (``paged=True``).  ``handle`` (a
        :class:`~repro_torch.serving.scheduler.SchedulerHandle`) cancels
        requests at the scheduler's next step; ``faults`` (a
        :class:`~repro_torch.serving.faults.FaultInjector`, re-armed here)
        injects faults; the batch path ignores both."""
        t0 = tracing.now()
        self._reset_counters(handle, faults)
        if faults is not None:
            faults.reset()
        with tracing.span("serve"):
            self._serve(self._validate_all(requests), seed, t0)
        return requests

    def _serve(self, live: List[Request], seed: int, t0: float) -> None:
        use_sched = ((self.ecfg.scheduler or self.ecfg.paged)
                     and self._supports_scheduler())
        if self.ecfg.paged and use_sched:
            if live:
                seq = max(self._bucket(len(r.prompt)) for r in live)
                SlotScheduler(self, live, seq, seed=seed, t0=t0,
                              paged=True).run()
            return
        groups: Dict[int, List[Request]] = {}
        for r in live:
            groups.setdefault(self._bucket(len(r.prompt)), []).append(r)
        for seq, grp in groups.items():
            if use_sched:
                SlotScheduler(self, grp, seq, seed=seed, t0=t0).run()
                continue
            for i in range(0, len(grp), self.ecfg.max_batch):
                self._serve_batch(grp[i: i + self.ecfg.max_batch], seq,
                                  seed, t0=t0)

    def _transformer_family(self) -> bool:
        """Whether the model's prefill takes ``attn_width`` and
        ``prompt_lens`` and its decode the prompt lengths (the reference's
        gate); the ssm, hybrid and encdec families take neither."""
        return self.model.cfg.family in TRANSFORMER_FAMILIES

    def _supports_scheduler(self) -> bool:
        """Per-slot decode needs the GQA cache (per-row writes and
        validity); MLA latent caches and the plain families keep the batch
        path (``scheduler``, ``paged``, chunked admission and prefix
        sharing fall to it), as in the reference."""
        return self._transformer_family() and not self.model.cfg.mla.enabled

    _supports_sparse_decode = _supports_scheduler

    @staticmethod
    def grow_cache(cache, old_len: int, extra: int):
        """Grow the cache by ``extra`` zero slots on the sequence axis (one
        copy per batch), walking the whole tree (dicts, lists, tuples) to
        every tensor leaf as the reference's ``jax.tree.map`` does: the
        stacked ``(L, B, Hkv, S, hd)`` K/V, MLA's latent dict, Whisper's
        ``((k, v), (enc_k, enc_v))``, the hybrid's ``((conv, h), (conv, h),
        (k, v))`` and trailing states.  Every non-trailing axis whose size
        equals ``old_len`` grows (``cache_ops.grow_leaf``), as in the
        reference: a recurrent state has no sequence axis and passes
        through unless one of its axes happens to equal the bucket, and so
        do a hybrid's rings and Whisper's encoder K/V unless the window or
        the frame count equals it (then they grow, in both packages)."""
        def walk(node):
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(walk(v) for v in node)
            return cache_ops.grow_leaf(node, old_len, extra)
        return walk(cache)

    @staticmethod
    def cache_insert(cache, new, slot: int):
        """Write one freshly prefilled request's cache (batch axis of size
        1: ``(L, 1, Hkv, S, hd)`` K/V, or MLA's latent dict, batch axis 0
        for prefix leaves and 1 for stacked ones) into row ``slot`` of the
        running cache, at sequence offset 0 and in place.  The slot's
        decode tail keeps what the previous occupant wrote; validity masks
        it."""
        def ins(dst, src, axis):
            for d, x in zip(dst, src):
                cache_ops.write_slot(d, x, {axis: slot})
        if isinstance(cache, dict):
            for c, n in zip(cache["prefix"], new["prefix"]):
                ins(c, n, 0)
            ins(cache["stack"], new["stack"], 1)
        else:
            ins(cache, new, 1)
        return cache

    @staticmethod
    def cache_insert_layer(cache, layer: int, slot: int, k, v, *,
                           offset: int = 0, length: Optional[int] = None):
        """Write ONE layer's prefill K/V (``(1, Hkv, S, hd)`` each) into
        row ``slot`` of the running ``(L, B, Hkv, S', hd)`` cache, in place:
        the incremental insert of chunked admission, made as each layer's
        K/V becomes final while the other slots keep decoding.  A packed
        segment ``[offset, offset + length)`` is cut out first and lands at
        the start of its slot's row.  Decode validity keeps the row dark
        until its plan row is spliced."""
        if length is not None:
            k = cache_ops.slice_segment(k, offset, length, axis=2)
            v = cache_ops.slice_segment(v, offset, length, axis=2)
        for dst, src in zip(cache, (k, v)):
            cache_ops.write_slot(dst, src[None], {0: layer, 1: slot})
        return cache

    def _width_cap(self, seq: int) -> Optional[int]:
        """The prefill width cap W of a bucket: ``prefill_width`` under
        ``width_policy="off"``; otherwise uncapped until the bucket's first
        prefill was observed, then resolved once and frozen (a cap of NB or
        more resolves to None, uncapped).  None for the plain families."""
        if not self._transformer_family():
            return None
        if self.ecfg.width_policy not in ("auto", "count"):
            return self.ecfg.prefill_width
        if seq in self._width_frozen:
            return self._width_frozen[seq]
        obs = (self._density_obs if self.ecfg.width_policy == "auto"
               else self._pop_obs).get(seq)
        if not obs:
            return None
        nb = max(seq // max(self.sp.cfg.block_size, 1), 1)
        if self.ecfg.width_policy == "auto":
            w = auto_width_cap(obs, nb,
                               percentile=self.ecfg.width_percentile,
                               safety=self.ecfg.width_safety)
        else:
            # each observation is one prefill's largest row: cover it
            w = population_width_cap(obs, nb, safety=self.ecfg.width_safety)
        self._width_frozen[seq] = None if w >= nb else w
        return self._width_frozen[seq]

    def _chunk_tokens(self, seq: int) -> int:
        """Tokens per prefill quantum for a bucket; 0 means one-shot
        admission.  Chunked admission needs a model it can serve
        (``Model.prefill_chunk``), a chunk-capable attention (the batched
        sparse path or the dense ``chunked`` one: the per-sample
        ``kernel``/``ref`` paths have no rectangular launch), a
        block-aligned bucket and a single-device serve (chunk launches take
        no mesh); the chunk is rounded up to whole blocks and capped at the
        bucket."""
        c = self.ecfg.prefill_chunk
        if c <= 0 or not self._supports_scheduler():
            return 0
        if not self.model.prefill_chunk:
            return 0
        if resolved_attn_impl(self.ecfg.attn_impl) not in ROW_ATTN_IMPLS:
            return 0
        if active_model_mesh() is not None:
            return 0
        bs = prefill_block_size(self.sp, seq)
        if seq % bs:
            return 0
        c = max(((c + bs - 1) // bs) * bs, bs)
        return min(c, seq)

    def _pad_prompt(self, r: Request, seq: int, row: np.ndarray) -> int:
        """Left-align one prompt into ``row``; flag and warn on clipping.
        Returns the row's valid prompt length."""
        prompt = np.asarray(r.prompt)
        if len(prompt) > seq:
            r.truncated = True
            logger.warning(
                "request %s: prompt of %d tokens exceeds the largest "
                "bucket (%d); clipping to the last %d tokens",
                r.uid, len(prompt), seq, seq)
        p = prompt[-seq:]
        row[: len(p)] = p
        return len(p)

    def _sample_batch(self, gen: torch.Generator, logits: torch.Tensor,
                      grp: List[Request]) -> np.ndarray:
        """One token per request under each request's own SamplingConfig
        (rows sharing a config are sampled together)."""
        by_cfg: Dict[SamplingConfig, List[int]] = {}
        for i, r in enumerate(grp):
            by_cfg.setdefault(r.sampling, []).append(i)
        toks = np.zeros((len(grp),), np.int64)
        with tracing.span("sample"):
            for scfg, rows in sorted(by_cfg.items(),
                                     key=lambda kv: kv[1][0]):
                t = sample_token(logits[rows], scfg, gen)
                toks[rows] = t.cpu().numpy()
        return toks

    def _record_prefill_stats(self, result, width: Optional[int],
                              seq: int) -> Dict[str, float]:
        """Pattern stats of one prefill (both serving paths), and the
        width-policy observation it feeds for bucket ``seq``."""
        st = result.stats
        stats = {"num_shared": float(st.num_shared),
                 "num_dense": float(st.num_dense),
                 "num_vs": float(st.num_vs),
                 "block_density": float(st.block_density),
                 "max_row_pop": float(st.max_row_pop),
                 "prefill_width_cap": 0 if width is None else int(width)}
        if self.ecfg.width_policy == "auto":
            self._density_obs.setdefault(seq, []).append(
                stats["block_density"])
        elif self.ecfg.width_policy == "count":
            self._pop_obs.setdefault(seq, []).append(stats["max_row_pop"])
        return stats

    def _replay_prefill_stats(self, stats: Dict[str, float],
                              seq: int) -> Dict[str, float]:
        """A prefix hit's stats: the donor's, whose width-policy observation
        is fed again, since the hit's cold prefill would have made exactly
        it (so later caps, and masks, follow the serve without sharing)."""
        stats = dict(stats)
        if self.ecfg.width_policy == "auto":
            self._density_obs.setdefault(seq, []).append(
                stats["block_density"])
        elif self.ecfg.width_policy == "count":
            self._pop_obs.setdefault(seq, []).append(stats["max_row_pop"])
        return stats

    @staticmethod
    def _plan_stats(plan, cache_len: int) -> Dict[str, float]:
        """Modeled sparse-decode traffic counters of a built DecodePlan."""
        total, streamed = dplan.plan_block_counts(plan)
        return {"decode_traffic_fraction": dplan.plan_traffic_fraction(plan),
                "decode_blocks_total": float(total),
                "decode_blocks_computed": float(streamed),
                "decode_blocks_skipped": float(total - streamed),
                "decode_cache_len": float(cache_len)}

    @staticmethod
    def _decode_rate(n_tokens: int, decode_s: float) -> float:
        return ((n_tokens - 1) / decode_s
                if n_tokens > 1 and decode_s > 0 else 0.0)

    def _serve_batch(self, grp: List[Request], seq: int, seed: int,
                     t0: Optional[float] = None) -> None:
        with tracing.span("batch"):
            self._run_batch(grp, seq, seed, t0)

    def _run_batch(self, grp: List[Request], seq: int, seed: int,
                   t0: Optional[float]) -> None:
        t0 = tracing.now() if t0 is None else t0
        b = len(grp)
        toks = np.zeros((b, seq), np.int64)
        plens_l = [self._pad_prompt(r, seq, toks[i])
                   for i, r in enumerate(grp)]
        plens = torch.tensor(plens_l, dtype=torch.int64, device=self.device)
        width = self._width_cap(seq)

        tp = tracing.now()
        for r in grp:
            r.queue_s = max(tp - (t0 + r.arrival_s), 0.0)
            r.prefill_positions += seq
        ragged = (dict(attn_width=width, prompt_lens=plens)
                  if self._transformer_family() else {})
        result = self.model.prefill(
            self.params, torch.as_tensor(toks, device=self.device), self.sp,
            method=self.ecfg.method, attn_impl=self.ecfg.attn_impl, **ragged)
        self._sync()
        prefill_s = tracing.now() - tp
        stats = self._record_prefill_stats(result, width, seq)

        max_new = max(r.max_new_tokens for r in grp)
        extra = max(max_new, self.ecfg.decode_extra)
        # decode headroom stays a block multiple so the plan's tables tile
        # the grown cache exactly
        blk = max(self.sp.cfg.block_size, 1)
        extra = ((extra + blk - 1) // blk) * blk
        cache = self.grow_cache(result.cache, seq, extra)

        use_sparse = (self.ecfg.decode_sparse and self.ecfg.method == "share"
                      and result.sp_state is not None
                      and self._supports_sparse_decode())
        plan = None
        if use_sparse:
            # built ONCE for the batch; every decode step reuses it
            plan = dplan.build_decode_plan(
                self.sp, result.sp_state, self.model.cfg, prefill_len=seq,
                cache_len=seq + extra)
            stats.update(self._plan_stats(plan, seq + extra))

        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        logits = result.last_logits
        outs: List[List[int]] = [[] for _ in range(b)]
        done = [False] * b
        t1 = tracing.now()
        finish = [t1] * b
        for i, r in enumerate(grp):
            if r.max_new_tokens <= 0:   # prefill-only: no token is emitted
                done[i], r.finish_reason = True, "length"
        for t in range(max_new):
            tok = self._sample_batch(gen, logits, grp)
            now = tracing.now()
            if t == 0:
                for r in grp:
                    if r.max_new_tokens > 0:
                        r.ttft_s = max(now - (t0 + r.arrival_s), 0.0)
            for i, r in enumerate(grp):
                if done[i]:
                    continue                 # inert row: sampled, discarded
                outs[i].append(int(tok[i]))
                if r.sampling.is_stop(int(tok[i])):
                    done[i], r.finish_reason = True, "stop"
                elif len(outs[i]) >= r.max_new_tokens:
                    done[i], r.finish_reason = True, "length"
                if done[i]:
                    finish[i] = now
            if all(done):
                break
            # a lockstep step burns max_batch slot-steps of capacity
            self.slot_steps += self.ecfg.max_batch
            self.active_slot_steps += b - sum(done)
            tok_t = torch.as_tensor(tok, device=self.device)[:, None]
            lens = (dict(plan=plan, prompt_lens=plens, prefill_len=seq,
                         decode_impl=self.ecfg.decode_impl)
                    if self._transformer_family() else {})
            logits, cache = self.model.decode(self.params, tok_t, cache,
                                              seq + t, **lens)

        for i, r in enumerate(grp):
            r.output_tokens = np.asarray(outs[i], np.int32)
            r.prefill_s = prefill_s
            r.decode_s = max(finish[i] - t1, 0.0)
            r.decode_tokens_per_s = self._decode_rate(len(outs[i]),
                                                      r.decode_s)
            r.pattern_stats = stats
            r.state = "done"

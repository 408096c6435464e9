"""Serving engine, batch-at-a-time path (port of the ``scheduler=False``
path of ``repro/serving/engine.py``).

Requests are grouped by sequence bucket and served ``max_batch`` at a time:
prompts are left-aligned and right-padded to the bucket, the padded batch is
prefilled once (SharePrefill sparse prefill with ``method="share"``), and the
batch then decodes in lockstep until every row has its tokens or a stop
token.  Per-request prompt lengths are threaded into prefill (each row's
first token comes from its own last prompt token) and into every decode step
as slot validity (right-pad K/V is never attended).

With ``decode_sparse=True`` the prefill pattern dictionaries are compiled
into a :class:`~repro_torch.kernels.decode_attn.DecodePlan` once per batch,
over the grown cache (``seq + extra``; the headroom is a block multiple so
the tables tile it), and every decode step streams only the plan's blocks.

The slot scheduler, the paged cache, chunked prefill, prefix sharing, plan
refresh and the ``auto``/``count`` width policies are not ported yet; asking
for them raises ``NotImplementedError`` naming the ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.api import SharePrefill
from repro_torch.models.api import Model
from repro_torch.serving import decode_plan as dplan
from repro_torch.serving.sampling import SamplingConfig, sample_token

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # (prompt_len,) int
    max_new_tokens: int = 16
    sampling: SamplingConfig = dataclasses.field(
        default_factory=SamplingConfig)
    arrival_s: float = 0.0              # arrival offset from serve() start
    # filled by the engine:
    output_tokens: Optional[np.ndarray] = None
    prefill_s: float = 0.0              # the batch's prefill wall time
    decode_s: float = 0.0               # first token → this row's last token
    queue_s: float = 0.0                # arrival → prefill start
    ttft_s: float = 0.0                 # arrival → first token
    decode_tokens_per_s: float = 0.0    # (n_tokens − 1) / decode_s
    truncated: bool = False             # prompt clipped to the largest bucket
    finish_reason: str = ""             # "stop" | "length"
    state: str = "waiting"              # waiting | done
    pattern_stats: Optional[Dict[str, float]] = None

    def metrics(self) -> Dict[str, float]:
        return {"queue_s": self.queue_s, "ttft_s": self.ttft_s,
                "prefill_s": self.prefill_s, "decode_s": self.decode_s,
                "decode_tokens_per_s": self.decode_tokens_per_s}


# EngineConfig fields of the reference that are not ported yet: a value
# other than the default raises, naming the ROADMAP.md item that ports it
_NOT_PORTED = {
    "scheduler": (False, "A.7 (slot scheduler)"),
    "paged": (False, "A.7 (paged cache)"),
    "prefill_chunk": (0, "A.8 (chunked prefill)"),
    "prefill_pack": (1, "A.8 (prefill packing)"),
    "prefix_sharing": (False, "A.9 (prefix sharing)"),
    "refresh_every": (0, "A.9 (pattern refresh)"),
    "width_policy": ("off", "A.5 (width policies)"),
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 8
    method: str = "share"               # prefill pattern policy
    attn_impl: str = "auto"             # auto | sparse: the sparse kernels
    seq_buckets: tuple = (512, 2048, 8192, 32768)
    decode_extra: int = 128             # decode headroom beyond the prompt
    decode_sparse: bool = False         # decode through a DecodePlan
    decode_impl: str = "auto"           # auto | kernel | einsum
    prefill_width: Optional[int] = None  # static per-row block budget W
    width_policy: str = "off"
    scheduler: bool = False
    paged: bool = False
    prefill_chunk: int = 0
    prefill_pack: int = 1
    prefix_sharing: bool = False
    refresh_every: int = 0

    def __post_init__(self):
        for name, (default, item) in _NOT_PORTED.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"EngineConfig.{name}={getattr(self, name)!r}: not ported "
                    f"yet (ROADMAP.md queue {item})")


class ServingEngine:
    """Serves requests through ``model`` on ``model.device``."""

    def __init__(self, model: Model, params, sp: SharePrefill,
                 ecfg: EngineConfig = EngineConfig()):
        self.model = model
        self.params = params
        self.sp = sp
        self.ecfg = ecfg
        self.device = model.device

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _bucket(self, n: int) -> int:
        for b in self.ecfg.seq_buckets:
            if n <= b:
                return b
        return self.ecfg.seq_buckets[-1]

    def serve(self, requests: List[Request], *,
              seed: int = 0) -> List[Request]:
        """Serve ``requests`` grouped by bucket, ``max_batch`` at a time."""
        t0 = time.time()
        groups: Dict[int, List[Request]] = {}
        for r in requests:
            groups.setdefault(self._bucket(len(r.prompt)), []).append(r)
        for seq, grp in groups.items():
            for i in range(0, len(grp), self.ecfg.max_batch):
                self._serve_batch(grp[i: i + self.ecfg.max_batch], seq,
                                  seed, t0=t0)
        return requests

    @staticmethod
    def grow_cache(cache, old_len: int, extra: int):
        """Grow the stacked ``(L, B, Hkv, S, hd)`` K/V by ``extra`` zero
        slots on the sequence axis (one copy per batch)."""
        def grow(x):
            out = x.new_zeros(x.shape[:3] + (old_len + extra,) + x.shape[4:])
            out[:, :, :, :old_len] = x
            return out
        return tuple(grow(x) for x in cache)

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
        for scfg, rows in sorted(by_cfg.items(), key=lambda kv: kv[1][0]):
            t = sample_token(logits[rows], scfg, gen)
            toks[rows] = t.cpu().numpy()
        return toks

    @staticmethod
    def _decode_rate(n_tokens: int, decode_s: float) -> float:
        return ((n_tokens - 1) / decode_s
                if n_tokens > 1 and decode_s > 0 else 0.0)

    def _serve_batch(self, grp: List[Request], seq: int, seed: int,
                     t0: Optional[float] = None) -> None:
        t0 = time.time() if t0 is None else t0
        b = len(grp)
        toks = np.zeros((b, seq), np.int64)
        plens_l = [self._pad_prompt(r, seq, toks[i])
                   for i, r in enumerate(grp)]
        plens = torch.tensor(plens_l, dtype=torch.int64, device=self.device)
        width = self.ecfg.prefill_width

        tp = time.time()
        for r in grp:
            r.queue_s = max(tp - (t0 + r.arrival_s), 0.0)
        result = self.model.prefill(
            self.params, torch.as_tensor(toks, device=self.device), self.sp,
            method=self.ecfg.method, attn_impl=self.ecfg.attn_impl,
            attn_width=width, prompt_lens=plens)
        self._sync()
        prefill_s = time.time() - tp

        st = result.stats
        stats = {"num_shared": float(st.num_shared),
                 "num_dense": float(st.num_dense),
                 "num_vs": float(st.num_vs),
                 "block_density": float(st.block_density),
                 "max_row_pop": float(st.max_row_pop),
                 "prefill_width_cap": 0 if width is None else int(width)}

        max_new = max(r.max_new_tokens for r in grp)
        extra = max(max_new, self.ecfg.decode_extra)
        # decode headroom stays a block multiple so the plan's tables tile
        # the grown cache exactly
        blk = max(self.sp.cfg.block_size, 1)
        extra = ((extra + blk - 1) // blk) * blk
        cache = self.grow_cache(result.cache, seq, extra)

        use_sparse = (self.ecfg.decode_sparse and self.ecfg.method == "share"
                      and result.sp_state is not None)
        plan = None
        if use_sparse:
            # built ONCE for the batch; every decode step reuses it
            plan = dplan.build_decode_plan(
                self.sp, result.sp_state, self.model.cfg, prefill_len=seq,
                cache_len=seq + extra)
            total, streamed = dplan.plan_block_counts(plan)
            stats.update({
                "decode_traffic_fraction": dplan.plan_traffic_fraction(plan),
                "decode_blocks_total": float(total),
                "decode_blocks_computed": float(streamed),
                "decode_blocks_skipped": float(total - streamed),
                "decode_cache_len": float(seq + extra)})

        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        logits = result.last_logits
        outs: List[List[int]] = [[] for _ in range(b)]
        done = [False] * b
        t1 = time.time()
        finish = [t1] * b
        for i, r in enumerate(grp):
            if r.max_new_tokens <= 0:   # prefill-only: no token is emitted
                done[i], r.finish_reason = True, "length"
        for t in range(max_new):
            tok = self._sample_batch(gen, logits, grp)
            now = time.time()
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
            tok_t = torch.as_tensor(tok, device=self.device)[:, None]
            logits, cache = self.model.decode(
                self.params, tok_t, cache, seq + t, plan=plan,
                prompt_lens=plens, prefill_len=seq,
                decode_impl=self.ecfg.decode_impl)

        for i, r in enumerate(grp):
            r.output_tokens = np.asarray(outs[i], np.int32)
            r.prefill_s = prefill_s
            r.decode_s = max(finish[i] - t1, 0.0)
            r.decode_tokens_per_s = self._decode_rate(len(outs[i]),
                                                      r.decode_s)
            r.pattern_stats = stats
            r.state = "done"

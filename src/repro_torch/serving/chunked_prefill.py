"""One chunked (optionally packed) admission, advanced a quantum at a
time (port of ``repro/serving/chunked_prefill.py``).

:class:`ChunkedPrefillRun` holds what the scheduler needs to advance an
in-flight admission one quantum at a time: the padded (packed) token row,
per-segment positions and prompt lengths, the pattern-sharing state carried
from layer to layer, and a phase machine over the quanta

    begin → [layer_begin → chunk × C → layer_end] × L → finish

(the quanta are :mod:`repro_torch.models.chunked_prefill`'s functions,
called with the engine's method and attention and the run's width).  Each
:meth:`step` runs exactly ONE quantum and synchronises the device once, so
the scheduler's loop (one quantum, then one decode step) bounds how long
an admission stalls the occupied slots.

Two events reach the caller:

``"kv"``   a layer's K/V just became final (``kv_layer``, ``kv``): the
           scheduler writes it into the admitted slot(s) at once, segment
           by segment, while decode goes on between quanta;
``"done"`` the last quantum ran: ``logits`` holds each segment's
           last-token logits ``(P, V)``, ``sp_state`` the dictionary after
           prefill, ``attn_stats`` the pattern stats reduced over layers.

Packing (P > 1) concatenates same-bucket prompts into one ``(1, P·seq)``
row: positions restart per segment, a block-diagonal segment mask isolates
attention, and each segment's K/V slice lands in its own slot.  The pattern
dictionary is shared across the packed row: the trade-off that keeps
packing opt-in.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import chunked_prefill as cp
from repro_torch.models.attention import AttnStats, prefill_block_size


class ChunkedPrefillRun:
    """One in-flight chunked admission (a packed group of 1+ requests)."""

    def __init__(self, eng, requests: List, slot_ids: List[int], seq: int,
                 chunk_tokens: int, width: Optional[int]):
        self.eng = eng
        self.requests = requests
        self.slot_ids = slot_ids
        self.seq = seq
        self.width = width
        self.P = len(requests)
        total = self.P * seq
        self.total = total

        sp = eng.sp
        bs = prefill_block_size(sp, total)
        if total % bs:
            raise ValueError(f"bucket {seq} (packed total {total}) does not "
                             f"tile block size {bs}")
        self.bs = bs
        self.nb = total // bs
        # a packed run carries the segment isolation mask; a solo run has
        # exactly the one-shot mask geometry
        self.seg_blocks = seq // bs if self.P > 1 else None
        cnb = max(chunk_tokens // bs, 1)
        self.chunks: List[Tuple[int, int]] = [
            (o, min(cnb, self.nb - o)) for o in range(0, self.nb, cnb)]

        dev = eng.device
        toks = np.zeros((1, total), np.int64)
        self.plens = [eng._pad_prompt(r, seq, toks[0, j * seq:(j + 1) * seq])
                      for j, r in enumerate(requests)]
        self.tokens = torch.as_tensor(toks, device=dev)
        # positions restart per segment: each packed prompt is roped as if
        # it were alone at the start of its own slot
        self.positions = torch.arange(seq, device=dev).repeat(self.P)[None]

        applicable = sp.cfg.enabled and sp.applicable(total)
        self.sp_state = (sp.init_state(1, total, device=dev) if applicable
                         else None)
        self.cluster_arr = (sp.layer_cluster_ids(device=dev) if applicable
                            else None)
        self.cfg = eng.model.cfg
        self.num_layers = self.cfg.num_layers

        self.x = None
        self.layer = 0
        self._phase = "begin"
        self._chunk_i = 0
        self._stage = None
        self._outs: List[torch.Tensor] = []
        self._ats: List[torch.Tensor] = []
        self._layer_stats: List[AttnStats] = []
        self.kv = None              # (k, v) of the layer just finalised
        self.kv_layer = -1
        self.logits = None          # (P, V) after the finish quantum
        self.attn_stats: Optional[AttnStats] = None
        self.quanta_done = 0
        self.quanta_total = 2 + self.num_layers * (2 + len(self.chunks))

    @property
    def done(self) -> bool:
        return self._phase == "done"

    def abort(self) -> None:
        """Abandon the run between quanta: drop every device reference so
        its working set is freed at once.  Terminal (a later :meth:`step`
        raises); the scheduler releases the run's pages and slots itself,
        and K/V already inserted stays dark (the slots were never
        occupied, so validity masks the rows)."""
        self.x = self._stage = self.kv = self.logits = None
        self._outs, self._ats, self._layer_stats = [], [], []
        self.sp_state = None
        self._phase = "done"

    def step(self) -> Optional[str]:
        """Run ONE quantum to completion (the device synchronised after
        it).  Returns ``"kv"`` when a layer's K/V is ready to insert,
        ``"done"`` after the last quantum, else ``None``."""
        eng, cfg = self.eng, self.cfg
        params, sp, impl = eng.params, eng.sp, eng.ecfg.attn_impl
        ev = None
        if self._phase == "begin":
            self.x = cp.chunk_prefill_begin(params, cfg, self.tokens)
            self._phase = "layer_begin"

        elif self._phase == "layer_begin":
            self._stage = cp.chunk_prefill_layer_begin(
                params, cfg, self.layer, self.x, self.positions, sp,
                self.sp_state, self.cluster_arr, method=eng.ecfg.method,
                attn_impl=impl, seg_blocks=self.seg_blocks)
            self._outs, self._ats = [], []
            self._chunk_i = 0
            self._phase = "chunk"

        elif self._phase == "chunk":
            cs, cb = self.chunks[self._chunk_i]
            out, at = cp.chunk_prefill_attn(
                sp, self._stage, attn_impl=impl, attn_width=self.width,
                chunk_start=cs, chunk_blocks=cb)
            self._outs.append(out)
            if at is not None:
                self._ats.append(at)
            self._chunk_i += 1
            if self._chunk_i == len(self.chunks):
                self._phase = "layer_end"

        elif self._phase == "layer_end":
            cat = lambda xs: torch.cat(xs, dim=2) if len(xs) > 1 else xs[0]
            self.x, self.kv, self.sp_state, stats = cp.chunk_prefill_layer_end(
                params, cfg, self.layer, self.x, self._stage, cat(self._outs),
                cat(self._ats) if self._ats else None, sp, self.sp_state,
                self.cluster_arr)
            self._layer_stats.append(stats)
            self.kv_layer = self.layer
            self._stage = None
            self._outs, self._ats = [], []
            self.layer += 1
            self._phase = ("finish" if self.layer == self.num_layers
                           else "layer_begin")
            ev = "kv"

        elif self._phase == "finish":
            dev = self.eng.device
            rows = torch.tensor(
                [j * self.seq + max(min(p, self.seq), 1) - 1
                 for j, p in enumerate(self.plens)], device=dev)
            bidx = torch.zeros((self.P,), dtype=torch.long, device=dev)
            self.logits = cp.chunk_prefill_finish(params, cfg, self.x, bidx,
                                                  rows)
            self.attn_stats = AttnStats.reduce_layers(self._layer_stats)
            self.x = None
            self._phase = "done"
            ev = "done"

        else:
            raise RuntimeError("step() on a completed ChunkedPrefillRun")
        self.eng._sync()
        self.quanta_done += 1
        return ev

"""Deterministic fault injection for the serving stack (port of
``repro/serving/faults.py``; the chaos harness).

A :class:`FaultInjector` carries a list of declarative fault *specs* and is
handed to ``ServingEngine.serve(faults=...)``; the slot scheduler calls
back into it at fixed points of its step loop, so every injection lands at
a deterministic (uid, step) coordinate and a run with the same specs
replays the same faults:

* :class:`NaNLogits` — poison one request's decode logits (the per-row
  isfinite guard must quarantine exactly that slot, ``finish_reason
  "failed"``, every other slot bitwise-unaffected).
* :class:`PrefillError` — raise a typed :class:`RequestError` inside the
  request's admission prefill (one-shot launch or chunked quantum); the
  try/except isolation must fail only the admitting request(s).
* :class:`CancelAt` — a mid-decode cancellation by uid at a scheduler
  step, exercising the same path as :class:`SchedulerHandle.cancel`.
* :class:`HoldPages` — allocator exhaustion: take pages out of circulation
  for a step window (``PageAllocator.hold``), forcing admission deferrals
  and — with ``EngineConfig.preempt_after_steps`` — preemption.
* :class:`SlowQuantum` — a slow/stuck prefill quantum: sleep before each
  quantum of any run admitting the uid, so deadlines can expire an
  admission between quanta.

One-shot semantics: specs that corrupt or raise fire at most once per
serve; :meth:`reset` (called by ``serve()``) re-arms everything, so a
benchmark's repeat loop replays identical fault schedules.  The scheduler
releases any still-held pages at the end of the serve
(:meth:`release_pages`), so injected exhaustion can never leak pool pages.
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, Iterable

import numpy as np

from repro_torch.serving.errors import RequestError


@dataclasses.dataclass(frozen=True)
class NaNLogits:
    """Poison ``uid``'s decode logits at generated-token index
    ``at_token`` (token 0 comes from prefill, so ``at_token >= 1`` targets
    a decode step).  Fires once."""
    uid: int
    at_token: int = 1


@dataclasses.dataclass(frozen=True)
class PrefillError:
    """Raise a ``RequestError(kind="prefill")`` inside ``uid``'s admission
    prefill (before the launch / the next quantum).  Fires once."""
    uid: int
    message: str = "injected prefill fault"


@dataclasses.dataclass(frozen=True)
class CancelAt:
    """Cancel ``uid`` once the scheduler reaches ``step`` (1-based step
    counter) — WAITING, mid-chunked-prefill, or DECODE alike."""
    uid: int
    step: int = 1


@dataclasses.dataclass(frozen=True)
class HoldPages:
    """Hold up to ``pages`` pool pages for steps
    ``[from_step, until_step)`` — injected allocator exhaustion.  Ignored
    on non-paged schedulers."""
    pages: int
    from_step: int = 1
    until_step: int = 10 ** 9


@dataclasses.dataclass(frozen=True)
class SlowQuantum:
    """Sleep ``delay_s`` before every prefill quantum of a chunked run
    that admits ``uid`` — a slow/stuck prefill the deadline reaper can
    expire between quanta."""
    uid: int
    delay_s: float = 0.01


class FaultInjector:
    """Deterministic fault schedule, consumed by the slot scheduler."""

    def __init__(self, *specs):
        self.specs = list(specs)
        self.reset()

    def reset(self) -> None:
        """Re-arm every spec (``serve()`` calls this so repeat runs replay
        the identical fault schedule)."""
        self._fired: set = set()
        self._cancelled: set = set()
        self._held: dict = {}           # spec index → held page ids

    # -- step hooks ------------------------------------------------------
    def on_step(self, step: int, alloc=None) -> None:
        """Called once per scheduler step, before reaping: applies due
        cancellations and opens/closes injected page-exhaustion windows."""
        for si, sp in enumerate(self.specs):
            if isinstance(sp, CancelAt):
                if step >= sp.step:
                    self._cancelled.add(sp.uid)
            elif isinstance(sp, HoldPages) and alloc is not None:
                held = self._held.get(si)
                if held is None and sp.from_step <= step < sp.until_step:
                    self._held[si] = alloc.hold(sp.pages)
                elif held is not None and step >= sp.until_step:
                    alloc.free(held)
                    self._held[si] = None
                    self._fired.add(("held", si))

    def cancelled(self) -> FrozenSet[int]:
        """uids whose injected cancellation is due (reaped like
        :meth:`SchedulerHandle.cancel`)."""
        return frozenset(self._cancelled)

    # -- prefill hooks ---------------------------------------------------
    def check_prefill(self, uids: Iterable[int]) -> None:
        """Raise the pending :class:`PrefillError` if any of ``uids`` is
        targeted (the scheduler's try/except quarantine catches it)."""
        for sp in self.specs:
            if (isinstance(sp, PrefillError) and sp.uid in uids
                    and ("prefill", sp.uid) not in self._fired):
                self._fired.add(("prefill", sp.uid))
                raise RequestError(sp.uid, sp.message, kind="prefill")

    def quantum_delay(self, uids: Iterable[int]) -> float:
        """Injected sleep before a chunked run's next quantum."""
        uids = set(uids)
        return sum(sp.delay_s for sp in self.specs
                   if isinstance(sp, SlowQuantum) and sp.uid in uids)

    # -- decode hooks ----------------------------------------------------
    def corrupt_logits(self, uid: int, token_index: int,
                       row: np.ndarray) -> np.ndarray:
        """Return ``uid``'s decode-logits row, poisoned if a
        :class:`NaNLogits` spec is due at this generated-token index."""
        for sp in self.specs:
            if (isinstance(sp, NaNLogits) and sp.uid == uid
                    and token_index >= sp.at_token
                    and ("nan", sp.uid) not in self._fired):
                self._fired.add(("nan", sp.uid))
                row = np.array(row, np.float32)
                row[...] = np.nan
                return row
        return row

    # -- cleanup ---------------------------------------------------------
    def release_pages(self, alloc) -> None:
        """Return every still-held page to the pool (the scheduler calls
        this at the end of the serve — injected exhaustion never leaks)."""
        for si, ids in list(self._held.items()):
            if ids is not None and len(ids):
                alloc.free(ids)
        self._held.clear()

    def held_pages(self) -> int:
        return sum(len(ids) for ids in self._held.values()
                   if ids is not None)


__all__ = ["FaultInjector", "NaNLogits", "PrefillError", "CancelAt",
           "HoldPages", "SlowQuantum"]

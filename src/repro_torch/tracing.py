"""The port's spans and its one host clock.

A span is a ``torch.profiler.record_function`` range named
``repro_torch.<name>`` at a layer boundary of serving or of the model step
(``serve``, ``sched.decode_step``, ``model.prefill``, ``share.masks``,
``moe.experts``, …).  Spans are off by default: :func:`span` then returns
one shared no-op context after a single flag check.  An operator turns
them on around a profiler session::

    from repro_torch import tracing
    tracing.enable()
    with torch.profiler.profile(activities=[CPU, CUDA]) as prof:
        engine.serve(requests)
    tracing.enable(False)

The spans write nothing of their own: the profiler holds them with its
events, and a span adds no device synchronisation and no host copy.
Nesting gives each span the span that caused it: a request's admission
(``sched.admit``) holds its ``model.prefill``, which holds each layer's
``share.masks``.  Spans carry no arguments: the profiler of torch 2.13
keeps none of ``record_function``'s, in its events or in an exported
trace.

:func:`now` is the clock of every stamp the serving engine and the
scheduler take (``Request.queue_s``, ``ttft_s``, ``prefill_s``,
``decode_s``, ``ServingEngine.phase_s``).  It reads epoch seconds, the
base of the profiler's event times (``trace_start_ns`` is epoch
nanoseconds), so a stamp and a span line up without a conversion.
"""
from __future__ import annotations

import contextlib
import time

import torch

_ON = False
_OFF = contextlib.nullcontext()


def enable(on: bool = True) -> None:
    """Turn every span on (or off, ``on=False``)."""
    global _ON
    _ON = bool(on)


def enabled() -> bool:
    return _ON


def span(name: str):
    """The range ``repro_torch.<name>`` while spans are on, else the shared
    no-op context."""
    if not _ON:
        return _OFF
    return torch.profiler.record_function("repro_torch." + name)


def now() -> float:
    """Host wall-clock seconds on the profiler's base (epoch)."""
    return time.time()

"""The port's spans (``repro_torch.tracing``) in a traced run's profile:
device time, idle time and host time by span.

A device operation (kernel, copy or fill) belongs to the innermost
``repro_torch.*`` range open on the host when the runtime call that
launched it ran (the profiler correlates the two by id).  B.1 and B.2 are
launched through ``ctypes`` with no aten op above them, so matching by
aten op would lose exactly them.  An idle stretch of the device belongs to
the innermost range open on the host over it.  The ranges are opened on
one thread, the serving loop's, so containment on the host clock is
containment on that thread.

:func:`attribute` works on plain tuples (the CPU tests build them by
hand); :func:`from_events` makes the tuples from ``torch.profiler``
events.  The profiler also gives every ``record_function`` range a
device-side twin (``gpu_user_annotation``) spanning the work launched
inside it; :func:`from_events` leaves those out of the device's
operations, as ``trace.py`` leaves out the benchmark's own ``bench.*``.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

PREFIX = "repro_torch."
NO_SPAN = "(no span)"
_RUNTIME = ("cuda_runtime", "cuda_driver")
_ANNOTATION = "gpu_user_annotation"
# a runtime or driver call by name, where the events carry no activity
# kind (torch before 2.13): cudaLaunchKernel, cuLaunchKernel, …
_API = re.compile(r"cu(da)?[A-Z]")

Op = Tuple[float, float, str, int]      # device: start, end (µs), name, id
Range = Tuple[float, float, str]        # host: start, end (µs), span name


@dataclasses.dataclass
class SpanTimes:
    """Seconds by span name.  ``device_s`` and ``idle_s`` count what lies
    under a span at any depth; ``self_device_s`` and ``self_idle_s`` what
    lies under it as the innermost span (``NO_SPAN``: under none).
    ``host_s`` holds each range's host duration; ``by_group`` the device
    seconds of each kernel group (``trace.group``) under each span, at any
    depth."""
    kernel_s: float
    device_s: Dict[str, float]
    self_device_s: Dict[str, float]
    idle_s: Dict[str, float]
    self_idle_s: Dict[str, float]
    host_s: Dict[str, List[float]]
    by_group: Dict[Tuple[str, str], float]


def _owners(ranges: Sequence[Range]):
    """The nesting of ``ranges`` (sorted by start, the longer first):
    each range's parent index, and the innermost range after each
    boundary (``bounds``, ``owner``; -1: none)."""
    parent, stack, events = [], [], []
    for i, (s, e, _) in enumerate(ranges):
        while stack and ranges[stack[-1]][1] <= s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
        events.append((s, 1, i))
        events.append((e, 0, i))
    events.sort()
    bounds, owner, open_ = [], [], []
    for t, opening, i in events:
        if opening:
            open_.append(i)
        else:
            open_.remove(i)
        if bounds and bounds[-1] == t:
            owner[-1] = open_[-1] if open_ else -1
        else:
            bounds.append(t)
            owner.append(open_[-1] if open_ else -1)
    return parent, bounds, owner


def _busy(ops: Sequence[Op]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e, _, _ in sorted(ops):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _idle(busy, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` outside ``busy``."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def attribute(ops: Sequence[Op], launches: Dict[int, float],
              ranges: Sequence[Range], group=lambda name: name,
              lo: Optional[float] = None,
              hi: Optional[float] = None) -> SpanTimes:
    """Device, idle and host seconds by span.  ``ops`` are the device's
    operations, ``launches`` the host time of the runtime call behind each
    operation's id, ``ranges`` the spans (name without the prefix); times
    in µs.  Idle is measured over ``[lo, hi]`` (default: from the first to
    the last event)."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    parent, bounds, owner = _owners(ranges)
    names = [r[2] for r in ranges]

    chains: Dict[int, Tuple[str, ...]] = {-1: ()}

    def chain(i: int) -> Tuple[str, ...]:
        """The distinct names of range ``i`` and its ancestors."""
        todo = []
        while i not in chains:
            todo.append(i)
            i = parent[i]
        for j in reversed(todo):
            up = chains[parent[j]]
            chains[j] = up if names[j] in up else up + (names[j],)
        return chains[todo[0]] if todo else chains[i]

    def innermost(t: float) -> int:
        k = bisect.bisect_right(bounds, t) - 1
        return owner[k] if k >= 0 else -1

    device: Dict[str, float] = {}
    self_device: Dict[str, float] = {}
    by_group: Dict[Tuple[str, str], float] = {}
    kernel_s = 0.0
    for s, e, name, corr in ops:
        d = (e - s) / 1e6
        kernel_s += d
        t = launches.get(corr)
        r = innermost(t) if t is not None else -1
        key = names[r] if r >= 0 else NO_SPAN
        self_device[key] = self_device.get(key, 0.0) + d
        g = group(name)
        for n in chain(r) or (NO_SPAN,):
            device[n] = device.get(n, 0.0) + d
            by_group[(g, n)] = by_group.get((g, n), 0.0) + d

    starts = [r[0] for r in ranges] + [o[0] for o in ops]
    ends = [r[1] for r in ranges] + [o[1] for o in ops]
    lo = min(starts, default=0.0) if lo is None else lo
    hi = max(ends, default=0.0) if hi is None else hi
    # the host's innermost range over each stretch between two boundaries,
    # against the device's idle stretches: both sorted, walked together
    cuts = [-float("inf")] + bounds + [float("inf")]
    owners = [-1] + owner
    idle_s: Dict[str, float] = {}
    self_idle: Dict[str, float] = {}
    k = 0
    for s, e in _idle(_busy(ops), lo, hi):
        while cuts[k + 1] <= s:
            k += 1
        while cuts[k] < e:
            d = (min(e, cuts[k + 1]) - max(s, cuts[k])) / 1e6
            r = owners[k]
            key = names[r] if r >= 0 else NO_SPAN
            self_idle[key] = self_idle.get(key, 0.0) + d
            for n in chain(r):
                idle_s[n] = idle_s.get(n, 0.0) + d
            if cuts[k + 1] >= e:
                break
            k += 1
    host_s: Dict[str, List[float]] = {}
    for s, e, n in ranges:
        host_s.setdefault(n, []).append((e - s) / 1e6)
    return SpanTimes(kernel_s, device, self_device, idle_s, self_idle,
                     host_s, by_group)


def tuples(events):
    """``(ops, launches, ranges)`` of :func:`attribute` from
    ``torch.profiler`` events (``prof.events()``): the device's operations
    but the ranges' device-side twins and the benchmark's ``bench.*``, the
    runtime calls' host times by correlation id, and the
    ``repro_torch.*`` ranges."""
    from torch.autograd import DeviceType
    ops, launches, ranges = [], {}, []
    for e in events:
        tr = e.time_range
        kind = getattr(e, "activity_type", "")
        if e.device_type == DeviceType.CUDA:
            if kind != _ANNOTATION and not e.name.startswith(
                    (PREFIX, "bench.")):
                ops.append((tr.start, tr.end, e.name, e.id))
        elif kind in _RUNTIME or (not kind and _API.match(e.name)):
            launches[e.id] = tr.start
        elif e.name.startswith(PREFIX):
            ranges.append((tr.start, tr.end, e.name[len(PREFIX):]))
    return ops, launches, ranges


def from_events(events, group=lambda name: name, lo: Optional[float] = None,
                hi: Optional[float] = None) -> SpanTimes:
    """:func:`attribute` over ``torch.profiler`` events."""
    return attribute(*tuples(events), group, lo, hi)


def table(t: SpanTimes) -> str:
    """One line a span, most device time first: device, self device and
    idle seconds (under the span at any depth, and as the innermost), host
    seconds and count; then the time under no span."""
    rows = ["span device_s self_device_s idle_s self_idle_s host_s count"]
    names = sorted(t.host_s, key=lambda n: -t.device_s.get(n, 0.0))
    for n in names + [NO_SPAN]:
        host = t.host_s.get(n, [])
        rows.append(
            f"{n} {t.device_s.get(n, 0.0):.6f} "
            f"{t.self_device_s.get(n, 0.0):.6f} {t.idle_s.get(n, 0.0):.6f} "
            f"{t.self_idle_s.get(n, 0.0):.6f} {sum(host):.6f} {len(host)}")
    rows.append(f"kernel_s {t.kernel_s:.6f}")
    return "\n".join(rows)


def spans_of(ctx) -> Optional[SpanTimes]:
    """The traced run's :class:`SpanTimes` (``ctx.trace.spans``), or None
    where the run has none."""
    return getattr(getattr(ctx, "trace", None), "spans", None)


def device_share(ctx, *names: str) -> Optional[float]:
    """Percent of the kernel time under any of ``names``; None without
    spans or where none of them ran."""
    t = spans_of(ctx)
    if t is None or t.kernel_s <= 0 or not any(n in t.device_s
                                               for n in names):
        return None
    return 100.0 * sum(t.device_s.get(n, 0.0) for n in names) / t.kernel_s

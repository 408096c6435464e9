"""The port's spans (``repro_torch.tracing``) and
``Request.prefill_positions``.

Tiny smoke configs on the CPU: llama3-8b-262k (dense GQA, no window, so a
chunked run may pack) and mixtral-8x22b (MoE, 4 experts, window 128), 2
layers, block 64.  Spans are read from a CPU ``torch.profiler`` session:
their names, and their nesting by time containment (every span is opened
on the serving thread).
"""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.serving import EngineConfig, Request, ServingEngine
from repro_torch.serving import scheduler as sched_mod

PREFIX = "repro_torch."


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def spans_off_after():
    yield
    tracing.enable(False)


_MODELS = {}


def _model(name):
    if name not in _MODELS:
        model = build_model(get_smoke_config(name), device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        _MODELS[name] = (model, params, model.default_share_prefill())
    return _MODELS[name]


def _requests(shape, arrival=0.0, seed=1):
    g = np.random.default_rng(seed)
    return [Request(uid=i, prompt=g.integers(0, 500, n).astype(np.int32),
                    max_new_tokens=m, arrival_s=arrival if i == 0 else 0.0)
            for i, (n, m) in enumerate(shape)]


MIXED = ((256, 3), (100, 2), (200, 3))
PAGED = dict(max_batch=2, paged=True, decode_sparse=True,
             seq_buckets=(128, 256), decode_impl="kernel")


def _serve(name, reqs, **kw):
    model, params, sp = _model(name)
    eng = ServingEngine(model, params, sp, EngineConfig(**kw))
    eng.serve(reqs)
    return eng


def _profiled(name, reqs, **kw):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng = _serve(name, reqs, **kw)
    spans = sorted((e.time_range.start, -e.time_range.end,
                    e.name[len(PREFIX):])
                   for e in prof.events() if e.name.startswith(PREFIX))
    return eng, [(s, -e, n) for s, e, n in spans]


def _parents(spans):
    """Each span's enclosing spans, outermost first (a stack over spans
    sorted by start, longer first on a tie)."""
    out, stack = [], []
    for s, e, n in spans:
        while stack and stack[-1][1] < e:
            stack.pop()
        out.append((n, [p[2] for p in stack]))
        stack.append((s, e, n))
    return out


def test_off_is_free():
    assert not tracing.enabled()
    _, spans = _profiled("llama3-8b-262k", _requests(MIXED), **PAGED)
    assert spans == []
    t = time.perf_counter()
    for _ in range(100_000):
        with tracing.span("sched.decode_step"):
            pass
    assert time.perf_counter() - t < 0.1


# what each path reaches, and chains that must appear (innermost first)
PATHS = {
    "paged": (dict(PAGED), {
        "serve", "sched.wait", "sched.admit", "sched.decode_step", "sample",
        "model.prefill", "model.decode", "model.head", "attn.qkv",
        "share.masks", "attn.rows", "share.update", "attn.out",
        "attn.decode", "ffn", "moe.route", "moe.dispatch", "moe.experts",
        "moe.combine"}, [
        ("share.masks", "model.prefill", "sched.admit", "serve"),
        ("attn.rows", "model.prefill"), ("share.update", "model.prefill"),
        ("attn.decode", "model.decode", "sched.decode_step", "serve"),
        ("moe.experts", "ffn", "model.prefill"),
        ("moe.dispatch", "ffn", "model.decode"),
        ("moe.combine", "ffn", "model.decode"),
        ("moe.route", "ffn", "model.prefill"),
        ("sample", "sched.decode_step"), ("sched.wait", "serve")]),
    "chunked": (dict(PAGED, prefill_chunk=128), {
        "serve", "sched.quantum", "sched.decode_step", "share.masks",
        "attn.rows", "share.update", "attn.out", "ffn", "moe.experts"}, [
        ("share.masks", "sched.quantum", "serve"),
        ("attn.rows", "sched.quantum"), ("moe.experts", "sched.quantum")]),
    "batch": (dict(max_batch=2, seq_buckets=(128, 256)), {
        "serve", "batch", "sample", "model.prefill", "model.decode",
        "share.masks", "attn.rows"}, [
        ("share.masks", "model.prefill", "batch", "serve"),
        ("attn.decode", "model.decode", "batch"), ("sample", "batch")]),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_nesting(path):
    kw, names, chains = PATHS[path]
    tracing.enable()
    eng, spans = _profiled("mixtral-8x22b", _requests(MIXED, arrival=0.3),
                           **kw)
    assert names <= {n for _, _, n in spans}, names - {n for *_, n in spans}
    parents = _parents(spans)
    for chain in chains:
        inner, outer = chain[0], list(chain[1:])
        assert any([p for p in ps if p in outer] == outer[::-1]
                   for n, ps in parents if n == inner), chain
    if path == "batch":
        return
    # phase_s and the spans are one stretch each: a span a decode step,
    # and each phase's clock read inside its span
    steps = sum(n == "sched.decode_step" for *_, n in spans)
    assert steps == eng.slot_steps // kw["max_batch"] > 0
    for phase, span in (("decode", "sched.decode_step"),
                        ("idle", "sched.wait")):
        total = sum(e - s for s, e, n in spans if n == span) / 1e6
        assert 0 < eng.phase_s[phase] <= total + 1e-6, phase


def test_clock():
    """The best of three probes: a probe the machine preempts between the
    stamp and the span is not the clock's fault."""
    tracing.enable()
    gaps = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t = tracing.now()
            with tracing.span("probe"):
                pass
        (ev,) = [e for e in prof.events() if e.name == PREFIX + "probe"]
        start = prof.profiler.kineto_results.trace_start_ns() / 1e9 \
            + ev.time_range.start / 1e6
        gaps.append(abs(start - t))
    assert min(gaps) < 1e-3


COUNTERS = ("finish_reason", "prefill_positions", "prefix_hit",
            "preempted_count", "waiting_deferred_steps", "refreshes",
            "tail_fraction", "plan_traffic_fraction", "pattern_stats")


@pytest.mark.parametrize("name", ["llama3-8b-262k", "mixtral-8x22b"])
def test_same_outputs(name):
    runs = []
    for on in (False, True):
        tracing.enable(on)
        reqs = _requests(MIXED)
        with profile(activities=[ProfilerActivity.CPU]):
            _serve(name, reqs, **PAGED)
        runs.append(reqs)
    for a, b in zip(*runs):
        assert np.array_equal(a.output_tokens, b.output_tokens)
        for k in COUNTERS:
            assert getattr(a, k) == getattr(b, k), k


POSITIONS = [
    # path, engine settings, prompts, positions each request's prefill
    # computed: its bucket, its packed segment, or 0 on a prefix hit
    ("batch", dict(max_batch=2, seq_buckets=(128, 256)), MIXED,
     [256, 128, 256]),
    ("one-shot", PAGED, MIXED, [256, 128, 256]),
    ("packed", dict(PAGED, prefill_chunk=128, prefill_pack=2),
     ((256, 3), (250, 2), (240, 3)), [256, 256, 256]),
    ("prefix-hit", dict(PAGED, prefix_sharing=True), "twice", [256, 0]),
]


@pytest.mark.parametrize("path,kw,shape,want", POSITIONS,
                         ids=[p[0] for p in POSITIONS])
def test_prefill_positions(path, kw, shape, want, monkeypatch):
    runs = []

    class Run(sched_mod.ChunkedPrefillRun):
        def __init__(self, eng, requests, *a, **k):
            runs.append(len(requests))
            super().__init__(eng, requests, *a, **k)

    monkeypatch.setattr(sched_mod, "ChunkedPrefillRun", Run)
    if shape == "twice":
        reqs = _requests(((256, 3),))
        reqs.append(Request(uid=1, prompt=reqs[0].prompt.copy(),
                            max_new_tokens=3, arrival_s=0.2))
    else:
        reqs = _requests(shape)
    eng = _serve("llama3-8b-262k", reqs, **kw)
    assert [r.prefill_positions for r in reqs] == want
    assert all(r.finish_reason == "length" for r in reqs)
    if path == "packed":
        assert runs == [2, 1] and eng.phase_s["prefill"] > 0
    if path == "prefix-hit":
        assert reqs[1].prefix_hit


def test_idle_phase_adds_the_time_slept(monkeypatch):
    """``phase_s["idle"]`` is the wall time the wait took, not the wait
    that was planned."""
    real, planned = time.sleep, []

    class Clock:
        @staticmethod
        def sleep(s):
            planned.append(s)
            real(s + 0.05)

    monkeypatch.setattr(sched_mod, "time", Clock)
    reqs = _requests(((100, 2),), arrival=0.3)
    eng = _serve("llama3-8b-262k", reqs, **PAGED)
    assert len(planned) == 1
    assert eng.phase_s["idle"] >= planned[0] + 0.05

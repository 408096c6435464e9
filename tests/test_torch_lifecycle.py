"""The port's request lifecycle (ROADMAP.md A.9) against the JAX
package's: cancellation, deadlines, fault quarantine, preemption with
carry replay, held-page windows and slow quanta — the cases of the
reference's ``tests/test_lifecycle.py`` and ``tests/test_chaos.py``.

Each case serves the same requests through both packages (granite-3-2b's
smoke config, ``tests/torch_serving_helpers.py``), with the same faults
(``FaultInjector`` specs of each package, or a ``SchedulerHandle``), and
holds the port to the reference's: every request's ``finish_reason``,
``state``, ``preempted_count``, ``resume_tokens`` and
``waiting_deferred_steps``, and the engine's ``preemptions`` exactly;
greedy tokens near-tie aware (a stream may leave the reference's only
where the reference's top-2 margin is below ``TIE_TOL``).  The port's own
invariant for sampled streams (the reference's JAX key chains cannot be
reproduced): a preempted and resumed stream equals the unpreempted one.
"""
import pytest

import repro.serving as jserving
import repro_torch.serving as tserving
from repro_torch.serving import RequestError, SamplingConfig

from torch_serving_helpers import (JRequest, MarginRecorder, Request,
                                   assert_greedy_agree, make_pair,
                                   one_torch_thread, page_leak_audit,
                                   port_engine, ref_engine, requests)

S64, S256 = 64, 256
CONTIG = dict(max_batch=2, seq_buckets=(S64,), scheduler=True)
TIGHT = dict(max_batch=3, seq_buckets=(S64,), paged=True, decode_sparse=True,
             decode_extra=S64, num_pages=6, preempt_after_steps=2)
CHUNKED = dict(max_batch=2, seq_buckets=(S256,), paged=True,
               prefill_chunk=64)

# name → (engine config, max_new_tokens, prompt length, fault specs,
#         handle cancels, request overrides {index: fields}, expected
#         finish reasons {index: reason} (the rest finish "length"))
CASES = {
    "cancel_waiting": (CONTIG, (5, 4, 3), S64, [], (1,), {},
                       {1: "cancelled"}),
    "cancel_mid_decode": (CONTIG, (10, 6), S64,
                          [("CancelAt", dict(uid=0, step=4))], (), {},
                          {0: "cancelled"}),
    "cancel_mid_chunked_run": (CHUNKED, (4, 6), S256,
                               [("CancelAt", dict(uid=0, step=2))], (), {},
                               {0: "cancelled"}),
    "deadline_waiting": (CONTIG, (4, 4), S64, [], (),
                         {1: dict(deadline_s=1e-6)}, {1: "timeout"}),
    "nan_quarantine": (CONTIG, (8, 6), S64,
                       [("NaNLogits", dict(uid=0, at_token=2))], (), {},
                       {0: "failed"}),
    "prefill_quarantine": (CONTIG, (4, 6), S64,
                           [("PrefillError", dict(uid=0))], (), {},
                           {0: "failed"}),
    "preempt_resume": (TIGHT, (20, 18, 12), S64, [], (), {}, {}),
    "priority_victim": (TIGHT, (20, 18, 12), S64, [], (),
                        {0: dict(priority=1)}, {}),
    "preempt_during_chunked_admission": (
        dict(max_batch=3, seq_buckets=(S256,), paged=True, prefill_chunk=64,
             decode_extra=S64, num_pages=11, preempt_after_steps=1),
        (16, 5, 4), S256, [], (), {}, {}),
    "held_pages_window": (
        dict(max_batch=2, seq_buckets=(S64,), paged=True, decode_extra=S64),
        (6, 5, 4), S64,
        [("HoldPages", dict(pages=4, from_step=1, until_step=6))], (), {},
        {}),
    "slow_quanta_race_deadline": (
        dict(max_batch=2, seq_buckets=(S256,), scheduler=True,
             prefill_chunk=64),
        (5, 6), S256, [("SlowQuantum", dict(uid=0, delay_s=0.15))], (),
        {0: dict(deadline_s=0.2)}, {0: "timeout"}),
    "combined_chaos": (
        TIGHT, (20, 18, 12, 8, 10), S64,
        [("NaNLogits", dict(uid=3, at_token=3)),
         ("CancelAt", dict(uid=4, step=10))], (),
        {0: dict(priority=1), 1: dict(priority=1)},
        {3: "failed", 4: "cancelled"}),
}


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _serve(pair, name):
    """The case through both packages: (reference requests, reference
    engine, port requests, port engine, reference margins)."""
    kw, max_new, seq, specs, cancels, fields, _ = CASES[name]
    vocab = pair["cfg"].vocab_size
    out = []
    for pkg, cls in ((jserving, JRequest), (tserving, Request)):
        reqs = requests(cls, vocab, max_new, seq=seq)
        for i, f in fields.items():
            for k, v in f.items():
                setattr(reqs[i], k, v)
        faults = [getattr(pkg, n)(**a) for n, a in specs]
        handle = None
        if cancels:
            handle = pkg.SchedulerHandle()
            for uid in cancels:
                handle.cancel(uid)
        if pkg is jserving:
            eng = ref_engine(pair, **kw)
            injector = MarginRecorder(*faults)
        else:
            eng = port_engine(pair, **kw)
            injector = pkg.FaultInjector(*faults)
        eng.serve(reqs, seed=0, handle=handle, faults=injector)
        out += [reqs, eng]
        if pkg is jserving:
            margins = injector.margins
    return out + [margins]


@pytest.mark.parametrize("name", list(CASES))
def test_lifecycle_matches_reference(pair, name):
    jreqs, jeng, treqs, teng, margins = _serve(pair, name)
    expect = CASES[name][-1]
    for i, (r, g) in enumerate(zip(jreqs, treqs)):
        want = expect.get(i, "length")
        assert r.finish_reason == want, (i, r.finish_reason)
        assert (g.finish_reason, g.state) == (want, r.state), i
        if want == "failed":
            assert isinstance(g.error, RequestError)
            assert (g.error.uid, g.error.kind) == (r.error.uid, r.error.kind)
    same = assert_greedy_agree(jreqs, treqs, margins)
    for r, g in zip(jreqs, treqs):
        out = g.output_tokens.tolist()
        if g.finish_reason in ("cancelled", "timeout", "failed"):
            # a doomed stream is a prefix of the reference's
            assert out == r.output_tokens.tolist()[: len(out)] or not same
    if not same:
        return
    assert teng.preemptions == jeng.preemptions
    assert teng.pages_exhausted_steps == jeng.pages_exhausted_steps
    for r, g in zip(jreqs, treqs):
        assert (g.preempted_count, g.waiting_deferred_steps) == (
            r.preempted_count, r.waiting_deferred_steps), r.uid
        assert g.resume_tokens == [int(t) for t in r.resume_tokens], r.uid
    if "preempt" in name or name == "combined_chaos":
        assert teng.preemptions > 0
        assert any(g.preempted_count > 0 and g.state == "done"
                   for g in treqs)
    if name == "priority_victim":
        assert treqs[0].preempted_count == 0 < treqs[1].preempted_count
    if name == "held_pages_window":
        assert teng.pages_exhausted_steps > 0
    if teng.ecfg.paged:
        assert teng.page_pool_stats["pages_in_use_at_end"] == 0


@pytest.mark.parametrize("sampling", [
    SamplingConfig(), SamplingConfig(temperature=1.0, top_k=20)])
def test_preempted_stream_is_the_unpreempted_stream(pair, sampling):
    """The tight pool preempts and resumes; every stream, greedy or
    sampled, equals the ample pool's serve of the same requests."""
    vocab = pair["cfg"].vocab_size
    streams = []
    for kw in (dict(TIGHT, num_pages=0, preempt_after_steps=0), TIGHT):
        eng = port_engine(pair, **kw)
        reqs = requests(Request, vocab, (20, 18, 12), sampling=sampling)
        eng.serve(reqs, seed=0)
        assert all(r.finish_reason == "length" for r in reqs)
        streams.append([r.output_tokens.tolist() for r in reqs])
        preempted = [r.preempted_count for r in reqs]
    assert sum(preempted) > 0 and eng.preemptions > 0
    assert streams[0] == streams[1]


class _Hooked:
    """The port's model, calling ``hook`` before every decode step."""

    def __init__(self, model, hook):
        self._model, self._hook = model, hook

    def __getattr__(self, name):
        return getattr(self._model, name)

    def decode(self, *args, **kw):
        self._hook()
        return self._model.decode(*args, **kw)


def test_handle_cancels_mid_decode_from_another_thread(pair):
    """``SchedulerHandle.cancel`` from a second thread ends the request at
    the next step: a prefix of its solo stream, the neighbour unchanged."""
    import threading
    vocab = pair["cfg"].vocab_size
    clean = requests(Request, vocab, (40, 6))
    port_engine(pair, **CONTIG).serve(clean, seed=0)
    handle = tserving.SchedulerHandle()
    steps = []

    def hook():
        steps.append(1)
        if len(steps) == 8:
            t = threading.Thread(target=handle.cancel, args=(0,))
            t.start()
            t.join()

    tm = pair["tm"]
    eng = tserving.ServingEngine(_Hooked(tm, hook), pair["tp"],
                                 tm.default_share_prefill(),
                                 tserving.EngineConfig(**CONTIG))
    reqs = requests(Request, vocab, (40, 6))
    eng.serve(reqs, seed=0, handle=handle)
    out = reqs[0].output_tokens.tolist()
    # the prefill's token and the 8 decode steps up to the cancel; the
    # next step's reap vacates the slot
    assert reqs[0].finish_reason == "cancelled" and len(out) == 9
    assert out == clean[0].output_tokens.tolist()[: len(out)]
    assert reqs[1].output_tokens.tolist() == clean[1].output_tokens.tolist()

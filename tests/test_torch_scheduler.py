"""The port's continuous-batching ``SlotScheduler`` against the JAX
package's.

Both engines serve the same requests from the same parameters
(llama3-8b-262k smoke config, 8 query heads, 2 kv heads, block 64): the
reference with ``attn_impl="sparse"`` and ``decode_impl="kernel"`` (its
Pallas kernels interpret on the CPU), the port with ``decode_impl="kernel"``
(on CPU tensors, the kernels' plain versions).  Contiguous mode with sparse
and dense decode, paged mode with one bucket and with mixed buckets, and an
undersized pool.  Greedy tokens are compared near-tie aware, as in
``test_torch_serving.py``: a stream may flip only where the reference's
top-2 logit margin at that step is below ``TIE_TOL``.  Step counts, page
deferrals and pool peaks are exact.

Every test runs under a page-leak audit (the twin of the reference's
``tests/conftest.py::_page_leak_guard``): each paged serve must end with
zero pages in use and a consistent allocator.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten
from repro.configs import get_smoke_config as j_smoke
from repro.models.api import build_model as j_build
from repro.serving import EngineConfig as JConfig, Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving import decode_plan as jdplan
from repro.serving.sampling import SamplingConfig as JSampling
from repro_torch import checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.serving import (EngineConfig, Request, RequestError,
                                 SamplingConfig, ServingEngine,
                                 SlotScheduler)
from repro_torch.serving import engine as tengine

torch.backends.cuda.matmul.allow_tf32 = False

TIE_TOL = 1e-3
BASE = dict(max_batch=2, method="share", decode_impl="kernel")

# (prompt length, max_new_tokens): more requests than slots and mixed
# lengths, so slots finish early and are refilled during the serve
ONE_BUCKET = ((256, 5), (250, 2), (240, 4), (200, 3))
MIXED = ((256, 5), (100, 4), (250, 3), (128, 5))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in several
    worker processes at once, and torch's default of one thread per core
    in each of them oversubscribes the cores (these tests ran 15× slower
    that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def page_leak_audit(monkeypatch):
    """After the test, every paged serve it ran has zero pages in use and
    an allocator whose free list and refcounts agree."""
    seen = []
    summary = SlotScheduler._pool_summary

    def audited(self):
        summary(self)
        if self.paged:
            seen.append((self.alloc, dict(self.eng.page_pool_stats)))

    monkeypatch.setattr(SlotScheduler, "_pool_summary", audited)
    yield seen
    for alloc, stats in seen:
        alloc.check_consistency()
        assert stats["pages_in_use_at_end"] == 0, stats


@pytest.fixture(scope="module")
def pair():
    kw = dict(num_heads=8, num_kv_heads=2)
    jcfg = dataclasses.replace(j_smoke("llama3-8b-262k"), **kw)
    tcfg = dataclasses.replace(get_smoke_config("llama3-8b-262k"), **kw)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tp = checkpoint.params_from_numpy(_flatten(jp), tcfg, device="cpu")
    # one reference engine for every configuration, so its compiled
    # programs are shared between the tests
    jeng = JEngine(jm, jp, jm.default_share_prefill(), JConfig())
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, jeng=jeng,
                vocab=jcfg.vocab_size)


def _prompts(specs, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n, _ in specs]


def _serve_ref(pair, specs, **kw):
    jeng = pair["jeng"]
    jeng.ecfg = JConfig(attn_impl="sparse", **BASE, **kw)
    reqs = [JRequest(uid=i, prompt=p, max_new_tokens=m)
            for i, (p, (_, m)) in enumerate(
                zip(_prompts(specs, pair["vocab"]), specs))]
    jeng.serve(reqs, seed=0)
    return reqs, jeng


def _engine(pair, **kw):
    return ServingEngine(pair["tm"], pair["tp"],
                         pair["tm"].default_share_prefill(),
                         EngineConfig(**BASE, **kw))


def _serve(pair, specs, sampling=None, **kw):
    eng = _engine(pair, **kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=m,
                    sampling=sampling or SamplingConfig())
            for i, (p, (_, m)) in enumerate(
                zip(_prompts(specs, pair["vocab"]), specs))]
    eng.serve(reqs, seed=0)
    return reqs, eng


def _reference_margins(pair, prompt, bucket, tokens, upto, sparse):
    """The reference's top-2 logit margins of one request at steps
    0..upto, teacher-forced on its own tokens (its prefill at the bucket,
    the grown cache and, for sparse decode, its plan)."""
    jm, jp = pair["jm"], pair["jp"]
    sp = jm.default_share_prefill()
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :len(prompt)] = prompt
    plens = jnp.asarray([len(prompt)], jnp.int32)
    res = jm.prefill(jp, jnp.asarray(toks), sp, method="share",
                     attn_impl="sparse", prompt_lens=plens)
    extra = 128
    cache = {"prefix": [], "stack": tuple(
        jnp.pad(c, ((0, 0),) * 3 + ((0, extra), (0, 0)))
        for c in res.cache["stack"])}
    plan = None
    if sparse and res.sp_state is not None:
        plan = jdplan.build_decode_plan(sp, res.sp_state, jm.cfg,
                                        prefill_len=bucket,
                                        cache_len=bucket + extra)
    logits, margins = res.last_logits, []
    for t in range(upto + 1):
        top2 = np.sort(np.asarray(logits)[0])[-2:]
        margins.append(float(top2[1] - top2[0]))
        if t == upto:
            break
        logits, cache = jm.decode(
            jp, jnp.asarray([[tokens[t]]], jnp.int32), cache,
            jnp.int32(bucket + t), plan=plan, prompt_lens=plens,
            prefill_len=bucket, decode_impl="kernel")
    return margins


def _assert_greedy_agree(pair, specs, ref, got, buckets, sparse):
    """Equal streams, or a first flip at a reference near-tie; returns
    whether every stream was identical."""
    prompts = _prompts(specs, pair["vocab"])
    identical = True
    for i, (r, g) in enumerate(zip(ref, got)):
        a, b = r.output_tokens.tolist(), g.output_tokens.tolist()
        flip = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y),
                    None)
        if flip is None:
            assert a == b and r.finish_reason == g.finish_reason, i
            continue
        identical = False
        bucket = next(s for s in buckets if len(prompts[i]) <= s)
        m = _reference_margins(pair, prompts[i], bucket, a, flip, sparse)
        print(f"request {i}: flip at token {flip}, margin {m[flip]:.3e}")
        assert m[flip] < TIE_TOL
    return identical


CASES = {
    "contiguous_sparse": (ONE_BUCKET, dict(scheduler=True,
                                           decode_sparse=True,
                                           seq_buckets=(256,))),
    "contiguous_dense": (ONE_BUCKET, dict(scheduler=True,
                                          seq_buckets=(256,))),
    "paged_one_bucket": (ONE_BUCKET, dict(paged=True, decode_sparse=True,
                                          seq_buckets=(256,))),
    "paged_mixed_buckets": (MIXED, dict(paged=True, decode_sparse=True,
                                        seq_buckets=(128, 256))),
    "paged_undersized_pool": (MIXED, dict(paged=True, decode_sparse=True,
                                          seq_buckets=(128, 256),
                                          num_pages=9)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_scheduler_matches_reference(pair, name):
    specs, kw = CASES[name]
    ref, jeng = _serve_ref(pair, specs, **kw)
    got, eng = _serve(pair, specs, **kw)
    same = _assert_greedy_agree(pair, specs, ref, got, kw["seq_buckets"],
                                kw.get("decode_sparse", False))
    for r, g in zip(ref, got):
        assert g.state == "done" and g.finish_reason == "length"
        assert g.waiting_deferred_steps == r.waiting_deferred_steps
        assert g.tail_fraction == pytest.approx(r.tail_fraction, abs=1e-6)
        assert g.plan_traffic_fraction == pytest.approx(
            r.plan_traffic_fraction, abs=1e-6)
        for key in ("num_shared", "num_dense", "num_vs",
                    "decode_blocks_computed"):
            assert g.pattern_stats.get(key) == r.pattern_stats.get(key)
    # step-deterministic counters (equal token streams take equal steps)
    assert eng.pages_exhausted_steps == jeng.pages_exhausted_steps
    if same:
        assert (eng.slot_steps, eng.active_slot_steps) == (
            jeng.slot_steps, jeng.active_slot_steps)
    if kw.get("paged"):
        for key in ("num_pages", "page_size", "table_blocks",
                    "peak_pages"):
            assert eng.page_pool_stats[key] == jeng.page_pool_stats[key]
    if name == "paged_undersized_pool":
        assert eng.pages_exhausted_steps > 0


def test_pool_too_small_for_one_request_raises(pair):
    eng = _engine(pair, paged=True, decode_sparse=True, seq_buckets=(256,),
                  num_pages=3)
    with pytest.raises(ValueError, match="deadlock"):
        eng.serve([Request(uid=0, prompt=np.ones(200, np.int32),
                           max_new_tokens=2)])


@pytest.mark.parametrize("mode", ["scheduler", "paged"])
def test_stop_tokens_and_prefill_only(pair, mode):
    kw = {mode: True, "decode_sparse": True, "seq_buckets": (128, 256)}
    free, _ = _serve(pair, ((250, 6),), **kw)
    full = free[0].output_tokens.tolist()
    stop = full[2]
    specs = ((250, 6), (100, 0), (200, 3))
    reqs, eng = _serve(pair, specs, sampling=SamplingConfig(
        stop_tokens=(stop,)), **kw)
    assert reqs[0].finish_reason == "stop"
    assert reqs[0].output_tokens.tolist() == full[:full.index(stop) + 1]
    assert reqs[1].output_tokens.tolist() == [] and reqs[1].ttft_s == 0.0
    assert reqs[1].finish_reason == "length" and reqs[1].state == "done"
    assert reqs[1].pattern_stats is not None


@pytest.mark.parametrize("paged", [False, True])
def test_vacated_slot_plan_row_emptied(pair, paged):
    """After the serve every slot is free, its plan row empty and, under
    paging, its page-table row null."""
    eng = _engine(pair, scheduler=True, paged=paged, decode_sparse=True,
                  seq_buckets=(256,))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=m) for i, (p, (_, m))
            in enumerate(zip(_prompts(ONE_BUCKET[:2], pair["vocab"]),
                             ONE_BUCKET[:2]))]
    sched = SlotScheduler(eng, reqs, 256, seed=0, paged=paged)
    sched.run()
    assert all(s is None for s in sched.slots)
    assert not sched.plan.counts.any() and not sched.plan.keep_heads.any()
    if paged:
        assert not sched.page_table.any()
        assert sched.cache[0].dtype == torch.float32


def test_per_request_metrics(pair):
    # 10 usable pages: a 256 request (6 pages) and a 128 one (4) decode
    # together, and the next 256 request waits for pages
    reqs, eng = _serve(pair, MIXED, paged=True, decode_sparse=True,
                       seq_buckets=(128, 256), num_pages=11)
    for r in reqs:
        m = r.metrics()
        assert set(m) == {"queue_s", "ttft_s", "prefill_s", "decode_s",
                          "decode_tokens_per_s", "prefill_stall_s",
                          "waiting_deferred_steps", "preempted_count",
                          "prefix_hit", "tail_fraction",
                          "plan_traffic_fraction", "refreshes"}
        assert m["ttft_s"] >= m["prefill_s"] > 0 and m["queue_s"] >= 0
        assert m["decode_tokens_per_s"] > 0
        assert 0 < m["plan_traffic_fraction"] <= 1
        assert 0 < m["tail_fraction"] < 1
    # the first admission ran alone; later ones stalled an occupied slot
    assert reqs[0].prefill_stall_s == 0.0
    assert max(r.prefill_stall_s for r in reqs) > 0
    assert max(r.queue_s for r in reqs) > min(r.queue_s for r in reqs)
    assert sum(r.waiting_deferred_steps for r in reqs) == \
        eng.pages_exhausted_steps > 0
    assert 0 < eng.slot_occupancy() <= 1
    assert eng.phase_s["prefill"] > 0 and eng.phase_s["decode"] > 0
    assert eng.page_pool_stats["peak_utilization"] <= 1


def test_arrivals_are_admitted_in_order(pair):
    base, _ = _serve(pair, ONE_BUCKET, scheduler=True, seq_buckets=(256,))
    eng = _engine(pair, scheduler=True, seq_buckets=(256,))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=m, arrival_s=0.05 * i)
            for i, (p, (_, m)) in enumerate(
                zip(_prompts(ONE_BUCKET, pair["vocab"]), ONE_BUCKET))]
    eng.serve(reqs, seed=0)
    for a, b in zip(base, reqs):
        assert a.output_tokens.tolist() == b.output_tokens.tolist()
        assert b.queue_s >= 0.0 and b.ttft_s > 0.0


BAD = {
    "empty_prompt": dict(prompt=np.zeros((0,), np.int32)),
    "2d_prompt": dict(prompt=np.ones((2, 3), np.int32)),
    "float_prompt": dict(prompt=np.ones(4, np.float32)),
    "negative_max_new": dict(max_new_tokens=-1),
    "negative_deadline": dict(deadline_s=-1.0),
    "too_long_no_truncation": dict(prompt=np.ones(300, np.int32),
                                   allow_truncation=False),
    "stop_not_iterable": dict(stop_tokens=5),
    "stop_negative": dict(stop_tokens=(3, -1)),
    "stop_bool": dict(stop_tokens=(True,)),
}


@pytest.mark.parametrize("name", list(BAD))
def test_validate_request_matches_reference(pair, name):
    bad = dict(BAD[name])
    stop = bad.pop("stop_tokens", ())
    base = dict(uid=7, prompt=np.ones(10, np.int32), max_new_tokens=2)
    base.update(bad)
    jreq = JRequest(**base, sampling=JSampling(stop_tokens=stop))
    treq = Request(**base, sampling=SamplingConfig(stop_tokens=stop))
    pair["jeng"].ecfg = JConfig(seq_buckets=(256,))
    with pytest.raises(Exception) as jerr:
        pair["jeng"].validate_request(jreq)
    eng = _engine(pair, seq_buckets=(256,), scheduler=True)
    with pytest.raises(RequestError) as terr:
        eng.validate_request(treq)
    assert str(terr.value) == str(jerr.value) and terr.value.uid == 7
    ok = Request(uid=8, prompt=np.ones(10, np.int32), max_new_tokens=2)
    eng.serve([treq, ok])
    assert treq.finish_reason == "rejected" and treq.state == "failed"
    assert treq.error is not None and len(treq.output_tokens) == 0
    assert ok.finish_reason == "length" and len(ok.output_tokens) == 2


class _Faulty:
    """The port's model, failing one request's prefill or poisoning one
    decode row's logits from a given step on."""

    def __init__(self, model, *, bad_prompt_len=None, nan_row=None,
                 nan_from=0):
        self.model, self.cfg, self.device = model, model.cfg, model.device
        self.bad_prompt_len, self.nan_row, self.nan_from = (
            bad_prompt_len, nan_row, nan_from)
        self.steps = 0

    def prefill(self, params, tokens, sp, **kw):
        if int(kw["prompt_lens"][0]) == self.bad_prompt_len:
            raise RuntimeError("injected prefill failure")
        return self.model.prefill(params, tokens, sp, **kw)

    def decode(self, *args, **kw):
        logits, cache = self.model.decode(*args, **kw)
        self.steps += 1
        if self.nan_row is not None and self.steps == self.nan_from + 1:
            logits = logits.clone()
            logits[self.nan_row] = float("nan")
        return logits, cache

    def init_cache(self, *args, **kw):
        return self.model.init_cache(*args, **kw)


@pytest.mark.parametrize("fault", ["prefill", "decode"])
def test_quarantine_fails_only_the_faulty_request(pair, fault):
    base, _ = _serve(pair, MIXED, paged=True, decode_sparse=True,
                     seq_buckets=(128, 256))
    if fault == "prefill":
        model = _Faulty(pair["tm"], bad_prompt_len=MIXED[1][0])
        bad = 1
    else:
        model = _Faulty(pair["tm"], nan_row=0, nan_from=2)
        bad = 0                          # request 0 decodes in slot 0
    eng = ServingEngine(model, pair["tp"],
                        pair["tm"].default_share_prefill(),
                        EngineConfig(**BASE, paged=True, decode_sparse=True,
                                     seq_buckets=(128, 256)))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=m) for i, (p, (_, m))
            in enumerate(zip(_prompts(MIXED, pair["vocab"]), MIXED))]
    eng.serve(reqs, seed=0)
    r = reqs[bad]
    assert r.finish_reason == "failed" and r.state == "failed"
    assert isinstance(r.error, RequestError) and r.error.kind == fault
    for i, (a, b) in enumerate(zip(base, reqs)):
        if i != bad:
            assert b.finish_reason == "length"
            assert b.output_tokens.tolist() == a.output_tokens.tolist()


def test_bf16_serve_keeps_the_prefill_dtype(pair):
    model = build_model(pair["tm"].cfg, dtype=torch.bfloat16, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    for paged in (False, True):
        eng = ServingEngine(model, params, model.default_share_prefill(),
                            EngineConfig(**BASE, scheduler=True, paged=paged,
                                         decode_sparse=True,
                                         seq_buckets=(256,)))
        reqs = [Request(uid=i, prompt=p, max_new_tokens=3) for i, p in
                enumerate(_prompts(ONE_BUCKET[:3], pair["vocab"]))]
        sched = SlotScheduler(eng, reqs, 256, seed=0, paged=paged)
        sched.run()
        assert sched.cache[0].dtype == torch.bfloat16
        assert all(len(r.output_tokens) == 3 for r in reqs)


def test_sampled_streams_follow_the_request_seed(pair):
    """A sampled stream depends on (seed, uid) only, not on its slot or
    neighbours."""
    scfg = SamplingConfig(temperature=1.0, top_k=20)
    a, _ = _serve(pair, ONE_BUCKET, sampling=scfg, scheduler=True,
                  seq_buckets=(256,))
    b, _ = _serve(pair, ONE_BUCKET[:1], sampling=scfg, scheduler=True,
                  seq_buckets=(256,))
    assert a[0].output_tokens.tolist() == b[0].output_tokens.tolist()


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = f.default_factory()
        else:
            out[f.name] = dataclasses.MISSING
    return out


@pytest.mark.parametrize("cls,ref", [(Request, JRequest),
                                     (EngineConfig, JConfig)],
                         ids=["Request-Request-table0",
                              "EngineConfig-EngineConfig-table1"])
def test_fields_match_the_reference(cls, ref):
    """Every field of the reference's dataclass is in the port with the
    same default (a sampling config compares by its fields), and every one
    is ported: no refusal table is left."""
    mine, theirs = _defaults(cls), _defaults(ref)
    assert set(theirs) <= set(mine), set(theirs) - set(mine)
    for name, default in theirs.items():
        got = mine[name]
        if dataclasses.is_dataclass(default):
            default, got = dataclasses.asdict(default), \
                dataclasses.asdict(got)
        assert got == default, name
    assert not any(n.endswith("NOT_PORTED") for n in dir(tengine))


# each case keeps its id from when every option raised; every option is
# now taken and served (prefix sharing since A.9's last slice)
@pytest.mark.parametrize("make", [
    lambda: (dict(preempt_after_steps=4), {}),
    lambda: (dict(prefix_max_entries=8, prefix_sharing=True), {}),
    lambda: (dict(refresh_mass=0.5), {}),
    lambda: (dict(width_safety=2.0), {}),
    lambda: ({}, dict(deadline_s=1.0)),
    lambda: ({}, dict(priority=2))],
    ids=["make0-A.9", "make1-A.9", "make2-A.9", "make3-A.5", "make4-A.9",
         "make5-A.9"])
def test_unported_scheduler_options_raise(pair, make):
    ecfg, req = make()
    eng = _engine(pair, paged=True, decode_sparse=True, seq_buckets=(256,),
                  **ecfg)
    r = Request(uid=0, prompt=np.ones(200, np.int32), max_new_tokens=3,
                **req)
    assert all(getattr(eng.ecfg, k) == v for k, v in ecfg.items())
    assert all(getattr(r, k) == v for k, v in req.items())
    eng.serve([r], seed=0)
    assert r.finish_reason == "length" and len(r.output_tokens) == 3


def test_prefix_sharing_still_raises(pair):
    """Prefix sharing no longer raises (its name is kept from when it
    did): the options are taken, a duplicated prompt is served as a hit,
    and ``Request.prefix_hit`` is settable as in the reference."""
    assert EngineConfig(prefix_sharing=True).prefix_sharing
    assert Request(uid=0, prompt=np.ones(3), prefix_hit=True).prefix_hit
    eng = _engine(pair, paged=True, decode_sparse=True, seq_buckets=(256,),
                  prefix_sharing=True)
    reqs = [Request(uid=i, prompt=np.ones(200, np.int32), max_new_tokens=3)
            for i in range(2)]
    eng.serve(reqs, seed=0)
    assert [r.prefix_hit for r in reqs] == [False, True]
    assert reqs[0].output_tokens.tolist() == reqs[1].output_tokens.tolist()
    assert eng.prefix_stats["prefix_hits"] == 1


def test_serve_refuses_handles_and_faults(pair):
    """``serve(handle=, faults=)`` is ported: an empty handle and an empty
    injector change nothing, and a cancel through the handle ends the
    request before its admission."""
    from repro_torch.serving import FaultInjector, SchedulerHandle
    eng = _engine(pair, scheduler=True, seq_buckets=(256,))
    base, _ = _serve(pair, ONE_BUCKET[:2], scheduler=True,
                     seq_buckets=(256,))
    handle = SchedulerHandle()
    reqs = [Request(uid=i, prompt=p, max_new_tokens=m) for i, (p, (_, m))
            in enumerate(zip(_prompts(ONE_BUCKET[:2], pair["vocab"]),
                             ONE_BUCKET[:2]))]
    eng.serve(reqs, seed=0, handle=handle, faults=FaultInjector())
    assert eng.handle is handle and eng.faults is not None
    for a, b in zip(base, reqs):
        assert a.output_tokens.tolist() == b.output_tokens.tolist()
    handle.cancel(1)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=m) for i, (p, (_, m))
            in enumerate(zip(_prompts(ONE_BUCKET[:2], pair["vocab"]),
                             ONE_BUCKET[:2]))]
    eng.serve(reqs, seed=0, handle=handle)
    assert reqs[1].finish_reason == "cancelled"
    assert reqs[0].output_tokens.tolist() == base[0].output_tokens.tolist()

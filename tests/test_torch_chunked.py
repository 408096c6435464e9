"""The port's chunked prefill (chunked admission and packing) against its
own one-shot prefill and against the JAX package's chunked prefill.

Both packages run granite-3-2b's smoke config from the same parameters
(the reference's, through ``checkpoint.params_from_numpy``), SEQ 256 and
block 64, with prompts from a numpy seed.  The reference runs its batched
Pallas kernel in interpret mode (``attn_impl="sparse"``; its ``auto``
picks dense attention off the TPU), the port the kernels' plain versions
on CPU tensors.

What is held, and how tightly:
  * a :class:`ChunkedPrefillRun` driven to its end, at chunks of 1 block,
    3 blocks (a ragged 1-block tail) and the whole bucket, gives logits and
    every layer's K/V **bitwise** equal to the port's one-shot prefill, for
    the batched sparse path and for ``attn_impl="chunked"`` (every chunk is
    the one-shot launch's rows at the same shapes);
  * against the reference's run: logits 1e-4 and K/V 1e-4 (two float32
    layers, products summed in other orders), layer 0's masks, decisions,
    the DecodePlan tables and the packed keep-sets **exactly**;
  * chunked and chunked+packed scheduler serves (2 slots, mixed
    ``max_new_tokens``) give greedy tokens equal to the reference's chunked
    serves near-tie aware (a stream may flip only where the reference's
    top-2 margin is below ``TIE_TOL``), and solo runs equal to the port's
    one-shot scheduler's; packed runs leave one-shot where the reference's
    packed serve leaves the reference's one-shot serve;
  * a paged chunked admission into a slot whose last occupant was of a
    shorter bucket: every layer's K/V bitwise the one-shot prefill's;
  * dense attention under block masks (``chunked_attention`` with masks,
    stats, windows, sinks and offsets, and its AttentionFn) at 1e-5.

Every test runs under the page-leak audit and the one-thread setting of
``tests/test_torch_scheduler.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten
from repro.configs import get_smoke_config as j_smoke
from repro.core import patterns as jpat
from repro.kernels import chunked as jchunk
from repro.models.api import build_model as j_build
from repro.serving import EngineConfig as JConfig, Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving import decode_plan as jdplan
from repro.serving import sparse_decode as jsd
from repro.serving.chunked_prefill import ChunkedPrefillRun as JRun
from repro_torch import checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.core import patterns
from repro_torch.core.pattern_dict import PivotalState
from repro_torch.kernels import chunked
from repro_torch.models import build_model
from repro_torch.serving import (EngineConfig, Request, ServingEngine,
                                 SlotScheduler)
from repro_torch.serving import decode_plan as dplan
from repro_torch.serving import engine as tengine
from repro_torch.serving import paged_cache, sparse_decode
from repro_torch.serving.chunked_prefill import ChunkedPrefillRun

torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "granite-3-2b"
SEQ = 256
BS = 64                                 # 4 q/kv blocks at SEQ
TIE_TOL = 1e-3
T = lambda a: torch.from_numpy(np.array(a))
# (prompt length, max_new_tokens): more requests than the 2 slots
SPECS = ((256, 5), (250, 2), (240, 4), (200, 3))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def page_leak_audit(monkeypatch):
    """Every paged serve a test runs ends with zero pages in use and a
    consistent allocator."""
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
    jcfg, tcfg = j_smoke(ARCH), get_smoke_config(ARCH)
    assert jcfg.share_prefill.block_size == BS
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tp = checkpoint.params_from_numpy(_flatten(jp), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n, _ in SPECS]
    jsp = jm.default_share_prefill()
    # one reference engine for every sparse-path configuration, so its
    # compiled programs are shared between the tests
    jeng = JEngine(jm, jp, jsp, JConfig())
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, cfg=tcfg, prompts=prompts,
                sp=tm.default_share_prefill(), jsp=jsp, jeng=jeng)


def _engine(pair, **kw):
    base = dict(method="share", max_batch=2, seq_buckets=(SEQ,),
                scheduler=True, decode_impl="kernel")
    return ServingEngine(pair["tm"], pair["tp"], pair["sp"],
                         EngineConfig(**{**base, **kw}))


def _j_engine(pair, **kw):
    base = dict(method="share", max_batch=2, seq_buckets=(SEQ,),
                scheduler=True, decode_impl="kernel", attn_impl="sparse")
    cfg = JConfig(**{**base, **kw})
    if cfg.attn_impl != "sparse":
        return JEngine(pair["jm"], pair["jp"], pair["jsp"], cfg)
    pair["jeng"].ecfg = cfg
    return pair["jeng"]


def _drive(run):
    """Drive a run to its end; each layer's K/V from its "kv" event."""
    kvs = {}
    while not run.done:
        if run.step() == "kv":
            kvs[run.kv_layer] = run.kv
    return kvs


def _oneshot(pair, prompt, attn_impl):
    toks = torch.zeros((1, SEQ), dtype=torch.long)
    toks[0, :len(prompt)] = T(prompt)
    return pair["tm"].prefill(pair["tp"], toks, pair["sp"], method="share",
                              attn_impl=attn_impl,
                              prompt_lens=torch.tensor([len(prompt)]))


def _j_state(state):
    """A reference PivotalState as the port's."""
    return PivotalState(*(T(x) for x in state))


# ------------------------------------------------- quantum equivalence

@pytest.mark.parametrize("chunk", [BS, 3 * BS, SEQ],
                         ids=["chunk=1blk", "chunk=3blk_ragged_tail",
                              "chunk=seq"])
def test_run_matches_oneshot_and_reference(pair, chunk):
    """The sparse path's quanta: bitwise the port's one-shot prefill; the
    reference's run within tolerance, its plan tables exactly."""
    prompt = pair["prompts"][2]
    eng = _engine(pair, prefill_chunk=chunk)
    run = ChunkedPrefillRun(eng, [Request(uid=0, prompt=prompt,
                                          max_new_tokens=1)],
                            [0], SEQ, chunk, None)
    assert run.chunks[-1][0] + run.chunks[-1][1] == SEQ // BS
    assert run.quanta_total == 2 + pair["cfg"].num_layers * (
        2 + len(run.chunks))
    kvs = _drive(run)
    assert run.quanta_done == run.quanta_total
    res = _oneshot(pair, prompt, "auto")
    assert torch.equal(run.logits, res.last_logits)
    assert sorted(kvs) == list(range(pair["cfg"].num_layers))
    for li, (k, v) in kvs.items():
        assert torch.equal(k, res.cache[0][li])
        assert torch.equal(v, res.cache[1][li])
    for a, b in zip(run.sp_state, res.sp_state):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(run.attn_stats, res.stats))

    jeng = _j_engine(pair, prefill_chunk=chunk)
    jrun = JRun(jeng, [JRequest(uid=0, prompt=prompt, max_new_tokens=1)],
                [0], SEQ, chunk, None)
    jkvs = _drive(jrun)
    assert jrun.chunks == run.chunks and jrun.plens == run.plens
    np.testing.assert_allclose(run.logits.numpy(), np.asarray(jrun.logits),
                               atol=1e-4, rtol=0)
    for li, (k, v) in kvs.items():
        np.testing.assert_allclose(k.numpy(), np.asarray(jkvs[li][0]),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(v.numpy(), np.asarray(jkvs[li][1]),
                                   atol=1e-4, rtol=0)
    cache_len = SEQ + 2 * BS
    mine = dplan.build_decode_plan(pair["sp"], run.sp_state, pair["cfg"],
                                   prefill_len=SEQ, cache_len=cache_len)
    ref = jdplan.build_decode_plan(pair["jsp"], jrun.sp_state,
                                   pair["jm"].cfg, prefill_len=SEQ,
                                   cache_len=cache_len)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_chunked_attn_impl_run_matches_oneshot_and_reference(pair):
    """``attn_impl="chunked"`` (dense attention under the masks) through
    the quanta, ragged tail: bitwise the port's one-shot prefill on the
    same path, and the reference's chunked run within tolerance."""
    prompt = pair["prompts"][1]
    eng = _engine(pair, prefill_chunk=3 * BS, attn_impl="chunked")
    run = ChunkedPrefillRun(eng, [Request(uid=0, prompt=prompt,
                                          max_new_tokens=1)],
                            [0], SEQ, 3 * BS, None)
    kvs = _drive(run)
    res = _oneshot(pair, prompt, "chunked")
    assert torch.equal(run.logits, res.last_logits)
    for li, (k, v) in kvs.items():
        assert torch.equal(k, res.cache[0][li])
    jeng = _j_engine(pair, prefill_chunk=3 * BS, attn_impl="chunked")
    jrun = JRun(jeng, [JRequest(uid=0, prompt=prompt, max_new_tokens=1)],
                [0], SEQ, 3 * BS, None)
    _drive(jrun)
    np.testing.assert_allclose(run.logits.numpy(), np.asarray(jrun.logits),
                               atol=1e-4, rtol=0)
    # the sparse path's logits agree with the dense path's as well
    np.testing.assert_allclose(run.logits.numpy(),
                               _oneshot(pair, prompt, "auto")
                               .last_logits.numpy(), atol=1e-4, rtol=0)


def test_layer_begin_masks_match_reference(pair):
    """Layer 0's staged masks, decisions and stats gate of a solo and of a
    packed run equal the reference's exactly; the head permutation keeps
    every head inside its GQA group."""
    prompts = pair["prompts"][:2]
    for P in (1, 2):
        eng = _engine(pair, prefill_chunk=BS, prefill_pack=P)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=1)
                for i, p in enumerate(prompts[:P])]
        run = ChunkedPrefillRun(eng, reqs, list(range(P)), SEQ, BS, None)
        jeng = _j_engine(pair, prefill_chunk=BS, prefill_pack=P)
        jrun = JRun(jeng, [JRequest(uid=i, prompt=p, max_new_tokens=1)
                           for i, p in enumerate(prompts[:P])],
                    list(range(P)), SEQ, BS, None)
        for r in (run, jrun):
            r.step()                    # begin
            r.step()                    # layer 0's layer_begin
        st = run._stage
        np.testing.assert_array_equal(st.masks.numpy(),
                                      np.asarray(jrun._masks))
        np.testing.assert_array_equal(st.gate.numpy(),
                                      np.asarray(jrun._gate))
        for f in ("use_shared", "use_dense", "use_vs"):
            np.testing.assert_array_equal(
                getattr(st.decision, f).numpy(),
                np.asarray(getattr(jrun._decision, f)))
        g = st.q.shape[1] // st.k.shape[1]
        assert (st.perm // g == torch.arange(st.q.shape[1]) // g).all()


# ------------------------------------------------------------ packing

def test_packed_masks_are_block_diagonal(pair):
    """After a packed run's first layer_begin, every staged head mask stays
    in the block diagonal: segment j never attends segment i's blocks."""
    eng = _engine(pair, prefill_chunk=BS, prefill_pack=2)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=1)
            for i, p in enumerate(pair["prompts"][:2])]
    run = ChunkedPrefillRun(eng, reqs, [0, 1], SEQ, BS, None)
    assert run.P == 2 and run.seg_blocks == SEQ // BS
    run.step()
    run.step()
    masks = run._stage.masks                      # (1, H, NB, NB)
    assert masks.shape[-1] == 2 * (SEQ // BS)
    seg = patterns.segment_block_mask(masks.shape[-1], run.seg_blocks)
    np.testing.assert_array_equal(
        seg.numpy(), np.asarray(jpat.segment_block_mask(masks.shape[-1],
                                                        run.seg_blocks)))
    assert masks.any() and not (masks & ~seg).any()


def test_packed_decode_keep_blocks_match_reference(pair):
    """Per-segment keep-sets of a packed dictionary equal the reference's
    on the same dictionary, and the plan rows cut from them stay inside the
    segment's own slot."""
    jeng = _j_engine(pair, prefill_chunk=2 * BS, prefill_pack=2)
    jrun = JRun(jeng, [JRequest(uid=i, prompt=p, max_new_tokens=1)
                       for i, p in enumerate(pair["prompts"][:2])],
                [0, 1], SEQ, 2 * BS, None)
    _drive(jrun)
    cfg, seg = pair["cfg"], SEQ // BS
    state = _j_state(jrun.sp_state)
    nb = (SEQ + 2 * BS) // BS
    for j in range(2):
        kw = dict(num_segs=2, seg_blocks=seg, segment=j)
        mine = sparse_decode.packed_decode_keep_blocks(
            pair["sp"], state, cfg.num_layers, cfg.num_heads, **kw)
        ref = jsd.packed_decode_keep_blocks(
            pair["jsp"], jrun.sp_state, cfg.num_layers, cfg.num_heads, **kw)
        assert mine.shape == (cfg.num_layers, 1, cfg.num_heads, seg)
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
        plan = dplan.build_decode_plan(pair["sp"], state, cfg,
                                       prefill_len=SEQ,
                                       cache_len=SEQ + 2 * BS,
                                       keep_blocks=mine)
        jplan = jdplan.build_decode_plan(pair["jsp"], jrun.sp_state,
                                         pair["jm"].cfg, prefill_len=SEQ,
                                         cache_len=SEQ + 2 * BS,
                                         keep_blocks=ref)
        for a, b in zip(plan, jplan):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert plan.indices.shape[-1] == nb and int(plan.indices.max()) < nb


def test_layer_inserts_place_each_segment(pair):
    """A packed layer's K/V lands segment by segment at the start of each
    slot's row (contiguous) and in each slot's pages (paged), in place."""
    rng = np.random.default_rng(3)
    hkv, hd, L = 2, 8, 3
    k, v = (torch.from_numpy(rng.standard_normal((1, hkv, 2 * SEQ, hd))
                             .astype(np.float32)) for _ in range(2))
    cache = (torch.zeros(L, 2, hkv, SEQ + BS, hd),
             torch.zeros(L, 2, hkv, SEQ + BS, hd))
    for j in range(2):
        out = ServingEngine.cache_insert_layer(cache, 1, 1 - j, k, v,
                                               offset=j * SEQ, length=SEQ)
        assert out is cache
        assert torch.equal(cache[0][1, 1 - j, :, :SEQ],
                           k[0, :, j * SEQ:(j + 1) * SEQ])
        assert torch.equal(cache[1][1, 1 - j, :, :SEQ],
                           v[0, :, j * SEQ:(j + 1) * SEQ])
    assert not cache[0][[0, 2]].any() and not cache[0][:, :, :, SEQ:].any()

    pool = (torch.zeros(L, 12, hkv, BS, hd), torch.zeros(L, 12, hkv, BS, hd))
    pages = [np.array([3, 7, 1, 9]), np.array([2, 11, 5, 4])]
    for j in range(2):
        paged_cache.insert_prefill_layer(pool, 2, k, v, pages[j],
                                         offset=j * SEQ, length=SEQ)
        seg = k[0, :, j * SEQ:(j + 1) * SEQ]
        got = torch.cat([pool[0][2, p] for p in pages[j]], dim=1)
        assert torch.equal(got, seg)
    assert not pool[0][:2].any()


# ------------------------------------------------ scheduler conformance

def _margins(pair, prompt, tokens, upto):
    """The reference's top-2 margins of one request served alone one-shot
    at steps 0..upto, teacher-forced on ``tokens``."""
    jm, jp, sp = pair["jm"], pair["jp"], pair["jsp"]
    toks = np.zeros((1, SEQ), np.int32)
    toks[0, :len(prompt)] = prompt
    plens = jnp.asarray([len(prompt)], jnp.int32)
    res = jm.prefill(jp, jnp.asarray(toks), sp, method="share",
                     attn_impl="sparse", prompt_lens=plens)
    extra = 128
    cache = {"prefix": [], "stack": tuple(
        jnp.pad(c, ((0, 0),) * 3 + ((0, extra), (0, 0)))
        for c in res.cache["stack"])}
    plan = jdplan.build_decode_plan(sp, res.sp_state, jm.cfg,
                                    prefill_len=SEQ, cache_len=SEQ + extra)
    logits, margins = res.last_logits, []
    for t in range(upto + 1):
        top2 = np.sort(np.asarray(logits)[0])[-2:]
        margins.append(float(top2[1] - top2[0]))
        if t == upto:
            break
        logits, cache = jm.decode(
            jp, jnp.asarray([[tokens[t]]], jnp.int32), cache,
            jnp.int32(SEQ + t), plan=plan, prompt_lens=plens,
            prefill_len=SEQ, decode_impl="kernel")
    return margins


CASES = {
    "chunked": dict(prefill_chunk=BS),
    "chunked+packed": dict(prefill_chunk=2 * BS, prefill_pack=2),
    "paged_chunked+packed": dict(prefill_chunk=3 * BS, prefill_pack=2,
                                 paged=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_chunked_scheduler_matches_oneshot_and_reference(pair, name):
    """Chunked (and packed) admission interleaves quanta with decode steps
    and refills, yet every request's greedy tokens equal the reference's
    chunked serve's (near-tie aware), and a solo chunked serve's equal the
    port's one-shot scheduler's with the same plan traffic; the phase
    clocks come back populated.  A packed run shares one pattern
    dictionary across its segments (the documented trade-off of packing),
    so its masks, and here request 1's first token (one-shot margin
    1.6e-2), may differ from a solo prefill's, in the reference as in the
    port: it is held to the reference's packed serve only."""
    kw = CASES[name]
    packed = kw.get("prefill_pack", 1) > 1
    paged = dict(paged=True) if kw.get("paged") else {}
    outs = {}
    for tag, ekw in (("oneshot", paged), ("chunk", kw)):
        eng = _engine(pair, decode_sparse=True, **ekw)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=m)
                for i, (p, (_, m)) in enumerate(zip(pair["prompts"], SPECS))]
        eng.serve(reqs, seed=0)
        outs[tag] = reqs
        assert eng.phase_s["prefill"] > 0 and eng.phase_s["decode"] > 0
        for r in reqs:
            assert r.state == "done" and r.finish_reason == "length"
            assert len(r.output_tokens) == r.max_new_tokens
    for a, b in zip(outs["oneshot"], outs["chunk"]):
        if not packed:
            np.testing.assert_array_equal(a.output_tokens, b.output_tokens)
            assert a.pattern_stats == b.pattern_stats

    jeng = _j_engine(pair, decode_sparse=True, **kw)
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=m)
             for i, (p, (_, m)) in enumerate(zip(pair["prompts"], SPECS))]
    jeng.serve(jreqs, seed=0)
    for i, (r, g) in enumerate(zip(jreqs, outs["chunk"])):
        a, b = r.output_tokens.tolist(), g.output_tokens.tolist()
        flip = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y),
                    None)
        if flip is None:
            assert a == b
            continue
        m = _margins(pair, pair["prompts"][i], a, flip)
        print(f"request {i}: flip at token {flip}, margin {m[flip]:.3e}")
        assert m[flip] < TIE_TOL


def test_packing_leaves_oneshot_in_the_reference_too(pair):
    """Why packed serves are held to the reference's packed serve and not
    to one-shot: on these prompts the reference's OWN packed serve leaves
    its own one-shot serve, at a top-2 margin well above ``TIE_TOL`` (no
    near tie), because the packed run's shared strip and dictionary change
    the masks.  The port's packed serve leaves the port's one-shot serve at
    the same requests and steps."""
    def serve(make, request, **kw):
        eng = make(pair, decode_sparse=True, **kw)
        reqs = [request(uid=i, prompt=p, max_new_tokens=m)
                for i, (p, (_, m)) in enumerate(zip(pair["prompts"], SPECS))]
        eng.serve(reqs, seed=0)
        return [r.output_tokens.tolist() for r in reqs]

    def flips(a, b):
        return {i: next(t for t, (x, y) in enumerate(zip(s, u)) if x != y)
                for i, (s, u) in enumerate(zip(a, b)) if s != u}

    packed = CASES["chunked+packed"]
    jone = serve(_j_engine, JRequest)
    ref = flips(jone, serve(_j_engine, JRequest, **packed))
    mine = flips(serve(_engine, Request), serve(_engine, Request, **packed))
    print(f"reference: packed leaves one-shot at {ref}; port: {mine}")
    assert ref and mine == ref
    for i, t in ref.items():
        m = _margins(pair, pair["prompts"][i], jone[i], t)[t]
        print(f"request {i}: reference one-shot margin {m:.3e} at {t}")
        assert m >= TIE_TOL


def test_chunked_admission_into_a_slot_of_another_bucket(pair, monkeypatch):
    """Paged, two buckets: a short request leaves slot 1 at a decode
    position inside the long bucket's prompt, and a long chunked admission
    reuses the slot while slot 0 decodes.  The decode steps between its
    quanta append slot 1's inert K/V; none of it may land on the admitted
    prompt: every layer's K/V at completion is bitwise the one-shot
    prefill's, and every request's tokens equal the one-shot paged
    serve's."""
    rng = np.random.default_rng(7)
    vocab = pair["cfg"].vocab_size
    specs = ((100, 40), (120, 2), (250, 3))     # A decodes, B leaves, C in
    prompts = [rng.integers(0, vocab, n) for n, _ in specs]
    seen = {}
    complete = SlotScheduler._complete_run

    def completed(self, run):
        if run.seq == SEQ:
            pages = self.slot_pages[run.slot_ids[0]][: SEQ // BS]
            seen["kv"] = [[torch.cat([pool[li, p] for p in pages], dim=1)
                           for li in range(pool.shape[0])]
                          for pool in self.cache]
        seen.setdefault("slots", []).append((run.seq, run.slot_ids[0]))
        complete(self, run)

    monkeypatch.setattr(SlotScheduler, "_complete_run", completed)
    outs = {}
    for chunk in (0, BS):
        eng = _engine(pair, decode_sparse=True, paged=True,
                      seq_buckets=(2 * BS, SEQ), prefill_chunk=chunk)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=m)
                for i, (p, (_, m)) in enumerate(zip(prompts, specs))]
        eng.serve(reqs, seed=0)
        outs[chunk] = [r.output_tokens.tolist() for r in reqs]
        assert all(r.finish_reason == "length" for r in reqs)
    # the long run went into the slot the short request left
    assert seen["slots"] == [(2 * BS, 0), (2 * BS, 1), (SEQ, 1)]
    assert outs[BS] == outs[0]
    res = _oneshot(pair, prompts[2], "auto")
    for got, want in zip(seen["kv"], res.cache):
        for li, x in enumerate(got):
            assert torch.equal(x, want[li][0]), f"layer {li}"


def test_prefill_stall_metric(pair):
    """The first admission runs against idle slots (no stall); one admitted
    into a live decode records the decode time it displaced, at most its
    own prefill time."""
    eng = _engine(pair, decode_sparse=True, prefill_chunk=BS)
    reqs = [Request(uid=i, prompt=pair["prompts"][i], max_new_tokens=m)
            for i, m in enumerate((8, 8, 4))]
    eng.serve(reqs, seed=0)
    assert reqs[0].prefill_stall_s == 0.0
    assert reqs[2].prefill_stall_s > 0.0
    assert reqs[2].prefill_stall_s <= reqs[2].prefill_s + 1e-9
    assert all(r.ttft_s >= r.prefill_s > 0 for r in reqs)


def test_run_failure_quarantines_the_run(pair, monkeypatch):
    """A quantum that raises fails every segment of its run, returns its
    pages, and the serve goes on with the next requests."""
    eng = _engine(pair, decode_sparse=True, prefill_chunk=2 * BS,
                  prefill_pack=2, paged=True)
    real = ChunkedPrefillRun.step

    def step(self):
        if self.quanta_done == 3 and self.requests[0].uid == 0:
            raise RuntimeError("injected")
        return real(self)
    monkeypatch.setattr(ChunkedPrefillRun, "step", step)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=m)
            for i, (p, (_, m)) in enumerate(zip(pair["prompts"], SPECS))]
    eng.serve(reqs, seed=0)
    assert [r.finish_reason for r in reqs] == ["failed", "failed", "length",
                                               "length"]
    assert all("injected" in str(r.error) for r in reqs[:2])
    assert all(len(r.output_tokens) == r.max_new_tokens for r in reqs[2:])


# ----------------------------------------------------- admission gating

def test_chunk_tokens_gating_matches_reference(pair):
    """``_chunk_tokens``: off, misaligned and per-sample configs admit
    one-shot; enabled ones round the chunk up to whole blocks and cap it at
    the bucket, as the reference's do."""
    cases = [(dict(prefill_chunk=BS), SEQ), (dict(prefill_chunk=BS), SEQ + 1),
             (dict(), SEQ), (dict(prefill_chunk=BS + 1), SEQ),
             (dict(prefill_chunk=BS + 1), BS),
             (dict(prefill_chunk=BS, attn_impl="kernel"), SEQ),
             (dict(prefill_chunk=BS, attn_impl="chunked"), SEQ)]
    got = [_engine(pair, **kw)._chunk_tokens(seq) for kw, seq in cases]
    ref = [_j_engine(pair, **kw)._chunk_tokens(seq) for kw, seq in cases]
    assert got == ref == [BS, 0, 0, 2 * BS, BS, 0, BS]
    nochunk = ServingEngine(
        dataclasses.replace(pair["tm"], prefill_chunk=False), pair["tp"],
        pair["sp"], EngineConfig(prefill_chunk=BS, seq_buckets=(SEQ,)))
    assert nochunk._chunk_tokens(SEQ) == 0     # a model it cannot serve


@pytest.mark.parametrize("chunk", [0, BS], ids=["oneshot", "chunked"])
def test_sparse_fallback_is_per_request(pair, monkeypatch, chunk):
    """An admission with no pattern dictionary gets the all-keep dense plan
    row; later admissions keep sparse rows."""
    eng = _engine(pair, decode_sparse=True, prefill_chunk=chunk)
    state = {"first": True}
    if chunk == 0:
        real = eng.model.prefill

        class Model:
            def __getattr__(self, name):
                return getattr(pair["tm"], name)

            def prefill(self, *a, **kw):
                res = real(*a, **kw)
                if state["first"]:
                    state["first"] = False
                    res = res._replace(sp_state=None)
                return res
        eng.model = Model()
    else:
        real_step = ChunkedPrefillRun.step

        def step(self):
            ev = real_step(self)
            if ev == "done" and state["first"]:
                state["first"] = False
                self.sp_state = None
            return ev
        monkeypatch.setattr(ChunkedPrefillRun, "step", step)
    calls = {"dense": 0, "sparse": 0}
    real_dense, real_build = dplan.dense_decode_plan, dplan.build_decode_plan

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(dplan, "dense_decode_plan", count("dense",
                                                          real_dense))
    monkeypatch.setattr(dplan, "build_decode_plan", count("sparse",
                                                          real_build))
    reqs = [Request(uid=i, prompt=pair["prompts"][i], max_new_tokens=4)
            for i in range(3)]
    sched = SlotScheduler(eng, reqs, SEQ, seed=0)
    sched.run()
    assert sched.use_sparse
    assert calls == {"dense": 1, "sparse": 2}
    assert all(len(r.output_tokens) == 4 for r in reqs)


def test_chunked_options_need_no_refusal():
    cfg = EngineConfig(prefill_chunk=128, prefill_pack=2)
    assert (cfg.prefill_chunk, cfg.prefill_pack) == (128, 2)
    # no option of the engine is refused any more (the refusal table went
    # with A.9's last slice)
    assert not hasattr(tengine, "_NOT_PORTED")


# ------------------------------------- dense attention under block masks

@pytest.mark.parametrize("kw", [
    dict(), dict(causal=False), dict(window=100, sink=20),
    dict(q_offset=64), dict(q_offset=64, window=100)],
    ids=["causal", "full", "window_sink", "offset", "offset_window"])
def test_masked_chunked_attention_matches_reference(kw):
    """Output and Ã with a block mask and stats, at an offset (a 2-block q
    chunk of a 4-block prefix) or suffix-aligned, with windows and sinks."""
    rng = np.random.default_rng(5)
    b, h, nkv, d, bs = 2, 3, 256, 16, 64
    n = 128 if "q_offset" in kw else nkv
    q = rng.standard_normal((b, h, n, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, h, nkv, d)).astype(np.float32)
            for _ in range(2))
    mask = rng.random((b, h, n // bs, nkv // bs)) < 0.7
    mask[0, 1, 0] = False                          # an empty row
    ref = jchunk.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_size=bs,
        block_mask=jnp.asarray(mask), collect_stats=True, **kw)
    got = chunked.chunked_attention(T(q), T(k), T(v), block_size=bs,
                                    block_mask=T(mask), collect_stats=True,
                                    **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               atol=1e-5, rtol=0)
    ra, ga = np.asarray(ref[1]), got[1].numpy()
    np.testing.assert_array_equal(np.isneginf(ga), np.isneginf(ra))
    fin = np.isfinite(ra)
    np.testing.assert_allclose(ga[fin], ra[fin], atol=1e-5, rtol=0)
    # the unmasked form, and a chunk of it at its offset: bitwise the rows
    full = chunked.chunked_attention(T(q), T(k), T(v), block_size=bs)
    off = nkv - n
    part = chunked.chunked_attention(T(q[:, :, bs:]), T(k), T(v),
                                     block_size=bs, q_offset=off + bs)
    assert torch.equal(part, full[:, :, bs:])


def test_chunked_attention_fn_matches_reference():
    """The per-sample AttentionFn of ``attn_impl="chunked"``: GQA K/V
    expanded, every head's Ã."""
    rng = np.random.default_rng(6)
    h, hkv, n, d, bs = 4, 2, 256, 16, 64
    q = rng.standard_normal((h, n, d)).astype(np.float32)
    k, v = (rng.standard_normal((hkv, n, d)).astype(np.float32)
            for _ in range(2))
    mask = (rng.random((h, n // bs, n // bs)) < 0.7) & np.tril(
        np.ones((n // bs, n // bs), bool))
    ro, ra = jchunk.chunked_attention_fn(block_size=bs)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask))
    go, ga = chunked.chunked_attention_fn(block_size=bs)(T(q), T(k), T(v),
                                                         T(mask))
    np.testing.assert_allclose(go.numpy(), np.asarray(ro), atol=1e-5, rtol=0)
    ra = np.asarray(ra)
    np.testing.assert_array_equal(np.isneginf(ga.numpy()), np.isneginf(ra))
    fin = np.isfinite(ra)
    np.testing.assert_allclose(ga.numpy()[fin], ra[fin], atol=1e-5, rtol=0)


def test_block_helpers_match_reference():
    for n, nkv, bs in ((256, 256, 64), (300, 200, 128), (257, 257, 64)):
        assert chunked.largest_divisor_block(n, nkv, bs) == \
            jchunk.largest_divisor_block(n, nkv, bs)
    for nb, w, sink in ((8, 3, 1), (6, 2, 0)):
        np.testing.assert_array_equal(
            patterns.sliding_window_block_mask(nb, w, sink).numpy(),
            np.asarray(jpat.sliding_window_block_mask(nb, w, sink)))
    with pytest.raises(ValueError, match="does not tile"):
        patterns.segment_block_mask(6, 4)

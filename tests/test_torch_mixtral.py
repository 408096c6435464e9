"""Mixtral in the port (the MoE FFN and sliding-window attention, ROADMAP.md
A.10's first slice) against the JAX package's.

Both packages run mixtral-8x22b's smoke config (2 layers, 4 experts top 2,
window 128 tokens, block 64) from the same parameters (the reference's,
through ``checkpoint.params_from_numpy``), and a GQA variant the test
builds (8 query heads over 2 kv heads: the smoke config has G = 1), at
SEQ 256 (4 blocks: the window keeps 2 diagonals and the sink column).

  * layer 0's masks (the window's block mask ANDed in), decisions, head
    permutation and the B.2 index tables of a chunked run **exactly**
    (GQA), and the DecodePlan tables of a whole prefill **exactly**;
  * one-shot (batched sparse path), per-sample (``attn_impl="kernel"``),
    dense (token window) and chunked prefill logits within 1e-4 of the
    reference's (K/V 1e-4, stats 1e-6); the port's chunked run bitwise its
    one-shot prefill;
  * windowed decode with a plan, paged (G = 1) and contiguous (GQA),
    within 1e-4 of the reference's steps, at positions where the window
    hides whole kept blocks;
  * a greedy paged scheduler serve near-tie aware; ``_pack_limit`` 1;
  * the traced prefill (``core/profile.py``) through the MoE FFN, stats
    1e-6 and logits 1e-4.

The witness: a chunked MoE prefill routes its FFN over the whole row in
each layer's last quantum, the one-shot prefill's groups, so the
reference's own chunked run is bitwise its one-shot prefill, as the
port's is.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import profile as jprofile
from repro.core.patterns import sliding_window_block_mask as j_window
from repro.kernels import indices as jind
from repro.serving import decode_plan as jdplan
from repro.serving.chunked_prefill import ChunkedPrefillRun as JRun
from repro_torch.core import profile
from repro_torch.kernels import indices as tind
from repro_torch.models.attention import extra_block_mask
from repro_torch.serving import ServingEngine
from repro_torch.serving import decode_plan as dplan
from repro_torch.serving.chunked_prefill import ChunkedPrefillRun

from torch_serving_helpers import (JRequest, MarginRecorder, Request,
                                   assert_greedy_agree, make_pair,
                                   one_torch_thread, page_leak_audit,
                                   port_engine, ref_engine, requests)

torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "mixtral-8x22b"
SEQ, BS = 256, 64
PLENS = np.array([256, 230])
T = lambda a: torch.from_numpy(np.array(a))
GQA = dict(num_heads=8, num_kv_heads=2)


_PAIRS = {}


@pytest.fixture
def pair(request):
    """The G1 pair, or the one a test's ``g`` parameter names."""
    name = getattr(request, "param", "G1")
    if name not in _PAIRS:
        _PAIRS[name] = _make(name)
    return _PAIRS[name]


def _make(name):
    p = make_pair(ARCH, **({} if name == "G1" else GQA))
    cfg = p["cfg"]
    assert cfg.sliding_window == 128 and cfg.share_prefill.block_size == BS
    assert cfg.moe.enabled
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, SEQ))
    jm, tm = p["jm"], p["tm"]
    jsp, tsp = jm.default_share_prefill(), tm.default_share_prefill()
    jr = jm.prefill(p["jp"], jnp.asarray(toks, jnp.int32), jsp,
                    method="share", attn_impl="sparse",
                    prompt_lens=jnp.asarray(PLENS, jnp.int32))
    tr = tm.prefill(p["tp"], T(toks), tsp, method="share",
                    prompt_lens=T(PLENS))
    p.update(toks=toks, jsp=jsp, tsp=tsp, jr=jr, tr=tr)
    return p


@pytest.mark.parametrize("pair", ["G4"], indirect=True)
def test_window_masks_decisions_and_tables_match_reference(pair):
    """Layer 0's staged masks of a chunked run of both packages (the
    reference's jitted quanta, shared with the chunked test)."""
    cfg = pair["cfg"]
    nb = SEQ // BS
    extra = extra_block_mask(cfg, nb, BS)
    assert torch.equal(extra, T(j_window(nb, cfg.sliding_window // BS)))
    kw = dict(max_batch=2, seq_buckets=(SEQ,), paged=True,
              prefill_chunk=3 * BS, attn_impl="sparse")
    prompt = pair["toks"][1][: PLENS[1]]
    run = ChunkedPrefillRun(port_engine(pair, **kw),
                            [Request(uid=0, prompt=prompt)], [0], SEQ,
                            3 * BS, None)
    jrun = JRun(ref_engine(pair, **kw), [JRequest(uid=0, prompt=prompt)],
                [0], SEQ, 3 * BS, None)
    for r in (run, jrun):
        r.step()                        # begin
        r.step()                        # layer 0's layer_begin
    st = run._stage
    np.testing.assert_array_equal(st.masks.numpy(), np.asarray(jrun._masks))
    for f in ("use_shared", "use_dense", "use_vs"):
        np.testing.assert_array_equal(getattr(st.decision, f).numpy(),
                                      np.asarray(getattr(jrun._decision, f)))
    np.testing.assert_array_equal(st.gate.numpy(), np.asarray(jrun._gate))
    np.testing.assert_array_equal(st.perm.numpy(), np.asarray(jrun._perm))
    # the window hides blocks of every head: the masks are sparse
    assert not bool((st.masks & ~extra).any())
    causal = torch.ones(nb, nb, dtype=torch.bool).tril()
    assert float(st.masks.float().mean()) < float(causal.float().mean())
    for a, b in zip(tind.compact_block_mask(st.masks),
                    jind.compact_block_mask(jrun._masks)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("pair", ["G1", "G4"], indirect=True)
def test_decode_plan_tables_match_reference(pair):
    """A whole windowed prefill's DecodePlan tables, exactly."""
    cfg, tsp, jsp, jm = pair["cfg"], pair["tsp"], pair["jsp"], pair["jm"]
    cache_len = SEQ + 2 * BS
    mine = dplan.build_decode_plan(tsp, pair["tr"].sp_state, cfg,
                                   prefill_len=SEQ, cache_len=cache_len)
    ref = jdplan.build_decode_plan(jsp, pair["jr"].sp_state, jm.cfg,
                                   prefill_len=SEQ, cache_len=cache_len)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("impl", ["auto", "kernel", "dense"])
@pytest.mark.parametrize("pair", ["G1", "G4"], indirect=True)
def test_prefill_matches_reference(pair, impl):
    jr = pair["jr"]
    if impl == "auto":
        tr = pair["tr"]
    else:
        method, attn = (("dense", "auto") if impl == "dense"
                        else ("share", impl))
        tr = pair["tm"].prefill(pair["tp"], T(pair["toks"]), pair["tsp"],
                                method=method, attn_impl=attn,
                                prompt_lens=T(PLENS))
        if impl == "dense":
            jr = pair["jm"].prefill(
                pair["jp"], jnp.asarray(pair["toks"], jnp.int32),
                pair["jsp"], method="dense",
                prompt_lens=jnp.asarray(PLENS, jnp.int32))
        else:
            for a, b in zip(tr, pair["tr"]):     # the batched path's
                if isinstance(a, torch.Tensor):
                    np.testing.assert_allclose(a.numpy(), b.numpy(),
                                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(tr.last_logits.numpy(),
                               np.asarray(jr.last_logits), atol=1e-4, rtol=0)
    for i in range(2):
        np.testing.assert_allclose(tr.cache[i].numpy(),
                                   np.asarray(jr.cache["stack"][i]),
                                   atol=1e-4, rtol=1e-4)
    for a, b in zip(tr.stats, jr.stats):
        np.testing.assert_allclose(float(a), float(b), atol=1e-6)
    if impl != "dense":
        assert float(tr.stats.block_density) < 1.0    # the window's skips


def _run(eng, cls, prompt, chunk):
    run = cls(eng, [Request(uid=0, prompt=prompt, max_new_tokens=1)
                    if cls is ChunkedPrefillRun else
                    JRequest(uid=0, prompt=prompt, max_new_tokens=1)],
              [0], SEQ, chunk, None)
    kvs = {}
    while not run.done:
        if run.step() == "kv":
            kvs[run.kv_layer] = run.kv
    return run, kvs


@pytest.mark.parametrize("pair,chunk", [("G1", BS), ("G4", 3 * BS)],
                         indirect=["pair"])
def test_chunked_prefill_matches_oneshot_and_reference(pair, chunk):
    prompt = pair["toks"][1][: PLENS[1]]
    kw = dict(max_batch=2, seq_buckets=(SEQ,), paged=True,
              prefill_chunk=chunk, attn_impl="sparse")
    run, kvs = _run(port_engine(pair, **kw), ChunkedPrefillRun, prompt,
                    chunk)
    toks = torch.zeros((1, SEQ), dtype=torch.long)
    toks[0, :len(prompt)] = T(prompt)
    one = pair["tm"].prefill(pair["tp"], toks, pair["tsp"],
                             prompt_lens=torch.tensor([len(prompt)]))
    assert torch.equal(run.logits, one.last_logits)
    for li, (k, v) in kvs.items():
        assert torch.equal(k, one.cache[0][li])
        assert torch.equal(v, one.cache[1][li])
    jrun, jkvs = _run(ref_engine(pair, **kw), JRun, prompt, chunk)
    np.testing.assert_allclose(run.logits.numpy(), np.asarray(jrun.logits),
                               atol=1e-4, rtol=0)
    for li, (k, v) in kvs.items():
        np.testing.assert_allclose(k.numpy(), np.asarray(jkvs[li][0]),
                                   atol=1e-4, rtol=0)


def test_chunked_moe_routes_the_oneshot_groups_in_the_reference_too(pair):
    """The witness: the reference's chunked MoE prefill is bitwise its own
    one-shot prefill (each layer's FFN runs over the whole row in the
    run's last quantum of the layer: 512-token groups, capacity 320 at
    4 experts top 2, as one-shot), so chunked = one-shot holds for the
    MoE family as it does for the dense one."""
    from repro.models import moe as jmoe
    prompt = pair["toks"][1][: PLENS[1]]
    kw = dict(max_batch=2, seq_buckets=(SEQ,), paged=True,
              prefill_chunk=BS, attn_impl="sparse")
    jrun, _ = _run(ref_engine(pair, **kw), JRun, prompt, BS)
    toks = np.zeros((1, SEQ), np.int32)
    toks[0, :len(prompt)] = prompt
    one = pair["jm"].prefill(pair["jp"], jnp.asarray(toks), pair["jsp"],
                             method="share", attn_impl="sparse",
                             prompt_lens=jnp.asarray([len(prompt)]))
    np.testing.assert_array_equal(np.asarray(jrun.logits),
                                  np.asarray(one.last_logits))
    assert jmoe._group_size(SEQ) == SEQ
    assert jmoe._capacity(SEQ, pair["jm"].cfg) == 160


def _grown(pair, extra):
    jcache = {"prefix": [], "stack": tuple(
        jnp.pad(c, ((0, 0),) * 3 + ((0, extra), (0, 0)))
        for c in pair["jr"].cache["stack"])}
    tcache = ServingEngine.grow_cache(
        tuple(c.clone() for c in pair["tr"].cache), SEQ, extra)
    return jcache, tcache


def _plans(pair, cache_len):
    j = jdplan.build_decode_plan(pair["jsp"], pair["jr"].sp_state,
                                 pair["jm"].cfg, prefill_len=SEQ,
                                 cache_len=cache_len)
    t = dplan.build_decode_plan(pair["tsp"], pair["tr"].sp_state,
                                pair["cfg"], prefill_len=SEQ,
                                cache_len=cache_len)
    return j, t


@pytest.mark.parametrize("pair,paged", [("G1", True), ("G4", False)],
                         indirect=["pair"], ids=["G1-paged", "G4-contiguous"])
def test_windowed_decode_matches_reference(pair, paged):
    """Two decode steps with the plan: the window (128) hides the first
    ~128 prompt tokens, so kept blocks the band hides wholly (blocks 0 and
    1) stream and weigh nothing."""
    jm, tm = pair["jm"], pair["tm"]
    extra = 2 * BS
    total = SEQ + extra
    jcache, tcache = _grown(pair, extra)
    jplan, tplan = _plans(pair, total)
    keep_blocks = tplan.indices.shape[-1]
    assert keep_blocks > (total - pair["cfg"].sliding_window) // BS
    table = None
    if paged:
        nb = total // BS
        table = (1 + np.random.default_rng(5).permutation(2 * nb + 2)
                 [: 2 * nb]).reshape(2, nb).astype(np.int32)
        pools = []
        for x in tcache:
            x = x.numpy()
            pool = np.zeros((x.shape[0], 2 * nb + 3) + x.shape[2:3] + (BS,)
                            + x.shape[4:], np.float32)
            tiles = x.reshape(x.shape[0], 2, x.shape[2], nb, BS, x.shape[4])
            pool[:, table.reshape(-1)] = np.moveaxis(tiles, 3, 2).reshape(
                x.shape[0], 2 * nb, x.shape[2], BS, x.shape[4])
            pools.append(pool)
        jcache = {"prefix": [], "stack": tuple(jnp.asarray(p)
                                               for p in pools)}
        tcache = tuple(T(p) for p in pools)
    tok = np.asarray(pair["jr"].last_logits).argmax(-1)[:, None]
    for t in range(2):
        pos = np.full((2,), SEQ + t, np.int32)
        kw = dict(prompt_lens=T(PLENS), plan=tplan)
        jkw = dict(prompt_lens=jnp.asarray(PLENS, jnp.int32), plan=jplan,
                   decode_impl="kernel")
        if paged:
            kw.update(prefill_len=T([SEQ, SEQ]), page_table=T(table))
            jkw.update(prefill_len=jnp.asarray([SEQ, SEQ], jnp.int32),
                       page_table=jnp.asarray(table))
            tpos, jpos = T(pos).long(), jnp.asarray(pos)
        else:
            kw.update(prefill_len=SEQ)
            jkw.update(prefill_len=SEQ)
            tpos, jpos = SEQ + t, jnp.int32(SEQ + t)
        jl, jcache = jm.decode(pair["jp"], jnp.asarray(tok, jnp.int32),
                               jcache, jpos, **jkw)
        tl, tcache = tm.decode(pair["tp"], T(tok).long(), tcache, tpos, **kw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        tok = np.asarray(jl).argmax(-1)[:, None]
    # the window is what the step applied: without it the logits move
    nowin = tm.decode(pair["tp"], T(tok).long(),
                      tuple(c.clone() for c in tcache), tpos, window=10 ** 6,
                      **kw)[0]
    assert not torch.allclose(nowin, tl, atol=1e-3)


def test_greedy_paged_serve_matches_reference(pair):
    vocab = pair["cfg"].vocab_size
    kw = dict(max_batch=2, seq_buckets=(SEQ,), paged=True,
              decode_sparse=True)
    rec = MarginRecorder()
    jr, tr = (requests(cls, vocab, (5, 3, 4), seq=SEQ)
              for cls in (JRequest, Request))
    for r in (jr[2], tr[2]):
        r.prompt = r.prompt[:200]       # right-padded in its bucket
    ref_engine(pair, **kw).serve(jr, seed=0, faults=rec)
    teng = port_engine(pair, **kw)
    teng.serve(tr, seed=0)
    assert all(r.finish_reason == "length" for r in tr)
    assert_greedy_agree(jr, tr, rec.margins)


def test_pack_limit_is_one_with_a_window(pair):
    kw = dict(max_batch=2, seq_buckets=(SEQ,), paged=True, prefill_chunk=BS,
              prefill_pack=2)
    from repro.serving.scheduler import SlotScheduler as JSched
    from repro_torch.serving import SlotScheduler
    reqs = requests(Request, pair["cfg"].vocab_size, (2, 2), seq=SEQ)
    sched = SlotScheduler(port_engine(pair, **kw), reqs, SEQ, paged=True)
    assert sched._pack_limit(SEQ) == 1
    jsched = JSched(ref_engine(pair, **kw),
                    requests(JRequest, pair["cfg"].vocab_size, (2, 2),
                             seq=SEQ), SEQ, paged=True)
    assert jsched._pack_limit(SEQ) == 1
    # the same engine without the window would pack two
    tm = pair["tm"]
    nowin = dataclasses.replace(tm.cfg, sliding_window=0)
    eng = ServingEngine(dataclasses.replace(tm, cfg=nowin), pair["tp"],
                        tm.default_share_prefill(),
                        port_engine(pair, **kw).ecfg)
    assert SlotScheduler(eng, reqs, SEQ, paged=True)._pack_limit(SEQ // 2) \
        == 2


def test_traced_prefill_takes_the_moe_ffn(pair):
    toks = pair["toks"][:1, :128]
    jt = jprofile.run_prefill_traced(pair["jp"], pair["jm"].cfg,
                                     jnp.asarray(toks, jnp.int32),
                                     pair["jsp"])
    tt = profile.run_prefill_traced(pair["tp"], pair["cfg"], T(toks),
                                    pair["tsp"])
    np.testing.assert_allclose(tt.last_logits, jt.last_logits, atol=1e-4,
                               rtol=0)
    for a, b in zip(tt.per_layer, jt.per_layer):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-6)

"""The port's block-paged KV cache, plan row helpers and paged / per-slot
decode against the JAX package's.

Exact: the page allocator over one scripted acquire/share/release sequence
(ids, errors, peak), its consistency audit, ``gather_pages``,
``insert_prefill``, the cache-op helpers and the scheduler's plan row
helpers.  Floats: the paged decode plain versions against the reference's
paged Pallas kernel in interpret mode on decode conformance cases scattered
into a shuffled pool (2e-5 in float32, 2e-2 in bfloat16, the conformance
suite's tolerances), and bitwise against the port's own contiguous path on
the same cache; one ``decode_step`` with per-slot positions bitwise against
the scalar step, and within 1e-4 of the reference's vector-``pos`` and
paged steps (two float32 layers summed in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten
from repro.configs import get_smoke_config as j_smoke
from repro.kernels.decode_attn import DecodePlan as JPlan
from repro.kernels.decode_attn import flash_decode_plan_paged as j_paged
from repro.kernels.decode_attn import gather_pages as j_gather
from repro.models.api import build_model as j_build
from repro.serving import cache_ops as jops
from repro.serving import decode_plan as jdplan
from repro.serving import paged_cache as jpc
from repro_torch import checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.decode_attn import (
    DecodePlan, decode_plan_einsum_paged, decode_plan_einsum_sliced_paged,
    flash_decode_plan, flash_decode_plan_paged,
    flash_decode_sparse_batched_paged, flash_decode_sparse_paged_cuda,
    gather_pages)
from repro_torch.models import build_model
from repro_torch.serving import cache_ops
from repro_torch.serving import decode_plan as dplan
from repro_torch.serving import paged_cache as pc
from test_decode_conformance import CASES, build_case

torch.backends.cuda.matmul.allow_tf32 = False

T = lambda a: torch.from_numpy(np.array(a))


def _cfgs():
    kw = dict(num_heads=8, num_kv_heads=2)
    return (dataclasses.replace(j_smoke("llama3-8b-262k"), **kw),
            dataclasses.replace(get_smoke_config("llama3-8b-262k"), **kw))


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


# ------------------------------------------------------------- allocator

def _script(mod):
    """One acquire/share/release sequence; every result or error, in
    order, plus the final peak and utilization."""
    a = mod.PageAllocator(9)
    log = []

    def do(fn, *args):
        try:
            out = fn(*args)
            log.append(("ok", None if out is None else np.asarray(out)
                        .tolist()))
        except ValueError as e:
            log.append((type(e).__name__, str(e)))

    first = a.acquire(3)
    do(lambda: first)
    do(a.acquire, 9)                       # more than the pool: None
    do(a.share, [int(first[0]), int(first[1])])
    do(a.release, [int(first[0])])         # refcount 2 → 1
    do(a.release, [int(first[1]), int(first[1]), int(first[1])])
    do(a.share, [0])                       # the null page
    do(a.share, [7])                       # free page
    do(a.release, [9])                     # out of range
    do(a.release, [int(first[2]), 0])      # bad id mid-list: nothing freed
    do(lambda: a.refcount(first[2]))
    do(a.release, [int(first[0]), int(first[1])])
    do(a.release, [int(first[1])])         # double free
    do(a.hold, 4)
    do(a.acquire, 2)
    do(a.hold, 10)                         # whatever is left
    do(a.hold, 1)                          # nothing left: empty
    do(a.free, [int(first[2])])
    do(a.alloc, 1)                         # recycled id
    do(a.check_consistency)
    log.append(("state", a.peak_in_use, a.free_pages, a.used_pages,
                a.utilization()))
    return log


def test_allocator_matches_reference_exactly():
    assert _script(pc) == _script(jpc)
    for mod in (pc, jpc):
        with pytest.raises(ValueError, match="null page"):
            mod.PageAllocator(1)


@pytest.mark.parametrize("corrupt", ["null_ref", "negative", "dup_free",
                                     "free_with_ref", "lost_page"])
def test_consistency_audit_matches_reference(corrupt):
    msgs = []
    for mod in (pc, jpc):
        a = mod.PageAllocator(6)
        a.acquire(2)
        if corrupt == "null_ref":
            a._refs[0] = 1
        elif corrupt == "negative":
            a._refs[4] = -1
        elif corrupt == "dup_free":
            a._free.append(a._free[0])
        elif corrupt == "free_with_ref":
            a._refs[a._free[0]] = 2
        else:
            a._free.pop()
        with pytest.raises(mod.PageAllocatorError) as err:
            a.check_consistency()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------------- pool and helpers

def test_gather_pages_and_insert_prefill_match_reference():
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(0)
    l, hkv, s, hd, ps = (tcfg.num_layers, tcfg.num_kv_heads, 128,
                         tcfg.resolved_head_dim, 64)
    new = [rng.standard_normal((l, 1, hkv, s, hd)).astype(np.float32)
           for _ in range(2)]
    pages = np.array([5, 2], np.int32)
    jpool = jpc.insert_prefill(
        jpc.init_paged_pool(jcfg, num_pages=7, page_size=ps),
        {"prefix": [], "stack": tuple(jnp.asarray(x) for x in new)}, pages)
    tpool = pc.insert_prefill(
        pc.init_paged_pool(tcfg, num_pages=7, page_size=ps),
        tuple(T(x) for x in new), pages)
    for a, b in zip(tpool, jpool["stack"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not tpool[0][:, [0, 1, 3, 4, 6]].any()      # untouched pages
    table = np.array([[5, 2, 0], [2, 0, 5]], np.int32)
    np.testing.assert_array_equal(
        gather_pages(tpool[0][1], T(table)).numpy(),
        np.asarray(j_gather(jpool["stack"][0][1], jnp.asarray(table))))
    assert pc.page_bytes(tcfg, ps) == jpc.page_bytes(jcfg, ps)
    assert pc.contiguous_kv_bytes(tcfg, 4, 640, 2) == \
        jpc.contiguous_kv_bytes(jcfg, 4, 640, 2)
    assert tpool[0].dtype == torch.float32
    bf = pc.init_paged_pool(tcfg, num_pages=3, page_size=ps,
                            dtype=torch.bfloat16)
    assert bf[0].shape == (l, 3, hkv, ps, hd) and bf[1].dtype == \
        torch.bfloat16


def test_init_paged_pool_rejects_mla():
    _, tcfg = _cfgs()
    mla = dataclasses.replace(tcfg, mla=dataclasses.replace(
        tcfg.mla, kv_lora_rank=64))
    with pytest.raises(ValueError, match="latent"):
        pc.init_paged_pool(mla, num_pages=4, page_size=64)


def test_cache_ops_match_reference():
    x = np.arange(2 * 8 * 8, dtype=np.float32).reshape(2, 8, 8)
    for shape in [(2, 8, 8), (2, 3, 8, 4), (2, 4, 3)]:
        assert cache_ops.seq_grow_pads(shape, 8, 4) == \
            jops.seq_grow_pads(shape, 8, 4)
    np.testing.assert_array_equal(cache_ops.grow_leaf(T(x), 8, 4).numpy(),
                                  np.asarray(jops.grow_leaf(x, 8, 4)))
    y = T(np.ones((2, 4, 3)))
    assert cache_ops.grow_leaf(y, 8, 4) is y
    assert cache_ops.grow_leaf("marker", 8, 4) == "marker"
    dst = np.zeros((3, 4, 2, 8, 5), np.float32)
    src = np.random.default_rng(1).standard_normal((1, 1, 2, 6, 5))
    np.testing.assert_array_equal(
        cache_ops.write_slot(T(dst), T(src.astype(np.float32)),
                             {0: 2, 1: 1}).numpy(),
        np.asarray(jops.write_slot(jnp.asarray(dst), jnp.asarray(src),
                                   {0: 2, 1: 1})))
    np.testing.assert_array_equal(
        cache_ops.slice_segment(T(x), 2, 3, axis=1).numpy(),
        np.asarray(jops.slice_segment(jnp.asarray(x), 2, 3, axis=1)))


# -------------------------------------------------------- plan row helpers

def _plan_pair(j, t):
    for f in ("indices", "counts", "keep_heads"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), f)


def test_empty_and_dense_plans_match_reference():
    jcfg, tcfg = _cfgs()
    _plan_pair(jdplan.empty_decode_plan(jcfg, batch=3, cache_len=384,
                                        block_size=64),
               dplan.empty_decode_plan(tcfg, batch=3, cache_len=384,
                                       block_size=64))
    _plan_pair(jdplan.dense_decode_plan(jcfg, cache_len=384, block_size=64),
               dplan.dense_decode_plan(tcfg, cache_len=384, block_size=64))
    for fn in (dplan.empty_decode_plan, jdplan.empty_decode_plan):
        with pytest.raises(ValueError, match="multiple"):
            fn(tcfg, batch=1, cache_len=100, block_size=64)


def _random_row(rng, l=2, hkv=2, nb=5, g=4):
    keep = rng.random((l, 1, hkv, nb, g)) < 0.5
    keep[..., -1, :] = True
    union = keep.any(-1)
    idx = np.zeros(union.shape[:-1] + (nb,), np.int32)
    cnt = union.sum(-1).astype(np.int32)
    for ix in np.ndindex(union.shape[:-1]):
        ids = np.flatnonzero(union[ix])
        idx[ix] = np.concatenate([ids, np.full(nb - len(ids), ids[-1])])
    return idx, cnt, keep


def test_update_plan_slot_and_pad_plan_row_match_reference():
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(3)
    idx, cnt, keep = _random_row(rng)
    jrow, trow = JPlan(idx, cnt, keep), DecodePlan(T(idx), T(cnt), T(keep))
    jpad, tpad = jdplan.pad_plan_row(jrow, 7), dplan.pad_plan_row(trow, 7)
    _plan_pair(jpad, tpad)
    jplan = jdplan.empty_decode_plan(jcfg, batch=3, cache_len=7 * 64,
                                     block_size=64)
    tplan = dplan.empty_decode_plan(tcfg, batch=3, cache_len=7 * 64,
                                    block_size=64)
    _plan_pair(jdplan.update_plan_slot(jplan, jpad, 1),
               dplan.update_plan_slot(tplan, tpad, 1))
    assert not tplan.keep_heads[:, [0, 2]].any()        # other slots
    for upd, plan, row in ((dplan.update_plan_slot, tplan, trow),
                           (jdplan.update_plan_slot, jplan, jrow)):
        with pytest.raises(ValueError, match="plan width mismatch"):
            upd(plan, row, 0)
    for pad, row in ((dplan.pad_plan_row, trow), (jdplan.pad_plan_row, jrow)):
        with pytest.raises(ValueError, match="cannot narrow"):
            pad(row, 4)
    for kw in (dict(prefill_blocks=3), dict(prefill_blocks=3,
                                            num_blocks=5)):
        got = dplan.plan_row_tail_stats(tpad, **kw)
        ref = jdplan.plan_row_tail_stats(jpad, **kw)
        assert got == pytest.approx(ref, abs=1e-6)


# ---------------------------------------------- paged decode plain versions

SUBSET = [c for c in CASES if c.name in (
    "gqa4", "ragged_prompts", "empty_keep_head", "bf16",
    "grow_cache_ragged", "width_capped")]


def _page_in(cache_k, cache_v, ps, seed=0, slack=3):
    """Scatter contiguous (B, Hkv, S, D) caches into a shuffled pool with
    slack pages; numpy, so both packages get the same pool."""
    b, hkv, s, d = cache_k.shape
    nb = s // ps
    num_pages = 1 + b * nb + slack
    table = (1 + np.random.default_rng(seed).permutation(num_pages - 1)
             [: b * nb]).reshape(b, nb).astype(np.int32)

    def scatter(cache):
        pool = np.zeros((num_pages, hkv, ps, d), cache.dtype)
        tiles = np.moveaxis(cache.reshape(b, hkv, nb, ps, d), 1, 2)
        pool[table.reshape(-1)] = tiles.reshape(b * nb, hkv, ps, d)
        return pool

    return scatter(cache_k), scatter(cache_v), table


def _torch(x):
    """A JAX array as a torch tensor, bfloat16 kept."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("case", SUBSET, ids=lambda c: c.name)
def test_paged_decode_matches_reference_kernel(case):
    data = build_case(case)
    ck, cv = (np.asarray(x) for x in (data.cache_k, data.cache_v))
    pk, pv, table = _page_in(ck, cv, case.bs)
    ref = np.asarray(j_paged(data.q, jnp.asarray(pk), jnp.asarray(pv),
                             jnp.asarray(table), data.plan, data.valid,
                             impl="kernel", interpret=True), np.float32)
    q, valid = _torch(data.q), _torch(data.valid)
    plan = DecodePlan(*(_torch(x) for x in data.plan))
    tpk, tpv, ttab = _torch(pk), _torch(pv), T(table)
    tol = 2e-2 if case.dtype == "bfloat16" else 2e-5
    for impl in ("kernel", "einsum"):
        got = flash_decode_plan_paged(q, tpk, tpv, ttab, plan, valid,
                                      impl=impl)
        np.testing.assert_allclose(got.float().numpy(), ref, atol=tol,
                                   rtol=0)
        # bitwise the port's contiguous path on the same cache
        same = flash_decode_plan(q, _torch(data.cache_k),
                                 _torch(data.cache_v), plan, valid,
                                 impl=impl)
        assert torch.equal(got, same), impl
    if case.empty_head:
        assert not got.reshape(case.b, case.hkv, -1, case.d)[:, 0].any()


def test_paged_decode_dispatch_and_plain_versions():
    data = build_case(SUBSET[0])
    pk, pv, table = _page_in(*(np.asarray(x) for x in
                               (data.cache_k, data.cache_v)), 64)
    q, valid = _torch(data.q), _torch(data.valid)
    plan = DecodePlan(*(_torch(x) for x in data.plan))
    args = (q, T(pk), T(pv), T(table))
    sliced = decode_plan_einsum_sliced_paged(*args, plan, valid)
    assert torch.equal(flash_decode_sparse_batched_paged(*args, *plan, valid),
                       sliced)
    full = decode_plan_einsum_paged(*args, plan.keep_heads, valid)
    np.testing.assert_allclose(full.numpy(), sliced.numpy(), atol=2e-5)
    with pytest.raises(ValueError, match="unknown decode impl"):
        flash_decode_plan_paged(*args, plan, valid, impl="pallas")


def test_paged_kernel_wrapper_refuses_what_it_does_not_take():
    q = torch.zeros(1, 8, 64)
    pool = torch.zeros(5, 2, 64, 64)
    table = torch.zeros(1, 2, dtype=torch.int32)
    idx = torch.zeros(1, 2, 2, dtype=torch.int32)
    cnt = torch.ones(1, 2, dtype=torch.int32)
    keep = torch.ones(1, 2, 2, 4, dtype=torch.bool)
    valid = torch.ones(1, 128, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_sparse_paged_cuda(q, pool, pool, table, idx, cnt, keep,
                                       valid)
    with pytest.raises(ValueError, match="multiple of 32"):
        flash_decode_sparse_paged_cuda(
            q, torch.zeros(5, 2, 40, 64), torch.zeros(5, 2, 40, 64), table,
            idx, cnt, keep, torch.ones(1, 80, dtype=torch.bool))
    with pytest.raises(ValueError, match="plan / valid shapes"):
        flash_decode_sparse_paged_cuda(q, pool, pool, table, idx, cnt,
                                       keep, valid[:, :100])
    with pytest.raises(ValueError, match="page table"):
        flash_decode_sparse_paged_cuda(q, pool, pool, table[0], idx, cnt,
                                       keep, valid)


def test_page_recycling_no_stale_reads():
    """Pages freed by request A and granted to request B read back pure B:
    bitwise the contiguous decode of B."""
    case = SUBSET[0]
    da = build_case(case)
    db = build_case(dataclasses.replace(case, seed=99))
    b, hkv, s, d = da.cache_k.shape
    ps = case.bs
    nb = s // ps
    alloc = pc.PageAllocator(1 + b * nb)
    pool_k = torch.zeros(1 + b * nb, hkv, ps, d)
    pool_v = torch.zeros_like(pool_k)

    def scatter(cache, pages):
        tiles = T(cache).reshape(b, hkv, nb, ps, d).transpose(1, 2)
        return tiles.reshape(b * nb, hkv, ps, d), torch.as_tensor(
            pages.astype(np.int64))

    pages_a = alloc.alloc(b * nb)
    for pool, cache in ((pool_k, da.cache_k), (pool_v, da.cache_v)):
        tiles, ids = scatter(np.asarray(cache), pages_a)
        pool[ids] = tiles
    alloc.free(pages_a)
    pages_b = alloc.alloc(b * nb)
    assert set(pages_b.tolist()) == set(pages_a.tolist())
    for pool, cache in ((pool_k, db.cache_k), (pool_v, db.cache_v)):
        tiles, ids = scatter(np.asarray(cache), pages_b)
        pool[ids] = tiles
    plan = DecodePlan(*(_torch(x) for x in db.plan))
    got = flash_decode_plan_paged(_torch(db.q), pool_k, pool_v,
                                  T(pages_b.reshape(b, nb)), plan,
                                  _torch(db.valid), impl="einsum")
    ref = flash_decode_plan(_torch(db.q), _torch(db.cache_k),
                            _torch(db.cache_v), plan, _torch(db.valid),
                            impl="einsum")
    assert torch.equal(got, ref)


# ------------------------------------------------- per-slot decode_step

S = 256
EXTRA = 128


@pytest.fixture(scope="module")
def decode_pair():
    """Two single-request prefills (buckets 128 and 256) of both models on
    shared parameters, each grown to the shared cache of 384 slots."""
    jcfg, tcfg = _cfgs()
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tp = checkpoint.params_from_numpy(_flatten(jp), tcfg, device="cpu")
    rng = np.random.default_rng(4)
    plens, buckets = np.array([100, 250]), np.array([128, 256])
    tcaches, jcaches = [], []
    jsp, tsp = jm.default_share_prefill(), tm.default_share_prefill()
    for plen, bucket in zip(plens, buckets):
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :plen] = rng.integers(0, jcfg.vocab_size, plen)
        tr = tm.prefill(tp, T(toks), tsp, prompt_lens=T([plen]))
        jr = jm.prefill(jp, jnp.asarray(toks, jnp.int32), jsp,
                        method="share", attn_impl="sparse",
                        prompt_lens=jnp.asarray([plen], jnp.int32))
        tcaches.append(tr.cache)
        jcaches.append(jr.cache["stack"])
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, tcfg=tcfg, tcaches=tcaches,
                jcaches=jcaches, plens=plens, buckets=buckets)


def _contiguous(caches, total):
    """Per-request (L, 1, Hkv, S_i, hd) caches → one (L, 2, Hkv, total, hd)
    cache, each at sequence offset 0."""
    out = []
    for i in range(2):
        parts = [c[i] for c in caches]
        x = np.zeros(parts[0].shape[:1] + (2,) + parts[0].shape[2:3]
                     + (total,) + parts[0].shape[4:], np.float32)
        for r, p in enumerate(parts):
            x[:, r, :, :p.shape[3]] = np.asarray(p)[:, 0]
        out.append(x)
    return out


def test_vector_pos_decode_step(decode_pair):
    """Per-slot ``pos`` at equal positions is bitwise the scalar step; at
    different positions (two buckets in one batch) it matches the
    reference's vector-``pos`` step and its paged step."""
    d = decode_pair
    tm, tp, jm, jp = d["tm"], d["tp"], d["jm"], d["jp"]
    total = S + EXTRA
    ck, cv = _contiguous(d["tcaches"], total)
    plens = T(d["plens"])
    tok = T(np.array([[3], [7]]))
    # equal positions: vector pos == scalar pos, bitwise
    outs = []
    for pos in (S, T([S, S])):
        cache = (T(ck), T(cv))
        outs.append(tm.decode(tp, tok, cache, pos, prompt_lens=plens,
                              prefill_len=S)[0])
    assert torch.equal(outs[0], outs[1])

    # ragged positions and prefill lengths: against the reference
    pos = np.array([128, 256])
    pfl = d["buckets"]
    jc = {"prefix": [], "stack": tuple(jnp.asarray(x) for x in
                                       _contiguous(d["jcaches"], total))}
    jl, _ = jm.decode(jp, jnp.asarray(tok.numpy(), jnp.int32), jc,
                      jnp.asarray(pos, jnp.int32),
                      prompt_lens=jnp.asarray(d["plens"], jnp.int32),
                      prefill_len=jnp.asarray(pfl, jnp.int32))
    tcache = (T(ck), T(cv))
    tl, _ = tm.decode(tp, tok, tcache, T(pos), prompt_lens=plens,
                      prefill_len=T(pfl))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)

    # the same step over a shuffled page pool: 6 table blocks per slot
    ps, nb = 64, total // 64
    table = (1 + np.random.default_rng(5).permutation(2 * nb + 2)
             [: 2 * nb]).reshape(2, nb).astype(np.int32)
    pools = []
    for x in _contiguous(d["tcaches"], total):
        pool = np.zeros((x.shape[0], 2 * nb + 3) + x.shape[2:3] + (ps,)
                        + x.shape[4:], np.float32)
        tiles = x.reshape(x.shape[0], 2, x.shape[2], nb, ps, x.shape[4])
        pool[:, table.reshape(-1)] = np.moveaxis(tiles, 3, 2).reshape(
            x.shape[0], 2 * nb, x.shape[2], ps, x.shape[4])
        pools.append(pool)
    jpool = {"prefix": [], "stack": tuple(jnp.asarray(p) for p in pools)}
    jlp, jpool = jm.decode(jp, jnp.asarray(tok.numpy(), jnp.int32), jpool,
                           jnp.asarray(pos, jnp.int32),
                           prompt_lens=jnp.asarray(d["plens"], jnp.int32),
                           prefill_len=jnp.asarray(pfl, jnp.int32),
                           page_table=jnp.asarray(table))
    tpool = tuple(T(p) for p in pools)
    tlp, tpool = tm.decode(tp, tok, tpool, T(pos), prompt_lens=plens,
                           prefill_len=T(pfl), page_table=T(table))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-4,
                               rtol=0)
    assert torch.equal(tlp, tl)          # paged == contiguous, bitwise
    np.testing.assert_allclose(tpool[0].numpy(),
                               np.asarray(jpool["stack"][0]), atol=1e-4,
                               rtol=1e-4)
    with pytest.raises(ValueError, match="vector"):
        tm.decode(tp, tok, tpool, S, prompt_lens=plens, prefill_len=S,
                  page_table=T(table))

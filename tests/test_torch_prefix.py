"""The port's prefix sharing with copy-on-write (ROADMAP.md A.9) against
the JAX package's — the cases of the reference's
``tests/test_prefix_sharing.py`` and its refresh fence.

Index tier, no model: ``prefix_digest`` equal to the reference's hex
string over random prompts, buckets and salts; ``PrefixIndex``'s LRU
order, pinning, eviction, ``clear`` and counters driven in lockstep with
the reference's index over twin allocators, refcounts and entries exactly.

Serve tier (granite-3-2b's smoke config, ``tests/torch_serving_helpers.
py``): each case is served by the reference with sharing on, by the port
with sharing on and by the port with sharing off.  The port's hit streams
are bitwise its serve without sharing (greedy, sampled, chunked,
truncated, through COW exhaustion and preempt/resume); against the
reference's serve the hits, misses, pages saved, COW copies, evictions,
preemptions and finish reasons are equal, the page tables and refcounts
at every decode step equal, and greedy tokens near-tie aware.  Every
serve runs under the page-leak audit.
"""
import hashlib

import numpy as np
import pytest
import torch

import repro.serving as jserving
import repro_torch.serving as tserving
from repro.data import DataConfig, sample
from repro.serving.scheduler import SlotScheduler as JScheduler
from repro_torch.serving import SamplingConfig
from repro_torch.serving.scheduler import SlotScheduler as TScheduler

from torch_serving_helpers import (JRequest, MarginRecorder, Request,
                                   assert_greedy_agree, make_pair,
                                   one_torch_thread, page_leak_audit,
                                   port_engine, ref_engine, requests)

SEQ, S64 = 256, 64
BASE = dict(max_batch=2, seq_buckets=(SEQ,), decode_sparse=True, paged=True)
TIGHT = dict(max_batch=2, seq_buckets=(S64,), decode_sparse=True,
             decode_extra=S64, paged=True, num_pages=4)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


# ------------------------------------------------------------- index tier

@pytest.mark.parametrize("seed", range(4))
def test_prefix_digest_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        n = int(rng.integers(1, 600))
        prompt = rng.integers(0, 2 ** 31 - 1, n)
        bucket = int(rng.choice([64, 128, 256, 512]))
        salt = rng.choice(["", "granite/dense/2/4/64", "mé"])
        ref = jserving.prefix_digest(prompt, bucket, salt)
        assert tserving.prefix_digest(prompt, bucket, salt) == ref
        # the same bytes as the reference hashes: the clipped int32 tokens
        assert tserving.prefix_digest(
            np.asarray(prompt, np.int32)[-bucket:], bucket, salt) == ref
    h = hashlib.blake2b(digest_size=16)
    h.update(b"")
    h.update(np.int64(64).tobytes())
    h.update(np.int64(3).tobytes())
    h.update(np.array([1, 2, 3], np.int32).tobytes())
    assert tserving.prefix_digest([1, 2, 3], 64) == h.hexdigest()


def test_prefix_digest_hashes_clipped_prompt():
    long = np.arange(300, dtype=np.int32) % 50
    other = long.copy()
    other[:40] = 7                      # differs only in the clipped head
    d = tserving.prefix_digest
    assert d(long, 256) == d(other, 256)
    tail = long.copy()
    tail[-1] += 1
    assert d(long, 256) != d(tail, 256)
    assert d(long, 256) != d(long, 128)
    assert d(long, 256, salt="m1") != d(long, 256, salt="m2")


def _entries(pkg, digest, pages, width=None):
    return pkg.PrefixEntry(digest=digest, bucket=64, plen=4,
                           pages=np.asarray(pages, np.int32),
                           prompt_pages=len(pages), logits=None,
                           plan_row=None, stats={}, width=width)


def test_prefix_index_pins_and_releases_pages():
    """The reference's LRU, pinning and ``clear`` case, exactly."""
    a = tserving.PageAllocator(10)
    idx = tserving.PrefixIndex(max_entries=2)
    p1 = a.acquire(2)
    assert idx.publish(_entries(tserving, "d1", p1), a)
    assert all(a.refcount(p) == 2 for p in p1)
    a.release(p1)
    assert all(a.refcount(p) == 1 for p in p1)
    assert idx.lookup("d1") is not None
    p2 = a.acquire(2)
    idx.publish(_entries(tserving, "d2", p2), a)
    a.release(p2)
    p3 = a.acquire(2)
    idx.publish(_entries(tserving, "d3", p3), a)
    a.release(p3)
    assert idx.lookup("d1") is None and len(idx) == 2
    assert all(a.refcount(p) == 0 for p in p1)
    assert idx.evict_one(a)
    idx.clear(a)
    assert a.free_pages == 9 and idx.evictions == 2
    a.check_consistency()


@pytest.mark.parametrize("seed", range(3))
def test_prefix_index_walk_matches_reference(seed):
    """Random publish (same and other width caps) / lookup / evict /
    clear in lockstep on both packages' index and allocator: return
    values, LRU order, refcounts and counters equal after every op."""
    rng = np.random.default_rng(seed)
    allocs = [jserving.PageAllocator(24), tserving.PageAllocator(24)]
    idxs = [jserving.PrefixIndex(max_entries=3),
            tserving.PrefixIndex(max_entries=3)]

    def step(pkg, a, idx, op, digest, width, n):
        if op <= 1:
            pages = a.acquire(n)
            if pages is None:
                return None
            res = idx.publish(_entries(pkg, digest, pages, width), a)
            a.release(pages)                # the donor leaves at once
            return res
        if op == 2:
            e = idx.lookup(digest)
            return None if e is None else e.pages.tolist()
        if op == 3:
            return idx.evict_one(a)
        idx.clear(a)
        return len(idx)

    for _ in range(120):
        op = int(rng.choice(5, p=[0.3, 0.2, 0.3, 0.15, 0.05]))
        args = (op, f"d{int(rng.integers(0, 6))}",
                [None, 4][int(rng.integers(0, 2))], int(rng.integers(1, 4)))
        outs = [(step(pkg, a, idx, *args), list(idx._entries))
                for pkg, a, idx in zip((jserving, tserving), allocs, idxs)]
        assert outs[0] == outs[1]
        np.testing.assert_array_equal(allocs[0]._refs, allocs[1]._refs)
        assert idxs[0].stats() == idxs[1].stats()
        allocs[1].check_consistency()
    for a, idx in zip(allocs, idxs):
        idx.clear(a)
        assert a.free_pages == a.num_pages - 1


def test_copy_page_copies_every_layer_in_place():
    from repro_torch.serving import paged_cache
    pool = tuple(torch.arange(2 * 5 * 2 * 4 * 3, dtype=torch.float32)
                 .reshape(2, 5, 2, 4, 3) + i for i in range(2))
    before = [p.clone() for p in pool]
    assert paged_cache.copy_page(pool, 3, 1) is pool
    for p, b in zip(pool, before):
        assert torch.equal(p[:, 1], b[:, 3])
        keep = [0, 2, 3, 4]
        assert torch.equal(p[:, keep], b[:, keep])


# ------------------------------------------------------------- serve tier

def _prompt(vocab, seq, uid):
    dcfg = DataConfig(vocab_size=vocab, seq_len=seq, global_batch=1,
                      task="retrieval")
    return np.asarray(sample(dcfg, uid)["tokens"])


def _dup(cls, vocab, max_new=(6, 6, 5, 4), seq=SEQ, **kw):
    """Three requests of one prompt and one of another (the reference's
    ``_dup_requests``)."""
    shared = _prompt(vocab, seq, 7)
    reqs = [cls(uid=i, prompt=shared.copy(), max_new_tokens=m, **kw)
            for i, m in enumerate(max_new[:-1])]
    reqs.append(cls(uid=99, prompt=_prompt(vocab, seq, 42),
                    max_new_tokens=max_new[-1], **kw))
    return reqs


@pytest.fixture
def tables(monkeypatch):
    """Each package's page table and refcounts before every decode step."""
    seen = {"ref": [], "port": []}
    for key, cls in (("ref", JScheduler), ("port", TScheduler)):
        step = cls._decode_step

        def wrapped(self, _step=step, _key=key):
            if self.paged and self.prefix is not None:
                seen[_key].append((self.page_table.copy(),
                                   self.alloc._refs.copy()))
            return _step(self)

        monkeypatch.setattr(cls, "_decode_step", wrapped)
    return seen


_STATS = ("prefix_hits", "prefix_misses", "prefix_pages_saved",
          "prefix_cow_copies", "prefix_evictions", "prefix_entries")


def _three_serves(pair, make, kw, faults=(), seed=0):
    """``make(cls)``'s requests through the reference (sharing on), the
    port (on) and the port (off): (ref reqs, ref engine, port reqs, port
    engine, port-off reqs, margins)."""
    jr = make(JRequest)
    jeng = ref_engine(pair, **kw, prefix_sharing=True)
    rec = MarginRecorder(*[getattr(jserving, n)(**a) for n, a in faults])
    jeng.serve(jr, seed=seed, faults=rec)
    out = [jr, jeng]
    for on in (True, False):
        tr = make(Request)
        teng = port_engine(pair, **kw, prefix_sharing=on)
        inj = tserving.FaultInjector(
            *[getattr(tserving, n)(**a) for n, a in faults])
        teng.serve(tr, seed=seed, faults=inj)
        out += [tr, teng] if on else [tr]
    return out + [rec.margins]


def _assert_bitwise(ref, got):
    for a, b in zip(ref, got):
        assert b.finish_reason == a.finish_reason, a.uid
        np.testing.assert_array_equal(a.output_tokens, b.output_tokens)


def _assert_like_reference(jr, jeng, tr, teng, margins, tables=None):
    assert [r.prefix_hit for r in tr] == [r.prefix_hit for r in jr]
    assert [r.preempted_count for r in tr] == \
        [r.preempted_count for r in jr]
    assert teng.preemptions == jeng.preemptions
    for k in _STATS:
        assert teng.prefix_stats[k] == jeng.prefix_stats[k], k
    assert teng.page_pool_stats["peak_pages"] == \
        jeng.page_pool_stats["peak_pages"]
    identical = assert_greedy_agree(jr, tr, margins)
    if tables is not None and identical:
        assert len(tables["ref"]) == len(tables["port"]) > 0
        for (jt, jref), (tt, tref) in zip(tables["ref"], tables["port"]):
            np.testing.assert_array_equal(tt, jt)
            np.testing.assert_array_equal(tref, jref)
    return identical


def test_prefix_hit_bitwise_greedy(pair, tables):
    vocab = pair["cfg"].vocab_size
    jr, jeng, tr, teng, off, margins = _three_serves(
        pair, lambda cls: _dup(cls, vocab), BASE)
    _assert_bitwise(off, tr)
    assert [r.prefix_hit for r in tr] == [False, True, True, False]
    ps = teng.prefix_stats
    assert ps["prefix_hits"] == 2 and ps["prefix_pages_saved"] > 0
    assert ps["prefix_cow_copies"] > 0
    assert tr[1].prefill_s < tr[0].prefill_s
    assert all(r.metrics()["prefix_hit"] == float(r.prefix_hit) for r in tr)
    assert tr[1].pattern_stats == tr[0].pattern_stats
    _assert_like_reference(jr, jeng, tr, teng, margins, tables)


def test_prefix_hit_bitwise_sampled(pair):
    """Port against port: a hit's sampled stream is its cold stream (the
    generator is seeded from the hit's own uid)."""
    vocab = pair["cfg"].vocab_size
    sk = dict(sampling=SamplingConfig(temperature=0.8))
    streams = []
    for on in (False, True):
        reqs = _dup(Request, vocab, **sk)
        eng = port_engine(pair, **BASE, prefix_sharing=on)
        eng.serve(reqs, seed=3)
        streams.append(reqs)
    _assert_bitwise(*streams)
    assert eng.prefix_stats["prefix_hits"] == 2


def test_prefix_hit_bitwise_chunked(pair, tables):
    vocab = pair["cfg"].vocab_size
    kw = dict(BASE, prefill_chunk=64)
    jr, jeng, tr, teng, off, margins = _three_serves(
        pair, lambda cls: _dup(cls, vocab), kw)
    _assert_bitwise(off, tr)
    assert teng.prefix_stats["prefix_hits"] >= 1
    _assert_like_reference(jr, jeng, tr, teng, margins, tables)


def test_truncated_prompts_share_by_clipped_digest(pair):
    vocab = pair["cfg"].vocab_size
    long = _prompt(vocab, SEQ + 50, 7)
    other = long.copy()
    other[:30] = 11                     # clipped away

    def make(cls):
        return [cls(uid=0, prompt=long.copy(), max_new_tokens=6),
                cls(uid=1, prompt=other.copy(), max_new_tokens=5)]

    jr, jeng, tr, teng, off, margins = _three_serves(pair, make, BASE)
    assert all(r.truncated for r in tr) and tr[1].prefix_hit
    _assert_bitwise(off, tr)
    _assert_like_reference(jr, jeng, tr, teng, margins)


def test_cow_exhaustion_preempts_and_resumes_bitwise(pair, tables):
    """3 allocatable pages: the donor holds 2 (the index pins them) and
    its own copy takes the third, so the hit's copy preempts the hit; a
    distinct request rides through the churn untouched."""
    vocab = pair["cfg"].vocab_size
    shared, distinct = _prompt(vocab, S64, 5), _prompt(vocab, S64, 29)

    def make(cls):
        return [cls(uid=0, prompt=shared.copy(), max_new_tokens=12),
                cls(uid=1, prompt=shared.copy(), max_new_tokens=10),
                cls(uid=2, prompt=distinct.copy(), max_new_tokens=6)]

    jr, jeng, tr, teng, off, margins = _three_serves(pair, make, TIGHT)
    _assert_bitwise(off, tr)
    assert teng.preemptions >= 1
    assert any(r.preempted_count > 0 for r in tr)
    assert teng.prefix_stats["prefix_cow_copies"] >= 1
    _assert_like_reference(jr, jeng, tr, teng, margins, tables)


def test_truncated_preempt_resume_reenters_index(pair):
    vocab = pair["cfg"].vocab_size
    long = _prompt(vocab, S64 + 40, 5)  # truncated to the 64 bucket

    def make(cls):
        return [cls(uid=0, prompt=long.copy(), max_new_tokens=12),
                cls(uid=1, prompt=long.copy(), max_new_tokens=10)]

    jr, jeng, tr, teng, off, margins = _three_serves(pair, make, TIGHT)
    assert all(r.truncated for r in tr) and teng.preemptions >= 1
    _assert_bitwise(off, tr)
    _assert_like_reference(jr, jeng, tr, teng, margins)


def test_fault_release_paths_drop_shared_references(pair):
    """A cancelled hit and a poisoned hit release shared pages cleanly
    (the leak audit checks the allocator); the donor and the distinct
    request serve bitwise the serve without sharing or faults."""
    vocab = pair["cfg"].vocab_size
    faults = [("CancelAt", dict(uid=1, step=6)),
              ("NaNLogits", dict(uid=2, at_token=2))]
    clean = _dup(Request, vocab, max_new=(8, 8, 8, 5))
    port_engine(pair, **BASE).serve(clean, seed=0)
    jr, jeng, tr, teng, off, margins = _three_serves(
        pair, lambda cls: _dup(cls, vocab, max_new=(8, 8, 8, 5)), BASE,
        faults=faults)
    assert tr[1].finish_reason == "cancelled"
    assert tr[2].finish_reason == "failed"
    _assert_bitwise([clean[0], clean[3]], [tr[0], tr[3]])
    _assert_bitwise(off, tr)
    _assert_like_reference(jr, jeng, tr, teng, margins)


def test_refresh_defers_while_prefix_shared(pair):
    """The reference's COW fence case: a 1-entry index evicts r0's entry
    when r1 publishes, so r0 refreshes and r1 (pinned all serve) defers;
    ``deferred_cow`` and the refresh counts equal the reference's."""
    vocab = pair["cfg"].vocab_size
    long = 4 * S64 + 3
    kw = dict(max_batch=2, seq_buckets=(S64,), paged=True,
              decode_sparse=True, prefix_sharing=True, prefix_max_entries=1,
              refresh_every=S64, refresh_mass=0.5)
    jeng = ref_engine(pair, **kw)
    rec = MarginRecorder()
    jr = requests(JRequest, vocab, (long, long), base=30)
    jeng.serve(jr, seed=0, faults=rec)
    teng = port_engine(pair, **kw)
    tr = requests(Request, vocab, (long, long), base=30)
    teng.serve(tr, seed=0)
    assert tr[0].refreshes > 0 and tr[1].refreshes == 0
    assert teng.refresh_stats["deferred_cow"] > 0
    assert teng.refresh_stats == jeng.refresh_stats
    assert [r.refreshes for r in tr] == [r.refreshes for r in jr]
    assert all(len(r.output_tokens) == long for r in tr)
    assert_greedy_agree(jr, tr, rec.margins)

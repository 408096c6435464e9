"""The port's decode-pattern refresh (ROADMAP.md A.9 with A.5's width
policies and A.2's ragged masks) against the JAX package's.

Unit tier, on seeded numpy inputs through both packages:
  * ``score_mass_budgets``, ``ragged_top_mask`` (ties included) and
    ``ragged_cap_block_mask`` **exactly**; every cumulative score sum is
    asserted to lie more than 1e-6 (relative) from its mass target, and
    every kept set's lowest score more than 1e-6 from the next one, so a
    flip would be a real fault and not a near-tie;
  * ``set_plan_width`` / ``bucket_plan_width`` (with the narrowing
    guard), ``build_refresh_plan_row`` and ``extend_plan_row_horizon``
    **exactly**, given the same window and shuffled pages;
  * ``compute_strips_paged`` within 1e-6 of the reference's;
  * the query ring equal to the reference's;
  * ``collect_queries``: logits bitwise those of the step without it, the
    queries within 1e-5 of the reference's (layer 0's, which depend only
    on the token and its position, differ by 4.8e-6 of values up to 2.7:
    the packages' float32 QKV and RoPE round differently).

Serve tier (granite-3-2b's smoke config, ``tests/torch_serving_helpers.
py``): refresh serves on cadence, with horizon extensions, on the tail
threshold and through chunked admission, and a preempt → resume that
rebuilds the refresh state cold, each against the reference's same serve
— ``refreshes``, tail and traffic fractions (1e-6), ``refresh_stats`` and
``preemptions`` equal, greedy tokens near-tie aware; and ``_width_cap``'s
frozen W against the reference's engine for ``auto`` and ``count``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.kernels import indices as jind
from repro.kernels import strip as jstrip
from repro.serving import decode_plan as jdplan
from repro.serving import refresh as jrefresh
from repro.serving import width_policy as jwp
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import indices as tind
from repro_torch.kernels import strip as tstrip
from repro_torch.kernels.decode_attn import DecodePlan
from repro_torch.serving import decode_plan as dplan
from repro_torch.serving import refresh as trefresh
from repro_torch.serving import width_policy as twp

from torch_serving_helpers import (ARCH, JRequest, MarginRecorder, Request,
                                   assert_greedy_agree, make_pair,
                                   one_torch_thread, page_leak_audit,
                                   port_engine, ref_engine, requests)

torch.backends.cuda.matmul.allow_tf32 = False

T = lambda a: torch.from_numpy(np.array(a))
N = lambda a: np.asarray(a)
REL = 1e-6


def _assert_clear_cuts(scores, mass, budgets):
    """No cumulative sum within 1e-6 (relative) of its mass target, and at
    each row's cut the kept set's lowest score more than 1e-6 above the
    next one."""
    desc = -np.sort(-np.asarray(scores, np.float64), axis=-1)
    cum = np.cumsum(desc, axis=-1)
    target = mass * cum[..., -1:]
    live = target[..., 0] > 0
    gap = np.abs(cum - target) / np.maximum(target, 1e-30)
    assert gap[live].min() > REL, gap[live].min()
    k = np.asarray(budgets)
    nb = desc.shape[-1]
    cut = (k < nb) & live
    lo = np.take_along_axis(desc, (k - 1)[..., None], -1)[..., 0]
    hi = np.take_along_axis(desc, np.minimum(k, nb - 1)[..., None], -1)[
        ..., 0]
    rel = (lo - hi) / np.maximum(lo, 1e-30)
    assert not cut.any() or rel[cut].min() > REL, rel[cut].min()


# --------------------------------------------------------------------------
# budgets and ragged masks
# --------------------------------------------------------------------------

SMALL = np.array([[0.5, 0.3, 0.1, 0.1], [0.0, 0.0, 0.0, 0.0]], np.float32)


@pytest.mark.parametrize("mass,lo,hi", [(0.7, 1, None), (0.95, 1, None),
                                        (0.95, 2, 3)])
def test_score_mass_budgets_reference_rows(mass, lo, hi):
    want = N(jwp.score_mass_budgets(jnp.asarray(SMALL), mass=mass,
                                    min_width=lo, max_width=hi))
    got = twp.score_mass_budgets(T(SMALL), mass=mass, min_width=lo,
                                 max_width=hi)
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()


@pytest.mark.parametrize("mass", [0.3, 0.5, 0.9, 0.95])
@pytest.mark.parametrize("seed", [0, 1])
def test_score_mass_budgets_exact(seed, mass):
    rng = np.random.default_rng(seed)
    scores = (rng.random((3, 8, 24)) ** 3).astype(np.float32)
    scores[0, 0] = 0.0                          # an all-zero row
    for lo, hi in ((1, None), (2, 12)):
        want = N(jwp.score_mass_budgets(jnp.asarray(scores), mass=mass,
                                        min_width=lo, max_width=hi))
        got = twp.score_mass_budgets(T(scores), mass=mass, min_width=lo,
                                     max_width=hi)
        np.testing.assert_array_equal(got.numpy(), want)
        _assert_clear_cuts(scores, mass, want)
        assert want[0, 0] == lo             # the all-zero row's floor


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ragged_top_mask_ties(seed):
    """Scores drawn from 5 levels, so most rows tie at their cut: the
    higher block index wins, as in the reference."""
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, 5, (4, 6, 16)).astype(np.float32) / 4
    widths = rng.integers(0, 17, (4, 6)).astype(np.int32)
    want = N(jind.ragged_top_mask(jnp.asarray(scores), jnp.asarray(widths)))
    got = tind.ragged_top_mask(T(scores), T(widths))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want.sum(-1) == np.minimum(widths, 16)).all()


def test_ragged_top_mask_reference_rows():
    scores = np.array([[0.1, 0.4, 0.2, 0.3], [0.5, 0.5, 0.0, 0.5]],
                      np.float32)
    got = tind.ragged_top_mask(T(scores), T(np.array([1, 2], np.int32)))
    assert got.tolist() == [[False, True, False, False],
                            [False, True, False, True]]


@pytest.mark.parametrize("seed", [0, 1])
def test_ragged_cap_block_mask_exact(seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((3, 5, 12)) < 0.5
    widths = rng.integers(0, 13, (3, 5)).astype(np.int32)
    want = N(jind.ragged_cap_block_mask(jnp.asarray(mask),
                                        jnp.asarray(widths)))
    got = tind.ragged_cap_block_mask(T(mask), T(widths))
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# plan width and refreshed rows
# --------------------------------------------------------------------------

@pytest.mark.parametrize("need,nb,slack", [(3, 16, 0), (5, 16, 0),
                                           (9, 12, 0), (0, 16, 0),
                                           (4, 64, 1), (64, 64, 0)])
def test_bucket_plan_width(need, nb, slack):
    assert dplan.bucket_plan_width(need, nb, slack=slack) == \
        jdplan.bucket_plan_width(need, nb, slack=slack)


def _plan_pair(seed=0, L=2, B=1, hkv=2, nb=8, g=2):
    rng = np.random.default_rng(seed)
    keep = rng.random((L, B, hkv, nb, g)) < 0.3
    keep[..., :2, :] = True
    union = keep.any(-1)
    ji, jc = jind.compact_block_mask(jnp.asarray(union), width=None)
    jrow = jdplan.DecodePlan(indices=ji, counts=jc,
                             keep_heads=jnp.asarray(keep))
    trow = DecodePlan(T(N(ji)), T(N(jc)), T(keep))
    return jrow, trow


@pytest.mark.parametrize("width", [8, 16, 6, 4])
def test_set_plan_width_exact(width):
    jrow, trow = _plan_pair()
    mx = int(N(jrow.counts).max())
    if width < mx:
        with pytest.raises(ValueError, match="cannot narrow"):
            dplan.set_plan_width(trow, width)
        with pytest.raises(ValueError):
            jdplan.set_plan_width(jrow, width)
        return
    want = jdplan.set_plan_width(jrow, width)
    got = dplan.set_plan_width(trow, width)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), N(b))
    back = dplan.set_plan_width(got, 8)     # widening pads repeat-last
    np.testing.assert_array_equal(back.counts.numpy(), N(jrow.counts))


def _row_inputs(seed, L=2, H=4, hkv=2, D=16, bs=16, nb=8, spare=3):
    """Window, page pools and a shuffled page map (block j of the slot on
    page table[j]; the pool holds spare pages no row maps)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((L, H, bs, D)).astype(np.float32)
    pool = rng.standard_normal((L, nb + spare + 1, hkv, bs, D)).astype(
        np.float32)
    table = (rng.permutation(nb + spare)[:nb] + 1).astype(np.int32)
    jcfg = dataclasses.replace(j_smoke(ARCH), num_heads=H, num_kv_heads=hkv)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), num_heads=H,
                               num_kv_heads=hkv)
    return q, pool, table, jcfg, tcfg


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("nblk", [5, 8])
def test_compute_strips_paged_matches_reference(seed, nblk):
    q, pool, table, _, _ = _row_inputs(seed)
    want = N(jstrip.compute_strips_paged(
        jnp.asarray(q[0]), jnp.asarray(pool[0]), jnp.asarray(table),
        block_size=16, num_blocks=nblk, impl="jnp"))
    got = tstrip.compute_strips_paged(T(q[0]), T(pool[0]), T(table),
                                      block_size=16, num_blocks=nblk)
    assert got.shape == want.shape == (4, 16, nblk * 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _pooled_scores(q, pool, table, nblk, bs=16):
    """Each layer's (H, nblk) block attention mass, as the row builder
    pools it."""
    out = []
    for layer in range(q.shape[0]):
        s = tstrip.compute_strips_paged(T(q[layer]), T(pool[layer]),
                                        T(table), block_size=bs,
                                        num_blocks=nblk)
        out.append(s.reshape(q.shape[1], bs, nblk, bs).sum((1, 3)).numpy())
    return np.stack(out)


ROWS = [(0, 0.5, 5, 2), (1, 0.5, 5, 2), (0, 0.3, 5, 0), (1, 0.95, 8, 0),
        (2, 0.8, 6, 1)]


@pytest.mark.parametrize("seed,mass,nblk,horizon", ROWS)
def test_build_refresh_plan_row_exact(seed, mass, nblk, horizon):
    q, pool, table, jcfg, tcfg = _row_inputs(seed)
    nb = 8
    want = jdplan.build_refresh_plan_row(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(table), jcfg,
        block_size=16, num_blocks=nblk, table_blocks=nb,
        horizon_blocks=horizon, mass=mass, strip_impl="jnp")
    got = dplan.build_refresh_plan_row(
        T(q), T(pool), T(table), tcfg, block_size=16, num_blocks=nblk,
        table_blocks=nb, horizon_blocks=horizon, mass=mass)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), N(b))
    scores = _pooled_scores(q, pool, table, nblk)
    _assert_clear_cuts(scores, mass, N(jwp.score_mass_budgets(
        jnp.asarray(scores), mass=mass)))
    kh = got.keep_heads.numpy()
    assert kh[..., max(nblk - 1, 0):nblk + horizon, :].all()
    assert not kh[..., nblk + horizon:, :].any()


@pytest.mark.parametrize("lo,hi", [(6, 8), (5, 7), (0, 2)])
def test_extend_plan_row_horizon_exact(lo, hi):
    q, pool, table, jcfg, tcfg = _row_inputs(3)
    jrow = jdplan.build_refresh_plan_row(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(table), jcfg,
        block_size=16, num_blocks=5, table_blocks=8, horizon_blocks=1,
        mass=0.5, strip_impl="jnp")
    trow = DecodePlan(*(T(N(x)) for x in jrow))
    want = jdplan.extend_plan_row_horizon(jrow, lo, hi)
    got = dplan.extend_plan_row_horizon(trow, lo, hi)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), N(b))


def test_query_ring_matches_reference():
    """Captured queries land at ``pos % bs``; the window is position
    ordered once a block boundary is reached after a full block."""
    rng = np.random.default_rng(0)
    L, H, hd, bs, pos0 = 2, 4, 8, 16, 37
    j = jrefresh.make_refresh_state(L, H, hd, bs, pos0)
    t = trefresh.make_refresh_state(L, H, hd, bs, pos0)
    ready = []
    for pos in range(pos0, pos0 + 2 * bs):
        q = rng.standard_normal((L, H, hd)).astype(np.float32)
        j.record(pos, q)
        t.record(pos, T(q))
        ready.append((j.window_ready(pos + 1), t.window_ready(pos + 1)))
        if t.window_ready(pos + 1):
            np.testing.assert_array_equal(t.window().numpy(), j.window())
    assert all(a == b for a, b in ready) and any(a for a, _ in ready)
    assert t.filled == j.filled == bs
    assert t.last_refresh_pos == j.last_refresh_pos == pos0


# --------------------------------------------------------------------------
# collect_queries
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    return make_pair()


def test_collect_queries_bitwise_and_against_reference(pair):
    """One sparse decode step from the reference's prefill cache and plan,
    with and without the capture: the port's logits bitwise equal, its
    (L, B, H, hd) queries within 1e-5 of the reference's; then the same
    step through a shuffled page table gives the same logits and
    queries."""
    from repro_torch.serving import paged_cache as tpaged
    jm, jp, tm, tp = pair["jm"], pair["jp"], pair["tm"], pair["tp"]
    seq, extra = 128, 64
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, seq)).astype(np.int32)
    plens = np.array([seq, seq - 20], np.int32)
    jsp = jm.default_share_prefill()
    jres = jm.prefill(jp, jnp.asarray(toks), jsp, method="share",
                      attn_impl="sparse", prompt_lens=jnp.asarray(plens))
    jplan = jdplan.build_decode_plan(jsp, jres.sp_state, jm.cfg,
                                     prefill_len=seq, cache_len=seq + extra)
    jcache = {"prefix": [], "stack": tuple(
        jnp.pad(c, ((0, 0),) * 3 + ((0, extra), (0, 0)))
        for c in jres.cache["stack"])}
    tok = np.array([[3], [5]], np.int32)
    pos = np.array([seq, seq], np.int32)
    jlogits, _, jq = jm.decode(
        jp, jnp.asarray(tok), jcache, jnp.asarray(pos), plan=jplan,
        prompt_lens=jnp.asarray(plens), prefill_len=seq,
        decode_impl="kernel", collect_queries=True)

    tplan = DecodePlan(*(T(N(x)) for x in jplan))
    cache = lambda: tuple(T(N(c)) for c in jcache["stack"])
    kw = dict(plan=tplan, prompt_lens=T(plens).long(), prefill_len=seq,
              decode_impl="kernel")
    tt, tpos = T(tok).long(), T(pos).long()
    base, _ = tm.decode(tp, tt, cache(), tpos, **kw)
    got, _, tq = tm.decode(tp, tt, cache(), tpos, collect_queries=True,
                           **kw)
    assert torch.equal(got, base)
    assert tq.shape == (tm.cfg.num_layers, 2, tm.cfg.num_heads,
                        tm.cfg.resolved_head_dim)
    # 1e-5: layer 0's queries, which depend on nothing but the token and
    # its position, already differ by 4.8e-6 (of values up to 2.7) between
    # the two packages' QKV projection and RoPE in float32
    np.testing.assert_allclose(tq.numpy(), N(jq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), N(jlogits), rtol=0, atol=1e-4)

    # paged: the same K/V through a reversed page table
    nbp = (seq + extra) // 64
    table = np.arange(2 * nbp, 0, -1, dtype=np.int32).reshape(2, nbp)
    pool = tpaged.init_paged_pool(tm.cfg, num_pages=2 * nbp + 1,
                                  page_size=64, dtype=torch.float32,
                                  device="cpu")
    full = cache()
    for b in range(2):
        tpaged.insert_prefill(pool, tuple(c[:, b:b + 1] for c in full),
                              table[b])
    pkw = dict(kw, prefill_len=T(np.array([seq, seq])).long(),
               page_table=T(table))
    clone = lambda: tuple(c.clone() for c in pool)
    pbase, _ = tm.decode(tp, tt, clone(), tpos, **pkw)
    pgot, _, pq = tm.decode(tp, tt, clone(), tpos, collect_queries=True,
                            **pkw)
    assert torch.equal(pgot, pbase) and torch.equal(pq, tq)
    with pytest.raises(ValueError, match="DecodePlan"):
        tm.decode(tp, tt, cache(), tpos, collect_queries=True)


# --------------------------------------------------------------------------
# serves against the reference
# --------------------------------------------------------------------------

LONG = 2 * 64 + 3       # two cadence points at refresh_every=64
PAGED = dict(max_batch=2, seq_buckets=(64,), paged=True, decode_sparse=True)
SERVES = {
    "cadence": (dict(PAGED, refresh_every=64, refresh_mass=0.5),
                (LONG, LONG), 64, 0),
    "horizon_extension": (dict(PAGED, refresh_every=128, refresh_mass=0.5,
                               refresh_horizon_blocks=1, decode_extra=256),
                          (LONG + 64, 90), 64, 10),
    "tail_threshold": (dict(PAGED, refresh_every=4096, refresh_mass=0.9,
                            refresh_tail_threshold=0.5),
                       (LONG, 70), 64, 20),
    "chunked": (dict(PAGED, seq_buckets=(256,), prefill_chunk=64,
                     refresh_every=64, refresh_mass=0.5),
                (LONG, 6), 256, 50),
}


def _serve_both(pair, kw, max_new, seq, base, mutate=None):
    vocab = pair["cfg"].vocab_size
    jeng = ref_engine(pair, **kw)
    jreqs = requests(JRequest, vocab, max_new, seq=seq, base=base)
    treqs = requests(Request, vocab, max_new, seq=seq, base=base)
    for rs in (jreqs, treqs):
        if mutate:
            mutate(rs)
    rec = MarginRecorder()
    jeng.serve(jreqs, seed=0, faults=rec)
    teng = port_engine(pair, **kw)
    teng.serve(treqs, seed=0)
    return jreqs, jeng, treqs, teng, rec.margins


@pytest.mark.parametrize("name", list(SERVES))
def test_refresh_serve_matches_reference(pair, name):
    kw, max_new, seq, base = SERVES[name]
    jreqs, jeng, treqs, teng, margins = _serve_both(pair, kw, max_new, seq,
                                                   base)
    same = assert_greedy_agree(jreqs, treqs, margins)
    assert teng.refresh_stats["refreshes"] > 0
    if not same:
        return
    assert teng.refresh_stats == jeng.refresh_stats
    for r, g in zip(jreqs, treqs):
        assert g.refreshes == r.refreshes
        assert g.tail_fraction == pytest.approx(r.tail_fraction, abs=1e-6)
        assert g.plan_traffic_fraction == pytest.approx(
            r.plan_traffic_fraction, abs=1e-6)
    if name == "horizon_extension":
        assert teng.refresh_stats["horizon_extensions"] > 0
    if name == "chunked":
        assert [g.refreshes > 0 for g in treqs] == [True, False]
    assert teng.phase_s["refresh"] > 0
    assert teng.page_pool_stats["pages_in_use_at_end"] == 0


def test_preempt_resume_rebuilds_refresh_state(pair):
    """The reference's scenario: the long request is the priority victim,
    its refresh state is dropped with its pages, and the resumed stream
    re-warms a cold window and refreshes again."""
    kw = dict(max_batch=3, seq_buckets=(64,), paged=True, decode_sparse=True,
              refresh_every=64, refresh_mass=0.5, num_pages=10,
              preempt_after_steps=2)

    def prio(rs):
        rs[0].priority = -1

    jreqs, jeng, treqs, teng, margins = _serve_both(
        pair, kw, (3 * 64, 3 * 64 - 10, 12), 64, 70, mutate=prio)
    same = assert_greedy_agree(jreqs, treqs, margins)
    assert teng.preemptions > 0 and treqs[0].preempted_count > 0
    assert treqs[0].refreshes >= 1 and treqs[0].finish_reason == "length"
    if same:
        assert teng.preemptions == jeng.preemptions
        for r, g in zip(jreqs, treqs):
            assert (g.preempted_count, g.refreshes,
                    g.waiting_deferred_steps) == (
                r.preempted_count, r.refreshes, r.waiting_deferred_steps)
            assert g.resume_tokens == list(r.resume_tokens)


@pytest.mark.parametrize("policy,kw", [("auto", {}),
                                       ("count", dict(width_safety=1.0))])
@pytest.mark.parametrize("scheduler", [False, True])
def test_width_cap_freezes_as_reference(pair, policy, kw, scheduler):
    """Two successive serves of one bucket: the first prefill runs
    uncapped, then the cap freezes at the reference's W."""
    ecfg = dict(max_batch=2, seq_buckets=(512,), width_policy=policy,
                scheduler=scheduler, **kw)
    jeng = ref_engine(pair, attn_impl="sparse", **ecfg)
    teng = port_engine(pair, **ecfg)
    vocab = pair["cfg"].vocab_size
    for rnd in range(2):
        jreqs = requests(JRequest, vocab, (2, 2), seq=512, base=90 + rnd)
        treqs = requests(Request, vocab, (2, 2), seq=512, base=90 + rnd)
        rec = MarginRecorder()
        jeng.serve(jreqs, seed=0, faults=rec)
        teng.serve(treqs, seed=0)
        assert teng._width_frozen == jeng._width_frozen
        for r, g in zip(jreqs, treqs):
            assert g.pattern_stats["prefill_width_cap"] == \
                r.pattern_stats["prefill_width_cap"]
        assert_greedy_agree(jreqs, treqs, rec.margins)
    caps = [g.pattern_stats["prefill_width_cap"] for g in treqs]
    assert teng._width_frozen.get(512, 0) in (None, caps[0])

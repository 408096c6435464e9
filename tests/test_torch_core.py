"""The port's SharePrefill core against the JAX package's, stage by stage.

Every boolean or integer result (masks, decisions, dictionaries, head
permutations) must be equal exactly.  To keep float summation order from
deciding a near-tie, each stage is fed the *same* input on both sides: the
JAX stage's input converted through numpy.  Float results (â, distances,
representatives, layer outputs) are compared at 1e-6 (stages) or 1e-5 (a
whole layer, whose attention runs FlashAttention-style on the JAX side),
float32 throughout.  Config variants force each decision branch: shared,
dense and vertical-slash.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.base import SharePrefillConfig as JSPC
from repro.core import construct as jconstruct
from repro.core import determine as jdetermine
from repro.core import jsd as jjsd
from repro.core import pattern_dict as jpdict
from repro.core import patterns as jpatterns
from repro.core import share_attention as jsa
from repro.core import vertical_slash as jvs
from repro.kernels import batched_sparse_attention_fn as j_attn_fn
from repro.kernels.strip import strip_scores_pallas
from repro_torch.configs.base import SharePrefillConfig
from repro_torch.core import construct, determine, jsd, pattern_dict
from repro_torch.core import patterns, share_attention as sa, vertical_slash
from repro_torch.core.api import SharePrefill

torch.backends.cuda.matmul.allow_tf32 = False

T = lambda a: torch.from_numpy(np.array(a))
N, BS, H, HKV, D = 512, 64, 8, 2, 32
NB = N // BS


def _strips(seed, b=2):
    """(B, H, bs, N) strips from the JAX strip kernel (interpret mode)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, H, N, D)).astype(np.float32)
    k = rng.standard_normal((b, HKV, N, D)).astype(np.float32)
    # a few strongly attended key columns make the heads differ in sparsity
    k[:, :, :BS] *= np.linspace(0.5, 3.0, H // HKV * HKV)[None, :HKV, None,
                                                           None]
    return np.stack([np.asarray(strip_scores_pallas(
        jnp.asarray(q[i]), jnp.asarray(k[i]), block_size=BS,
        interpret=True)) for i in range(b)])


# ------------------------------------------------------------ pattern algebra

@pytest.mark.parametrize("nbq,nbkv", [(5, 7), (6, 6)])
def test_causal_block_mask_exact(nbq, nbkv):
    np.testing.assert_array_equal(
        patterns.causal_block_mask(nbq, nbkv).numpy(),
        np.asarray(jpatterns.causal_block_mask(nbq, nbkv)))


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 40),
       st.floats(0.05, 0.99), st.booleans())
def test_cumulative_topk_mask_exact(seed, n, gamma, ties):
    """Equal scores keep index order on both sides (stable sort)."""
    rng = np.random.default_rng(seed)
    s = rng.random((3, n)).astype(np.float32)
    if ties:
        s = np.round(s * 4) / 4 + 1e-3          # many exact ties
    np.testing.assert_array_equal(
        patterns.cumulative_topk_mask(T(s), gamma).numpy(),
        np.asarray(jpatterns.cumulative_topk_mask(jnp.asarray(s), gamma)))


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(2, 12))
def test_vertical_and_slash_masks_exact(seed, nb):
    rng = np.random.default_rng(seed)
    col = rng.random(nb) < 0.4
    off = rng.random(nb) < 0.4
    np.testing.assert_array_equal(
        patterns.vertical_block_mask(nb, T(col)).numpy(),
        np.asarray(jpatterns.vertical_block_mask(nb, jnp.asarray(col))))
    np.testing.assert_array_equal(
        patterns.slash_block_mask(nb, T(off)).numpy(),
        np.asarray(jpatterns.slash_block_mask(nb, jnp.asarray(off))))
    m = rng.random((2, nb, nb)) < 0.5
    np.testing.assert_allclose(
        patterns.block_mask_density(T(m)).numpy(),
        np.asarray(jpatterns.block_mask_density(jnp.asarray(m))), rtol=1e-6)


def test_jsd_matches():
    rng = np.random.default_rng(0)
    p = rng.dirichlet(np.ones(16), size=(4, 8)).astype(np.float32)
    q = rng.dirichlet(np.ones(16) * 0.3, size=(4, 8)).astype(np.float32)
    np.testing.assert_allclose(jsd.js_distance(T(p), T(q)).numpy(),
                               np.asarray(jjsd.js_distance(p, q)), atol=1e-6)
    np.testing.assert_allclose(
        jsd.js_distance_to_uniform(T(p)).numpy(),
        np.asarray(jjsd.js_distance_to_uniform(p)), atol=1e-6)


# --------------------------------------------------------- Algorithm 3 and 5

def test_pooled_block_estimate_matches():
    strips = _strips(0)
    ref = jax.vmap(jax.vmap(
        lambda s: jdetermine.pooled_block_estimate(s, BS)))(strips)
    got = determine.pooled_block_estimate(T(strips), BS)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_vertical_slash_search_exact():
    strips = _strips(1)
    ref = jax.vmap(jax.vmap(lambda s: jvs.search_vertical_slash_from_strip(
        s, 0.9, BS)))(strips)
    got = vertical_slash.search_vertical_slash_from_strip(T(strips), 0.9, BS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _decision_inputs(seed):
    rng = np.random.default_rng(seed)
    a_hat = np.asarray(jax.vmap(jax.vmap(
        lambda s: jdetermine.pooled_block_estimate(s, BS)))(_strips(seed)))
    reps = rng.dirichlet(np.ones(NB), size=(2, H)).astype(np.float32)
    reps[:, ::2] = a_hat[:, ::2]                 # similar pivots on even heads
    valid = rng.random((2, H)) < 0.6
    return a_hat, reps, valid


@pytest.mark.parametrize("ids,delta,tau", [
    ([0, 1, 2, 3, 4, 5, 6, 7], 0.3, 0.2),        # the default thresholds
    ([0, 0, 1, 1, -1, 2, 2, -1], 0.3, 0.2),      # shared clusters and noise
    ([0, 1, 2, 3, 4, 5, 6, 7], 0.0, 0.2),        # delta = 0: all VS
    ([0, 1, 2, 3, 4, 5, 6, 7], 1.0, 1.0),        # every valid pivot shared
])
def test_determine_sparse_pattern_exact(ids, delta, tau):
    a_hat, reps, valid = _decision_inputs(2)
    ref = jax.vmap(lambda a, r, v: jdetermine.determine_sparse_pattern(
        a, jnp.asarray(ids), r, v, delta=delta, tau=tau))(a_hat, reps, valid)
    got = determine.determine_sparse_pattern(
        T(a_hat), torch.tensor(ids), T(reps), T(valid), delta=delta,
        tau=tau)
    for name in ("use_shared", "use_dense", "use_vs"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    np.testing.assert_allclose(got.d_sparse.numpy(),
                               np.asarray(ref.d_sparse), atol=1e-6)
    np.testing.assert_allclose(got.d_sim.numpy(), np.asarray(ref.d_sim),
                               atol=1e-6)
    if delta == 0.0:
        assert got.use_vs.all()
    if delta == 1.0:
        assert torch.equal(got.use_shared, T(valid))


def test_first_head_in_cluster_exact():
    ids = np.array([3, 1, 3, -1, 1, 0, -1, 0], np.int32)
    np.testing.assert_array_equal(
        determine.first_head_in_cluster(T(ids)).numpy(),
        np.asarray(jdetermine.first_head_in_cluster(jnp.asarray(ids))))


# ------------------------------------------------ Algorithm 2 and dictionary

def _a_tilde(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2, H, NB, NB)).astype(np.float32)
    a = np.where(np.tril(np.ones((NB, NB), bool)), a, -np.inf)
    a[0, 1, 3] = -np.inf                         # a row with no finite entry
    return a.astype(np.float32)


def test_construct_pivotal_pattern_exact():
    a = _a_tilde(3)
    ref_m, ref_r = jax.vmap(jax.vmap(
        lambda x: jconstruct.construct_pivotal_pattern(x, 0.9)))(a)
    got_m, got_r = construct.construct_pivotal_pattern(T(a), 0.9)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    np.testing.assert_allclose(got_r.numpy(), np.asarray(ref_r), atol=1e-6)


def test_pattern_dict_lookup_and_update_exact():
    rng = np.random.default_rng(4)
    c = 5
    ids = np.array([0, 1, 1, 4, -1, 2, 3, 0], np.int32)
    masks = rng.random((2, c, NB, NB)) < 0.5
    reps = rng.random((2, c, NB)).astype(np.float32)
    valid = rng.random((2, c)) < 0.5
    new_m = rng.random((2, H, NB, NB)) < 0.5
    new_r = rng.random((2, H, NB)).astype(np.float32)
    upd = np.stack([determine.first_head_in_cluster(T(ids)).numpy()] * 2)
    upd[1, 3] = False
    jstate = jpdict.PivotalState(jnp.asarray(masks), jnp.asarray(reps),
                                 jnp.asarray(valid))
    tstate = pattern_dict.PivotalState(T(masks), T(reps), T(valid))
    ref = jax.vmap(lambda st, m, r, u: jpdict.update(
        st, jnp.asarray(ids), m, r, u))(jstate, new_m, new_r, upd)
    got = pattern_dict.update(tstate, T(ids), T(new_m), T(new_r), T(upd))
    for f in ("masks", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    np.testing.assert_allclose(got.reps.numpy(), np.asarray(ref.reps),
                               atol=1e-7)
    ref_l = jax.vmap(lambda st: jpdict.lookup(st, jnp.asarray(ids)))(jstate)
    got_l = pattern_dict.lookup(tstate, T(ids))
    for r, g in zip(ref_l, got_l):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_pattern_sharing_head_perm_exact():
    rng = np.random.default_rng(5)
    ids = np.array([2, 0, 2, 0, 1, 1, 3, 1], np.int32)
    use_shared = rng.random((2, H)) < 0.7
    dec = lambda u: jdetermine.PatternDecision(u, u, u, u, u, u)
    ref = jax.vmap(lambda u: jsa.pattern_sharing_head_perm(
        dec(u), jnp.asarray(ids), H // HKV))(use_shared)
    tdec = determine.PatternDecision(*([T(use_shared)] * 6))
    got = sa.pattern_sharing_head_perm(tdec, T(ids), H // HKV)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got // (H // HKV) == torch.arange(H) // (H // HKV)).all()


# ----------------------------------------------------------- one whole layer

@pytest.mark.parametrize("variant", ["default", "all_vs", "clustered"])
def test_share_layer_matches_reference(variant):
    """Two consecutive layers of the batched SharePrefill path: the second
    sees the dictionary the first built, so shared heads occur."""
    rng = np.random.default_rng(6)
    cfg = dict(block_size=BS, min_seq_blocks=2)
    if variant == "all_vs":
        cfg["delta"] = 0.0
    ids = (np.array([0, 0, 1, 1, -1, 2, 2, 3], np.int32)
           if variant == "clustered" else np.arange(H, dtype=np.int32))
    jcfg, tcfg = JSPC(**cfg), SharePrefillConfig(**cfg)
    jstate = jsa.init_batched_state(2, H, NB)
    tstate = sa.init_batched_state(2, H, NB)
    seen = {"shared": 0, "dense": 0, "vs": 0}
    for layer in range(2):
        q = rng.standard_normal((2, H, N, D)).astype(np.float32)
        k = rng.standard_normal((2, HKV, N, D)).astype(np.float32)
        v = rng.standard_normal((2, HKV, N, D)).astype(np.float32)
        jout, jstate, jst = jsa.batched_share_prefill_attention_layer(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jstate,
            jnp.asarray(ids), jcfg, j_attn_fn(block_size=BS))
        tout, tstate, tst = sa.batched_share_prefill_attention_layer(
            T(q), T(k), T(v), tstate, T(ids), tcfg)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   atol=1e-5, rtol=0)
        for f in ("masks", "valid"):
            np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                          np.asarray(getattr(jstate, f)))
        np.testing.assert_allclose(tstate.reps.numpy(),
                                   np.asarray(jstate.reps), atol=1e-6)
        for a, b in zip(tst, jst):
            np.testing.assert_allclose(float(a), float(b), atol=1e-6)
        seen["shared"] += float(tst.num_shared)
        seen["dense"] += float(tst.num_dense)
        seen["vs"] += float(tst.num_vs)
    if variant == "all_vs":
        assert seen["shared"] == seen["dense"] == 0
    else:
        assert seen["shared"] > 0 and seen["dense"] > 0


def test_share_prefill_api():
    cfg = SharePrefillConfig(block_size=BS, min_seq_blocks=4)
    sp = SharePrefill.trivial(cfg, num_layers=3, num_heads=H)
    assert sp.layer_cluster_ids().shape == (3, H)
    assert sp.applicable(4 * BS) and not sp.applicable(3 * BS)
    assert not sp.applicable(4 * BS + 1)
    assert not SharePrefill.disabled().applicable(N)
    st_ = sp.init_state(2, N)
    assert st_.masks.shape == (2, H, NB, NB) and not st_.valid.any()
    clustered = SharePrefill.from_clustering(cfg, np.zeros((3, H)), 0)
    assert clustered.num_clusters == 1
    with pytest.raises(ValueError, match="not divisible"):
        sp.init_state(1, N + 1)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        JSPC(block_size=BS, min_seq_blocks=4))


def test_share_layer_refuses_unbatched_attention_fn():
    """An unbatched (per-sample) attention function is never handed the
    batch: the layer runs it once per sample, on that sample's tensors."""
    calls = []

    def per_sample(q, k, v, masks):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(masks.shape)))
        return torch.zeros_like(q), torch.full(masks.shape, float("-inf"))

    tstate = sa.init_batched_state(2, H, NB)
    z = torch.zeros(2, H, N, D)
    zk = torch.zeros(2, HKV, N, D)
    out, new_state, _ = sa.batched_share_prefill_attention_layer(
        z, zk, zk, tstate, torch.arange(H), SharePrefillConfig(
            block_size=BS), attention_fn=per_sample)
    assert calls == [((H, N, D), (HKV, N, D), (H, NB, NB))] * 2
    assert out.shape == z.shape and new_state.masks.shape[0] == 2

"""The port's kernel modules against the JAX package's, on the CPU.

The port's wrappers take their plain PyTorch versions for CPU tensors; the
JAX side runs its Pallas kernels in interpret mode, as its own tests do.
Inputs come from numpy with a seed and go through both packages.

Tolerances (float32, no TF32): strips 1e-6 (probabilities ≤ 1, the same
float32 logits summed in another order), attention outputs and Ã 1e-5
(FlashAttention-style online softmax on the JAX side against one dense
softmax on the port's side), tables and masks exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import indices as jidx
from repro.kernels.chunked import chunked_attention as j_chunked
from repro.kernels.decode_attn import (
    DecodePlan as JPlan, decode_plan_einsum as j_einsum,
    decode_plan_einsum_sliced as j_sliced,
    flash_decode_sparse_batched as j_decode)
from repro.kernels.ops import batched_block_sparse_attention as j_bbsa
from repro.kernels.strip import strip_scores_pallas
from repro_torch.kernels import (
    DecodePlan, batched_block_sparse_attention, batched_sparse_attention_fn,
    block_sparse_attention_cuda, cap_block_mask, compact_block_mask,
    compute_strips, decode_plan_einsum, decode_plan_einsum_sliced,
    flash_decode_cuda, flash_decode_plan, flash_decode_sparse_batched,
    flash_decode_sparse_cuda, strip_scores, strip_scores_cuda,
    table_block_mask)
from repro_torch.kernels.decode_attn import flash_decode_sparse_paged_cuda
from repro_torch.kernels import _build
from repro_torch.kernels.chunked import chunked_attention

torch.backends.cuda.matmul.allow_tf32 = False

T = lambda a: torch.from_numpy(np.array(a))


def _qkv(rng, b, h, hkv, n, d, nkv=None):
    nkv = n if nkv is None else nkv
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(b, h, n, d), f(b, hkv, nkv, d), f(b, hkv, nkv, d)


def _a_tilde_close(ja, ta, atol=1e-5):
    ja = np.asarray(ja)
    assert (np.isinf(ja) == np.isinf(ta)).all()
    fin = np.isfinite(ja)
    np.testing.assert_allclose(ta[fin], ja[fin], atol=atol, rtol=0)


# ------------------------------------------------------------------ strip

@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)])
def test_strip_matches_pallas(h, hkv):
    rng = np.random.default_rng(1)
    q, k, _ = _qkv(rng, 2, h, hkv, 256, 64)
    ref = np.stack([np.asarray(strip_scores_pallas(
        jnp.asarray(q[i]), jnp.asarray(k[i]), block_size=64,
        interpret=True)) for i in range(2)])
    got = strip_scores(T(q), T(k), 64).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_strip_uses_last_rows_of_longer_q():
    """N and the causal row offsets come from k; q may carry more rows."""
    rng = np.random.default_rng(2)
    q, k, _ = _qkv(rng, 1, 4, 2, 192, 32, nkv=128)
    ref = np.asarray(strip_scores_pallas(jnp.asarray(q[0]),
                                         jnp.asarray(k[0]), block_size=64,
                                         interpret=True))
    got = compute_strips(T(q), T(k), block_size=64).numpy()[0]
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


# ----------------------------------------------------- block-sparse prefill

def _mask_with_edge_rows(rng, b, h, nbq, nbkv):
    mask = rng.random((b, h, nbq, nbkv)) < 0.6
    mask &= np.tril(np.ones((nbq, nbkv), bool), k=nbkv - nbq)
    mask[0, 1, 2] = False                        # counts == 0 row
    mask[1, 0, -1] = True                        # a full row
    return mask


@pytest.mark.parametrize("width", [None, 2])
def test_block_sparse_matches_batched_pallas(width):
    rng = np.random.default_rng(3)
    b, h, hkv, n, d, bs = 2, 8, 2, 256, 32, 64
    q, k, v = _qkv(rng, b, h, hkv, n, d)
    mask = _mask_with_edge_rows(rng, b, h, n // bs, n // bs)
    gate = rng.random((b, h)) < 0.5               # stats-gate mix
    jo, ja = j_bbsa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(mask), block_size=bs, width=width,
                    stats_gate=jnp.asarray(gate))
    to, ta = batched_block_sparse_attention(
        T(q), T(k), T(v), T(mask), block_size=bs, width=width,
        stats_gate=T(gate))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    _a_tilde_close(ja, ta.numpy())
    assert (to.numpy()[0, 1, 2 * bs:3 * bs] == 0).all()     # counts == 0
    assert np.isinf(ta.numpy()[~gate]).all()                # gated off


@pytest.mark.parametrize("offset", [None, 1])
def test_block_sparse_q_block_offset(offset):
    """A rectangular chunk (NBq < NBkv) anchored at ``q_block_offset``."""
    rng = np.random.default_rng(4)
    b, h, hkv, d, bs = 1, 4, 2, 32, 64
    q, k, v = _qkv(rng, b, h, hkv, 2 * bs, d, nkv=4 * bs)
    off = 2 if offset is None else offset
    mask = np.ones((b, h, 2, 4), bool)
    mask &= np.tril(np.ones((2, 4), bool), k=off)
    mask[0, 3, 1, 0] = False
    jo, ja = j_bbsa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(mask), block_size=bs, q_block_offset=offset)
    to, ta = batched_block_sparse_attention(T(q), T(k), T(v), T(mask),
                                            block_size=bs,
                                            q_block_offset=offset)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    _a_tilde_close(ja, ta.numpy())


def test_batched_fn_raises_on_misaligned_grid():
    fn = batched_sparse_attention_fn(block_size=64)
    assert fn.batched
    q = torch.zeros(1, 2, 128, 16)
    k = torch.zeros(1, 2, 128, 16)
    with pytest.raises(ValueError, match="does not tile"):
        fn(q, k, k, torch.ones(1, 2, 3, 3, dtype=torch.bool))


# ------------------------------------------------------------------ decode

def _decode_case(rng, b=2, h=8, hkv=2, s=256, d=32, bs=64):
    g = h // hkv
    nb = s // bs
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    ck = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    cv = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    keep = rng.random((b, hkv, nb, g)) < 0.7
    union = keep.any(-1)
    union[1, 1] = False                          # counts == 0 slot
    keep &= union[..., None]
    valid = np.ones((b, s), bool)
    valid[0, 100:150] = False                    # right-pad of a short prompt
    valid[:, 200:] = False                       # past the decode position
    return q, ck, cv, keep, union, valid


def test_decode_matches_pallas_kernel():
    rng = np.random.default_rng(5)
    q, ck, cv, keep, union, valid = _decode_case(rng)
    idx, cnt = jidx.compact_block_mask(jnp.asarray(union))
    ref = np.asarray(j_decode(jnp.asarray(q), jnp.asarray(ck),
                              jnp.asarray(cv), idx, cnt, jnp.asarray(keep),
                              jnp.asarray(valid), interpret=True))
    got = flash_decode_sparse_batched(
        T(q), T(ck), T(cv), T(idx), T(cnt),
        T(keep), T(valid)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    g = q.shape[1] // ck.shape[1]
    assert (got[1, g:2 * g] == 0).all() and (ref[1, g:2 * g] == 0).all()


@pytest.mark.parametrize("width", [None, 2])
def test_decode_einsum_paths_match_reference(width):
    rng = np.random.default_rng(6)
    q, ck, cv, keep, union, valid = _decode_case(rng)
    if width is not None:
        union = np.asarray(jidx.cap_block_mask(jnp.asarray(union), width))
        keep &= union[..., None]
    idx, cnt = jidx.compact_block_mask(jnp.asarray(union), width=width)
    jp = JPlan(idx, cnt, jnp.asarray(keep))
    tp = DecodePlan(T(idx), T(cnt), T(keep))
    args_j = (jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv))
    args_t = (T(q), T(ck), T(cv))
    ref_full = np.asarray(j_einsum(*args_j, jnp.asarray(keep),
                                   jnp.asarray(valid)))
    ref_sl = np.asarray(j_sliced(*args_j, jp, jnp.asarray(valid)))
    np.testing.assert_allclose(
        decode_plan_einsum(*args_t, T(keep), T(valid)).numpy(), ref_full,
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        decode_plan_einsum_sliced(*args_t, tp, T(valid)).numpy(), ref_sl,
        atol=1e-5, rtol=0)
    for impl in ("auto", "einsum", "kernel"):
        got = flash_decode_plan(*args_t, tp, T(valid), impl=impl).numpy()
        np.testing.assert_allclose(got, ref_sl, atol=1e-5, rtol=0)


def test_decode_impl_unknown_raises():
    rng = np.random.default_rng(7)
    q, ck, cv, keep, union, valid = _decode_case(rng)
    i, c = compact_block_mask(T(union))
    with pytest.raises(ValueError, match="unknown decode impl"):
        flash_decode_plan(T(q), T(ck), T(cv), DecodePlan(i, c, T(keep)),
                          T(valid), impl="pallas")


# ----------------------------------------------------------------- chunked

@pytest.mark.parametrize("causal,n", [(True, 256), (False, 256),
                                      (True, 200)])
def test_chunked_attention_matches_reference(causal, n):
    """Includes a ragged last chunk (200 = 3 × 64 + 8)."""
    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, 2, 4, 4, n, 32)
    ref, _ = j_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       block_size=64, causal=causal)
    got = chunked_attention(T(q), T(k), T(v), block_size=64, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


# ------------------------------------------------ CUDA wrappers on the CPU

def test_cuda_wrappers_refuse_cpu_tensors():
    """On the CPU the dispatchers take the plain versions; the kernel
    wrappers themselves never run on CPU tensors, and nothing is built."""
    q = torch.zeros(1, 2, 128, 64)
    k = torch.zeros(1, 2, 128, 64)
    with pytest.raises(ValueError, match="CUDA"):
        strip_scores_cuda(q, k, 64)
    idx = torch.zeros(1, 2, 2, 2, dtype=torch.int32)
    cnt = torch.ones(1, 2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        block_sparse_attention_cuda(q, k, k, idx, cnt, block_size=64)
    dec_idx = torch.zeros(1, 2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_sparse_cuda(q[:, :, 0], k, k, dec_idx,
                                 torch.ones(1, 2, dtype=torch.int32),
                                 torch.ones(1, 2, 2, 1, dtype=torch.bool),
                                 torch.ones(1, 128, dtype=torch.bool))
    assert not _build._LIBS


def test_cuda_wrappers_refuse_unsupported_shapes():
    """Shapes the kernels do not take raise before any device check."""
    with pytest.raises(ValueError, match="N % bs"):
        strip_scores_cuda(torch.zeros(1, 2, 100, 64),
                          torch.zeros(1, 2, 100, 64), 64)
    with pytest.raises(ValueError, match="block-aligned"):
        block_sparse_attention_cuda(
            torch.zeros(1, 2, 100, 64), torch.zeros(1, 2, 100, 64),
            torch.zeros(1, 2, 100, 64), torch.zeros(1, 2, 1, 1,
                                                    dtype=torch.int32),
            torch.zeros(1, 2, 1, dtype=torch.int32), block_size=64)
    # the decode kernels stream K/V rows as 16-byte vectors: D % 8 == 0
    d = 36
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_decode_sparse_cuda(
            torch.zeros(1, 2, d), torch.zeros(1, 2, 128, d),
            torch.zeros(1, 2, 128, d), torch.zeros(1, 2, 2, dtype=torch.int32),
            torch.ones(1, 2, dtype=torch.int32),
            torch.ones(1, 2, 2, 1, dtype=torch.bool),
            torch.ones(1, 128, dtype=torch.bool))
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_decode_sparse_paged_cuda(
            torch.zeros(1, 2, d), torch.zeros(3, 2, 64, d),
            torch.zeros(3, 2, 64, d), torch.ones(1, 2, dtype=torch.int32),
            torch.zeros(1, 2, 2, dtype=torch.int32),
            torch.ones(1, 2, dtype=torch.int32),
            torch.ones(1, 2, 2, 1, dtype=torch.bool),
            torch.ones(1, 128, dtype=torch.bool))
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_decode_cuda(torch.zeros(2, d), torch.zeros(2, 128, d),
                          torch.zeros(2, 128, d),
                          torch.ones(2, 128, dtype=torch.bool), block_kv=64)


def test_build_dir_keyed_by_sources():
    d = _build._build_dir()
    assert d.parent == _build.BUILD_ROOT and len(d.name) == 16
    assert {s.stem for s in _build._sources()} == {
        "strip", "block_sparse_attn", "decode_attn"}


# --------------------------------------------------------------- tables

masks = st.integers(0, 2 ** 31 - 1).flatmap(
    lambda seed: st.tuples(st.just(seed), st.integers(1, 3),
                           st.integers(1, 9), st.floats(0.0, 1.0),
                           st.one_of(st.none(), st.integers(1, 10))))


@settings(max_examples=30, deadline=None)
@given(masks)
def test_compact_block_mask_exact(case):
    seed, h, nb, density, width = case
    mask = np.random.default_rng(seed).random((2, h, nb, nb)) < density
    ji, jc = jidx.compact_block_mask(jnp.asarray(mask), width=width)
    ti, tc = compact_block_mask(T(mask), width=width)
    assert ti.dtype == torch.int32 and tc.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@settings(max_examples=30, deadline=None)
@given(masks)
def test_cap_block_mask_exact(case):
    seed, h, nb, density, width = case
    mask = np.random.default_rng(seed).random((h, nb, nb)) < density
    w = width or nb
    np.testing.assert_array_equal(
        cap_block_mask(T(mask), w).numpy(),
        np.asarray(jidx.cap_block_mask(jnp.asarray(mask), w)))


@settings(max_examples=40, deadline=None)
@given(masks)
def test_table_block_mask_inverts_compaction(case):
    seed, h, nb, density, width = case
    mask = T(np.random.default_rng(seed).random((h, nb, nb)) < density)
    i, c = compact_block_mask(mask, width=width)
    expect = mask if width is None else cap_block_mask(mask, width)
    assert torch.equal(table_block_mask(i, c, nb), expect)

"""The port's kernel API slice against the JAX package's, on the CPU.

The four kernels no serving path of the reference batches (the single-
sample block-sparse kernel, the paged block-sparse kernel and the two
single-sample decodes), the per-sample SharePrefill path behind
``attn_impl="kernel"`` / ``"ref"``, and the helpers they need.  The port's
wrappers take their plain versions for CPU tensors; the reference runs its
Pallas kernels in interpret mode.  Inputs come from numpy with a seed.

Tolerances: attention outputs, Ã and stats 1e-5 in float32 (online softmax
on the reference's side against one dense softmax on the port's, float32
products summed in another order) and 2e-2 in bfloat16 (one bf16 rounding
of outputs below 2 in magnitude, whose ulp is 2^-7, with room for a second);
stats are float32 in both dtypes (1e-5) and their −inf pattern is exact;
tables, masks, decisions and dictionaries exactly; dictionary
representatives 1e-6; model logits 1e-4 (two float32 layers); greedy tokens
near-tie aware at 1e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten
from repro.configs import get_smoke_config as j_smoke
from repro.core import share_attention as jsa
from repro.kernels import indices as jidx
from repro.kernels import ops as jops
from repro.kernels.block_sparse_attn import (
    block_sparse_attention_batched_paged as j_paged,
    block_sparse_attention_kernel as j_single, ragged_schedule)
from repro.kernels.decode_attn import flash_decode as j_flash_decode
from repro.kernels.decode_attn import flash_decode_sparse as j_flash_sparse
from repro.kernels.decode_attn import gather_pages as j_gather
from repro.kernels.ref import block_sparse_attention_ref as j_bsa_ref
from repro.kernels.ref import decode_attention_ref as j_decode_ref
from repro.kernels.ref import dense_attention_ref as j_dense_ref
from repro.models.api import build_model as j_build
from repro.serving import EngineConfig as JConfig, Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch import checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.core import pattern_dict as pdict
from repro_torch.core import share_attention as sa
from repro_torch.kernels import (
    block_sparse_attention, block_sparse_attention_batched_paged,
    block_sparse_attention_kernel, block_sparse_attention_paged_cuda,
    block_sparse_attention_plain, block_sparse_attention_ref,
    block_sparse_attention_single_cuda, build_block_tables,
    compact_block_mask, decode_attention_ref, decode_block_table,
    dense_attention_ref, flash_decode, flash_decode_cuda,
    flash_decode_sparse, flash_decode_sparse_single_cuda, make_attention_fn,
    scatter_block_stats, sparse_attention_fn)
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn import gather_pages
from repro_torch.models import build_model
from repro_torch.models.attention import resolve_attention_fn
from repro_torch.serving import EngineConfig, Request, ServingEngine

torch.backends.cuda.matmul.allow_tf32 = False

T = lambda a: torch.from_numpy(np.array(a))
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TIE_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor in ``dtype``."""
    x = np.asarray(x, np.float32)
    if dtype == "bfloat16":
        return (jnp.asarray(x).astype(jnp.bfloat16),
                torch.from_numpy(x).bfloat16())
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, ref, atol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol, rtol=0)


def _stats_close(got, ref, atol=1e-5):
    """Finite entries within ``atol``; −inf at exactly the same places."""
    got, ref = got.numpy(), np.asarray(ref)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], atol=atol, rtol=0)


def _causal_mask(rng, lead, nb, p=0.6):
    mask = rng.random((*lead, nb, nb)) < p
    mask &= np.tril(np.ones((nb, nb), bool))
    mask[..., np.arange(nb), np.arange(nb)] = True
    return mask


# ------------------------------------------- B.6: single-sample kernel

def _single_tables(rng, h, nb, width):
    """Tables of a random causal mask, with a counts == 0 row and a row
    that lists a block above the diagonal first (row 1 of head 0: blocks
    2, 0, 1)."""
    indices, counts = jidx.compact_block_mask(
        jnp.asarray(_causal_mask(rng, (h,), nb)), width=width)
    indices, counts = np.array(indices), np.array(counts)
    w = indices.shape[-1]
    counts[1, 2] = 0
    if w >= 3:
        indices[0, 1, :3] = (2, 0, 1)
        indices[0, 1, 3:] = 1
        counts[0, 1] = 3
    return indices, counts


@pytest.mark.parametrize("h,hkv,width,dtype", [
    (4, 2, None, "float32"), (8, 2, None, "float32"), (8, 2, 2, "float32"),
    (8, 2, None, "bfloat16")], ids=["g2", "g4", "capped", "bf16"])
def test_single_sample_kernel_matches_pallas(h, hkv, width, dtype):
    rng = np.random.default_rng(10)
    n, d, bs = 256, 32, 64
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((h, n, d), (hkv, n, d), (hkv, n, d)))
    indices, counts = _single_tables(rng, h, n // bs, width)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    jo, js = j_single(jq, jk, jv, jnp.asarray(indices), jnp.asarray(counts),
                      block_size=bs, interpret=True)
    to, ts = block_sparse_attention_kernel(tq, tk, tv, T(indices),
                                           T(counts), block_size=bs)
    assert to.dtype == tq.dtype and ts.dtype == torch.float32
    _close(to, jo, TOL[dtype])
    _stats_close(ts, js)
    assert (to[1, 2 * bs:3 * bs] == 0).all()                 # counts == 0
    assert np.isneginf(ts[1, 2].numpy()).all()
    if indices.shape[-1] >= 3:
        # the block above the diagonal is visited with no valid entry; the
        # batched kernel's causal step bound would drop block 1 instead
        row_stats = ts[0, 1].numpy()
        assert np.isneginf(row_stats[0]) and np.isfinite(row_stats[1:3]).all()
        bo, _ = block_sparse_attention_plain(
            tq[None], tk[None], tv[None], T(indices)[None], T(counts)[None],
            block_size=bs)
        row = slice(bs, 2 * bs)
        assert not torch.allclose(bo[0, 0, row].float(), to[0, row].float())


@pytest.mark.parametrize("impl,width", [("kernel", None), ("kernel", 2),
                                        ("ref", None)])
def test_block_sparse_attention_matches_reference(impl, width):
    """``ops.block_sparse_attention`` on out and the scattered Ã, GQA K/V."""
    rng = np.random.default_rng(11)
    h, hkv, n, d, bs = 8, 2, 256, 32, 64
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((h, n, d), (hkv, n, d), (hkv, n, d)))
    mask = _causal_mask(rng, (h,), n // bs)
    mask[2, 1] = False                                       # empty row
    jo, ja = jops.block_sparse_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        block_size=bs, impl=impl, interpret=True, width=width)
    to, ta = block_sparse_attention(T(q), T(k), T(v), T(mask),
                                    block_size=bs, impl=impl, width=width)
    _close(to, jo, 1e-5)
    _stats_close(ta, ja)
    fn = make_attention_fn(block_size=bs, impl=impl, width=width)
    fo, fa = fn(T(q), T(k), T(v), T(mask))
    assert torch.equal(fo, to) and torch.equal(fa, ta)
    with pytest.raises(ValueError, match="unknown block-sparse impl"):
        block_sparse_attention(T(q), T(k), T(v), T(mask), block_size=bs,
                               impl="sparse")


def test_sparse_attention_fn_is_per_sample():
    rng = np.random.default_rng(12)
    q, k = (T(rng.standard_normal(s).astype(np.float32))
            for s in ((4, 256, 32), (2, 256, 32)))
    mask = T(_causal_mask(rng, (4,), 4))
    fn = sparse_attention_fn(block_size=64, width=2)
    assert not getattr(fn, "batched", False)
    out, a = fn(q, k, k, mask)
    ref = block_sparse_attention(q, k, k, mask, block_size=64, width=2)
    assert torch.equal(out, ref[0]) and torch.equal(a, ref[1])
    with pytest.raises(ValueError, match="does not tile"):
        fn(q, k, k, mask[:, :2, :2])


def test_scatter_block_stats_and_tables_match_reference():
    rng = np.random.default_rng(13)
    mask = _causal_mask(rng, (3, 4), 6)
    mask[0, 1, 3] = False
    for width in (None, 2):
        ji, jc = jidx.compact_block_mask(jnp.asarray(mask), width=width)
        ti, tc = compact_block_mask(T(mask), width=width)
        stats = rng.standard_normal(ti.shape).astype(np.float32)
        stats[np.arange(ti.shape[-1]) >= tc.numpy()[..., None]] = -np.inf
        np.testing.assert_array_equal(
            scatter_block_stats(T(stats), ti, 6).numpy(),
            np.asarray(jidx.scatter_block_stats(
                jnp.asarray(stats).reshape(12, 6, -1),
                ji.reshape(12, 6, -1), 6)).reshape(3, 4, 6, 6))
    for a, b in zip(build_block_tables(T(mask)),
                    jidx.build_block_tables(jnp.asarray(mask))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_oracles_match_reference():
    rng = np.random.default_rng(14)
    h, n, d, bs = 4, 128, 32, 32
    q, k, v = (rng.standard_normal((h, n, d)).astype(np.float32)
               for _ in range(3))
    mask = _causal_mask(rng, (h,), n // bs)
    mask[1, 2] = False                          # a row with nothing valid
    to, ta = block_sparse_attention_ref(T(q), T(k), T(v), T(mask),
                                        block_size=bs)
    jo, ja = j_bsa_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(mask), block_size=bs)
    _close(to, jo, 1e-5)
    _stats_close(ta, ja)
    assert (to[1, 2 * bs:3 * bs] == 0).all()
    for causal in (True, False):
        _close(dense_attention_ref(T(q), T(k[:, :96]), T(v[:, :96]),
                                   causal=causal),
               j_dense_ref(jnp.asarray(q), jnp.asarray(k[:, :96]),
                           jnp.asarray(v[:, :96]), causal=causal), 1e-5)
    lm = np.arange(n) < 100
    for window, sink in ((0, 0), (16, 4)):
        _close(decode_attention_ref(T(q[:, 0]), T(k), T(v),
                                    length_mask=T(lm), window=window,
                                    sink=sink),
               j_decode_ref(jnp.asarray(q[:, 0]), jnp.asarray(k),
                            jnp.asarray(v), length_mask=jnp.asarray(lm),
                            window=window, sink=sink), 1e-5)


# ------------------------------------------------- B.5: paged kernel

def _page_in(k, v, ps, rng, slack=3):
    """Contiguous (B, Hkv, S, D) K/V scattered into a shuffled pool whose
    null page 0 and slack pages hold random values; numpy."""
    b, hkv, s, d = k.shape
    nb = s // ps
    num_pages = 1 + b * nb + slack
    table = (1 + rng.permutation(num_pages - 1)[: b * nb]).reshape(b, nb)

    def scatter(x):
        pool = rng.standard_normal((num_pages, hkv, ps, d)).astype(np.float32)
        pool[table.reshape(-1)] = np.moveaxis(
            x.reshape(b, hkv, nb, ps, d), 1, 2).reshape(b * nb, hkv, ps, d)
        return pool

    return scatter(k), scatter(v), table.astype(np.int32)


@pytest.mark.parametrize("offset,dtype", [(None, "float32"), (1, "float32"),
                                          (None, "bfloat16")])
def test_paged_kernel_matches_pallas(offset, dtype):
    """A 2-block chunk against a 4-block paged prefix: the plain version
    against the reference's paged kernel (Ã against the reference's own
    scatter of its stats), and bitwise against the contiguous plain
    version on the gathered pages."""
    rng = np.random.default_rng(15)
    b, h, hkv, n, s, d, bs = 2, 8, 2, 128, 256, 32, 64
    q = rng.standard_normal((b, h, n, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, s, d)).astype(np.float32)
            for _ in range(2))
    nbq, nbkv = n // bs, s // bs
    off = nbkv - nbq if offset is None else offset
    mask = rng.random((b, h, nbq, nbkv)) < 0.6
    mask &= np.tril(np.ones((nbq, nbkv), bool), k=off)
    mask[0, 1, 0] = False                                  # counts == 0
    indices, counts = (np.array(x) for x in
                       jidx.compact_block_mask(jnp.asarray(mask)))
    gate = rng.random((b, h)) < 0.5
    pk, pv, table = _page_in(k, v, bs, rng)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, pk, pv))
    jo, js = j_paged(jq, jk, jv, jnp.asarray(table), jnp.asarray(indices),
                     jnp.asarray(counts), block_size=bs,
                     stats_gate=jnp.asarray(gate), q_block_offset=offset,
                     interpret=True)
    row_map, slot_map = ragged_schedule(nbq, nbkv, width=nbkv,
                                        q_block_offset=offset)
    ja = jidx.scatter_schedule_stats(js, jnp.asarray(indices), row_map,
                                     slot_map, nbkv)
    args = (T(indices), T(counts))
    kw = dict(block_size=bs, stats_gate=T(gate), q_block_offset=offset)
    to, ta = block_sparse_attention_batched_paged(tq, tk, tv, T(table),
                                                  *args, **kw)
    _close(to, jo, TOL[dtype])
    _stats_close(ta, ja)
    assert (to[0, 1, :bs] == 0).all() and np.isneginf(ta[~T(gate)]).all()
    co, ca = block_sparse_attention_plain(
        tq, gather_pages(tk, T(table)), gather_pages(tv, T(table)), *args,
        **kw)
    assert torch.equal(to, co) and torch.equal(ta, ca)
    np.testing.assert_array_equal(
        gather_pages(tk, T(table)).float().numpy(),
        np.asarray(j_gather(jk, jnp.asarray(table)), np.float32))


def test_paged_kernel_requires_page_size_equal_block_size():
    pool = torch.zeros(5, 2, 32, 32)
    q = torch.zeros(1, 4, 64, 32)
    table = torch.ones(1, 2, dtype=torch.int32)
    idx = torch.zeros(1, 4, 1, 2, dtype=torch.int32)
    cnt = torch.ones(1, 4, 1, dtype=torch.int32)
    for fn in (block_sparse_attention_batched_paged,
               block_sparse_attention_paged_cuda):
        with pytest.raises(ValueError, match="page_size 32 != block_size"):
            fn(q, pool, pool, table, idx, cnt, block_size=64)


# ------------------------------------------- B.7 / B.8: single decodes

def _decode_inputs(rng, h, hkv, s, d, bs):
    q = rng.standard_normal((h, d)).astype(np.float32)
    k, v = (rng.standard_normal((hkv, s, d)).astype(np.float32)
            for _ in range(2))
    nb = s // bs
    # per-head masks within a group: random blocks × a length, one head
    # all false, and one kv group with no kept block at all in [1, 3)
    keep = rng.random((h, nb)) < 0.5
    keep[:, -1] = True
    mask = np.repeat(keep, bs, axis=1) & (np.arange(s) < s - 5)[None]
    mask &= rng.random((h, s)) < 0.9
    mask[1] = False
    mask[:, bs:3 * bs] = False
    return q, k, v, mask


def _reference_decode_table(mask, hkv, block_kv):
    """The table ``flash_decode_sparse`` builds (``repro/kernels/
    decode_attn.py:252-260``), in jnp as it is written there."""
    h, s = mask.shape
    nb = s // block_kv
    maskg = jnp.asarray(mask).reshape(hkv, h // hkv, s)
    blk_any = jnp.any(maskg.reshape(hkv, h // hkv, nb, block_kv), axis=(1, 3))
    cols = jnp.arange(nb, dtype=jnp.int32)
    key = jnp.where(blk_any, cols, cols + nb)
    order = jnp.argsort(key, axis=-1).astype(jnp.int32)
    counts = jnp.sum(blk_any, axis=-1).astype(jnp.int32)
    last = jnp.take_along_axis(order,
                               jnp.maximum(counts - 1, 0)[:, None], -1)
    widx = jnp.arange(nb, dtype=jnp.int32)
    indices = jnp.where(widx[None, :] < counts[:, None], order, last)
    return np.asarray(indices), np.asarray(counts)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("h,hkv,dtype", [(4, 2, "float32"),
                                         (8, 2, "float32"),
                                         (8, 2, "bfloat16")],
                         ids=["g2", "g4", "bf16"])
def test_single_decode_matches_pallas(sparse, h, hkv, dtype):
    rng = np.random.default_rng(16)
    s, d, bs = 512, 32, 64
    q, k, v, mask = _decode_inputs(rng, h, hkv, s, d, bs)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    jfn, tfn = ((j_flash_sparse, flash_decode_sparse) if sparse
                else (j_flash_decode, flash_decode))
    jo = jfn(jq, jk, jv, jnp.asarray(mask), block_kv=bs, interpret=True)
    to = tfn(tq, tk, tv, T(mask), block_kv=bs)
    assert to.shape == (h, d) and to.dtype == tq.dtype
    _close(to, jo, TOL[dtype])
    assert (to[1] == 0).all() and (np.asarray(jo[1], np.float32) == 0).all()
    if sparse:
        ti, tc = decode_block_table(T(mask), hkv, bs)
        ri, rc = _reference_decode_table(mask, hkv, bs)
        np.testing.assert_array_equal(ti.numpy(), ri)
        np.testing.assert_array_equal(tc.numpy(), rc)
        assert (tc.numpy() < s // bs).all()             # blocks skipped


def test_flash_decode_drops_a_ragged_tail_like_the_reference():
    """On the CPU the plain version reads ``S // block_kv`` whole blocks, as
    the reference does; the kernel's wrapper refuses the shape."""
    rng = np.random.default_rng(17)
    q, k, v, _ = _decode_inputs(rng, 4, 2, 320, 32, 64)
    k, v = k[:, :300], v[:, :300]
    mask = np.ones((4, 300), bool)
    jo = j_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(mask), block_kv=64, interpret=True)
    _close(flash_decode(T(q), T(k), T(v), T(mask), block_kv=64), jo, 1e-5)
    for fn in (flash_decode_cuda, flash_decode_sparse_single_cuda):
        with pytest.raises(ValueError, match="S % block_kv"):
            fn(T(q), T(k), T(v), T(mask), block_kv=64)


def test_new_cuda_wrappers_refuse_cpu_tensors():
    """The new kernel wrappers never run on CPU tensors, and nothing is
    built."""
    q = torch.zeros(4, 128, 64)
    k = torch.zeros(2, 128, 64)
    idx = torch.zeros(4, 2, 2, dtype=torch.int32)
    cnt = torch.ones(4, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        block_sparse_attention_single_cuda(q, k, k, idx, cnt, block_size=64)
    pool = torch.zeros(3, 2, 64, 64)
    with pytest.raises(ValueError, match="CUDA"):
        block_sparse_attention_paged_cuda(
            q[None], pool, pool, torch.ones(1, 2, dtype=torch.int32),
            idx[None], cnt[None], block_size=64)
    mask = torch.ones(4, 128, dtype=torch.bool)
    for fn in (flash_decode_cuda, flash_decode_sparse_single_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q[:, 0], k, k, mask, block_kv=64)
    assert not _build._LIBS


# --------------------------------------- the per-sample SharePrefill path

def _cfgs():
    kw = dict(num_heads=8, num_kv_heads=2)
    return (dataclasses.replace(j_smoke("llama3-8b-262k"), **kw),
            dataclasses.replace(get_smoke_config("llama3-8b-262k"), **kw))


S = 512
PLENS = (512, 450)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tp = checkpoint.params_from_numpy(_flatten(jp), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in PLENS]
    toks = np.zeros((2, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, prompts=prompts, toks=toks)


def test_per_sample_layer_matches_reference():
    """One layer over a batch of two through a per-sample attention
    function: outputs, the new dictionaries and the reduced LayerStats
    against the reference's vmap branch and its ``_reduce_layer_stats``
    (means of the per-sample stats, ``max_row_pop`` a max)."""
    rng = np.random.default_rng(18)
    b, h, hkv, n, d, bs = 2, 8, 2, 256, 32, 64
    jcfg, tcfg = _cfgs()
    spc = dataclasses.replace(jcfg.share_prefill, block_size=bs)
    tspc = dataclasses.replace(tcfg.share_prefill, block_size=bs)
    q = rng.standard_normal((b, h, n, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, n, d)).astype(np.float32)
            for _ in range(2))
    ids = np.array([0, 0, 1, 1, 2, 2, -1, 3], np.int32)
    nb = n // bs
    # sample 1 starts with a pivot for cluster 0 so its heads can share
    masks0 = np.zeros((b, 4, nb, nb), bool)
    masks0[1, 0] = np.tril(np.ones((nb, nb), bool))
    reps0 = np.full((b, 4, nb), 1.0 / nb, np.float32)
    valid0 = np.zeros((b, 4), bool)
    valid0[1, 0] = True
    from repro.core.pattern_dict import PivotalState as JState
    jst = JState(jnp.asarray(masks0), jnp.asarray(reps0),
                 jnp.asarray(valid0))
    tst = pdict.PivotalState(T(masks0), T(reps0), T(valid0))
    for impl in ("kernel", "ref"):
        jo, jnew, jstats = jsa.batched_share_prefill_attention_layer(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jst,
            jnp.asarray(ids), spc,
            jops.make_attention_fn(block_size=bs, impl=impl))
        to, tnew, tstats = sa.batched_share_prefill_attention_layer(
            T(q), T(k), T(v), tst, T(ids), tspc,
            make_attention_fn(block_size=bs, impl=impl))
        _close(to, jo, 1e-5)
        np.testing.assert_array_equal(tnew.masks.numpy(),
                                      np.asarray(jnew.masks))
        np.testing.assert_array_equal(tnew.valid.numpy(),
                                      np.asarray(jnew.valid))
        np.testing.assert_allclose(tnew.reps.numpy(), np.asarray(jnew.reps),
                                   atol=1e-6)
        for name, a, r in zip(tstats._fields, tstats, jstats):
            np.testing.assert_allclose(float(a), float(r), atol=1e-6,
                                       err_msg=name)
    # the input dictionaries are untouched, and the samples' own differ
    np.testing.assert_array_equal(tst.masks.numpy(), masks0)
    assert not torch.equal(tnew.masks[0], tnew.masks[1])


def test_single_sample_layer_takes_either_fn():
    """``share_prefill_attention_layer`` for one sample, with its default
    per-sample function and with a batched one (the sample as a batch of
    one, with the stats gate), against the reference's."""
    from repro.kernels import batched_sparse_attention_fn as j_batched_fn
    from repro.core.pattern_dict import init_pivotal_state
    from repro_torch.kernels import batched_sparse_attention_fn
    rng = np.random.default_rng(19)
    h, hkv, n, d, bs = 8, 2, 256, 32, 64
    jcfg, tcfg = _cfgs()
    spc = dataclasses.replace(jcfg.share_prefill, block_size=bs)
    tspc = dataclasses.replace(tcfg.share_prefill, block_size=bs)
    q = rng.standard_normal((h, n, d)).astype(np.float32)
    k, v = (rng.standard_normal((hkv, n, d)).astype(np.float32)
            for _ in range(2))
    ids = np.array([0, 0, 1, 1, 2, 2, -1, 3], np.int32)
    jst = init_pivotal_state(4, n // bs)
    tst = pdict.PivotalState(*(T(x) for x in jst))
    for jfn, tfn in ((None, None),
                     (j_batched_fn(block_size=bs),
                      batched_sparse_attention_fn(block_size=bs))):
        jo, jnew, jstats = jsa.share_prefill_attention_layer(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jst,
            jnp.asarray(ids), spc, jfn)
        to, tnew, tstats = sa.share_prefill_attention_layer(
            T(q), T(k), T(v), tst, T(ids), tspc, tfn)
        _close(to, jo, 1e-5)
        for f in ("masks", "valid"):
            np.testing.assert_array_equal(getattr(tnew, f).numpy(),
                                          np.asarray(getattr(jnew, f)))
        np.testing.assert_allclose(tnew.reps.numpy(), np.asarray(jnew.reps),
                                   atol=1e-6)
        for name, a, r in zip(tstats._fields, tstats, jstats):
            np.testing.assert_allclose(float(a), float(r), atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_model_prefill_matches_reference(models, impl):
    m = models
    plens = np.asarray(PLENS, np.int32)
    jr = m["jm"].prefill(m["jp"], jnp.asarray(m["toks"]),
                         m["jm"].default_share_prefill(), method="share",
                         attn_impl=impl, prompt_lens=jnp.asarray(plens))
    tr = m["tm"].prefill(m["tp"], T(m["toks"]).long(),
                         m["tm"].default_share_prefill(), method="share",
                         attn_impl=impl, prompt_lens=T(plens).long())
    np.testing.assert_allclose(tr.last_logits.numpy(),
                               np.asarray(jr.last_logits), atol=1e-4, rtol=0)
    for i in range(2):
        np.testing.assert_allclose(tr.cache[i].numpy(),
                                   np.asarray(jr.cache["stack"][i]),
                                   atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tr.sp_state.masks.numpy(),
                                  np.asarray(jr.sp_state.masks))
    np.testing.assert_array_equal(tr.sp_state.valid.numpy(),
                                  np.asarray(jr.sp_state.valid))
    np.testing.assert_allclose(tr.sp_state.reps.numpy(),
                               np.asarray(jr.sp_state.reps), atol=1e-6)
    for name, a, r in zip(tr.stats._fields, tr.stats, jr.stats):
        np.testing.assert_allclose(float(a), float(r), atol=1e-6,
                                   err_msg=name)
    assert 0.0 < float(tr.stats.block_density) < 1.0


def test_width_cap_applies_to_the_per_sample_path(models):
    """``attn_width`` under ``kernel`` caps the masks as a boolean mask,
    like the reference."""
    m = models
    kw = dict(method="share", attn_impl="kernel", attn_width=3)
    jr = m["jm"].prefill(m["jp"], jnp.asarray(m["toks"]),
                         m["jm"].default_share_prefill(), **kw)
    tr = m["tm"].prefill(m["tp"], T(m["toks"]).long(),
                         m["tm"].default_share_prefill(), **kw)
    np.testing.assert_allclose(tr.last_logits.numpy(),
                               np.asarray(jr.last_logits), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tr.sp_state.masks.numpy(),
                                  np.asarray(jr.sp_state.masks))
    assert not getattr(resolve_attention_fn("kernel", 64, width=3),
                       "batched", False)


def _reference_margins(m, tokens, upto, impl):
    """The reference's top-2 logit margins per row at steps 0..upto,
    teacher-forced on its own tokens (prefill, grown cache and plan as its
    engine builds them)."""
    from repro.serving import decode_plan as jdplan
    jm, jp = m["jm"], m["jp"]
    plens = jnp.asarray(PLENS, jnp.int32)
    sp = jm.default_share_prefill()
    res = jm.prefill(jp, jnp.asarray(m["toks"]), sp, method="share",
                     attn_impl=impl, prompt_lens=plens)
    extra = 128
    cache = {"prefix": [], "stack": tuple(
        jnp.pad(c, ((0, 0),) * 3 + ((0, extra), (0, 0)))
        for c in res.cache["stack"])}
    plan = jdplan.build_decode_plan(sp, res.sp_state, jm.cfg,
                                    prefill_len=S, cache_len=S + extra)
    logits, margins = res.last_logits, []
    for t in range(upto + 1):
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        if t == upto:
            break
        tok = jnp.asarray(np.stack([r[t] for r in tokens])[:, None])
        logits, cache = jm.decode(jp, tok, cache, jnp.int32(S + t),
                                  plan=plan, prompt_lens=plens,
                                  prefill_len=S)
    return np.stack(margins, axis=1)


def test_kernel_impl_serve_matches_reference(models):
    """A greedy batch serve with ``EngineConfig(attn_impl="kernel")`` on
    both sides, near-tie aware."""
    m, new = models, 6
    jeng = JEngine(m["jm"], m["jp"], m["jm"].default_share_prefill(),
                   JConfig(max_batch=2, method="share", attn_impl="kernel",
                           seq_buckets=(S,), decode_sparse=True))
    teng = ServingEngine(m["tm"], m["tp"], m["tm"].default_share_prefill(),
                         EngineConfig(max_batch=2, method="share",
                                      attn_impl="kernel", seq_buckets=(S,),
                                      decode_sparse=True))
    reqs = lambda cls: [cls(uid=i, prompt=p, max_new_tokens=new)
                        for i, p in enumerate(m["prompts"])]
    ref = [r.output_tokens for r in jeng.serve(reqs(JRequest))]
    got = [r.output_tokens for r in teng.serve(reqs(Request))]
    flips = [next((t for t, (a, b) in enumerate(zip(r, g)) if a != b), None)
             for r, g in zip(ref, got)]
    assert all(len(r) == len(g) == new for r, g in zip(ref, got))
    if all(f is None for f in flips):
        return
    margins = _reference_margins(m, ref, max(f for f in flips
                                             if f is not None), "kernel")
    for row, f in enumerate(flips):
        if f is not None:
            assert margins[row, f] < TIE_TOL

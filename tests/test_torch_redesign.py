"""The algorithms of the redesigned kernel bodies, on the CPU.

The CUDA bodies run only on the card; these tests hold plain mirrors of
their arithmetic against the JAX package's Pallas kernels (interpret mode):

  * split-K decode (``csrc/decode_attn.cu``): each (batch, kv head) row's
    table entries, as 32-key tiles, cut into ``splits`` contiguous chunks,
    a partial ``(m, l, acc)`` per chunk, merged in split order under the
    −inf-safe rule, at float32 tolerance (1e-5, the one the port's decode
    tests use), with exact zeros where the contract asks for them;
  * the bf16 tensor-core block-sparse bodies (``csrc/block_sparse_attn.cu``):
    64-key sub-tiles (the ``mma.sync`` body) or whole 128-key blocks (the
    Hopper body), base-2 online softmax, P rounded to bf16 only as the
    operand of PV, float32 ``l`` and accumulators, Ã from the raw logits,
    within ``chip_smoke.TOL`` for bf16 (the tolerance the card's check uses);

and pin the wrappers' split rule and their argument plumbing to the C
functions (counts of pointers and ints, one split rule for every decode
instance, the strip's chunk partials' scratch).  The strip body's own
mirror is in ``tests/test_torch_strip.py``.
"""
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import indices as jidx
from repro.kernels.decode_attn import (
    flash_decode as j_flash_decode,
    flash_decode_sparse_batched as j_decode)
from repro.kernels.ops import batched_block_sparse_attention as j_bbsa
from repro_torch.kernels import _build
from repro_torch.kernels import block_sparse_attn as bsa
from repro_torch.kernels import decode_attn as da
from repro_torch.kernels import strip as sk
from repro_torch.kernels.indices import compact_block_mask

torch.backends.cuda.matmul.allow_tf32 = False

ROOT = Path(__file__).resolve().parents[1]
T = lambda a: torch.from_numpy(np.array(a))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------- split-K decode

def _partial(qg, k, v, ok):
    """One chunk's partial: qg (G, D) against k / v (K, D) under ok (G, K);
    (m, l, acc) with (−inf, 0, 0) for a head that sees nothing."""
    d = qg.shape[-1]
    s = (qg @ k.T) * (1.0 / math.sqrt(d))
    s = s.masked_fill(~ok, float("-inf"))
    m = s.max(dim=-1).values if s.shape[-1] else torch.full(
        (qg.shape[0],), float("-inf"))
    safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.where(ok, torch.exp(s - safe[:, None]), torch.zeros_like(s))
    return m, p.sum(-1), p @ v


def _combine(parts):
    """The combine kernel's rule: weights exp(m_s − M) against the largest
    partial max M, 0 for a partial at −inf, in split order."""
    ms = torch.stack([m for m, _, _ in parts])          # (S, G)
    big = ms.max(dim=0).values
    l = torch.zeros_like(big)
    acc = torch.zeros_like(parts[0][2])
    for m, ls, a in parts:
        w = torch.where(torch.isinf(m), torch.zeros_like(m),
                        torch.exp(m - torch.where(torch.isinf(big),
                                                  torch.zeros_like(big),
                                                  big)))
        l = l + ls * w
        acc = acc + a * w[:, None]
    return acc / torch.clamp(l, min=1e-30)[:, None]


KT = 32      # keys per tile of the decode kernel


def _chunk_keys(blocks, bs: int, splits: int):
    """Each split's keys: the blocks' 32-key tiles cut into ``splits``
    contiguous chunks of the kernel's rule [c·N / splits, (c+1)·N /
    splits)."""
    tiles = (blocks[:, None] * bs + torch.arange(0, bs, KT)[None]).reshape(-1)
    n = len(tiles)
    return [(tiles[c * n // splits:(c + 1) * n // splits, None]
             + torch.arange(KT)[None]).reshape(-1) for c in range(splits)]


def split_decode_plan(q, ck, cv, idx, cnt, keep, valid, splits):
    """Mirror of the PLAN instance: q (B, H, D), cache (B, Hkv, S, D), the
    plan tables and valid (B, S); (B, H, D)."""
    b, h, d = q.shape
    hkv, s = ck.shape[1], ck.shape[2]
    g, nb = h // hkv, keep.shape[2]
    bs = s // nb
    out = torch.zeros_like(q)
    for bi in range(b):
        for hk in range(hkv):
            qg = q[bi, hk * g:(hk + 1) * g]
            blocks = idx[bi, hk, :int(cnt[bi, hk])].long()
            parts = []
            for keys in _chunk_keys(blocks, bs, splits):
                ok = keep[bi, hk, keys // bs].T & valid[bi, keys][None]
                parts.append(_partial(qg, ck[bi, hk, keys], cv[bi, hk, keys],
                                      ok))
            out[bi, hk * g:(hk + 1) * g] = _combine(parts)
    return out


def split_decode_mask(q, ck, cv, mask, bs, splits):
    """Mirror of the MASK_DENSE instance: q (H, D), cache (Hkv, S, D), the
    token mask (H, S); every block walked; (H, D)."""
    h, d = q.shape
    hkv, s = ck.shape[:2]
    g = h // hkv
    out = torch.zeros_like(q)
    for hk in range(hkv):
        parts = []
        for keys in _chunk_keys(torch.arange(s // bs), bs, splits):
            parts.append(_partial(q[hk * g:(hk + 1) * g], ck[hk, keys],
                                  cv[hk, keys],
                                  mask[hk * g:(hk + 1) * g][:, keys]))
        out[hk * g:(hk + 1) * g] = _combine(parts)
    return out


def _plan_case(seed):
    """Rows of seven 64-key blocks (14 tiles: uneven chunks for most split
    counts, chunks that cut a block), a counts == 0 slot, and a row whose
    third and fourth blocks are masked for every head (an all-masked chunk
    at 7 splits)."""
    rng = np.random.default_rng(seed)
    b, h, hkv, nb, bs, d = 2, 8, 2, 7, 64, 32
    g, s = h // hkv, nb * bs
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    ck = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    cv = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    keep = rng.random((b, hkv, nb, g)) < 0.7
    keep[0, 0] = True
    keep[0, 0, 2:4] = False                      # an all-masked chunk
    union = keep.any(-1)
    union[0, 0] = True
    union[1, 1] = False                          # counts == 0 slot
    keep &= union[..., None]
    valid = np.ones((b, s), bool)
    valid[1, 300:] = False                       # right-pad
    return q, ck, cv, keep, union, valid


@pytest.mark.parametrize("splits", [1, 2, 3, 7, 14, 20])
def test_split_decode_matches_pallas(splits):
    """Split counts from one chunk through one split per block (7) and per
    tile (14) to empty chunks (20), uneven last chunks, an all-masked chunk
    and a counts == 0 slot, against the reference kernel."""
    q, ck, cv, keep, union, valid = _plan_case(11)
    idx, cnt = jidx.compact_block_mask(jnp.asarray(union))
    ref = np.asarray(j_decode(jnp.asarray(q), jnp.asarray(ck),
                              jnp.asarray(cv), idx, cnt, jnp.asarray(keep),
                              jnp.asarray(valid), interpret=True))
    got = split_decode_plan(T(q), T(ck), T(cv), T(idx), T(cnt), T(keep),
                            T(valid), splits).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    g = q.shape[1] // ck.shape[1]
    assert (got[1, g:2 * g] == 0).all()          # counts == 0: exact zeros
    # the all-masked chunk leaves the result as without those blocks
    idx0, cnt0 = np.asarray(idx).copy(), np.asarray(cnt).copy()
    keep_rows = [j for j in idx0[0, 0, :cnt0[0, 0]] if j not in (2, 3)]
    idx0[0, 0, :len(keep_rows)] = keep_rows
    cnt0[0, 0] = len(keep_rows)
    alone = split_decode_plan(T(q), T(ck), T(cv), T(idx0), T(cnt0), T(keep),
                              T(valid), 1).numpy()
    np.testing.assert_allclose(got[0, :g], alone[0, :g], atol=1e-6, rtol=0)


@pytest.mark.parametrize("splits", [1, 3, 16])
def test_split_decode_token_mask_matches_pallas(splits):
    """The token-mask (flash_decode) instance under the same split and
    combine, with an all-false head writing exact zeros."""
    rng = np.random.default_rng(12)
    h, hkv, bs, d = 8, 2, 64, 32
    s = 8 * bs
    q = rng.standard_normal((h, d)).astype(np.float32)
    ck = rng.standard_normal((hkv, s, d)).astype(np.float32)
    cv = rng.standard_normal((hkv, s, d)).astype(np.float32)
    mask = rng.random((h, s)) < 0.1
    mask[3] = False                              # an all-false head
    mask[5, :3 * bs] = False                     # masked early chunks
    ref = np.asarray(j_flash_decode(jnp.asarray(q), jnp.asarray(ck),
                                    jnp.asarray(cv), jnp.asarray(mask),
                                    block_kv=bs, interpret=True))
    got = split_decode_mask(T(q), T(ck), T(cv), T(mask), bs, splits).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert (got[3] == 0).all()


@pytest.mark.parametrize("b,hkv,w,sms,want", [
    (2, 8, 65, 132, 33),      # the batch serve: 528 CTAs on 132 SMs
    (4, 8, 65, 132, 17),      # the paged scheduler serve
    (1, 8, 65, 132, 65),      # one sample: capped at one split per entry
    (1, 1, 1, 132, 1),        # a one-entry table
    (64, 8, 65, 132, 2),
    (128, 8, 10, 132, 1),     # more rows than CTAs wanted: one split
    (3, 2, 40, 0, 1),         # no SM count: still one split
])
def test_decode_split_rule(b, hkv, w, sms, want):
    got = da.decode_splits(b, hkv, w, sms)
    assert got == want
    assert 1 <= got <= w and got * b * hkv >= 1


class _FakeLaunch:
    """Stands in for a loaded C function: records the arguments and checks
    their count against the declared pointers, ints and stream."""

    def __init__(self, n_ptr, n_int):
        self.n = n_ptr + n_int + 1
        self.calls = []

    def __call__(self, *args):
        assert len(args) == self.n
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_launch(monkeypatch):
    """The CUDA wrappers driven on CPU tensors: device checks off, a fake C
    function per entry point, 132 SMs."""
    fns = {}

    def function(stem, name, n_ptr, n_int):
        return fns.setdefault(name, _FakeLaunch(n_ptr, n_int))

    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    monkeypatch.setattr(da, "_check_launch", lambda *a: None)
    monkeypatch.setattr(da, "_check_masked",
                        lambda what, q, ck, cv, mask, block_kv:
                        (q.shape[0], ck.shape[0], ck.shape[1], q.shape[1]))
    monkeypatch.setattr(da, "sm_count", lambda device: 132)
    monkeypatch.setattr(bsa, "_check_tensors", lambda *a: None)
    monkeypatch.setattr(sk, "_check_tensors", lambda *a: None)
    return fns


def test_decode_wrappers_share_the_split_rule(fake_launch):
    """The contiguous, paged and token-mask wrappers pass decode_splits of
    their own (B, Hkv, NB) and scratch for (B, H, splits, D + 2)
    partials."""
    b, h, hkv, nb, ps, d = 2, 32, 8, 65, 32, 128
    s = nb * ps
    q = torch.zeros(b, h, d)
    cache = torch.zeros(b, hkv, s, d)
    idx, cnt = compact_block_mask(torch.ones(b, hkv, nb, dtype=torch.bool))
    keep = torch.ones(b, hkv, nb, h // hkv, dtype=torch.bool)
    valid = torch.ones(b, s, dtype=torch.bool)
    pool = torch.zeros(b * nb + 1, hkv, ps, d)
    table = torch.arange(1, b * nb + 1, dtype=torch.int32).reshape(b, nb)
    da.flash_decode_sparse_cuda(q, cache, cache, idx, cnt, keep, valid)
    da.flash_decode_sparse_paged_cuda(q, pool, pool, table, idx, cnt, keep,
                                      valid)
    mask = torch.ones(h, s, dtype=torch.bool)
    da.flash_decode_cuda(q[0], cache[0], cache[0], mask, block_kv=ps)
    da.flash_decode_sparse_single_cuda(q[0], cache[0], cache[0], mask,
                                       block_kv=ps)
    want = da.decode_splits(b, hkv, nb, 132)
    plan = fake_launch["repro_decode_attn"].calls[0]
    paged = fake_launch["repro_decode_attn_paged"].calls[0]
    assert plan[-2] == paged[-2] == want == 33
    one = da.decode_splits(1, hkv, nb, 132)
    masked = fake_launch["repro_decode_attn_mask"].calls
    assert [c[-2] for c in masked] == [one, one] and [c[-3] for c in
                                                      masked] == [0, 1]


@pytest.mark.parametrize("w", [65, 33, 16, 4])
def test_decode_split_ignores_table_width(fake_launch, w):
    """A plan narrowed to W table entries (a refresh's set_plan_width)
    splits each row as the full-width plan does: the split follows the
    plan's NB blocks, so no row's rounding moves with W."""
    b, h, hkv, nb, ps, d = 2, 32, 8, 65, 32, 128
    q = torch.zeros(b, h, d)
    keep = torch.zeros(b, hkv, nb, h // hkv, dtype=torch.bool)
    keep[:, :, :4] = True
    idx, cnt = compact_block_mask(keep.any(-1))
    idx = idx[..., :w].contiguous()
    valid = torch.ones(b, nb * ps, dtype=torch.bool)
    pool = torch.zeros(b * nb + 1, hkv, ps, d)
    table = torch.arange(1, b * nb + 1, dtype=torch.int32).reshape(b, nb)
    cache = torch.zeros(b, hkv, nb * ps, d)
    da.flash_decode_sparse_cuda(q, cache, cache, idx, cnt, keep, valid)
    da.flash_decode_sparse_paged_cuda(q, pool, pool, table, idx, cnt, keep,
                                      valid)
    plan = fake_launch["repro_decode_attn"].calls[0]
    paged = fake_launch["repro_decode_attn_paged"].calls[0]
    assert plan[-3] == paged[-4] == w            # the table width passed
    assert plan[-2] == paged[-2] == da.decode_splits(b, hkv, nb, 132) == 33


def test_block_sparse_wrappers_pass_every_argument(fake_launch):
    """The three block-sparse wrappers hand their C functions as many
    arguments as those declare."""
    b, h, hkv, n, d, bs = 1, 4, 2, 256, 64, 64
    q, kv = torch.zeros(b, h, n, d), torch.zeros(b, hkv, n, d)
    m = torch.tril(torch.ones(n // bs, n // bs, dtype=torch.bool))
    idx, cnt = compact_block_mask(m.expand(b, h, -1, -1))
    bsa.block_sparse_attention_cuda(q, kv, kv, idx, cnt, block_size=bs)
    bsa.block_sparse_attention_single_cuda(q[0], kv[0], kv[0], idx[0],
                                           cnt[0], block_size=bs)
    pool = torch.zeros(5, hkv, bs, d)
    table = torch.arange(1, 5, dtype=torch.int32)[None]
    bsa.block_sparse_attention_paged_cuda(q, pool, pool, table, idx, cnt,
                                          block_size=bs)
    assert {k: len(v.calls) for k, v in fake_launch.items()} == {
        "repro_block_sparse_attn": 1, "repro_block_sparse_attn_single": 1,
        "repro_block_sparse_attn_paged": 1}


def test_strip_wrapper_passes_every_argument(fake_launch, monkeypatch):
    """The strip wrapper hands its C function q, k, the strip, float32
    scratch (2, B, H, bs, C) for the chunk partials, and the chunk size of
    the rule; N = 1088: 17 sub-tiles in 6 chunks of 192 keys, the last of
    128."""
    monkeypatch.setattr(_build, "ptr", lambda t: t)
    b, h, hkv, nq, n, d, bs = 2, 8, 2, 1120, 1088, 64, 64
    q, k = torch.zeros(b, h, nq, d), torch.zeros(b, hkv, n, d)
    out = sk.strip_scores_cuda(q, k, bs)
    (call,) = fake_launch["repro_strip"].calls
    q_, k_, out_, ml, *ints, stream = call
    assert q_ is q and k_ is k and out_ is out and stream is None
    assert out.shape == (b, h, bs, n) and out.dtype == torch.float32
    assert ml.shape == (2, b, h, bs, 6) and ml.dtype == torch.float32
    assert ints == [_build.dtype_code(q), b, h, hkv, nq, n, d, bs,
                    sk.strip_chunk(n)] and sk.strip_chunk(n) == 192


# ------------------------------------------------ tensor-core block-sparse

def _bf16(x):
    return torch.as_tensor(x).to(torch.bfloat16).float()


def tc_body(q, k, v, idx, cnt, *, bs, off, gate, causal=True, kn=64):
    """Mirror of the bf16 block-sparse bodies' arithmetic in float32 on bf16
    inputs: kn-key sub-tiles (64 for bsa_tc_kernel; 128, one whole block a
    step, for the Hopper body bsa_wgmma_kernel), base-2 online softmax with
    the −inf guards, P rounded to bf16 as PV's operand, l and acc in
    float32, Ã as the raw logits' sum times scale over the valid count;
    (out in bf16, Ã).  The Hopper body takes 2^x of the logit times scale
    · log2 e less the row maximum as one fused multiply-add, a float32
    rounding apart from this product-then-difference."""
    b, h, n, d = q.shape
    hkv, nkv = k.shape[1], k.shape[2]
    g, nbq, nbkv = h // hkv, n // bs, nkv // bs
    w = idx.shape[-1]
    scale = 1.0 / math.sqrt(d)
    sl2 = scale * 1.4426950408889634
    inf = float("-inf")
    out = torch.zeros_like(q)
    a_tilde = torch.full((b, h, nbq, nbkv), inf)
    for bi in range(b):
        for hi in range(h):
            kh = hi // g
            for row in range(nbq):
                steps = min(off + row + 1, w) if causal else w
                nvis = min(int(cnt[bi, hi, row]), max(1, min(steps, nbkv)))
                qpos = (off + row) * bs + torch.arange(bs)
                qt = q[bi, hi, row * bs:(row + 1) * bs]
                m = torch.full((bs,), inf)
                l = torch.zeros(bs)
                o = torch.zeros(bs, d)
                for wi in range(nvis):
                    j = int(idx[bi, hi, row, wi])
                    ssum, scnt = 0.0, 0
                    for sub in range(bs // kn):
                        keys = j * bs + sub * kn + torch.arange(kn)
                        s = qt @ k[bi, kh, keys].T
                        ok = (keys[None] <= qpos[:, None]) if causal \
                            else torch.ones_like(s, dtype=torch.bool)
                        ssum += float(s[ok].sum())
                        scnt += int(ok.sum())
                        s2 = torch.where(ok, s * sl2, inf)
                        m_new = torch.maximum(m, s2.max(dim=1).values)
                        alpha = torch.where(torch.isinf(m), 0.0,
                                            torch.exp2(m - m_new))
                        m_use = torch.where(torch.isinf(m_new), 0.0, m_new)
                        p = torch.exp2(s2 - m_use[:, None])
                        l = l * alpha + p.sum(1)
                        o = o * alpha[:, None] + _bf16(p) @ v[bi, kh, keys]
                        m = m_new
                    if gate[bi, hi]:
                        a_tilde[bi, hi, row, j] = (ssum * scale / scnt
                                                   if scnt else inf)
                out[bi, hi, row * bs:(row + 1) * bs] = _bf16(
                    o / torch.clamp(l, min=1e-30)[:, None])
    return out, a_tilde


@pytest.mark.parametrize("bs,width,kn", [
    pytest.param(64, None, 64, id="64-None"),
    pytest.param(128, None, 64, id="128-None"),
    pytest.param(64, 2, 64, id="64-2"),
    pytest.param(128, None, 128, id="hopper-128-chunk"),
])
def test_tensor_core_body_fits_the_bf16_tolerance(bs, width, kn):
    """bf16 P before PV keeps the output within the card's bf16 tolerance
    of the float32 reference on the same (bf16-valued) inputs, and Ã within
    its tolerance; a counts == 0 row writes zeros.  The Hopper body's case
    (whole 128-key blocks, bs = 128, D = 128, G = 2) runs a chunk of the
    last two q blocks at q_block_offset 2, one of whose rows lists only
    its diagonal block."""
    tol = _chip_smoke().TOL
    rng = np.random.default_rng(13)
    chunk = kn == 128
    b, h, hkv, n, d = 2, 4, 2, 4 * bs, 128 if chunk else 64
    q, k, v = (_bf16(rng.standard_normal(s).astype(np.float32)).numpy()
               for s in ((b, h, n, d), (b, hkv, n, d), (b, hkv, n, d)))
    nb = n // bs
    mask = rng.random((b, h, nb, nb)) < 0.7
    mask &= np.tril(np.ones((nb, nb), bool))
    off = 2 if chunk else 0
    if chunk:
        q, mask = q[:, :, off * bs:], mask[:, :, off:]
        mask[1, 3, 0] = False                    # only the diagonal block
        mask[1, 3, 0, off] = True
    zero = 1 if chunk else 2
    mask[0, 1, zero] = False                     # counts == 0 row
    gate = rng.random((b, h)) < 0.5
    jo, ja = j_bbsa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(mask), block_size=bs, width=width,
                    stats_gate=jnp.asarray(gate),
                    q_block_offset=off if chunk else None)
    idx, cnt = compact_block_mask(T(mask), width=width)
    to, ta = tc_body(T(q), T(k), T(v), idx, cnt, bs=bs, off=off, gate=gate,
                     kn=kn)
    err = float(np.abs(to.numpy() - np.asarray(jo)).max())
    assert 0 < err <= tol[("out", "bfloat16")]
    ja = np.asarray(ja)
    assert (np.isinf(ja) == np.isinf(ta.numpy())).all()
    fin = np.isfinite(ja)
    np.testing.assert_allclose(ta.numpy()[fin], ja[fin],
                               atol=tol[("a_tilde", "bfloat16")], rtol=0)
    assert (to.numpy()[0, 1, zero * bs:(zero + 1) * bs] == 0).all()


# ------------------------------------------------------------ profiles

@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::bsa_tc_kernel<128, 128, 0>(x)",
     "block_sparse_attn"),
    ("void (anonymous namespace)::bsa_wgmma_kernel<128, 128, 0>"
     "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, int const*)",
     "block_sparse_attn"),
    ("void (anonymous namespace)::bsa_tc_kernel<64, 128, 1>(x)",
     "block_sparse_attn_paged"),
    ("void (anonymous namespace)::bsa_f32_kernel<128, 64, 2>(x)",
     "block_sparse_attn_single"),
    ("void (anonymous namespace)::bsa_tc_kernel<128, 192, 128, 0>(x)",
     "block_sparse_attn"),
    ("void (anonymous namespace)::bsa_tc_kernel<64, 128, 128, 1>(x)",
     "block_sparse_attn_paged"),
    ("void (anonymous namespace)::bsa_f32_kernel<64, 192, 128, 2>(x)",
     "block_sparse_attn_single"),
    ("void (anonymous namespace)::strip_tc_kernel<192, 2>(x)", "strip"),
    ("void (anonymous namespace)::bsa_tc_kernel<128, 256, 256, 0>(x)",
     "block_sparse_attn"),
    ("void (anonymous namespace)::bsa_f32_kernel<128, 256, 256, 2>(x)",
     "block_sparse_attn_single"),
    ("void (anonymous namespace)::decode_kernel<__nv_bfloat16, 0, 4, 1>(x)",
     "decode_attn"),
    ("void (anonymous namespace)::decode_kernel<float, 1, 8, 4>(x)",
     "decode_attn_paged"),
    ("void (anonymous namespace)::decode_combine_kernel<float, 2>(x)",
     "decode_attn_dense"),
    ("void (anonymous namespace)::decode_combine_kernel<__nv_bfloat16, 3>"
     "(x)", "decode_attn_sparse"),
    ("void (anonymous namespace)::strip_kernel<__nv_bfloat16>(x)", "strip"),
    ("void (anonymous namespace)::strip_tc_kernel<128, 1>(x)", "strip"),
    ("void (anonymous namespace)::strip_tc_kernel<96, 2>(x)", "strip"),
    ("void (anonymous namespace)::strip_f32_kernel<float, 1>(x)", "strip"),
    ("void (anonymous namespace)::strip_f32_kernel<__nv_bfloat16, 2>(x)",
     "strip"),
    ("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_TNT", "gemm"),
    ("void at::native::elementwise_kernel<128, 4>(x)", "other"),
])
def test_profile_groups_every_device_function(name, group):
    assert _chip_smoke().kernel_group(name) == group


def test_profile_refuses_an_unattributed_port_kernel():
    with pytest.raises(AssertionError, match="no instance"):
        _chip_smoke().kernel_group(
            "void (anonymous namespace)::bsa_tma_kernel<128, 128, 0>(x)")


# ------------------------------------- repairs: head dim 96 and G up to 16
#
# phi3-mini has D = 96 and mistral-large G = 12 (96 heads over 8 kv heads);
# the reference's kernels take any D and G.  The plain versions (what the
# card's checks hold the kernels against) against the Pallas kernels at
# those shapes, and the CUDA wrappers' shape gates through the fake C
# function.  ``reduced_config`` caps the smoke models at G = 1, so these
# shapes are built here.

@pytest.mark.parametrize("offset,d", [(None, 96), (2, 96), (None, 256),
                                      (2, 256)],
                         ids=["one_shot", "chunk", "one_shot_d256",
                              "chunk_d256"])
def test_block_sparse_plain_at_head_dim_96_matches_pallas(offset, d):
    """B.2 (batched), B.5 (paged) and B.6 (single-sample) plain versions
    at D = 96 (phi3-mini) and D = 256 (RecurrentGemma) against the
    reference's kernels; the chunk case is a 2-block q chunk at q block 2
    of a 4-block prefix."""
    from repro.kernels.block_sparse_attn import (
        block_sparse_attention_batched as j_batched,
        block_sparse_attention_batched_paged as j_paged,
        block_sparse_attention_kernel as j_single, ragged_schedule)
    rng = np.random.default_rng(21)
    b, h, hkv, s, bs = 2, 4, 2, 256, 64
    n = s if offset is None else 2 * bs
    nbq, nbkv = n // bs, s // bs
    off = nbkv - nbq if offset is None else offset
    q = rng.standard_normal((b, h, n, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, s, d)).astype(np.float32)
            for _ in range(2))
    mask = rng.random((b, h, nbq, nbkv)) < 0.6
    mask &= np.tril(np.ones((nbq, nbkv), bool), k=off)
    mask[:, :, np.arange(nbq), off + np.arange(nbq)] = True
    idx, cnt = (np.array(x) for x in
                jidx.compact_block_mask(jnp.asarray(mask)))
    gate = rng.random((b, h)) < 0.5
    kw = dict(block_size=bs, stats_gate=T(gate), q_block_offset=offset)
    row_map, slot_map = ragged_schedule(nbq, nbkv, width=nbkv,
                                        q_block_offset=offset)
    scatter = lambda st: np.asarray(jidx.scatter_schedule_stats(
        st, jnp.asarray(idx), row_map, slot_map, nbkv))

    jo, js = j_batched(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(idx), jnp.asarray(cnt), block_size=bs,
                       stats_gate=jnp.asarray(gate), q_block_offset=offset,
                       interpret=True)
    to, ta = bsa.block_sparse_attention_plain(T(q), T(k), T(v), T(idx),
                                              T(cnt), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=0)
    ja = scatter(js)
    assert (np.isneginf(ja) == np.isneginf(ta.numpy())).all()
    fin = np.isfinite(ja)
    np.testing.assert_allclose(ta.numpy()[fin], ja[fin], atol=1e-5, rtol=0)

    # B.5: the same launch through a page table over a shuffled pool
    nb = s // bs
    pages = 1 + rng.permutation(b * nb + 2)[: b * nb].reshape(b, nb)
    pool_k, pool_v = (np.zeros((b * nb + 3, hkv, bs, d), np.float32)
                      for _ in range(2))
    for pool, x in ((pool_k, k), (pool_v, v)):
        pool[pages.reshape(-1)] = np.moveaxis(
            x.reshape(b, hkv, nb, bs, d), 1, 2).reshape(-1, hkv, bs, d)
    table = pages.astype(np.int32)
    jo, js = j_paged(jnp.asarray(q), jnp.asarray(pool_k),
                     jnp.asarray(pool_v), jnp.asarray(table),
                     jnp.asarray(idx), jnp.asarray(cnt), block_size=bs,
                     stats_gate=jnp.asarray(gate), q_block_offset=offset,
                     interpret=True)
    po, pa = bsa.block_sparse_attention_paged_plain(
        T(q), T(pool_k), T(pool_v), T(table), T(idx), T(cnt), **kw)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=0)
    assert torch.equal(po, to) and torch.equal(pa, ta)

    if offset is None:              # B.6: sample 0, uniform W steps
        jo, js = j_single(jnp.asarray(q[0]), jnp.asarray(k[0]),
                          jnp.asarray(v[0]), jnp.asarray(idx[0]),
                          jnp.asarray(cnt[0]), block_size=bs,
                          interpret=True)
        so, ss = bsa.block_sparse_attention_single_plain(
            T(q[0]), T(k[0]), T(v[0]), T(idx[0]), T(cnt[0]), block_size=bs)
        np.testing.assert_allclose(so.numpy(), np.asarray(jo), atol=1e-5,
                                   rtol=0)
        js = np.asarray(js)
        assert (np.isneginf(js) == np.isneginf(ss.numpy())).all()
        fin = np.isfinite(js)
        np.testing.assert_allclose(ss.numpy()[fin], js[fin], atol=1e-5,
                                   rtol=0)


def _group12_case(rng, paged: bool):
    """A G = 12 plan (12 query heads over one kv head, 2 slots), partly
    false keep bits, a counts == 0 slot and a right-pad range; K/V
    contiguous, or in a shuffled pool through a page table."""
    b, h, hkv, nb, bs, d = 2, 24, 2, 6, 64, 32
    g, s = h // hkv, nb * bs
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    ck, cv = (rng.standard_normal((b, hkv, s, d)).astype(np.float32)
              for _ in range(2))
    keep = rng.random((b, hkv, nb, g)) < 0.6
    keep[..., -1, :] = True
    union = keep.any(-1)
    union[1, 1] = False                          # counts == 0 slot
    keep &= union[..., None]
    valid = np.ones((b, s), bool)
    valid[1, 200:300] = False                    # right-pad
    idx, cnt = (np.array(x) for x in
                jidx.compact_block_mask(jnp.asarray(union)))
    if not paged:
        return q, ck, cv, None, idx, cnt, keep, valid
    pages = 1 + rng.permutation(b * nb + 2)[: b * nb].reshape(b, nb)
    pools = []
    for x in (ck, cv):
        pool = rng.standard_normal((b * nb + 3, hkv, bs, d)).astype(
            np.float32)
        pool[pages.reshape(-1)] = np.moveaxis(
            x.reshape(b, hkv, nb, bs, d), 1, 2).reshape(-1, hkv, bs, d)
        pools.append(pool)
    return (q, pools[0], pools[1], pages.astype(np.int32), idx, cnt, keep,
            valid)


@pytest.mark.parametrize("paged", [False, True], ids=["B.3", "B.4"])
def test_plan_decode_plain_at_group_12_matches_pallas(paged):
    from repro.kernels.decode_attn import (
        flash_decode_sparse_batched_paged as j_decode_paged)
    q, ck, cv, table, idx, cnt, keep, valid = _group12_case(
        np.random.default_rng(22), paged)
    plan = da.DecodePlan(T(idx), T(cnt), T(keep))
    j = lambda x: jnp.asarray(x)
    if paged:
        ref = j_decode_paged(j(q), j(ck), j(cv), j(table), j(idx), j(cnt),
                             j(keep), j(valid), interpret=True)
        got = da.decode_plan_einsum_sliced_paged(T(q), T(ck), T(cv),
                                                 T(table), plan, T(valid))
    else:
        ref = j_decode(j(q), j(ck), j(cv), j(idx), j(cnt), j(keep),
                       j(valid), interpret=True)
        got = da.decode_plan_einsum_sliced(T(q), T(ck), T(cv), plan,
                                           T(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    assert (got[1, 12:24] == 0).all()            # counts == 0: exact zeros


@pytest.mark.parametrize("sparse", [False, True], ids=["B.7", "B.8"])
def test_token_mask_decode_plain_at_group_12_matches_pallas(sparse):
    from repro.kernels.decode_attn import flash_decode_sparse as j_sparse
    rng = np.random.default_rng(23)
    h, hkv, s, d, bs = 24, 2, 384, 32, 64
    q = rng.standard_normal((h, d)).astype(np.float32)
    ck, cv = (rng.standard_normal((hkv, s, d)).astype(np.float32)
              for _ in range(2))
    mask = np.repeat(rng.random((h, s // bs)) < 0.5, bs, axis=1)
    mask &= rng.random((h, s)) < 0.9
    mask[:, -bs:] = True
    mask[7] = False                              # an all-false head
    jfn, tfn = ((j_sparse, da.flash_decode_sparse_plain) if sparse
                else (j_flash_decode, da.flash_decode_plain))
    ref = jfn(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
              jnp.asarray(mask), block_kv=bs, interpret=True)
    got = tfn(T(q), T(ck), T(cv), T(mask), block_kv=bs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    assert (got[7] == 0).all()


@pytest.mark.parametrize("d,ok", [(64, True), (96, True), (128, True),
                                  (80, False), (48, False), (256, "wide")])
def test_block_sparse_wrappers_take_head_dim_96(fake_launch, d, ok):
    """The three block-sparse wrappers launch at D in {64, 96, 128} with
    their declared argument counts, and raise at any other D; at D = 256
    the batched and single-sample wrappers launch and the paged one (on no
    path) raises."""
    b, h, hkv, n, bs = 1, 4, 2, 256, 64
    q, kv = torch.zeros(b, h, n, d), torch.zeros(b, hkv, n, d)
    m = torch.tril(torch.ones(n // bs, n // bs, dtype=torch.bool))
    idx, cnt = compact_block_mask(m.expand(b, h, -1, -1))
    pool = torch.zeros(5, hkv, bs, d)
    table = torch.arange(1, 5, dtype=torch.int32)[None]
    calls = (
        lambda: bsa.block_sparse_attention_cuda(q, kv, kv, idx, cnt,
                                                block_size=bs),
        lambda: bsa.block_sparse_attention_single_cuda(
            q[0], kv[0], kv[0], idx[0], cnt[0], block_size=bs),
        lambda: bsa.block_sparse_attention_paged_cuda(
            q, pool, pool, table, idx, cnt, block_size=bs))
    names = ["repro_block_sparse_attn", "repro_block_sparse_attn_single",
             "repro_block_sparse_attn_paged"]
    launched = (names if ok is True else names[:2] if ok == "wide"
                else [])
    for name, call in zip(names, calls):
        if name in launched:
            call()
        else:
            with pytest.raises(ValueError, match=r"D in \(64, 96, 128\)"):
                call()
    assert {k: len(v.calls) for k, v in fake_launch.items()} == \
        dict.fromkeys(launched, 1)


_check_masked = da._check_masked       # the real gate, before any stub


@pytest.mark.parametrize("g,ok", [(8, True), (12, True), (16, True),
                                  (17, False)])
def test_decode_wrappers_take_groups_up_to_16(fake_launch, monkeypatch, g,
                                              ok):
    """The four decode wrappers launch at G <= 16 with their declared
    argument counts and raise above it (the token-mask wrappers in their
    shape gate, which the fixture stubs, so it is put back here)."""
    b, hkv, nb, ps, d = 2, 2, 4, 64, 32
    h, s = g * hkv, nb * ps
    q = torch.zeros(b, h, d)
    cache = torch.zeros(b, hkv, s, d)
    idx, cnt = compact_block_mask(torch.ones(b, hkv, nb, dtype=torch.bool))
    keep = torch.ones(b, hkv, nb, g, dtype=torch.bool)
    valid = torch.ones(b, s, dtype=torch.bool)
    pool = torch.zeros(b * nb + 1, hkv, ps, d)
    table = torch.arange(1, b * nb + 1, dtype=torch.int32).reshape(b, nb)
    mask = torch.ones(h, s, dtype=torch.bool)
    calls = (
        lambda: da.flash_decode_sparse_cuda(q, cache, cache, idx, cnt, keep,
                                            valid),
        lambda: da.flash_decode_sparse_paged_cuda(q, pool, pool, table, idx,
                                                  cnt, keep, valid),
        lambda: da.flash_decode_cuda(q[0], cache[0], cache[0], mask,
                                     block_kv=ps),
        lambda: da.flash_decode_sparse_single_cuda(q[0], cache[0], cache[0],
                                                   mask, block_kv=ps))
    if ok:
        for call in calls:
            call()
        assert {k: len(v.calls) for k, v in fake_launch.items()} == {
            "repro_decode_attn": 1, "repro_decode_attn_paged": 1,
            "repro_decode_attn_mask": 2}
        return
    monkeypatch.setattr(da, "_check_masked", _check_masked)
    for call in calls:
        with pytest.raises(ValueError, match="G <= 16"):
            call()
    assert not fake_launch

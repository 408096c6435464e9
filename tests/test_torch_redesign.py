"""The algorithms of the redesigned kernel bodies, on the CPU.

The CUDA bodies run only on the card; these tests hold plain mirrors of
their arithmetic against the JAX package's Pallas kernels (interpret mode):

  * split-K decode (``csrc/decode_attn.cu``): each (batch, kv head) row's
    table entries, as 32-key tiles, cut into ``splits`` contiguous chunks,
    a partial ``(m, l, acc)`` per chunk, merged in split order under the
    −inf-safe rule, at float32 tolerance (1e-5, the one the port's decode
    tests use), with exact zeros where the contract asks for them;
  * the bf16 tensor-core block-sparse body (``csrc/block_sparse_attn.cu``):
    64-key sub-tiles, base-2 online softmax, P rounded to bf16 only as the
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
    their own (B, Hkv, W) and scratch for (B, H, splits, D + 2) partials."""
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
    """Mirror of bsa_tc_kernel's arithmetic in float32 on bf16 inputs:
    kn-key sub-tiles, base-2 online softmax with the −inf guards, P rounded
    to bf16 as PV's operand, l and acc in float32, Ã as the raw logits'
    sum times scale over the valid count; (out in bf16, Ã)."""
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


@pytest.mark.parametrize("bs,width", [(64, None), (128, None), (64, 2)])
def test_tensor_core_body_fits_the_bf16_tolerance(bs, width):
    """bf16 P before PV keeps the output within the card's bf16 tolerance
    of the float32 reference on the same (bf16-valued) inputs, and Ã within
    its tolerance; a counts == 0 row writes zeros."""
    tol = _chip_smoke().TOL
    rng = np.random.default_rng(13)
    b, h, hkv, n, d = 2, 4, 2, 4 * bs, 64
    q, k, v = (_bf16(rng.standard_normal(s).astype(np.float32)).numpy()
               for s in ((b, h, n, d), (b, hkv, n, d), (b, hkv, n, d)))
    nb = n // bs
    mask = rng.random((b, h, nb, nb)) < 0.7
    mask &= np.tril(np.ones((nb, nb), bool))
    mask[0, 1, 2] = False                        # counts == 0 row
    gate = rng.random((b, h)) < 0.5
    jo, ja = j_bbsa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(mask), block_size=bs, width=width,
                    stats_gate=jnp.asarray(gate))
    idx, cnt = compact_block_mask(T(mask), width=width)
    to, ta = tc_body(T(q), T(k), T(v), idx, cnt, bs=bs, off=0, gate=gate)
    err = float(np.abs(to.numpy() - np.asarray(jo)).max())
    assert 0 < err <= tol[("out", "bfloat16")]
    ja = np.asarray(ja)
    assert (np.isinf(ja) == np.isinf(ta.numpy())).all()
    fin = np.isfinite(ja)
    np.testing.assert_allclose(ta.numpy()[fin], ja[fin],
                               atol=tol[("a_tilde", "bfloat16")], rtol=0)
    assert (to.numpy()[0, 1, 2 * bs:3 * bs] == 0).all()


# ------------------------------------------------------------ profiles

@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::bsa_tc_kernel<128, 128, 0>(x)",
     "block_sparse_attn"),
    ("void (anonymous namespace)::bsa_tc_kernel<64, 128, 1>(x)",
     "block_sparse_attn_paged"),
    ("void (anonymous namespace)::bsa_f32_kernel<128, 64, 2>(x)",
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
            "void (anonymous namespace)::bsa_wgmma_kernel<128, 128, 0>(x)")

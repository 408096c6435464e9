"""The port's baselines (MInference vertical-slash and FlexPrefill prefill)
against the JAX package's, on the CPU.

Inputs come from numpy with a seed, in float32 (TF32 off).  The reference
runs its Pallas kernels in interpret mode (``attn_impl="sparse"`` or
``"kernel"``; its ``auto`` picks dense attention off the TPU), the port the
kernels' plain versions on CPU tensors.

What is held, and how tightly:
  * the six baseline functions, ``search_vertical_slash_pattern``,
    ``gqa_head_vmap`` (G = 1 and G > 1) and the new pattern functions:
    masks and tables **exactly**, ``pooled_block_scores`` within 1e-6
    (float32 means and products summed in another order);
  * the batched, GQA-native builders **exactly** equal to ``gqa_head_vmap``
    of the per-head functions, the port's and the reference's;
  * one layer (granite-3-2b's smoke config, layer 0 on random hidden
    states): masks exactly, outputs and K/V within 1e-5, stats within
    1e-6, ``sp_state`` untouched;
  * a model prefill for ``method`` × ``attn_impl``: logits and every
    layer's K/V within 1e-4 (two float32 layers), stats within 1e-6;
  * a ``ChunkedPrefillRun`` at 1 and 3 blocks a chunk **bitwise** equal to
    the port's one-shot prefill of the same method;
  * batch, paged scheduler, chunked and packed serves: greedy tokens equal
    to the reference's same serve near-tie aware (a stream may flip only
    where the reference's top-2 margin is below ``TIE_TOL``).

A sequence of 256 tokens at block 64 has 4 blocks, where γ = 0.9 keeps
every block; the tests that hold masks also run γ = 0.3 and longer rows so
that masks are sparse.  Every test runs under the page-leak audit and the
one-thread setting of ``tests/test_torch_scheduler.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten
from repro.configs import get_smoke_config as j_smoke
from repro.core import baselines as jb
from repro.core import patterns as jpat
from repro.core import vertical_slash as jvs
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import chunked_prefill as jcp
from repro.models.api import build_model as j_build
from repro.serving import EngineConfig as JConfig, Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch import checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.core import baselines as tb
from repro_torch.core import patterns
from repro_torch.core.share_attention import gqa_head_vmap
from repro_torch.core.vertical_slash import search_vertical_slash_pattern
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.serving import (EngineConfig, Request, ServingEngine,
                                 SlotScheduler)
from repro_torch.serving.chunked_prefill import ChunkedPrefillRun

torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "granite-3-2b"
SEQ = 256
BS = 64
TIE_TOL = 1e-3
BASELINES = ("vertical_slash", "flex")
T = lambda a: torch.from_numpy(np.array(a))
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


def _qk(seed, b, h, hkv, n, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, n, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, n, d)).astype(np.float32)
    # a few heavy key columns and a local bias, so the selections are
    # neither empty nor everything
    k[..., rng.integers(0, n, 6), :] *= 3.0
    return q, k


# ------------------------------------------------------ pattern functions

@pytest.mark.parametrize("nbq,nbkv", [(6, 6), (4, 7)])
def test_dense_and_a_shape_masks_match_reference(nbq, nbkv):
    for causal in (True, False):
        np.testing.assert_array_equal(
            patterns.dense_block_mask(nbq, nbkv, causal).numpy(),
            np.asarray(jpat.dense_block_mask(nbq, nbkv, causal)))
    np.testing.assert_array_equal(patterns.dense_block_mask(nbq).numpy(),
                                  np.asarray(jpat.dense_block_mask(nbq)))
    for sink, local in ((1, 2), (2, 3), (0, 1)):
        np.testing.assert_array_equal(
            patterns.a_shape_block_mask(nbkv, sink, local).numpy(),
            np.asarray(jpat.a_shape_block_mask(nbkv, sink, local)))


def test_expand_indices_and_active_table_match_reference():
    rng = np.random.default_rng(3)
    m = rng.random((2, 5, 5)) < 0.4
    np.testing.assert_array_equal(
        patterns.expand_block_mask(T(m), 3).numpy(),
        np.asarray(jpat.expand_block_mask(jnp.asarray(m), 3)))
    idx = np.array([0, 4, 7, 4], np.int32)
    np.testing.assert_array_equal(
        patterns.indices_to_mask(T(idx), 9).numpy(),
        np.asarray(jpat.indices_to_mask(jnp.asarray(idx), 9)))
    mask = np.tril(rng.random((6, 6)) < 0.5)
    mask[2] = False                             # an empty row pads with 0
    for mk in (mask, np.zeros((3, 4), bool), np.tril(np.ones((4, 4), bool))):
        got, ref = patterns.active_block_table(mk), jpat.active_block_table(
            mk)
        for a, r in zip(got, ref):
            assert a.dtype == r.dtype
            np.testing.assert_array_equal(a, r)


@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)], ids=["G=1", "G=4"])
def test_gqa_head_vmap_matches_reference(h, hkv):
    """Each query head meets its own kv head; results stacked over H."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((h, 16, 8)).astype(np.float32)
    k = rng.standard_normal((hkv, 16, 8)).astype(np.float32)
    fn = lambda qh, kh: qh * 2.0 + kh                    # exact arithmetic
    got = gqa_head_vmap(fn, T(q), T(k))
    ref = jops.gqa_head_vmap(fn, jnp.asarray(q), jnp.asarray(k))
    assert got.shape == (h, 16, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        gqa_head_vmap(fn, T(q[:3]), T(k[:2]))


# ---------------------------------------------------- baseline functions

@pytest.mark.parametrize("seed,n,bs,gamma", [(0, 512, 64, 0.9),
                                             (1, 768, 64, 0.6),
                                             (2, 384, 32, 0.3)])
def test_per_head_baselines_match_reference(seed, n, bs, gamma):
    q, k = _qk(seed, 1, 4, 4, n, 32)
    q, k = q[0], k[0]
    kw = dict(gamma=gamma, block_size=bs)
    qh, kh = q[seed % 4], k[seed % 4]
    s_got = tb.pooled_block_scores(T(qh), T(kh), bs)
    s_ref = jb.pooled_block_scores(jnp.asarray(qh), jnp.asarray(kh), bs)
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_ref), atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(
        search_vertical_slash_pattern(T(qh), T(kh), gamma, bs).numpy(),
        np.asarray(jvs.search_vertical_slash_pattern(
            jnp.asarray(qh), jnp.asarray(kh), gamma, bs)))
    pairs = ((tb.minference_masks, jb.minference_masks),
             (tb.flexprefill_masks, jb.flexprefill_masks))
    dens = []
    for mine, ref in pairs:
        got = mine(T(q), T(k), **kw)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(ref(jnp.asarray(q), jnp.asarray(k),
                                        **kw)))
        dens.append(float(patterns.block_mask_density(got).mean()))
    np.testing.assert_array_equal(
        tb.flash_attention_mask(4, n // bs).numpy(),
        np.asarray(jb.flash_attention_mask(4, n // bs)))
    print(f"densities (minference, flex): {dens}")
    if gamma < 0.9:
        assert min(dens) < 1.0                  # the masks are not trivial


@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)], ids=["G=1", "G=4"])
@pytest.mark.parametrize("gamma", [0.9, 0.4])
def test_batched_builders_equal_per_head(h, hkv, gamma):
    """The model's batched builders equal ``gqa_head_vmap`` of the per-head
    functions sample by sample: the port's and the reference's."""
    b, n, bs = 2, 512, 64
    q, k = _qk(int(gamma * 10) + h, b, h, hkv, n, 32)
    kw = dict(gamma=gamma, block_size=bs)
    for method, batched, mine, ref in (
            ("vertical_slash", tb.minference_block_masks,
             tb.minference_head_mask, jb.minference_head_mask),
            ("flex", tb.flexprefill_block_masks, tb.flexprefill_head_mask,
             jb.flexprefill_head_mask)):
        got = batched(T(q), T(k), **kw)
        assert got.shape == (b, h, n // bs, n // bs)
        assert torch.equal(got, tb.baseline_block_masks(method, T(q), T(k),
                                                        **kw))
        for i in range(b):
            per = gqa_head_vmap(lambda qh, kh: mine(qh, kh, **kw), T(q[i]),
                                T(k[i]))
            assert torch.equal(got[i], per), method
            np.testing.assert_array_equal(
                got[i].numpy(), np.asarray(jops.gqa_head_vmap(
                    lambda qh, kh: ref(qh, kh, **kw), jnp.asarray(q[i]),
                    jnp.asarray(k[i]))))
    with pytest.raises(ValueError):
        tb.baseline_block_masks("share", T(q), T(k), **kw)


# ------------------------------------------------------ layer and model

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
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, cfg=tcfg, jcfg=jcfg,
                prompts=prompts, sp=tm.default_share_prefill(),
                jsp=jm.default_share_prefill())


def _with_gamma(sp, gamma):
    return dataclasses.replace(sp, cfg=dataclasses.replace(sp.cfg,
                                                           gamma=gamma))


@pytest.mark.parametrize("method", BASELINES)
@pytest.mark.parametrize("gamma,n", [(0.9, SEQ), (0.3, 512)])
def test_layer_matches_reference(pair, method, gamma, n):
    """Layer 0 on random hidden states: the staged masks equal the
    reference's chunk quantum's exactly, and one-shot attention (out, K/V,
    stats) matches the reference's, leaving ``sp_state`` untouched."""
    b = 2
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, n, pair["cfg"].d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(n), (b, n)).astype(np.int32)
    sp, jsp = _with_gamma(pair["sp"], gamma), _with_gamma(pair["jsp"], gamma)
    jcfg, tcfg = pair["jcfg"], pair["cfg"]
    jlayer = jax.tree.map(lambda p: p[0], pair["jp"]["stack"])
    tlayer = pair["tp"]["layers"][0]
    h = jnp.asarray(x)
    jq = jcp.chunk_prefill_layer_begin(
        pair["jp"], jcfg, 0, h, jnp.asarray(pos), jsp, None, None,
        method=method, attn_impl="sparse")
    from repro_torch.models import common
    th = common.rmsnorm(tlayer["ln1"], T(x), tcfg.rms_norm_eps)
    stage = tattn.attention_prefill_begin(
        tlayer["attn"], th, tcfg, T(pos).long(), method=method, sp=sp,
        sp_state=None, cluster_ids=None, attn_impl="sparse")
    assert stage.decision is None and stage.perm is None
    assert stage.gate.dtype == torch.int32 and not stage.gate.any()
    np.testing.assert_array_equal(stage.masks.numpy(), np.asarray(jq[3]))
    density = float(patterns.block_mask_density(stage.masks).mean())
    if gamma < 0.9 and method == "flex":
        assert density < 1.0        # random hidden states: the strip is
                                    # near uniform, and MInference keeps all

    jh = jnp.asarray(th.numpy())
    state = sp.init_state(b, n)
    jo, (jk, jv), _, jst = jattn.attention_prefill(
        jlayer["attn"], jh, jcfg, jnp.asarray(pos), method=method, sp=jsp,
        sp_state=None, cluster_ids=None, attn_impl="sparse")
    to, (tk, tv), new_state, tst = tattn.attention_prefill(
        tlayer["attn"], th, tcfg, T(pos).long(), method=method, sp=sp,
        sp_state=state, cluster_ids=None, attn_impl="sparse")
    assert new_state is state
    assert not state.valid.any() and not state.masks.any()
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                               rtol=0)
    for name, a, r in zip(tst._fields, tst, jst):
        np.testing.assert_allclose(float(a), float(r), atol=1e-6,
                                   err_msg=name)
    assert float(tst.num_vs) == tcfg.num_heads
    np.testing.assert_allclose(float(tst.block_density), density, atol=1e-6)


def _toks(pair, n=SEQ):
    toks = np.zeros((2, n), np.int32)
    plens = np.array([min(len(p), n) for p in pair["prompts"][:2]], np.int32)
    for i, p in enumerate(pair["prompts"][:2]):
        toks[i, :plens[i]] = p[:n]
    return toks, plens


@pytest.mark.parametrize("impl", ["sparse", "kernel", "ref", "chunked"])
@pytest.mark.parametrize("method", BASELINES)
def test_model_prefill_matches_reference(pair, method, impl):
    """``Model.prefill`` of a padded batch of two: logits, every layer's
    K/V and the stats against the reference's prefill with the same
    ``attn_impl``; ``auto`` is the port's ``sparse``."""
    toks, plens = _toks(pair)
    jr = pair["jm"].prefill(pair["jp"], jnp.asarray(toks), pair["jsp"],
                            method=method, attn_impl=impl,
                            prompt_lens=jnp.asarray(plens))
    tr = pair["tm"].prefill(pair["tp"], T(toks).long(), pair["sp"],
                            method=method, attn_impl=impl,
                            prompt_lens=T(plens).long())
    np.testing.assert_allclose(tr.last_logits.numpy(),
                               np.asarray(jr.last_logits), atol=1e-4, rtol=0)
    for i in range(2):
        np.testing.assert_allclose(tr.cache[i].numpy(),
                                   np.asarray(jr.cache["stack"][i]),
                                   atol=1e-4, rtol=0)
    for name, a, r in zip(tr.stats._fields, tr.stats, jr.stats):
        np.testing.assert_allclose(float(a), float(r), atol=1e-6,
                                   err_msg=name)
    assert not tr.sp_state.valid.any() and not tr.sp_state.masks.any()
    if impl == "sparse":
        auto = pair["tm"].prefill(pair["tp"], T(toks).long(), pair["sp"],
                                  method=method,
                                  prompt_lens=T(plens).long())
        assert torch.equal(auto.last_logits, tr.last_logits)


@pytest.mark.parametrize("method", BASELINES)
def test_width_cap_and_sparse_model_prefill(pair, method):
    """γ = 0.3 at 512 tokens (sparse masks) with a W cap of 3 blocks on the
    batched and the per-sample paths, against the reference."""
    toks, plens = _toks(pair, 512)
    sp, jsp = _with_gamma(pair["sp"], 0.3), _with_gamma(pair["jsp"], 0.3)
    for impl in ("sparse", "kernel"):
        kw = dict(method=method, attn_impl=impl, attn_width=3)
        jr = pair["jm"].prefill(pair["jp"], jnp.asarray(toks), jsp,
                                prompt_lens=jnp.asarray(plens), **kw)
        tr = pair["tm"].prefill(pair["tp"], T(toks).long(), sp,
                                prompt_lens=T(plens).long(), **kw)
        np.testing.assert_allclose(tr.last_logits.numpy(),
                                   np.asarray(jr.last_logits), atol=1e-4,
                                   rtol=0)
        for name, a, r in zip(tr.stats._fields, tr.stats, jr.stats):
            np.testing.assert_allclose(float(a), float(r), atol=1e-6,
                                       err_msg=name)
        assert float(tr.stats.block_density) < 1.0


def test_unknown_method_raises_and_a3_refusal_is_gone(pair):
    assert tattn.PREFILL_METHODS == jattn.PREFILL_METHODS
    toks, plens = _toks(pair)
    with pytest.raises(ValueError, match="unknown prefill method"):
        pair["tm"].prefill(pair["tp"], T(toks).long(), pair["sp"],
                           method="minference")
    import pathlib
    src = pathlib.Path(tattn.__file__).parents[1]
    for path in src.rglob("*.py"):
        assert "A.3" not in path.read_text(), path


# ------------------------------------------------------------ chunked

def _drive(run):
    kvs = {}
    while not run.done:
        if run.step() == "kv":
            kvs[run.kv_layer] = run.kv
    return kvs


def _engine(pair, **kw):
    base = dict(method="flex", max_batch=2, seq_buckets=(SEQ,),
                scheduler=True)
    return ServingEngine(pair["tm"], pair["tp"], pair["sp"],
                         EngineConfig(**{**base, **kw}))


@pytest.mark.parametrize("method", BASELINES)
@pytest.mark.parametrize("blocks", [1, 3], ids=["chunk=1blk",
                                                "chunk=3blk_ragged_tail"])
def test_chunked_run_is_bitwise_oneshot(pair, method, blocks):
    """The quanta of a baseline run give logits, every layer's K/V and the
    stats bitwise equal to the port's one-shot prefill, with ``sp_state``
    untouched, and its launches carry no Ã."""
    prompt = pair["prompts"][2]
    chunk = blocks * BS
    eng = _engine(pair, method=method, prefill_chunk=chunk)
    run = ChunkedPrefillRun(eng, [Request(uid=0, prompt=prompt,
                                          max_new_tokens=1)],
                            [0], SEQ, chunk, None)
    state0 = [x.clone() for x in run.sp_state]
    kvs = _drive(run)
    toks = torch.zeros((1, SEQ), dtype=torch.long)
    toks[0, :len(prompt)] = T(prompt)
    res = pair["tm"].prefill(pair["tp"], toks, pair["sp"], method=method,
                             prompt_lens=torch.tensor([len(prompt)]))
    assert torch.equal(run.logits, res.last_logits)
    for li, (k, v) in kvs.items():
        assert torch.equal(k, res.cache[0][li])
        assert torch.equal(v, res.cache[1][li])
    assert all(torch.equal(a, b) for a, b in zip(run.attn_stats, res.stats))
    assert all(torch.equal(a, b) for a, b in zip(run.sp_state, state0))


# ------------------------------------------------------------- serves

def _j_margins(pair, method, prompt, tokens, upto):
    """The reference's top-2 margins of one request served alone (its
    prefill under ``method``, dense decode), teacher-forced on
    ``tokens``."""
    jm, jp = pair["jm"], pair["jp"]
    toks = np.zeros((1, SEQ), np.int32)
    toks[0, :len(prompt)] = prompt
    plens = jnp.asarray([len(prompt)], jnp.int32)
    res = jm.prefill(jp, jnp.asarray(toks), pair["jsp"], method=method,
                     attn_impl="sparse", prompt_lens=plens)
    extra = 128
    cache = {"prefix": [], "stack": tuple(
        jnp.pad(c, ((0, 0),) * 3 + ((0, extra), (0, 0)))
        for c in res.cache["stack"])}
    logits, margins = res.last_logits, []
    for t in range(upto + 1):
        top2 = np.sort(np.asarray(logits)[0])[-2:]
        margins.append(float(top2[1] - top2[0]))
        if t == upto:
            break
        logits, cache = jm.decode(
            jp, jnp.asarray([[tokens[t]]], jnp.int32), cache,
            jnp.int32(SEQ + t), prompt_lens=plens, prefill_len=SEQ)
    return margins


SERVES = {
    "batch-vertical_slash": dict(method="vertical_slash", scheduler=False),
    "batch-flex": dict(method="flex", scheduler=False),
    "paged-vertical_slash": dict(method="vertical_slash", paged=True),
    "chunked-flex": dict(method="flex", prefill_chunk=BS),
    "paged_chunked+packed-vertical_slash": dict(
        method="vertical_slash", prefill_chunk=2 * BS, prefill_pack=2,
        paged=True),
}


@pytest.mark.parametrize("name", list(SERVES))
def test_serve_matches_reference(pair, name):
    """Greedy serves (more requests than the 2 slots, mixed
    ``max_new_tokens``, ``decode_sparse=True``, which a baseline decodes
    densely) against the reference's same serve, near-tie aware; packed
    serves are held to the reference's packed serve."""
    kw = SERVES[name]
    base = dict(max_batch=2, seq_buckets=(SEQ,), scheduler=True,
                decode_sparse=True)
    reqs = lambda cls: [cls(uid=i, prompt=p, max_new_tokens=m)
                        for i, (p, (_, m)) in enumerate(
                            zip(pair["prompts"], SPECS))]
    teng = ServingEngine(pair["tm"], pair["tp"], pair["sp"],
                         EngineConfig(**{**base, **kw}))
    got = teng.serve(reqs(Request), seed=0)
    jeng = JEngine(pair["jm"], pair["jp"], pair["jsp"],
                   JConfig(**{**base, **kw}, attn_impl="sparse"))
    ref = jeng.serve(reqs(JRequest), seed=0)
    for i, (r, g) in enumerate(zip(ref, got)):
        assert g.state == "done" and len(g.output_tokens) == g.max_new_tokens
        assert g.pattern_stats["num_vs"] == pair["cfg"].num_heads
        a, b = r.output_tokens.tolist(), g.output_tokens.tolist()
        flip = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y),
                    None)
        if flip is None:
            assert a == b
            continue
        m = _j_margins(pair, kw["method"], pair["prompts"][i], a, flip)
        print(f"request {i}: flip at token {flip}, margin {m[flip]:.3e}")
        assert m[flip] < TIE_TOL

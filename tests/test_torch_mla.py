"""DeepSeek-V2's latent attention in the port (MLA with its dense prefix
layer, ROADMAP.md A.10) against the JAX package's, and the block-sparse
kernels at Dqk ≠ Dv.

Both packages run deepseek-v2-236b's smoke config (2 layers: the dense-FFN
prefix layer and one MoE layer; 4 heads; Dqk = qk_nope 32 + qk_rope 16 =
48, Dv = 32; kv_lora 64; block 64) from the same parameters (the
reference's, through ``checkpoint.params_from_numpy``), at SEQ 256.

  * the reference's flat ``::`` leaves (``prefix_0::…`` and ``stack::…``,
    both Q variants) round-trip exactly;
  * ``mla_prefill`` of one layer for ``share`` (the batched sparse path)
    and the dense chunked fall of ``vertical_slash``, ``flex`` and
    ``dense``: output and latent cache 1e-5, stats 1e-6, dictionary masks
    exactly;
  * ``Model.prefill`` (latent cache ``{"prefix", "stack"}`` 1e-4, logits
    1e-4, stats 1e-6) then absorbed decode steps (logits 1e-4); the
    engine's ``grow_cache``/``cache_insert`` on that layout exactly; the
    absorbed decode equal to attention over the decompressed cache
    (1e-5);
  * the per-sample paths ``attn_impl="kernel"``/``"ref"`` (logits 1e-4);
  * the engine's batch serve against the reference's (pads attended in
    decode in both), greedy tokens near-tie aware; ``scheduler=True`` and
    ``paged=True`` land on the batch path; a per-slot ``pos`` or a page
    table raises;
  * the full config's widths (Dqk = 192, Dv = 128, no weights: meta
    tensors) through the strip and block-sparse wrappers' checks, which
    pass Dv and allocate ``(…, Dv)`` outputs (the fake C function of
    ``test_torch_redesign.py``); unequal widths other than (192, 128), and
    the paged instance at unequal widths, are refused;
  * the plain B.2 and B.6 at 48/32 and 192/128 against the reference's
    Pallas kernels in interpret mode (1e-5), and the plain B.1 at D = 192
    against the reference's strip kernel (1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten
from repro.kernels import indices as jidx
from repro.kernels.block_sparse_attn import (
    block_sparse_attention_batched as j_batched,
    block_sparse_attention_kernel as j_single, ragged_schedule)
from repro.kernels.strip import strip_scores_pallas
from repro.models import mla as jmla
from repro.serving import ServingEngine as JEngine
from repro_torch import checkpoint, tree
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import block_sparse_attn as bsa
from repro_torch.kernels import strip as sk
from repro_torch.kernels.indices import compact_block_mask
from repro_torch.models import build_model, mla
from repro_torch.serving import ServingEngine, SlotScheduler

from test_torch_redesign import fake_launch
from torch_serving_helpers import (JRequest, Request, assert_greedy_agree,
                                   make_pair, one_torch_thread, port_engine,
                                   ref_engine, requests)

torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "deepseek-v2-236b"
SEQ, BS = 256, 64
PLENS = np.array([256, 230])
T = lambda a: torch.from_numpy(np.array(a))

_PAIRS = {}


def _pair(q_lora: int = 0):
    """The smoke config's pair (``w_q``), or with a low-rank Q of rank
    ``q_lora`` (``w_q_down``, ``q_norm``, ``w_q_up``, as the full config)."""
    if q_lora not in _PAIRS:
        p = _lora_pair(q_lora) if q_lora else make_pair(ARCH)
        cfg = p["cfg"]
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                 (2, SEQ))
        p.update(toks=toks, jsp=p["jm"].default_share_prefill(),
                 tsp=p["tm"].default_share_prefill())
        _PAIRS[q_lora] = p
    return _PAIRS[q_lora]


def _lora_pair(q_lora: int):
    from repro.configs import get_smoke_config as j_smoke
    from repro.models.api import build_model as j_build
    from repro_torch.configs import get_smoke_config
    jc, tc = j_smoke(ARCH), get_smoke_config(ARCH)
    jcfg = dataclasses.replace(jc, mla=dataclasses.replace(
        jc.mla, q_lora_rank=q_lora))
    tcfg = dataclasses.replace(tc, mla=dataclasses.replace(
        tc.mla, q_lora_rank=q_lora))
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tp = checkpoint.params_from_numpy(_flatten(jp), tcfg, device="cpu")
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, cfg=tcfg, engines={})


@pytest.fixture
def pair():
    return _pair()


def _ref_prefill(p, **kw):
    kw.setdefault("attn_impl", "sparse")
    return p["jm"].prefill(p["jp"], jnp.asarray(p["toks"], jnp.int32),
                           p["jsp"], prompt_lens=jnp.asarray(PLENS), **kw)


def _port_prefill(p, **kw):
    return p["tm"].prefill(p["tp"], T(p["toks"]), p["tsp"],
                           prompt_lens=T(PLENS), **kw)


@pytest.mark.parametrize("q_lora", [0, 32], ids=["w_q", "q_lora"])
def test_leaves_round_trip(q_lora):
    """Every flat leaf of the reference's init lands in the port's layers
    (the prefix layer first, dense FFN; then the MoE stack) exactly, and
    the port's own init draws the same leaves and shapes."""
    p = _pair(q_lora)
    cfg, flat = p["cfg"], _flatten(p["jp"])
    assert cfg.mla.q_lora_rank == q_lora
    layers = p["tp"]["layers"]
    assert len(layers) == cfg.num_layers == 2
    seen = set()

    def walk(node, prefix, pick):
        for k, v in node.items():
            key = f"{prefix}::{k}"
            if isinstance(v, dict):
                walk(v, key, pick)
            else:
                seen.add(key)
                np.testing.assert_array_equal(v.numpy(), pick(flat[key]))

    walk(layers[0], "prefix_0", lambda a: a)
    walk(layers[1], "stack", lambda a: a[0])
    for top in ("embed", "lm_head"):
        seen.add(top)
        np.testing.assert_array_equal(p["tp"][top].numpy(), flat[top])
    seen.add("final_norm::scale")
    assert seen == set(flat)
    assert "router" not in layers[0]["ffn"] and "router" in layers[1]["ffn"]
    own = checkpoint.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    shapes = lambda ls: [jax.tree.map(lambda t: tuple(t.shape), l)
                         for l in ls]
    assert shapes(own["layers"]) == shapes(layers)
    assert float(own["layers"][0]["attn"]["kv_norm"]["scale"].min()) == 1.0


@pytest.mark.parametrize("method", ["share", "vertical_slash", "flex",
                                    "dense"])
def test_mla_prefill_layer_matches_reference(pair, method):
    """One MLA layer (the stack's) on the same input: ``share`` runs the
    batched sparse path, every other method the dense chunked attention
    with the state untouched and zero stats, as in the reference."""
    cfg, jcfg = pair["cfg"], pair["jm"].cfg
    x = np.random.default_rng(4).standard_normal(
        (2, SEQ, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(SEQ), (2, SEQ))
    jl = jax.tree.map(lambda a: a[0], pair["jp"]["stack"])["attn"]
    tl = pair["tp"]["layers"][1]["attn"]
    jst, tst = pair["jsp"].init_state(2, SEQ), pair["tsp"].init_state(2, SEQ)
    jy, (jc, jk), jst2, js = jmla.mla_prefill(
        jl, jnp.asarray(x), jcfg, jnp.asarray(pos), method=method,
        sp=pair["jsp"], sp_state=jst,
        cluster_ids=pair["jsp"].layer_cluster_ids()[1], attn_impl="sparse")
    ty, (tc, tk), tst2, ts = mla.mla_prefill(
        tl, T(x), cfg, T(pos), method=method, sp=pair["tsp"], sp_state=tst,
        cluster_ids=pair["tsp"].layer_cluster_ids()[1], attn_impl="auto")
    for a, b in ((ty, jy), (tc, jc), (tk, jk)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(float(a), float(b), atol=1e-6)
    np.testing.assert_array_equal(tst2.masks.numpy(), np.asarray(jst2.masks))
    np.testing.assert_array_equal(tst2.valid.numpy(), np.asarray(jst2.valid))
    if method == "share":               # the layer built pivots
        assert bool(tst2.valid.any()) and not bool(tst.valid.any())
    else:
        assert float(ts.block_density) == 1.0 and tst2 is tst


def test_model_prefill_cache_and_decode_match_reference(pair):
    """``Model.prefill`` (latent cache, logits, stats), then three absorbed
    decode steps on the grown cache (right-pad attended in both)."""
    jr, tr = _ref_prefill(pair), _port_prefill(pair)
    np.testing.assert_allclose(tr.last_logits.numpy(),
                               np.asarray(jr.last_logits), atol=1e-4, rtol=0)
    for a, b in zip(tr.stats, jr.stats):
        np.testing.assert_allclose(float(a), float(b), atol=1e-6)
    assert float(tr.stats.block_density) < 1.0     # the stack's: sparse
    cfg = pair["cfg"]
    r, rr = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    assert [tuple(x.shape) for x in tr.cache["prefix"][0]] == [
        (2, SEQ, r), (2, SEQ, rr)]
    assert [tuple(x.shape) for x in tr.cache["stack"]] == [
        (1, 2, SEQ, r), (1, 2, SEQ, rr)]
    pairs = list(zip(tr.cache["prefix"][0], jr.cache["prefix"][0])) + list(
        zip(tr.cache["stack"], jr.cache["stack"]))
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)
    extra = 128
    jcache = JEngine.grow_cache(jr.cache, SEQ, extra)
    tcache = ServingEngine.grow_cache(tr.cache, SEQ, extra)
    assert tcache["stack"][0].shape == (1, 2, SEQ + extra, r)
    assert tcache["prefix"][0][1].shape == (2, SEQ + extra, rr)
    tok = np.asarray(jr.last_logits).argmax(-1)[:, None]
    for t in range(3):
        jl, jcache = pair["jm"].decode(pair["jp"], jnp.asarray(tok, jnp.int32),
                                       jcache, jnp.int32(SEQ + t))
        tl, tcache = pair["tm"].decode(pair["tp"], T(tok).long(), tcache,
                                       SEQ + t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        tok = np.asarray(jl).argmax(-1)[:, None]
    np.testing.assert_allclose(tcache["stack"][0].numpy(),
                               np.asarray(jcache["stack"][0]), atol=1e-4,
                               rtol=1e-4)


def test_latent_cache_grow_and_insert_match_reference(pair):
    """``grow_cache`` and ``cache_insert`` on the ``{"prefix", "stack"}``
    latent layout (sequence axis 1 of the prefix leaves, 2 of the stacked
    ones; batch axis 0 and 1) against the reference engine's, exactly."""
    rng = np.random.default_rng(6)
    cfg = pair["cfg"]
    r, rr = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    mk = lambda b, s: {
        "prefix": [tuple(rng.standard_normal((b, s, w)).astype(np.float32)
                         for w in (r, rr))],
        "stack": tuple(rng.standard_normal((1, b, s, w)).astype(np.float32)
                       for w in (r, rr))}
    run, new = mk(3, 40), mk(1, 24)
    to_j = lambda c: jax.tree.map(jnp.asarray, c)
    to_t = lambda c: {"prefix": [tuple(T(x) for x in p)
                                 for p in c["prefix"]],
                      "stack": tuple(T(x) for x in c["stack"])}
    jgrown = JEngine.grow_cache(to_j(run), 40, 24)
    tgrown = ServingEngine.grow_cache(to_t(run), 40, 24)
    jins = JEngine.cache_insert(jgrown, to_j(new), 1)
    tins = ServingEngine.cache_insert(tgrown, to_t(new), 1)
    assert tins["stack"][0].shape == (1, 3, 64, r)
    for a, b in zip(jax.tree.leaves(jins), jax.tree.leaves(
            {"prefix": tins["prefix"], "stack": tins["stack"]})):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_absorbed_decode_matches_reference_and_decompressed(pair):
    """One layer's absorbed decode against the reference's, and against
    softmax attention over the decompressed latent cache (what prefill
    attends), both at 1e-5."""
    cfg, jcfg = pair["cfg"], pair["jm"].cfg
    rng = np.random.default_rng(5)
    s, pos = 80, 70
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((2, s, cfg.mla.kv_lora_rank)).astype(
        np.float32)
    kr = rng.standard_normal((2, s, cfg.mla.qk_rope_head_dim)).astype(
        np.float32)
    rope = np.array([[65], [61]])
    jl = jax.tree.map(lambda a: a[0], pair["jp"]["stack"])["attn"]
    tl = pair["tp"]["layers"][1]["attn"]
    jy, (jc, jk) = jmla.mla_decode(jl, jnp.asarray(x), jcfg, jnp.asarray(ckv),
                                   jnp.asarray(kr), jnp.int32(pos),
                                   jnp.asarray(rope))
    tc, tk = T(ckv), T(kr)
    ty = mla.mla_decode(tl, T(x), cfg, tc, tk, pos, T(rope))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6)
    # the same step with decompressed per-head K/V over slots <= pos
    from repro_torch.models import common
    q_nope, q_rope = mla._project_q(tl, T(x), cfg)
    q_rope = common.apply_rope(q_rope, T(rope)[:, None], cfg.rope_theta)
    k_nope, v = mla._decompress(tl, tc[:, :pos + 1])
    k = torch.cat([k_nope, tk[:, None, :pos + 1].expand(
        -1, cfg.num_heads, -1, -1)], -1)
    q = torch.cat([q_nope, q_rope], -1)
    att = torch.softmax(q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5, -1)
    want = common.gqa_out(tl, att @ v)
    np.testing.assert_allclose(ty.numpy(), want.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_per_sample_paths_match_reference(pair, impl):
    """``attn_impl="kernel"`` (B.6 per sample, at Dqk 48 / Dv 32) and
    ``"ref"``: logits 1e-4, stats 1e-6 and the dictionary against the
    reference's same path, and logits 1e-4 against the batched path."""
    jr = _ref_prefill(pair, attn_impl=impl)
    tr = _port_prefill(pair, attn_impl=impl)
    np.testing.assert_allclose(tr.last_logits.numpy(),
                               np.asarray(jr.last_logits), atol=1e-4, rtol=0)
    for a, b in zip(tr.stats, jr.stats):
        np.testing.assert_allclose(float(a), float(b), atol=1e-6)
    np.testing.assert_array_equal(tr.sp_state.masks.numpy(),
                                  np.asarray(jr.sp_state.masks))
    batched = _port_prefill(pair)
    np.testing.assert_allclose(tr.last_logits.numpy(),
                               batched.last_logits.numpy(), atol=1e-4,
                               rtol=0)


def _ref_batch_margins(p, reqs):
    """The reference's batch path replayed on its own tokens (prefill with
    prompt lengths, lockstep decode attending every slot): every row's
    top-2 logit margin by (uid, generated-token index)."""
    jm = p["jm"]
    b = len(reqs)
    toks = np.zeros((b, SEQ), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :len(r.prompt)] = r.prompt
    plens = jnp.asarray([len(r.prompt) for r in reqs], jnp.int32)
    res = jm.prefill(p["jp"], jnp.asarray(toks), jm.default_share_prefill(),
                     method="share", attn_impl="chunked", prompt_lens=plens)
    cache = JEngine.grow_cache(res.cache, SEQ, 128)
    logits, margins = res.last_logits, {}
    for t in range(max(len(r.output_tokens) for r in reqs)):
        rows = np.asarray(logits, np.float32)
        tok = np.zeros((b, 1), np.int32)
        for i, r in enumerate(reqs):
            top2 = np.sort(rows[i])[-2:]
            margins[(r.uid, t)] = float(top2[1] - top2[0])
            if t < len(r.output_tokens):
                tok[i, 0] = r.output_tokens[t]
        logits, cache = jm.decode(p["jp"], jnp.asarray(tok), cache,
                                  jnp.int32(SEQ + t))
    return margins


def test_batch_serve_matches_reference(pair):
    """The engine's batch path on both sides (prompt lengths for the last
    logits, no plan, pads attended in decode): greedy tokens near-tie
    aware, and ``scheduler=True`` / ``paged=True`` land on it."""
    vocab = pair["cfg"].vocab_size
    kw = dict(max_batch=2, seq_buckets=(SEQ,), decode_sparse=True)
    jr, tr = (requests(cls, vocab, (5, 3), seq=SEQ)
              for cls in (JRequest, Request))
    for r in (jr[1], tr[1]):
        r.prompt = r.prompt[:200]       # right-padded in its bucket
    ref_engine(pair, **kw).serve(jr, seed=0)
    port_engine(pair, **kw).serve(tr, seed=0)
    assert all(r.finish_reason == "length" for r in tr)
    assert "decode_traffic_fraction" not in tr[0].pattern_stats   # no plan
    assert_greedy_agree(jr, tr, _ref_batch_margins(pair, jr))


@pytest.mark.parametrize("flags", [{"scheduler": True}, {"paged": True}],
                         ids=["scheduler", "paged"])
def test_scheduler_flags_stay_on_the_batch_path(pair, flags, monkeypatch):
    vocab = pair["cfg"].vocab_size
    kw = dict(max_batch=2, seq_buckets=(SEQ,))
    base = requests(Request, vocab, (3, 2), seq=SEQ)
    port_engine(pair, **kw).serve(base, seed=0)

    def refuse(self):
        raise AssertionError("MLA reached the slot scheduler")
    monkeypatch.setattr(SlotScheduler, "run", refuse)
    got = requests(Request, vocab, (3, 2), seq=SEQ)
    eng = port_engine(pair, **kw, **flags)
    assert not eng._supports_scheduler()
    eng.serve(got, seed=0)
    for a, b in zip(base, got):
        np.testing.assert_array_equal(a.output_tokens, b.output_tokens)


def test_per_slot_pos_and_page_table_raise(pair):
    tm = pair["tm"]
    cache = tm.init_cache(2, 64)
    assert isinstance(cache, dict) and len(cache["prefix"]) == 1
    tok = torch.zeros((2, 1), dtype=torch.long)
    with pytest.raises(ValueError, match="per-slot"):
        tm.decode(pair["tp"], tok, cache, torch.tensor([8, 9]))
    with pytest.raises(ValueError, match="per-slot"):
        tm.decode(pair["tp"], tok, cache, torch.tensor([8, 9]),
                  page_table=torch.zeros((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="GQA decode contract"):
        tm.decode(pair["tp"], tok, cache, 8, collect_queries=True,
                  plan=object())
    assert not tm.prefill_chunk


def test_full_widths_reach_the_kernel_wrappers(fake_launch, monkeypatch):
    """DeepSeek-V2's full widths with no weights (meta tensors): layer
    0's q/k/v come out at Dqk = 192, Dv = 128, and the strip and the
    batched and single-sample block-sparse wrappers pass them (Dv among
    the ints) and allocate ``(…, Dv)`` outputs."""
    monkeypatch.setattr(_build, "ptr", lambda t: t)
    cfg = get_config(ARCH)
    m = cfg.mla
    assert (m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim) == (192,
                                                                       128)
    params = {name: torch.empty(shape, device="meta")
              for name, shape in mla.mla_leaf_shapes(cfg).items()}
    params = tree.unflatten(params)
    n, b, bs = 256, 1, 128
    x = torch.empty((b, n, cfg.d_model), device="meta")
    pos = torch.arange(n)[None]
    q, k, v, c_kv, k_rope = mla.mla_qkv(params, x, cfg, pos.to("meta"))
    h = cfg.num_heads
    assert q.shape == k.shape == (b, h, n, 192) and v.shape == (b, h, n, 128)
    assert c_kv.shape == (b, n, 512) and k_rope.shape == (b, n, 64)
    nb = n // bs
    idx = torch.empty((b, h, nb, nb), dtype=torch.int32, device="meta")
    cnt = torch.empty((b, h, nb), dtype=torch.int32, device="meta")
    strip = sk.strip_scores_cuda(q, k, bs)
    out, a_tilde = bsa.block_sparse_attention_cuda(q, k, v, idx, cnt,
                                                   block_size=bs)
    so, st = bsa.block_sparse_attention_single_cuda(q[0], k[0], v[0], idx[0],
                                                    cnt[0], block_size=bs)
    assert strip.shape == (b, h, bs, n)
    assert out.shape == (b, h, n, 128) and so.shape == (h, n, 128)
    assert a_tilde.shape == (b, h, nb, nb) and st.shape == (h, nb, nb)
    (batched,) = fake_launch["repro_block_sparse_attn"].calls
    (single,) = fake_launch["repro_block_sparse_attn_single"].calls
    assert batched[6] is out and single[5] is so
    assert list(batched[8:18]) == [_build.dtype_code(q), b, h, h, n, n, 192,
                                   128, bs, nb]
    assert list(single[7:14]) == [_build.dtype_code(q), h, h, n, 192, 128,
                                  bs]
    (s_call,) = fake_launch["repro_strip"].calls
    assert s_call[10] == 192


@pytest.mark.parametrize("d,dv,ok", [(192, 128, True), (48, 32, False),
                                     (192, 192, False), (128, 64, False)])
def test_block_sparse_wrappers_take_192_128_only(fake_launch, d, dv, ok):
    """Unequal widths launch at (192, 128) only (batched and single
    sample); the paged instance refuses unequal widths, naming those it
    takes."""
    b, h, n, bs = 1, 2, 256, 64
    q, k = torch.zeros(b, h, n, d), torch.zeros(b, h, n, d)
    v = torch.zeros(b, h, n, dv)
    m = torch.tril(torch.ones(n // bs, n // bs, dtype=torch.bool))
    idx, cnt = compact_block_mask(m.expand(b, h, -1, -1))
    calls = (lambda: bsa.block_sparse_attention_cuda(q, k, v, idx, cnt,
                                                     block_size=bs),
             lambda: bsa.block_sparse_attention_single_cuda(
                 q[0], k[0], v[0], idx[0], cnt[0], block_size=bs))
    for call in calls:
        if ok:
            out = call()[0]
            assert out.shape[-1] == dv
        else:
            with pytest.raises(ValueError, match=r"\(Dqk, Dv\) in"):
                call()
    pool_k, pool_v = torch.zeros(5, h, bs, d), torch.zeros(5, h, bs, dv)
    table = torch.arange(1, 5, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="equal K and V widths" if d != dv
                       else r"D in \(64, 96, 128\)"):
        bsa.block_sparse_attention_paged_cuda(q, pool_k, pool_v, table, idx,
                                              cnt, block_size=bs)
    want = 1 if ok else 0
    assert {k: len(v.calls) for k, v in fake_launch.items()} == (
        dict.fromkeys(["repro_block_sparse_attn",
                       "repro_block_sparse_attn_single"], want) if ok
        else {})


@pytest.mark.parametrize("d,dv", [(48, 32), (192, 128)])
def test_block_sparse_plain_at_unequal_widths_matches_pallas(d, dv):
    """B.2 (batched, gated stats) and B.6 (single sample) plain versions at
    Dqk ≠ Dv against the reference's Pallas kernels (interpret mode)."""
    rng = np.random.default_rng(22)
    b, h, hkv, s, bs = 2, 4, 2, 256, 64
    nb = s // bs
    q, k = (rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, hkv, s, d)))
    v = rng.standard_normal((b, hkv, s, dv)).astype(np.float32)
    mask = rng.random((b, h, nb, nb)) < 0.6
    mask &= np.tril(np.ones((nb, nb), bool))
    mask[:, :, np.arange(nb), np.arange(nb)] = True
    idx, cnt = (np.array(x) for x in
                jidx.compact_block_mask(jnp.asarray(mask)))
    gate = rng.random((b, h)) < 0.5
    jo, js = j_batched(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(idx), jnp.asarray(cnt), block_size=bs,
                       stats_gate=jnp.asarray(gate), interpret=True)
    to, ta = bsa.block_sparse_attention_plain(
        T(q), T(k), T(v), T(idx), T(cnt), block_size=bs,
        stats_gate=T(gate))
    assert to.shape == (b, h, s, dv)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=0)
    row_map, slot_map = ragged_schedule(nb, nb, width=nb)
    ja = np.asarray(jidx.scatter_schedule_stats(js, jnp.asarray(idx),
                                                row_map, slot_map, nb))
    assert (np.isneginf(ja) == np.isneginf(ta.numpy())).all()
    fin = np.isfinite(ja)
    np.testing.assert_allclose(ta.numpy()[fin], ja[fin], atol=1e-5, rtol=0)

    jo, js = j_single(jnp.asarray(q[0]), jnp.asarray(k[0]),
                      jnp.asarray(v[0]), jnp.asarray(idx[0]),
                      jnp.asarray(cnt[0]), block_size=bs, interpret=True)
    so, ss = bsa.block_sparse_attention_single_plain(
        T(q[0]), T(k[0]), T(v[0]), T(idx[0]), T(cnt[0]), block_size=bs)
    assert so.shape == (h, s, dv)
    np.testing.assert_allclose(so.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=0)
    js = np.asarray(js)
    assert (np.isneginf(js) == np.isneginf(ss.numpy())).all()
    fin = np.isfinite(js)
    np.testing.assert_allclose(ss.numpy()[fin], js[fin], atol=1e-5, rtol=0)


def test_strip_plain_at_192_matches_pallas():
    """B.1's plain version at D = 192 (MLA's Dqk) against the reference's
    strip kernel (interpret mode), 1e-6."""
    rng = np.random.default_rng(23)
    h, n, d, bs = 4, 256, 192, 64
    q = rng.standard_normal((h, n, d)).astype(np.float32)
    k = rng.standard_normal((h, n, d)).astype(np.float32)
    ref = strip_scores_pallas(jnp.asarray(q), jnp.asarray(k), block_size=bs,
                              interpret=True)
    got = sk.strip_scores(T(q)[None], T(k)[None], bs)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)

"""RecurrentGemma's hybrid stack in the port (``repro_torch.models.rglru``
and ``hybrid``, ROADMAP.md A.10) against the JAX package's, on the CPU.

Both packages run recurrentgemma-9b's smoke config (3 layers: one
(rec, rec, attn) super-block; d_model = lru_width = 256, 4 query heads
over 1 kv head of 64, window 256, block 64) and an 8-layer variant (two
super-blocks and two trailing recurrent layers), from the same parameters
(the reference's, through ``checkpoint.params_from_numpy``).  Inputs come
from a numpy seed; float32, no TF32.

What is held, and how tightly:
  * ``_causal_conv`` (fresh and carried state), ``rglru_apply`` at S = 1,
    48 and 257 with and without ``h0`` (against the reference's
    associative scan, and against a float64 sequential loop),
    ``recurrent_block_decode`` continuing ``recurrent_block_forward``:
    within ``ATOL``;
  * prefill under ``share`` (batched and per sample) and ``dense`` at
    S < W, S = W and S > W (the ring wraps): last logits within
    ``LOGIT_ATOL``, rings and recurrent states within ``LOGIT_ATOL`` too
    (K/V of order 2 after three float32 sublayers), stats 1e-6,
    the dictionary exactly; each super-block's masks, decisions and B.2
    tables exactly (each package's ``build_share_masks`` on its own layer
    input, under the window's block mask);
  * decode steps across the ring's wrap within ``LOGIT_ATOL``, and the
    port's dense prefill of S tokens plus a decode step against its dense
    prefill of S + 1;
  * a greedy batch serve near-tie aware (``scheduler=True`` on the batch
    path); the grow rule at a bucket equal to the window (the ring grows
    and decode writes past the window, in both packages);
  * the parameter bridge and ``init_params`` against the reference's tree
    (and the reference's ``w_out == w_x``, which the port does not copy).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten
from repro.core import share_attention as jsa
from repro.core.patterns import sliding_window_block_mask as j_window
from repro.kernels import indices as jind
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import hybrid as jhybrid
from repro.models import rglru as jrglru
from repro.serving import ServingEngine as JEngine
from repro_torch import checkpoint
from repro_torch.core import share_attention as sa
from repro_torch.kernels import indices as tind
from repro_torch.models import attention, common, hybrid, rglru
from repro_torch.models.attention import extra_block_mask
from repro_torch.serving import ServingEngine, SlotScheduler

from torch_serving_helpers import (JRequest, Request, assert_greedy_agree,
                                   make_pair, one_torch_thread,  # noqa: F401
                                   port_engine, ref_batch_margins,
                                   ref_engine, requests)

torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "recurrentgemma-9b"
W, BS = 256, 64
ATOL = 1e-5
LOGIT_ATOL = 1e-4
T = lambda a: torch.from_numpy(np.array(a))

_PAIRS = {}


@pytest.fixture
def pair(request):
    """The smoke config's pair (``L3``), or the 8-layer one (``L8``)."""
    name = getattr(request, "param", "L3")
    if name not in _PAIRS:
        p = make_pair(ARCH, **({} if name == "L3" else {"num_layers": 8}))
        assert p["cfg"].rglru.local_attn_window == W
        assert p["cfg"].share_prefill.block_size == BS
        _PAIRS[name] = p
    return _PAIRS[name]


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def _jlayer(p, sub="rec1", i=0):
    return jax.tree.map(lambda x: x[i], p["jp"]["stack"][sub])


def _flat_port(params) -> dict:
    """The port's hybrid tree in the reference's ``::`` keys (stacks
    stacked again)."""
    out = {}

    def walk(node, key):
        if isinstance(node, torch.Tensor):
            out[key] = node
        elif isinstance(node, list):
            for k in node[0]:
                walk(torch.stack([n[k] for n in node]) if isinstance(
                    node[0][k], torch.Tensor) else [n[k] for n in node],
                    f"{key}::{k}")
        else:
            for k, v in node.items():
                walk(v, f"{key}::{k}" if key else k)
    walk(params, "")
    return out


@pytest.mark.parametrize("pair", ["L8"], indirect=True)
def test_leaves_carry_across_and_init_matches_shapes(pair):
    cfg = pair["cfg"]
    ref = _flatten(pair["jp"])
    for params in (pair["tp"], checkpoint.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu")):
        got = _flat_port(params)
        assert set(got) == set(ref)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: v.shape for k, v in ref.items()}
    got = _flat_port(pair["tp"])
    for key in ("stack::rec2::mixer::lam", "stack::attn::mixer::wq",
                "trail_1::mixer::w_a", "lm_head"):
        _close(got[key], ref[key], atol=0)
    assert len(pair["tp"]["stack"]) == 2 and "trail_1" in pair["tp"]
    # a fact of the reference: w_out is drawn from w_x's key, so it equals
    # w_x where d_model == lru_width; the port draws every leaf on its own
    mixer = pair["jp"]["stack"]["rec1"]["mixer"]
    assert np.array_equal(np.asarray(mixer["w_out"]),
                          np.asarray(mixer["w_x"]))
    drawn = checkpoint.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    m = drawn["stack"][0]["rec1"]["mixer"]
    assert not torch.equal(m["w_out"], m["w_x"])
    a = torch.sigmoid(m["lam"])
    assert bool((a >= 0.9 - 1e-6).all() and (a <= 0.999 + 1e-6).all())
    assert float(m["conv_w"].std()) < 0.2 and not bool(m["b_a"].any())
    assert torch.equal(drawn["stack"][1]["attn"]["ln1"]["scale"],
                       torch.ones(cfg.d_model))


def test_causal_conv_matches_reference(pair):
    jl, tl = _jlayer(pair)["mixer"], pair["tp"]["stack"][0]["rec1"]["mixer"]
    rng = np.random.default_rng(1)
    u = rng.standard_normal((2, 37, W)).astype(np.float32)
    state = rng.standard_normal((2, 3, W)).astype(np.float32)
    for st in (None, state):
        ref = jrglru._causal_conv(jl, jnp.asarray(u),
                                  None if st is None else jnp.asarray(st))
        got = rglru._causal_conv(tl, T(u), None if st is None else T(st))
        for a, b in zip(got, ref):
            _close(a, b)


def _loop64(params, x, h0):
    """The recurrence in float64, one step at a time."""
    p = {k: np.asarray(v, np.float64) for k, v in params.items()}
    x = x.astype(np.float64)
    sig = lambda z: 1 / (1 + np.exp(-z))
    r, i = sig(x @ p["w_a"] + p["b_a"]), sig(x @ p["w_i"] + p["b_i"])
    log_a = 8.0 * r * np.log(sig(p["lam"]))
    a = np.exp(log_a)
    b = np.sqrt(np.maximum(1 - np.exp(2 * log_a), 1e-12)) * i * x
    h = np.zeros(x.shape[::2]) if h0 is None else h0.astype(np.float64)
    out = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return np.stack(out, 1)


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0_none", "h0"])
@pytest.mark.parametrize("s", [1, 48, 257])
def test_rglru_apply_matches_reference_and_a_float64_loop(pair, s, with_h0):
    """The doubling scan against the reference's associative scan and a
    float64 loop, within ``ATOL`` (states of order 1)."""
    jl, tl = _jlayer(pair)["mixer"], pair["tp"]["stack"][0]["rec1"]["mixer"]
    rng = np.random.default_rng(2 + s)
    x = rng.standard_normal((2, s, W)).astype(np.float32)
    h0 = (rng.standard_normal((2, W)).astype(np.float32) if with_h0
          else None)
    rh, rlast = jrglru.rglru_apply(jl, jnp.asarray(x), jl["lam"],
                                   None if h0 is None else jnp.asarray(h0))
    gh, glast = rglru.rglru_apply(tl, T(x), tl["lam"],
                                  None if h0 is None else T(h0))
    assert gh.dtype == torch.float32
    _close(gh, rh)
    _close(glast, rlast)
    _close(gh, _loop64({k: np.asarray(v) for k, v in jl.items()}, x, h0))


def test_recurrent_block_decode_continues_forward(pair):
    """Four decode steps after a 64-token forward, each against the
    reference's step, and the port's steps against its own forward over
    all 68 tokens."""
    cfg = pair["cfg"]
    jl, tl = _jlayer(pair)["mixer"], pair["tp"]["stack"][0]["rec1"]["mixer"]
    x = np.random.default_rng(4).standard_normal(
        (2, 68, cfg.d_model)).astype(np.float32)
    _, jst = jrglru.recurrent_block_forward(jl, jnp.asarray(x[:, :64]), cfg)
    _, tst = rglru.recurrent_block_forward(tl, T(x[:, :64]), cfg)
    for a, b in zip(tst, jst):
        _close(a, b)
    steps = []
    for t in range(64, 68):
        ry, jst = jrglru.recurrent_block_decode(
            jl, jnp.asarray(x[:, t:t + 1]), cfg, *jst)
        gy, tst = rglru.recurrent_block_decode(tl, T(x[:, t:t + 1]), cfg,
                                               *tst)
        _close(gy, ry)
        for a, b in zip(tst, jst):
            _close(a, b)
        steps.append(gy)
    whole, _ = rglru.recurrent_block_forward(tl, T(x), cfg)
    _close(torch.cat(steps, 1), whole[:, 64:].numpy())


def _tokens(p, s, seed=5):
    return np.random.default_rng(seed).integers(
        0, p["cfg"].vocab_size, (2, s)).astype(np.int32)


def _prefill_pair(p, s, method, impl):
    jm, tm = p["jm"], p["tm"]
    toks = _tokens(p, s)
    jr = jm.prefill(p["jp"], jnp.asarray(toks), jm.default_share_prefill(),
                    method=method, attn_impl=impl)
    tr = tm.prefill(p["tp"], T(toks).long(), tm.default_share_prefill(),
                    method=method, attn_impl=impl)
    return jr, tr


def _leaves(cache):
    return jax.tree.leaves(cache, is_leaf=lambda x: isinstance(
        x, torch.Tensor))


METHODS = [("share", "sparse"), ("dense", "sparse"), ("share", "kernel")]


@pytest.mark.parametrize("s", [128, W, 384], ids=["below_W", "at_W",
                                                  "wrapped"])
@pytest.mark.parametrize("method,impl", METHODS,
                         ids=["share", "dense", "share_kernel"])
def test_prefill_matches_reference(pair, method, impl, s):
    jr, tr = _prefill_pair(pair, s, method, impl)
    _close(tr.last_logits, jr.last_logits, atol=LOGIT_ATOL)
    got, ref = _leaves(tr.cache), _leaves(jr.cache)
    assert [tuple(a.shape) for a in got] == [b.shape for b in ref]
    for a, b in zip(got, ref):
        _close(a, b, atol=LOGIT_ATOL)
    ring = tr.cache["stack"][2][0]
    assert ring.shape[3] == W            # padded to the window below it
    if s < W:
        assert not bool(ring[:, :, :, s:].any())
    for a, b in zip(tr.stats, jr.stats):
        np.testing.assert_allclose(float(a), float(b), atol=1e-6)
    if method == "dense":             # a fresh dictionary, in both
        assert not bool(tr.sp_state.valid.any())
    for f in ("masks", "valid"):
        np.testing.assert_array_equal(getattr(tr.sp_state, f).numpy(),
                                      np.asarray(getattr(jr.sp_state, f)))
    _close(tr.sp_state.reps, jr.sp_state.reps, atol=1e-6)


@pytest.mark.parametrize("pair,s", [("L3", W), ("L8", 384)],
                         indirect=["pair"], ids=["L3-at_W", "L8-wrapped"])
def test_layer_masks_decisions_and_tables_match_reference(pair, s):
    """Super-block by super-block: each package's masks and decisions from
    its own attention-layer input under the window's block mask (exactly),
    their B.2 tables (exactly), and the dictionary after the last
    super-block against a whole prefill's; then the trailing layers'
    logits."""
    cfg, jcfg = pair["cfg"], pair["jm"].cfg
    jsp = pair["jm"].default_share_prefill()
    tsp = pair["tm"].default_share_prefill()
    toks = _tokens(pair, s)
    jx = pair["jp"]["embed"][jnp.asarray(toks)]
    tx = pair["tp"]["embed"][T(toks).long()]
    jpos = jnp.broadcast_to(jnp.arange(s)[None], (2, s))
    tpos = torch.arange(s)[None].expand(2, s)
    jst, tst = jsp.init_state(2, s), tsp.init_state(2, s)
    jids, tids = jsp.layer_cluster_ids(), tsp.layer_cluster_ids()
    nb = s // BS
    extra = extra_block_mask(hybrid._attn_cfg(cfg), nb, BS)
    jextra = j_window(nb, W // BS)
    assert torch.equal(extra, T(jextra))
    spc = cfg.share_prefill
    for li, block in enumerate(pair["tp"]["stack"]):
        jb = jax.tree.map(lambda a: a[li], pair["jp"]["stack"])
        for sub in ("rec1", "rec2"):
            jx, _ = jhybrid._sub_forward(jb[sub], jx, jcfg, "recurrent",
                                         jpos)
            tx, _ = hybrid._sub_forward(block[sub], tx, cfg)
        h = jcommon.rmsnorm(jb["attn"]["ln1"], jx, jcfg.rms_norm_eps)
        q, k, _ = jcommon.gqa_qkv(jb["attn"]["mixer"], h)
        q, k = jattn.rope_qk(q, k, jpos, jcfg)
        jmasks, jdec = jax.vmap(
            lambda qb, kb, st: jsa.build_share_masks(
                qb, kb, st, jids[li], jcfg.share_prefill, jextra))(q, k, jst)
        h = common.rmsnorm(block["attn"]["ln1"], tx, cfg.rms_norm_eps)
        q, k, _ = common.gqa_qkv(block["attn"]["mixer"], h)
        q, k = attention.rope_qk(q, k, tpos, cfg)
        tmasks, tdec = sa.build_share_masks(q, k, tst, tids[li], spc, extra)
        np.testing.assert_array_equal(tmasks.numpy(), np.asarray(jmasks))
        for f in ("use_shared", "use_dense", "use_vs"):
            np.testing.assert_array_equal(getattr(tdec, f).numpy(),
                                          np.asarray(getattr(jdec, f)))
        for a, b in zip(tind.compact_block_mask(tmasks),
                        jind.compact_block_mask(jmasks)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert not bool((tmasks & ~extra).any())
        jx, _, jst, _ = jhybrid._attn_prefill_sub(
            jb["attn"], jx, jcfg, jpos, jsp, jst, jids[li], "share",
            "sparse")
        tx, _, tst, _ = hybrid._attn_prefill_sub(
            block["attn"], tx, cfg, tpos, tsp, tst, tids[li], "share",
            "sparse")
    if s > W:                         # the window hides blocks of every head
        causal = torch.ones(nb, nb, dtype=torch.bool).tril()
        assert float(tmasks.float().mean()) < float(causal.float().mean())
    jr, tr = _prefill_pair(pair, s, "share", "sparse")
    for st, ref in ((tst, jst), (tr.sp_state, jr.sp_state)):
        np.testing.assert_array_equal(st.masks.numpy(), np.asarray(ref.masks))
        np.testing.assert_array_equal(st.valid.numpy(), np.asarray(ref.valid))
        _close(st.reps, ref.reps, atol=1e-6)
    _close(tr.last_logits, jr.last_logits, atol=LOGIT_ATOL)


@pytest.mark.parametrize("pair,s,steps", [("L3", 248, 12), ("L8", 384, 4)],
                         indirect=["pair"],
                         ids=["L3-across_the_wrap", "L8-full_ring"])
def test_decode_steps_match_reference(pair, s, steps):
    """Greedy decode steps after a prefill: at 248 tokens the steps cross
    position W (the ring's slot wraps to 0), at 384 the ring is full;
    logits each step and the caches at the end within tolerance."""
    jr, tr = _prefill_pair(pair, s, "share", "sparse")
    jc = JEngine.grow_cache(jr.cache, s, 64)
    tc = ServingEngine.grow_cache(tr.cache, s, 64)
    tok = np.argmax(np.asarray(jr.last_logits), -1)[:, None].astype(np.int32)
    jm, tm = pair["jm"], pair["tm"]
    for t in range(steps):
        jl, jc = jm.decode(pair["jp"], jnp.asarray(tok), jc,
                           jnp.int32(s + t))
        tl, tc = tm.decode(pair["tp"], T(tok).long(), tc, s + t)
        _close(tl, jl, atol=LOGIT_ATOL)
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    for a, b in zip(_leaves(tc), _leaves(jc)):
        _close(a, b, atol=1e-4)


def test_prefill_then_decode_equals_a_longer_dense_prefill(pair):
    """The ring holds the last W tokens and decode attends them all, which
    is the dense prefill's token window: prefill(S) + one decode step
    equals prefill(S + 1)'s last logits."""
    tm, s = pair["tm"], 384
    toks = T(_tokens(pair, s + 1)).long()
    sp = tm.default_share_prefill()
    head = tm.prefill(pair["tp"], toks[:, :s], sp, method="dense")
    step, _ = tm.decode(pair["tp"], toks[:, s:], head.cache, s)
    whole = tm.prefill(pair["tp"], toks, sp, method="dense")
    _close(step, whole.last_logits.numpy(), atol=LOGIT_ATOL)


@pytest.mark.parametrize("flags", [{}, {"scheduler": True}],
                         ids=["batch", "scheduler"])
def test_serve_matches_reference(pair, flags, monkeypatch):
    """Greedy tokens near-tie aware against the reference's same serve
    (both on the batched sparse path); ``scheduler=True`` falls to the
    batch path in both packages."""
    seq = 384
    vocab = pair["cfg"].vocab_size
    kw = dict(max_batch=2, seq_buckets=(seq,), decode_sparse=True,
              attn_impl="sparse", **flags)
    jr, tr = (requests(cls, vocab, (5, 3), seq=seq)
              for cls in (JRequest, Request))
    for r in (jr[1], tr[1]):
        r.prompt = r.prompt[:300]       # right-padded in its bucket

    def refuse(self):
        raise AssertionError("the hybrid family reached the slot scheduler")
    monkeypatch.setattr(SlotScheduler, "run", refuse)
    ref_engine(pair, **kw).serve(jr, seed=0)
    eng = port_engine(pair, **kw)
    assert not eng._supports_scheduler() and eng._width_cap(seq) is None
    eng.serve(tr, seed=0)
    assert [r.finish_reason for r in tr] == ["length", "length"]
    assert tr[0].pattern_stats["block_density"] < 1.0
    assert "decode_traffic_fraction" not in tr[0].pattern_stats   # no plan
    assert_greedy_agree(jr, tr, ref_batch_margins(
        pair, jr, seq, method="share", attn_impl="sparse"))


@pytest.mark.parametrize("bucket", [384, W], ids=["plain", "at_window"])
def test_grow_cache_follows_the_reference(pair, bucket):
    """``grow_cache`` walks the whole tree and grows every non-trailing
    axis equal to the bucket: nothing at 384; at a bucket equal to the
    window the rings grow to W + 64, in both packages, and decode then
    writes linearly past the window and attends it all (a fact of the
    reference, ROADMAP.md C), the steps still equal."""
    jr, tr = _prefill_pair(pair, bucket, "share", "sparse")
    jg = JEngine.grow_cache(jr.cache, bucket, 64)
    tg = ServingEngine.grow_cache(tr.cache, bucket, 64)
    for a, b in zip(_leaves(tg), _leaves(jg)):
        assert tuple(a.shape) == b.shape
        _close(a, b, atol=LOGIT_ATOL)
    ring = tg["stack"][2][0]
    assert ring.shape[3] == (W + 64 if bucket == W else W)
    if bucket != W:
        assert all(a is b for a, b in zip(_leaves(tg), _leaves(tr.cache)))
        return
    tok = np.argmax(np.asarray(jr.last_logits), -1)[:, None].astype(np.int32)
    for t in range(3):
        jl, jg = pair["jm"].decode(pair["jp"], jnp.asarray(tok), jg,
                                   jnp.int32(bucket + t))
        tl, tg = pair["tm"].decode(pair["tp"], T(tok).long(), tg, bucket + t)
        _close(tl, jl, atol=LOGIT_ATOL)
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    # the steps landed at slots W, W + 1, W + 2: past the window
    assert bool(tg["stack"][2][0][:, :, :, W:W + 3].any())


def test_init_cache_and_plain_signatures(pair):
    tm = pair["tm"]
    for n in (1000, 100):
        cache, ref = tm.init_cache(3, n), pair["jm"].init_cache(3, n)
        for a, b in zip(_leaves(cache), _leaves(ref)):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype)[6:] == str(b.dtype)
    assert not tm.prefill_chunk and not tm.transformer_family
    tok = torch.zeros((3, 1), dtype=torch.long)
    with pytest.raises(TypeError, match="prompt_lens"):
        tm.prefill(pair["tp"], tok, tm.default_share_prefill(),
                   prompt_lens=torch.ones(3))
    with pytest.raises(TypeError, match="plan"):
        tm.decode(pair["tp"], tok, tm.init_cache(3, 100), 0, plan=object())
    with pytest.raises(ValueError, match="lockstep"):
        tm.decode(pair["tp"], tok, tm.init_cache(3, 100), torch.zeros(3))
    sp = tm.default_share_prefill()
    assert sp.cluster_ids.shape == (pair["cfg"].num_layers,
                                    pair["cfg"].num_heads)

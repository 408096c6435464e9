"""Whisper's encoder-decoder in the port (``repro_torch.models.whisper``,
ROADMAP.md A.10) against the JAX package's, on the CPU.

Both packages run whisper-base's smoke config (2 encoder and 2 decoder
layers, d_model 256, 4 heads over 4 kv heads of 64, 64 stub frames, block
64) from the same parameters (the reference's, through
``checkpoint.params_from_numpy``); frames and tokens come from a numpy
seed; float32, no TF32.

What is held, and how tightly:
  * ``sinusoidal_positions`` within 1e-6 of the angle's magnitude;
  * ``encode`` at T = 64 (blocks of 64) and T = 100 (one block of all T),
    both ``_cross_attend`` branches (chunked when both lengths are
    multiples of 64, per sample through ``decode_attention_ref`` else):
    within ``ATOL``;
  * prefill under ``share`` (batched and per sample) and ``dense`` at 256
    decoder tokens, and dense at 100: last logits, self-attention and
    encoder K/V within ``LOGIT_ATOL``, stats 1e-6, the dictionary exactly;
    each decoder layer's masks, decisions and B.2 tables exactly (each
    package's ``build_share_masks`` on its own layer input);
  * decode steps within ``LOGIT_ATOL``, and the port's prefill of S tokens
    plus a decode step against its prefill of S + 1 (decode's sinusoid row
    ``pos``);
  * a greedy batch serve near-tie aware (zero frames, as in the
    reference; ``scheduler=True`` on the batch path); ``grow_cache``
    growing the self-attention K/V (and the encoder K/V too at a bucket
    equal to the frame count, in both packages);
  * the parameter bridge and ``init_params`` against the reference's tree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten
from repro.core import share_attention as jsa
from repro.kernels import indices as jind
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import whisper as jwhisper
from repro.serving import ServingEngine as JEngine
from repro_torch import checkpoint
from repro_torch.core import share_attention as sa
from repro_torch.kernels import indices as tind
from repro_torch.models import attention, common, whisper
from repro_torch.serving import ServingEngine, SlotScheduler

from torch_serving_helpers import (JRequest, Request, assert_greedy_agree,
                                   make_pair, one_torch_thread,  # noqa: F401
                                   port_engine, ref_batch_margins,
                                   ref_engine, requests)

torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "whisper-base"
SEQ, BS, FRAMES = 256, 64, 64
ATOL = 1e-5
LOGIT_ATOL = 1e-4
T = lambda a: torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def pair():
    p = make_pair(ARCH)
    cfg = p["cfg"]
    assert cfg.encdec.encoder_seq_len == FRAMES and cfg.num_kv_heads == 4
    assert cfg.share_prefill.block_size == BS and cfg.rope_theta == 0
    return p


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def _leaves(cache):
    return jax.tree.leaves(cache, is_leaf=lambda x: isinstance(
        x, torch.Tensor))


def _frames(cfg, t=FRAMES, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (2, t, cfg.d_model)).astype(np.float32)


def _tokens(p, s, seed=5):
    return np.random.default_rng(seed).integers(
        0, p["cfg"].vocab_size, (2, s)).astype(np.int32)


@pytest.mark.parametrize("num,dim", [(64, 256), (1500, 512)])
def test_sinusoidal_positions_match_reference(num, dim):
    got = common.sinusoidal_positions(num, dim)
    ref = np.asarray(jcommon.sinusoidal_positions(num, dim))
    assert tuple(got.shape) == ref.shape == (num, dim)
    # float32 angles up to ``num``: an ulp of the angle is ~1e-7 of it
    _close(got, ref, atol=1e-6 * num)


def test_leaves_carry_across_and_init_matches_shapes(pair):
    cfg = pair["cfg"]
    ref = _flatten(pair["jp"])
    for params in (pair["tp"], checkpoint.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu")):
        assert len(params["enc_stack"]) == cfg.encdec.num_encoder_layers
        assert len(params["dec_stack"]) == cfg.num_layers
        for key, arr in ref.items():
            group, *path = key.split("::")
            node = params[group]
            stacked = isinstance(node, list)
            for part in path:
                node = ([n[part] for n in node] if isinstance(node, list)
                        else node[part])
            got = torch.stack(node) if stacked else node
            assert tuple(got.shape) == arr.shape, key
            if params is pair["tp"]:
                _close(got, arr, atol=0)
    drawn = checkpoint.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    assert torch.equal(drawn["dec_stack"][1]["ln_x"]["scale"],
                       torch.ones(cfg.d_model))
    assert float(drawn["enc_stack"][0]["attn"]["wq"].abs().max()) <= \
        2 / cfg.d_model ** 0.5 + 1e-6


@pytest.mark.parametrize("t", [FRAMES, 100], ids=["chunked", "one_block"])
def test_encode_matches_reference(pair, t):
    frames = _frames(pair["cfg"], t)
    ref = jwhisper.encode(pair["jp"], pair["jm"].cfg, jnp.asarray(frames))
    got = whisper.encode(pair["tp"], pair["cfg"], T(frames))
    _close(got, ref)


@pytest.mark.parametrize("s,t", [(64, 128), (5, 100)],
                         ids=["chunked", "per_sample"])
def test_cross_attend_branches_match_reference(pair, s, t):
    cfg = pair["cfg"]
    jl = jax.tree.map(lambda a: a[1], pair["jp"]["dec_stack"])
    tl = pair["tp"]["dec_stack"][1]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    jkv = jwhisper._enc_kv(jl, jnp.asarray(enc))
    tkv = whisper._enc_kv(tl, T(enc))
    for a, b in zip(tkv, jkv):
        _close(a, b)
    ref = jwhisper._cross_attend(jl, jnp.asarray(x), jkv, pair["jm"].cfg)
    got = whisper._cross_attend(tl, T(x), tkv, cfg)
    _close(got, ref)


def _prefill_pair(p, s, method, impl, frames=True):
    jm, tm = p["jm"], p["tm"]
    toks = _tokens(p, s)
    emb = _frames(p["cfg"]) if frames else None
    jr = jm.prefill(p["jp"], jnp.asarray(toks), jm.default_share_prefill(),
                    method=method, attn_impl=impl,
                    embeds=None if emb is None else jnp.asarray(emb))
    tr = tm.prefill(p["tp"], T(toks).long(), tm.default_share_prefill(),
                    method=method, attn_impl=impl,
                    embeds=None if emb is None else T(emb))
    return jr, tr


@pytest.mark.parametrize("method,impl,s", [
    ("share", "sparse", SEQ), ("dense", "sparse", SEQ),
    ("share", "kernel", SEQ), ("share", "sparse", 100)],
    ids=["share", "dense", "share_kernel", "unaligned"])
def test_prefill_matches_reference(pair, method, impl, s):
    jr, tr = _prefill_pair(pair, s, method, impl)
    _close(tr.last_logits, jr.last_logits, atol=LOGIT_ATOL)
    got, ref = _leaves(tr.cache), _leaves(jr.cache)
    assert [tuple(a.shape) for a in got] == [b.shape for b in ref]
    for a, b in zip(got, ref):
        _close(a, b, atol=LOGIT_ATOL)
    for a, b in zip(tr.stats, jr.stats):
        np.testing.assert_allclose(float(a), float(b), atol=1e-6)
    if s % BS:                           # not block-aligned: dense, no state
        assert tr.sp_state is None and jr.sp_state is None
        return
    for f in ("masks", "valid"):
        np.testing.assert_array_equal(getattr(tr.sp_state, f).numpy(),
                                      np.asarray(getattr(jr.sp_state, f)))
    _close(tr.sp_state.reps, jr.sp_state.reps, atol=1e-6)


def test_layer_masks_decisions_and_tables_match_reference(pair):
    """Layer by layer through the decoder: each package's masks and
    decisions from its own layer input (exactly) and their B.2 tables
    (exactly); the dictionary after the last layer against a whole
    prefill's."""
    cfg, jcfg = pair["cfg"], pair["jm"].cfg
    jsp = pair["jm"].default_share_prefill()
    tsp = pair["tm"].default_share_prefill()
    toks, frames = _tokens(pair, SEQ), _frames(cfg)
    jenc = jwhisper.encode(pair["jp"], jcfg, jnp.asarray(frames))
    tenc = whisper.encode(pair["tp"], cfg, T(frames))
    jx = pair["jp"]["embed"][jnp.asarray(toks)] + \
        jcommon.sinusoidal_positions(SEQ, cfg.d_model)[None]
    tx = whisper._add_positions(pair["tp"]["embed"][T(toks).long()], cfg)
    jpos = jnp.broadcast_to(jnp.arange(SEQ)[None], (2, SEQ))
    tpos = torch.arange(SEQ)[None].expand(2, SEQ)
    jst, tst = jsp.init_state(2, SEQ), tsp.init_state(2, SEQ)
    jids, tids = jsp.layer_cluster_ids(), tsp.layer_cluster_ids()
    for li, tl in enumerate(pair["tp"]["dec_stack"]):
        jl = jax.tree.map(lambda a: a[li], pair["jp"]["dec_stack"])
        h = jcommon.rmsnorm(jl["ln1"], jx, jcfg.rms_norm_eps)
        q, k, _ = jcommon.gqa_qkv(jl["self_attn"], h)
        jmasks, jdec = jax.vmap(
            lambda qb, kb, st: jsa.build_share_masks(
                qb, kb, st, jids[li], jcfg.share_prefill))(q, k, jst)
        h = common.rmsnorm(tl["ln1"], tx, cfg.rms_norm_eps)
        q, k, _ = common.gqa_qkv(tl["self_attn"], h)
        tmasks, tdec = sa.build_share_masks(q, k, tst, tids[li],
                                            cfg.share_prefill)
        np.testing.assert_array_equal(tmasks.numpy(), np.asarray(jmasks))
        for f in ("use_shared", "use_dense", "use_vs"):
            np.testing.assert_array_equal(getattr(tdec, f).numpy(),
                                          np.asarray(getattr(jdec, f)))
        for a, b in zip(tind.compact_block_mask(tmasks),
                        jind.compact_block_mask(jmasks)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # each package's own decoder layer, as its prefill runs it
        y, _, jst, _ = jattn.attention_prefill(
            jl["self_attn"], jcommon.rmsnorm(jl["ln1"], jx,
                                             jcfg.rms_norm_eps),
            jcfg, jpos, method="share", sp=jsp, sp_state=jst,
            cluster_ids=jids[li], attn_impl="sparse")
        jx = jx + y
        jx = jx + jwhisper._cross_attend(
            jl, jcommon.rmsnorm(jl["ln_x"], jx, jcfg.rms_norm_eps),
            jwhisper._enc_kv(jl, jenc), jcfg)
        jx = jx + jcommon.mlp(jl["mlp"], jcommon.rmsnorm(
            jl["ln2"], jx, jcfg.rms_norm_eps))
        y, _, tst, _ = attention.attention_prefill(
            tl["self_attn"], h, cfg, tpos, method="share", sp=tsp,
            sp_state=tst, cluster_ids=tids[li], attn_impl="sparse")
        tx = whisper._cross_block(tl, tx + y, whisper._enc_kv(tl, tenc),
                                  cfg)
    jr, tr = _prefill_pair(pair, SEQ, "share", "sparse")
    for st, ref in ((tst, jst), (tr.sp_state, jr.sp_state)):
        np.testing.assert_array_equal(st.masks.numpy(), np.asarray(ref.masks))
        np.testing.assert_array_equal(st.valid.numpy(), np.asarray(ref.valid))
        _close(st.reps, ref.reps, atol=1e-6)


@pytest.mark.parametrize("s", [SEQ, 100], ids=["aligned", "unaligned"])
def test_decode_steps_match_reference(pair, s):
    jr, tr = _prefill_pair(pair, s, "share", "sparse")
    extra = 64
    jc = JEngine.grow_cache(jr.cache, s, extra)
    tc = ServingEngine.grow_cache(tr.cache, s, extra)
    assert tc["stack"][0][0].shape[3] == s + extra
    assert tc["stack"][1][0].shape[3] == FRAMES
    tok = np.argmax(np.asarray(jr.last_logits), -1)[:, None].astype(np.int32)
    for t in range(4):
        jl, jc = pair["jm"].decode(pair["jp"], jnp.asarray(tok), jc,
                                   jnp.int32(s + t))
        tl, tc = pair["tm"].decode(pair["tp"], T(tok).long(), tc, s + t)
        _close(tl, jl, atol=LOGIT_ATOL)
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    for a, b in zip(_leaves(tc), _leaves(jc)):
        _close(a, b, atol=LOGIT_ATOL)


def test_prefill_then_decode_equals_a_longer_prefill(pair):
    """prefill(S) and one decode step (the sinusoid's row S, every slot ≤
    S) give the last logits of prefill(S + 1), under the same frames."""
    tm = pair["tm"]
    toks = T(_tokens(pair, SEQ + 1)).long()
    frames = T(_frames(pair["cfg"]))
    sp = tm.default_share_prefill()
    head = tm.prefill(pair["tp"], toks[:, :SEQ], sp, method="dense",
                      embeds=frames)
    cache = ServingEngine.grow_cache(head.cache, SEQ, 64)
    step, _ = tm.decode(pair["tp"], toks[:, SEQ:], cache, SEQ)
    whole = tm.prefill(pair["tp"], toks, sp, method="dense", embeds=frames)
    _close(step, whole.last_logits.numpy(), atol=LOGIT_ATOL)


@pytest.mark.parametrize("flags", [{}, {"scheduler": True}],
                         ids=["batch", "scheduler"])
def test_serve_matches_reference(pair, flags, monkeypatch):
    """Greedy tokens near-tie aware against the reference's same serve
    (zero frames, the batched sparse path); ``scheduler=True`` falls to
    the batch path in both packages."""
    vocab = pair["cfg"].vocab_size
    kw = dict(max_batch=2, seq_buckets=(SEQ,), decode_sparse=True,
              attn_impl="sparse", **flags)
    jr, tr = (requests(cls, vocab, (5, 3), seq=SEQ)
              for cls in (JRequest, Request))
    for r in (jr[1], tr[1]):
        r.prompt = r.prompt[:200]       # right-padded in its bucket

    def refuse(self):
        raise AssertionError("the encdec family reached the slot scheduler")
    monkeypatch.setattr(SlotScheduler, "run", refuse)
    ref_engine(pair, **kw).serve(jr, seed=0)
    eng = port_engine(pair, **kw)
    assert not eng._supports_scheduler() and eng._width_cap(SEQ) is None
    eng.serve(tr, seed=0)
    assert [r.finish_reason for r in tr] == ["length", "length"]
    assert "decode_traffic_fraction" not in tr[0].pattern_stats   # no plan
    assert_greedy_agree(jr, tr, ref_batch_margins(
        pair, jr, SEQ, method="share", attn_impl="sparse"))


def test_grow_cache_at_the_frame_count_follows_the_reference(pair):
    """At a bucket equal to the frame count (64) ``grow_cache`` grows the
    encoder K/V too, in both packages (a fact of the reference, ROADMAP.md
    C); the decode steps still agree."""
    jr, tr = _prefill_pair(pair, FRAMES, "share", "sparse")
    jc = JEngine.grow_cache(jr.cache, FRAMES, 64)
    tc = ServingEngine.grow_cache(tr.cache, FRAMES, 64)
    for a, b in zip(_leaves(tc), _leaves(jc)):
        assert tuple(a.shape) == b.shape
        assert a.shape[3] == FRAMES + 64
    tok = np.argmax(np.asarray(jr.last_logits), -1)[:, None].astype(np.int32)
    for t in range(2):
        jl, jc = pair["jm"].decode(pair["jp"], jnp.asarray(tok), jc,
                                   jnp.int32(FRAMES + t))
        tl, tc = pair["tm"].decode(pair["tp"], T(tok).long(), tc, FRAMES + t)
        _close(tl, jl, atol=LOGIT_ATOL)
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)


def test_init_cache_and_plain_signatures(pair):
    tm = pair["tm"]
    cache, ref = tm.init_cache(3, 100), pair["jm"].init_cache(3, 100)
    for a, b in zip(_leaves(cache), _leaves(ref)):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype)[6:] == str(b.dtype)
    assert not tm.prefill_chunk and not tm.transformer_family
    tok = torch.zeros((3, 1), dtype=torch.long)
    with pytest.raises(TypeError, match="prompt_lens"):
        tm.prefill(pair["tp"], tok, tm.default_share_prefill(),
                   prompt_lens=torch.ones(3))
    with pytest.raises(TypeError, match="page_table"):
        tm.decode(pair["tp"], tok, cache, 0, page_table=torch.zeros(3, 1))
    with pytest.raises(ValueError, match="lockstep"):
        tm.decode(pair["tp"], tok, cache, torch.zeros(3))
    # no frames: zeros in the parameters' dtype, as the reference's zeros
    res = tm.prefill(pair["tp"], T(_tokens(pair, 64)).long(),
                     tm.default_share_prefill())
    assert bool(torch.isfinite(res.last_logits).all())

"""Qwen2-VL's backbone in the port (M-RoPE, ROADMAP.md A.10) against the
JAX package's.

Both packages run qwen2-vl-72b's smoke config (2 layers, 4 heads of 64,
M-RoPE sections (16, 8, 8), block 64) from the same parameters (the
reference's, through ``checkpoint.params_from_numpy``), at SEQ 256.  The
prefill rows are laid out as Qwen2-VL lays out an image prompt
(arXiv:2409.12191 §2.1): text at ``t = h = w = i``, then the smoke
config's 16 visual positions as a 4 × 4 grid at offset ``o`` (``t = o``,
``h = o + r``, ``w = o + c``) whose rows take random patch embeddings at
the token embedding's scale, then text from ``o + 4``.  The three streams
differ, so M-RoPE is not RoPE, and the rope ids end below the cache slots.

Tolerances: ``apply_mrope`` 1e-5 (float32 sin/cos of the same angles);
logits, K/V and decode logits 1e-4 (two float32 layers summed in another
order); masks, ``(indices, counts)``, decisions and the dictionary's masks
and validity exactly, its representatives 1e-6; greedy serve tokens near-
tie aware (a flip only where the reference's top-2 margin is below 1e-3).
A VLM without 3-D positions is the dense path under plain RoPE, and the
serving engine never passes positions or embeds, in the reference as here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import profile as jprofile
from repro.core import share_attention as jsa
from repro.kernels import indices as jind
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.serving import decode_plan as jdplan
from repro_torch.core import profile
from repro_torch.core import share_attention as sa
from repro_torch.core.pattern_dict import PivotalState
from repro_torch.kernels import indices as tind
from repro_torch.models import attention, common, transformer
from repro_torch.serving import ServingEngine
from repro_torch.serving import decode_plan as dplan

from torch_serving_helpers import (JRequest, MarginRecorder, Request,
                                   assert_greedy_agree, make_pair,
                                   one_torch_thread, page_leak_audit,
                                   port_engine, ref_engine, requests)

torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "qwen2-vl-72b"
SEQ, BS = 256, 64
PLENS = np.array([256, 230])
OFFSETS = (64, 100)             # each row's image offset o
T = lambda a: torch.from_numpy(np.array(a))


def image_layout(cfg, seq: int, offsets):
    """(positions (3, B, S) int64, visual (B, S) bool) of rows laid out as
    text, a square grid of ``num_visual_tokens`` at each offset, text."""
    g = int(round(cfg.vlm.num_visual_tokens ** 0.5))
    pos = np.zeros((3, len(offsets), seq), np.int64)
    vis = np.zeros((len(offsets), seq), bool)
    for b, o in enumerate(offsets):
        pos[:, b, :o] = np.arange(o)
        r, c = np.divmod(np.arange(g * g), g)
        pos[0, b, o:o + g * g] = o
        pos[1, b, o:o + g * g] = o + r
        pos[2, b, o:o + g * g] = o + c
        pos[:, b, o + g * g:] = o + g + np.arange(seq - o - g * g)
        vis[b, o:o + g * g] = True
    return pos, vis


@pytest.fixture(scope="module")
def pair():
    p = make_pair(ARCH)
    cfg = p["cfg"]
    assert cfg.vlm.enabled and cfg.vlm.mrope_sections == (16, 8, 8)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, SEQ))
    pos, vis = image_layout(cfg, SEQ, OFFSETS)
    emb = np.asarray(p["jp"]["embed"])[toks]
    patches = (rng.standard_normal(emb.shape) * 0.02).astype(np.float32)
    embeds = np.where(vis[..., None], patches, emb).astype(np.float32)
    jm, tm = p["jm"], p["tm"]
    jsp, tsp = jm.default_share_prefill(), tm.default_share_prefill()
    jr = jm.prefill(p["jp"], None, jsp, method="share", attn_impl="sparse",
                    prompt_lens=jnp.asarray(PLENS, jnp.int32),
                    positions=jnp.asarray(pos, jnp.int32),
                    embeds=jnp.asarray(embeds))
    tr = tm.prefill(p["tp"], None, tsp, method="share",
                    prompt_lens=T(PLENS), positions=T(pos),
                    embeds=T(embeds))
    p.update(toks=toks, pos=pos, vis=vis, embeds=embeds, jsp=jsp, tsp=tsp,
             jr=jr, tr=tr)
    return p


@pytest.mark.parametrize("sections,d", [((16, 24, 24), 128),
                                        ((16, 8, 8), 64)])
def test_apply_mrope_matches_reference(sections, d):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 40, d)).astype(np.float32)
    pos = rng.integers(0, 5000, (3, 2, 1, 40))
    ref = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                              sections)
    got = common.apply_mrope(T(x), T(pos), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_mrope_equals_rope_when_streams_equal():
    """Three equal streams give RoPE bitwise (the same float32 angles);
    distinct streams do not."""
    rng = np.random.default_rng(2)
    x = T(rng.standard_normal((2, 3, 40, 64)).astype(np.float32))
    p = T(rng.integers(0, 5000, (2, 1, 40)))
    same = common.apply_mrope(x, p[None].expand(3, -1, -1, -1), 1e6,
                              (16, 8, 8))
    assert torch.equal(same, common.apply_rope(x, p, 1e6))
    apart = torch.stack([p, p + 3, p + 7])
    assert not torch.allclose(common.apply_mrope(x, apart, 1e6, (16, 8, 8)),
                              same, atol=1e-3)
    with pytest.raises(ValueError, match="sum to"):
        common.apply_mrope(x, apart, 1e6, (16, 8, 4))


def test_rope_qk_branches_match_reference(pair):
    """2-D positions take plain RoPE, 3-D ones M-RoPE, on both sides."""
    cfg, jcfg = pair["cfg"], pair["jm"].cfg
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 4, SEQ, 64)).astype(np.float32)
    k = rng.standard_normal((2, 4, SEQ, 64)).astype(np.float32)
    pos3 = pair["pos"]
    pos2 = np.broadcast_to(np.arange(SEQ), (2, SEQ))
    for pos in (pos2, pos3):
        jq, jk = jattn.rope_qk(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(pos), jcfg)
        tq, tk = attention.rope_qk(T(q), T(k), T(pos), cfg)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5,
                                   rtol=0)
    tq2 = attention.rope_qk(T(q), T(k), T(pos2), cfg)[0]
    assert torch.equal(tq2, common.apply_rope(T(q), T(pos2)[:, None],
                                              cfg.rope_theta))
    assert not torch.allclose(attention.rope_qk(T(q), T(k), T(pos3), cfg)[0],
                              tq2, atol=1e-3)


def test_prefill_with_embeds_matches_reference(pair):
    """Logits and every layer's K/V of ``Model.prefill(positions=,
    embeds=)``; the layout moves them against a text-only prefill."""
    jr, tr = pair["jr"], pair["tr"]
    np.testing.assert_allclose(tr.last_logits.numpy(),
                               np.asarray(jr.last_logits), atol=1e-4, rtol=0)
    for i in range(2):
        np.testing.assert_allclose(tr.cache[i].numpy(),
                                   np.asarray(jr.cache["stack"][i]),
                                   atol=1e-4, rtol=1e-4)
    for a, b in zip(tr.stats, jr.stats):
        np.testing.assert_allclose(float(a), float(b), atol=1e-6)
    text = pair["tm"].prefill(pair["tp"], T(pair["toks"]), pair["tsp"],
                              prompt_lens=T(PLENS))
    assert not torch.allclose(text.last_logits, tr.last_logits, atol=1e-3)


def test_layer_masks_tables_decisions_and_dictionary(pair):
    """Layer by layer from the embeds under M-RoPE: each package's masks
    and decisions from its own layer input (exactly), the B.2 tables of
    the masks (exactly), and the dictionary after the prefill."""
    cfg, jcfg = pair["cfg"], pair["jm"].cfg
    jsp, tsp = pair["jsp"], pair["tsp"]
    jp, tp = pair["jp"], pair["tp"]
    jpos, tpos = jnp.asarray(pair["pos"], jnp.int32), T(pair["pos"])
    jx, tx = jnp.asarray(pair["embeds"]), T(pair["embeds"])
    jst, tst = jsp.init_state(2, SEQ), tsp.init_state(2, SEQ)
    jids, tids = jsp.layer_cluster_ids(), tsp.layer_cluster_ids()
    spc = cfg.share_prefill
    for li in range(cfg.num_layers):
        jl = jax.tree.map(lambda a: a[li], jp["stack"])
        tl = tp["layers"][li]
        h = jcommon.rmsnorm(jl["ln1"], jx, jcfg.rms_norm_eps)
        q, k, _ = jcommon.gqa_qkv(jl["attn"], h)
        q, k = jattn.rope_qk(q, k, jpos, jcfg)
        jmasks, jdec = jax.vmap(
            lambda qb, kb, st: jsa.build_share_masks(
                qb, kb, st, jids[li], jcfg.share_prefill))(q, k, jst)
        h = common.rmsnorm(tl["ln1"], tx, cfg.rms_norm_eps)
        q, k, _ = common.gqa_qkv(tl["attn"], h)
        q, k = attention.rope_qk(q, k, tpos, cfg)
        tmasks, tdec = sa.build_share_masks(q, k, tst, tids[li], spc)
        np.testing.assert_array_equal(tmasks.numpy(), np.asarray(jmasks))
        for f in ("use_shared", "use_dense", "use_vs"):
            np.testing.assert_array_equal(getattr(tdec, f).numpy(),
                                          np.asarray(getattr(jdec, f)))
        for a, b in zip(tind.compact_block_mask(tmasks),
                        jind.compact_block_mask(jmasks)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        jx, _, jst, _ = jtf.layer_prefill(
            jl, jx, jcfg, jpos, jsp, jst, jids[li], method="share",
            moe_ffn=False, attn_impl="sparse")
        tx, _, tst, _ = transformer.layer_prefill(
            tl, tx, cfg, tpos, tsp, tst, tids[li], method="share",
            attn_impl="auto")
    assert bool((tmasks.sum() < tmasks.numel()))
    for st, ref in ((tst, jst), (pair["tr"].sp_state, pair["jr"].sp_state)):
        np.testing.assert_array_equal(st.masks.numpy(), np.asarray(ref.masks))
        np.testing.assert_array_equal(st.valid.numpy(), np.asarray(ref.valid))
        np.testing.assert_allclose(st.reps.numpy(), np.asarray(ref.reps),
                                   atol=1e-6)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "plan"])
def test_decode_with_3d_positions_matches_reference(pair, sparse):
    """Three decode steps after the image prefill, rope positions ``(3, B,
    1)`` continuing each row's text ids (below the cache slots ``pos``),
    right-pad masked; with the prefill's plan on both sides (the JAX
    kernel in interpret mode)."""
    jm, tm = pair["jm"], pair["tm"]
    extra = 128
    jcache = {"prefix": [], "stack": tuple(
        jnp.pad(c, ((0, 0),) * 3 + ((0, extra), (0, 0)))
        for c in pair["jr"].cache["stack"])}
    tcache = ServingEngine.grow_cache(
        tuple(c.clone() for c in pair["tr"].cache), SEQ, extra)
    jplan = tplan = None
    if sparse:
        jst = pair["jr"].sp_state
        jplan = jdplan.build_decode_plan(pair["jsp"], jst, jm.cfg,
                                         prefill_len=SEQ,
                                         cache_len=SEQ + extra)
        tplan = dplan.build_decode_plan(
            pair["tsp"], PivotalState(T(jst.masks), T(jst.reps),
                                      T(jst.valid)), pair["cfg"],
            prefill_len=SEQ, cache_len=SEQ + extra)
    last = pair["pos"][:, :, -1:]
    tok = np.asarray(pair["jr"].last_logits).argmax(-1)[:, None]
    for t in range(3):
        rope = last + 1 + t                         # (3, B, 1)
        assert rope.max() < SEQ + t
        jl, jcache = jm.decode(pair["jp"], jnp.asarray(tok, jnp.int32),
                               jcache, jnp.int32(SEQ + t),
                               positions=jnp.asarray(rope, jnp.int32),
                               plan=jplan, decode_impl="kernel",
                               prompt_lens=jnp.asarray(PLENS),
                               prefill_len=SEQ)
        tl, tcache = tm.decode(pair["tp"], T(tok).long(), tcache, SEQ + t,
                               positions=T(rope), plan=tplan,
                               prompt_lens=T(PLENS), prefill_len=SEQ)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        tok = np.asarray(jl).argmax(-1)[:, None]
    # roping by the cache slot instead moves the logits
    nxt = dict(plan=tplan, prompt_lens=T(PLENS), prefill_len=SEQ)
    by_slot, by_rope = (
        tm.decode(pair["tp"], T(tok).long(),
                  tuple(c.clone() for c in tcache), SEQ + 3, **kw, **nxt)[0]
        for kw in ({}, {"positions": T(last + 4)}))
    assert not torch.allclose(by_slot, by_rope, atol=1e-3)


@pytest.mark.parametrize("mode", ["contiguous", "paged", "chunked"])
def test_text_scheduler_serve_matches_reference(pair, mode):
    """A text-only serve (the engine passes no positions or embeds: the
    dense path under plain RoPE) through the slot scheduler, contiguous,
    paged, and paged with chunked admission, against the reference's same
    serve; greedy tokens near-tie aware."""
    vocab = pair["cfg"].vocab_size
    kw = dict(max_batch=2, seq_buckets=(SEQ,), scheduler=True,
              decode_sparse=True)
    if mode != "contiguous":
        kw["paged"] = True
    if mode == "chunked":
        kw["prefill_chunk"] = 2 * BS
    rec = MarginRecorder()
    jr, tr = (requests(cls, vocab, (5, 3, 4), seq=SEQ)
              for cls in (JRequest, Request))
    for r in (jr[2], tr[2]):
        r.prompt = r.prompt[:200]       # right-padded in its bucket
    ref_engine(pair, **kw).serve(jr, seed=0, faults=rec)
    port_engine(pair, **kw).serve(tr, seed=0)
    assert all(r.finish_reason == "length" for r in tr)
    assert_greedy_agree(jr, tr, rec.margins)


def test_traced_prefill_on_vlm(pair):
    """``run_prefill_traced`` takes a VLM (tokens, plain RoPE): stats 1e-6
    and logits 1e-4 against the reference's trace."""
    toks = pair["toks"][:1, :128]
    jt = jprofile.run_prefill_traced(pair["jp"], pair["jm"].cfg,
                                     jnp.asarray(toks, jnp.int32),
                                     pair["jsp"])
    tt = profile.run_prefill_traced(pair["tp"], pair["cfg"], T(toks),
                                    pair["tsp"])
    np.testing.assert_allclose(tt.last_logits, jt.last_logits, atol=1e-4,
                               rtol=0)
    assert len(tt.per_layer) == pair["cfg"].num_layers
    for a, b in zip(tt.per_layer, jt.per_layer):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-6)

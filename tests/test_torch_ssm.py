"""The port's Mamba-2 family (``repro_torch.models.ssm`` and
``ssm_stack``, ROADMAP.md A.10) against the JAX package's, on the CPU.

Both packages run mamba2-370m's smoke config (2 layers, d_model 256,
d_inner 512, 16 SSD heads of 32 channels, state 16, chunk 64, conv width 4)
from the same parameters: the reference's, through the flat ``::`` npz
keys and ``checkpoint.params_from_numpy``.  Inputs come from a numpy seed;
float32, no TF32.

What is held, and how tightly:
  * ``_causal_conv`` (fresh and carried state), ``_ssd_chunked`` (and its
    invariance to the chunk size, the degenerate single chunk included),
    ``ssm_forward``'s output and both states, ``ssm_decode`` over several
    steps: within ``ATOL`` (float32 sums in another order);
  * the model's prefill last logits and cache, and a greedy decode
    continuation: within ``LOGIT_ATOL``; the port's prefill of S tokens
    then one decode equals its prefill of S + 1 within ``LOGIT_ATOL``;
  * greedy tokens through ``ServingEngine`` (near-tie aware), with
    ``scheduler=True`` and ``paged=True`` falling to the batch path, as in
    the reference; ``default_share_prefill()`` disabled;
  * ``grow_cache`` on the SSM cache: a state with no axis equal to the
    bucket passes through; at a bucket equal to the state's head count and
    state size (16) both packages grow those axes, and a serve at that
    bucket fails in both (a fact of the reference, ROADMAP.md's caveats).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro.serving import EngineConfig as JConfig
from repro.serving import ServingEngine as JEngine
from repro_torch import checkpoint
from repro_torch.models import build_model, ssm
from repro_torch.serving import ServingEngine, SlotScheduler

from torch_serving_helpers import (JRequest, Request, assert_greedy_agree,
                                   make_pair, one_torch_thread,  # noqa: F401
                                   port_engine, ref_engine, requests)

torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "mamba2-370m"
SEQ = 256
ATOL = 1e-5
LOGIT_ATOL = 1e-4
T = lambda a: torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def pair():
    return make_pair(ARCH)


def _layer(p, i=0):
    """Layer ``i``'s SSM parameters in both packages."""
    jl = jax.tree.map(lambda x: x[i], p["jp"]["stack"]["ssm"])
    return jl, p["tp"]["layers"][i]["ssm"]


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def test_leaves_carry_across_and_init_matches_shapes(pair):
    cfg = pair["cfg"]
    drawn = checkpoint.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    for got, ref in ((pair["tp"], pair["jp"]), (drawn, pair["jp"])):
        layer = got["layers"][0]
        for name, shape in ssm.ssm_leaf_shapes(cfg).items():
            node = layer["ssm"]
            for part in name.split("::"):
                node = node[part]
            leaf = ref["stack"]["ssm"]
            for part in name.split("::"):
                leaf = leaf[part]
            assert tuple(node.shape) == shape == leaf.shape[1:]
    _close(pair["tp"]["layers"][1]["ssm"]["w_in"],
           pair["jp"]["stack"]["ssm"]["w_in"][1], atol=0)
    np.testing.assert_allclose(drawn["layers"][0]["ssm"]["a_log"].numpy(),
                               np.asarray(pair["jp"]["stack"]["ssm"]
                                          ["a_log"][0]), atol=1e-6)
    assert len(drawn["layers"]) == cfg.num_layers


def test_causal_conv_matches_reference(pair):
    jl, tl = _layer(pair)
    cfg = pair["cfg"]
    c = tl["conv_w"].shape[1]
    rng = np.random.default_rng(1)
    u = rng.standard_normal((2, 37, c)).astype(np.float32)
    state = rng.standard_normal((2, cfg.ssm.conv_width - 1, c)
                                ).astype(np.float32)
    for st in (None, state):
        ref = jssm._causal_conv(jl, jnp.asarray(u),
                                None if st is None else jnp.asarray(st))
        got = ssm._causal_conv(tl, T(u), None if st is None else T(st))
        for a, b in zip(got, ref):
            _close(a, b)


def _ssd_inputs(seed=2, b=2, s=SEQ, nh=16, p=32, n=16):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, s, nh, p)).astype(np.float32)
    bb, cc = (rng.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(np.float32)
    a = -np.linspace(1.0, nh, nh).astype(np.float32)
    return xh, bb, cc, dt, a


@pytest.mark.parametrize("chunk", [16, 64, SEQ])
def test_ssd_chunked_matches_reference_at_every_chunk(chunk):
    """The same y whatever the chunk (``SEQ``: the degenerate one chunk),
    and the reference's at that chunk: within 2e-5 of max |y| (|y| reaches
    ~115 on these unit-normal inputs; another chunk sums the same terms in
    another order, and the reference's own chunks differ by 1e-5 of it)."""
    args = _ssd_inputs()
    got = ssm._ssd_chunked(*map(T, args), chunk)
    for ref_chunk in (64, chunk):
        ref = np.asarray(jssm._ssd_chunked(*map(jnp.asarray, args),
                                           ref_chunk))
        _close(got, ref, atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("s", [SEQ, 100])
def test_ssm_forward_output_and_states_match_reference(pair, s):
    """At 256 tokens (four chunks) and at 100 (not a multiple of the
    chunk: one chunk of 100)."""
    jl, tl = _layer(pair, 1)
    cfg = pair["cfg"]
    x = np.random.default_rng(3).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    ref_y, ref_st = jssm.ssm_forward(jl, jnp.asarray(x), cfg)
    got_y, got_st = ssm.ssm_forward(tl, T(x), cfg)
    _close(got_y, ref_y, atol=1e-4)
    for a, b in zip(got_st, ref_st):
        _close(a, b)
    assert got_st[1].dtype == torch.float32


def test_ssm_decode_steps_match_reference(pair):
    jl, tl = _layer(pair)
    cfg = pair["cfg"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    _, jst = jssm.ssm_forward(jl, jnp.asarray(x), cfg)
    _, tst = ssm.ssm_forward(tl, T(x), cfg)
    for _ in range(4):
        step = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        ry, jst = jssm.ssm_decode(jl, jnp.asarray(step), cfg, *jst)
        gy, tst = ssm.ssm_decode(tl, T(step), cfg, *tst)
        _close(gy, ry, atol=1e-4)
        for a, b in zip(tst, jst):
            _close(a, b)


def _tokens(p, s=SEQ, seed=5):
    return np.random.default_rng(seed).integers(
        0, p["cfg"].vocab_size, (2, s)).astype(np.int32)


def test_model_prefill_and_decode_match_reference(pair):
    jm, tm = pair["jm"], pair["tm"]
    toks = _tokens(pair)
    jr = jm.prefill(pair["jp"], jnp.asarray(toks), jm.default_share_prefill())
    tr = tm.prefill(pair["tp"], T(toks).long(), tm.default_share_prefill())
    _close(tr.last_logits, jr.last_logits, atol=LOGIT_ATOL)
    assert tr.sp_state is None and float(tr.stats.block_density) == 1.0
    for a, b in zip(tr.cache["stack"], jr.cache["stack"]):
        _close(a, b)
    assert tr.cache["prefix"] == []
    jc, tc = jr.cache, tr.cache
    tok = np.argmax(np.asarray(jr.last_logits), -1)[:, None].astype(np.int32)
    for t in range(4):
        jl, jc = jm.decode(pair["jp"], jnp.asarray(tok), jc,
                           jnp.int32(SEQ + t))
        tl, tc = tm.decode(pair["tp"], T(tok).long(), tc, SEQ + t)
        _close(tl, jl, atol=LOGIT_ATOL)
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)


def test_prefill_then_decode_continues_the_recurrence(pair):
    """Prefill of S tokens and one decode step give the logits of a
    prefill of S + 1 (which takes the degenerate single chunk)."""
    tm = pair["tm"]
    toks = T(_tokens(pair, SEQ + 1)).long()
    sp = tm.default_share_prefill()
    head = tm.prefill(pair["tp"], toks[:, :SEQ], sp)
    step, _ = tm.decode(pair["tp"], toks[:, SEQ:], head.cache, SEQ)
    whole = tm.prefill(pair["tp"], toks, sp)
    np.testing.assert_allclose(step.numpy(), whole.last_logits.numpy(),
                               atol=LOGIT_ATOL, rtol=0)


def test_init_cache_and_plain_signatures(pair):
    tm, cfg = pair["tm"], pair["cfg"]
    cache = tm.init_cache(3, 1000)
    ref = pair["jm"].init_cache(3, 1000)
    for a, b in zip(cache["stack"], ref["stack"]):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == str(b.dtype)
    assert not tm.prefill_chunk and not tm.transformer_family
    tok = torch.zeros((3, 1), dtype=torch.long)
    with pytest.raises(TypeError, match="prompt_lens"):
        tm.prefill(pair["tp"], tok, tm.default_share_prefill(),
                   prompt_lens=torch.ones(3))
    with pytest.raises(TypeError, match="plan"):
        tm.decode(pair["tp"], tok, cache, 0, plan=object())
    assert cfg.num_heads == 0


def test_default_share_prefill_is_disabled(pair):
    sp, ref = (m.default_share_prefill() for m in (pair["tm"], pair["jm"]))
    assert not sp.cfg.enabled and not ref.cfg.enabled
    assert not pair["cfg"].has_attention
    # the has_attention gate holds even where the config's own flag is on
    on = dataclasses.replace(
        pair["cfg"], share_prefill=dataclasses.replace(
            pair["cfg"].share_prefill, enabled=True))
    model = build_model(on, device="cpu")
    assert not model.default_share_prefill().cfg.enabled


def _ref_batch_margins(p, reqs, seq):
    """The reference's batch path replayed on its own tokens: every row's
    top-2 logit margin by (uid, generated-token index)."""
    jm = p["jm"]
    toks = np.zeros((len(reqs), seq), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :len(r.prompt)] = r.prompt
    res = jm.prefill(p["jp"], jnp.asarray(toks), jm.default_share_prefill())
    cache = JEngine.grow_cache(res.cache, seq, 128)
    logits, margins = res.last_logits, {}
    for t in range(max(len(r.output_tokens) for r in reqs)):
        rows = np.asarray(logits, np.float32)
        tok = np.zeros((len(reqs), 1), np.int32)
        for i, r in enumerate(reqs):
            top2 = np.sort(rows[i])[-2:]
            margins[(r.uid, t)] = float(top2[1] - top2[0])
            if t < len(r.output_tokens):
                tok[i, 0] = r.output_tokens[t]
        logits, cache = jm.decode(p["jp"], jnp.asarray(tok), cache,
                                  jnp.int32(seq + t))
    return margins


@pytest.mark.parametrize("flags", [{}, {"scheduler": True}, {"paged": True}],
                         ids=["batch", "scheduler", "paged"])
def test_serve_matches_reference(pair, flags, monkeypatch):
    """Greedy tokens near-tie aware against the reference's same serve;
    the scheduler flags fall to the batch path in both packages."""
    vocab = pair["cfg"].vocab_size
    kw = dict(max_batch=2, seq_buckets=(SEQ,), decode_sparse=True, **flags)
    jr, tr = (requests(cls, vocab, (5, 3), seq=SEQ)
              for cls in (JRequest, Request))
    for r in (jr[1], tr[1]):
        r.prompt = r.prompt[:200]       # right-padded in its bucket

    def refuse(self):
        raise AssertionError("the ssm family reached the slot scheduler")
    monkeypatch.setattr(SlotScheduler, "run", refuse)
    ref_engine(pair, **kw).serve(jr, seed=0)
    eng = port_engine(pair, **kw)
    assert not eng._supports_scheduler() and eng._width_cap(SEQ) is None
    eng.serve(tr, seed=0)
    assert [r.finish_reason for r in tr] == ["length", "length"]
    assert tr[0].pattern_stats["block_density"] == 1.0
    assert "decode_traffic_fraction" not in tr[0].pattern_stats   # no plan
    assert_greedy_agree(jr, tr, _ref_batch_margins(pair, jr, SEQ))


@pytest.mark.parametrize("bucket", [SEQ, 16], ids=["plain", "colliding"])
def test_grow_cache_follows_the_reference(pair, bucket):
    """``grow_cache`` grows every non-trailing axis equal to the bucket, in
    both packages: none of the SSM state's at 256, the head and state axes
    (both 16) at a bucket of 16, after which a serve fails in both."""
    toks = _tokens(pair, bucket)
    jr = pair["jm"].prefill(pair["jp"], jnp.asarray(toks),
                            pair["jm"].default_share_prefill())
    tr = pair["tm"].prefill(pair["tp"], T(toks).long(),
                            pair["tm"].default_share_prefill())
    jg = JEngine.grow_cache(jr.cache, bucket, 128)
    tg = ServingEngine.grow_cache(tr.cache, bucket, 128)
    expect = ([], [] if bucket == SEQ else [2, 3])     # conv, ssd
    for a, b, before, axes in zip(tg["stack"], jg["stack"],
                                  tr.cache["stack"], expect):
        assert tuple(a.shape) == b.shape
        _close(a, b)
        assert [i for i, (x, y) in enumerate(zip(a.shape, before.shape))
                if x != y] == axes
    assert tg["prefix"] == [] == jg["prefix"]
    if bucket == SEQ:
        assert all(a is b for a, b in zip(tg["stack"], tr.cache["stack"]))
        return
    assert tuple(tg["stack"][1].shape[2:4]) == (16 + 128, 16 + 128)
    vocab = pair["cfg"].vocab_size
    kw = dict(max_batch=1, seq_buckets=(16,))
    jq, tq = (requests(cls, vocab, (3,), seq=16) for cls in (JRequest,
                                                             Request))
    with pytest.raises(Exception):
        JEngine(pair["jm"], pair["jp"], pair["jm"].default_share_prefill(),
                JConfig(**kw)).serve(jq, seed=0)
    with pytest.raises(RuntimeError):
        port_engine(pair, **kw).serve(tq, seed=0)

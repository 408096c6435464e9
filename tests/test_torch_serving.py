"""The port's batch-path ``ServingEngine`` against the JAX package's.

Both engines serve the same ragged batch from the same parameters
(llama3-8b-262k smoke config, 8 query heads, 2 kv heads, seq 512, block
64): the reference with ``scheduler=False``, ``attn_impl="sparse"``,
``decode_sparse=True`` and ``decode_impl="kernel"`` (its Pallas kernels
interpret on the CPU), the port on its plain versions.  Greedy tokens are
compared near-tie aware: a stream may flip only where the reference's
top-2 logit margin at that step is below ``TIE_TOL`` (float32 logits agree
to ~1e-5 here), and after a flip the streams condition on different tokens,
so the comparison stops there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten
from repro.configs import get_smoke_config as j_smoke
from repro.models.api import build_model as j_build
from repro.serving import EngineConfig as JConfig, Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving import decode_plan as jdplan
from repro.serving.sampling import SamplingConfig as JSampling
from repro.serving.sampling import sample_token as j_sample
from repro_torch import checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.serving import (EngineConfig, Request, SamplingConfig,
                                 ServingEngine)
from repro_torch.serving.sampling import sample_token

torch.backends.cuda.matmul.allow_tf32 = False

TIE_TOL = 1e-3
S = 512
PLENS = (512, 450)
NEW = 6


def _setup():
    kw = dict(num_heads=8, num_kv_heads=2)
    jcfg = dataclasses.replace(j_smoke("llama3-8b-262k"), **kw)
    tcfg = dataclasses.replace(get_smoke_config("llama3-8b-262k"), **kw)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tp = checkpoint.params_from_numpy(_flatten(jp), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in PLENS]
    return jm, jp, tm, tp, prompts


@pytest.fixture(scope="module")
def served():
    jm, jp, tm, tp, prompts = _setup()
    jeng = JEngine(jm, jp, jm.default_share_prefill(), JConfig(
        max_batch=2, method="share", attn_impl="sparse", seq_buckets=(S,),
        decode_sparse=True, decode_impl="kernel"))
    jreqs = jeng.serve([JRequest(uid=i, prompt=p, max_new_tokens=NEW)
                        for i, p in enumerate(prompts)])
    teng = ServingEngine(tm, tp, tm.default_share_prefill(), EngineConfig(
        max_batch=2, method="share", seq_buckets=(S,), decode_sparse=True))
    treqs = teng.serve([Request(uid=i, prompt=p, max_new_tokens=NEW)
                        for i, p in enumerate(prompts)])
    return dict(jm=jm, jp=jp, prompts=prompts, jreqs=jreqs, treqs=treqs)


def _reference_margins(jm, jp, prompts, tokens, upto):
    """The reference's top-2 logit margins for each row at steps 0..upto,
    teacher-forced on the reference's own tokens (prefill, grown cache and
    plan as its engine builds them)."""
    toks = np.zeros((len(prompts), S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    plens = jnp.asarray(PLENS, jnp.int32)
    sp = jm.default_share_prefill()
    res = jm.prefill(jp, jnp.asarray(toks), sp, method="share",
                     attn_impl="sparse", prompt_lens=plens)
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
                                  prefill_len=S, decode_impl="kernel")
    return np.stack(margins, axis=1)                 # (B, upto + 1)


def test_serve_greedy_tokens_match_reference(served):
    ref = [r.output_tokens for r in served["jreqs"]]
    got = [r.output_tokens for r in served["treqs"]]
    flips = [next((t for t, (a, b) in enumerate(zip(r, g)) if a != b), None)
             for r, g in zip(ref, got)]
    for r, g in zip(ref, got):
        assert len(r) == len(g) == NEW
    if all(f is None for f in flips):
        return
    upto = max(f for f in flips if f is not None)
    margins = _reference_margins(served["jm"], served["jp"],
                                 served["prompts"], ref, upto)
    for row, f in enumerate(flips):
        if f is not None:
            print(f"request {row}: flip at token {f}, reference margin "
                  f"{margins[row, f]:.3e}")
            assert margins[row, f] < TIE_TOL


def test_serve_pattern_stats_match_reference(served):
    js, ts = served["jreqs"][0].pattern_stats, served["treqs"][0].pattern_stats
    for key in ("num_shared", "num_dense", "num_vs", "max_row_pop",
                "decode_blocks_total", "decode_blocks_computed",
                "decode_blocks_skipped", "decode_cache_len",
                "prefill_width_cap"):
        assert ts[key] == js[key], key
    for key in ("block_density", "decode_traffic_fraction"):
        assert ts[key] == pytest.approx(js[key], abs=1e-6), key


def test_serve_fills_request_metrics(served):
    for r in served["treqs"]:
        assert r.state == "done" and r.finish_reason == "length"
        m = r.metrics()
        assert set(m) == {"queue_s", "ttft_s", "prefill_s", "decode_s",
                          "decode_tokens_per_s", "prefill_stall_s",
                          "waiting_deferred_steps", "preempted_count",
                          "prefix_hit", "tail_fraction",
                          "plan_traffic_fraction", "refreshes"}
        assert m["prefill_s"] > 0 and m["ttft_s"] >= m["prefill_s"]
        assert m["decode_tokens_per_s"] > 0
        assert not r.truncated


def test_stop_token_and_prefill_only_rows():
    _, _, tm, tp, prompts = _setup()
    eng = ServingEngine(tm, tp, tm.default_share_prefill(),
                        EngineConfig(max_batch=3, seq_buckets=(S,),
                                     decode_sparse=True))
    free = eng.serve([Request(uid=0, prompt=prompts[0], max_new_tokens=4)])
    free_toks = free[0].output_tokens.tolist()
    stop = free_toks[-1]
    expect = free_toks[:free_toks.index(stop) + 1]
    reqs = eng.serve([
        Request(uid=0, prompt=prompts[0], max_new_tokens=4,
                sampling=SamplingConfig(stop_tokens=(stop,))),
        Request(uid=1, prompt=prompts[1], max_new_tokens=0),
        Request(uid=2, prompt=np.concatenate([prompts[0], prompts[1]]),
                max_new_tokens=2)])
    assert reqs[0].finish_reason == "stop"
    assert reqs[0].output_tokens.tolist() == expect
    assert len(reqs[1].output_tokens) == 0 and reqs[1].ttft_s == 0.0
    assert reqs[2].truncated and len(reqs[2].output_tokens) == 2


# each case keeps its id from when every option raised; every option is
# now taken and served (paged, sparse decode), prefix sharing since A.9's
# last slice
@pytest.mark.parametrize("field,value", [
    ("preempt_after_steps", 4), ("refresh_mass", 0.5),
    ("width_percentile", 50.0), ("prefix_sharing", True),
    ("refresh_every", 64), ("width_policy", "auto")],
    ids=["preempt_after_steps-4-A.9", "refresh_mass-0.5-A.9",
         "width_percentile-50.0-A.5", "prefix_sharing-True-A.9",
         "refresh_every-64-A.9", "width_policy-auto-A.5"])
def test_unported_engine_options_raise(field, value):
    cfg = dataclasses.replace(get_smoke_config("llama3-8b-262k"),
                              num_heads=8, num_kv_heads=2)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    ecfg = EngineConfig(**{field: value}, max_batch=2, paged=True,
                        decode_sparse=True, seq_buckets=(128,))
    assert getattr(ecfg, field) == value
    eng = ServingEngine(model, params, model.default_share_prefill(), ecfg)
    reqs = [Request(uid=i, prompt=np.arange(1, n + 1) % cfg.vocab_size,
                    max_new_tokens=3) for i, n in enumerate((128, 100))]
    eng.serve(reqs, seed=0)
    assert all(r.finish_reason == "length" and len(r.output_tokens) == 3
               for r in reqs)


@pytest.mark.parametrize("field,value", [("prefill_chunk", 128),
                                         ("prefill_pack", 2)])
def test_chunked_prefill_options_are_ported(field, value):
    assert getattr(EngineConfig(**{field: value}), field) == value


def test_bucket_and_grow_cache():
    _, _, tm, tp, _ = _setup()
    eng = ServingEngine(tm, tp, tm.default_share_prefill(),
                        EngineConfig(seq_buckets=(128, 512)))
    assert [eng._bucket(n) for n in (1, 128, 129, 600)] == [128, 128, 512,
                                                            512]
    k = torch.randn(2, 1, 2, 4, 8)
    gk, gv = ServingEngine.grow_cache((k, k + 1), 4, 4)
    assert gk.shape == (2, 1, 2, 8, 8) and torch.equal(gk[..., :4, :], k)
    assert not gk[..., 4:, :].any() and torch.equal(gv[..., :4, :], k + 1)


# ---------------------------------------------------------------- sampling

def test_greedy_sampling_matches_reference_with_ties():
    logits = np.array([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0]],
                      np.float32)
    ref = np.asarray(j_sample(jax.random.PRNGKey(0), jnp.asarray(logits),
                              JSampling()))
    got = sample_token(torch.from_numpy(logits), SamplingConfig(),
                       torch.Generator().manual_seed(0))
    assert got.tolist() == ref.tolist() == [1, 0]


@pytest.mark.parametrize("cfg", [
    SamplingConfig(temperature=0.7, top_k=1),
    SamplingConfig(temperature=1.0, top_p=1e-6)])
def test_truncated_sampling_keeps_the_argmax(cfg):
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(1))
    got = sample_token(logits, cfg, torch.Generator().manual_seed(2))
    assert torch.equal(got, logits.argmax(-1))


def test_temperature_sampling_follows_its_generator():
    logits = torch.randn(3, 40, generator=torch.Generator().manual_seed(3))
    cfg = SamplingConfig(temperature=1.0, top_k=10, top_p=0.9)
    draw = lambda s: sample_token(logits, cfg,
                                  torch.Generator().manual_seed(s))
    assert torch.equal(draw(5), draw(5))
    top10 = logits.topk(10, dim=-1).indices
    assert all(int(t) in top10[i].tolist() for i, t in enumerate(draw(6)))

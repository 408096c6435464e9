"""The port's profiling pass (``repro_torch.core.profile``) against the JAX
package's, on the CPU.

Both packages run granite-3-2b's smoke config from the same parameters
(the reference's, through ``checkpoint.params_from_numpy``), one prompt of
256 tokens from a numpy seed, block 64, float32.  Attention is dense
chunked attention under the masks in both (no Pallas kernel).

What is held, and how tightly:
  * ``capture_block_attention_maps``: shape ``(L, H, NB, NB)`` and values
    within 1e-5 (block means of float32 logits summed in another order);
  * ``run_prefill_traced`` for the four methods: every layer's masks
    **exactly**, per-layer stats within 1e-6, last and full logits within
    1e-4 (two float32 layers), q/k/v within 1e-4; at γ = 0.9 and, so that
    the baselines' masks are sparse, at γ = 0.3;
  * the port's ``share`` trace against its own ``Model.prefill``, as the
    reference's ``test_traced_prefill_matches_jitted`` holds its trace;
  * MLA and prefix-layer configs raise ``NotImplementedError``: their
    layers are not captured, as the reference's trace cannot capture them;
    a MoE config is traced (``test_torch_mixtral.py`` holds the MoE trace
    against the reference's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten
from repro.configs import get_smoke_config as j_smoke
from repro.core import profile as jprof
from repro.models.api import build_model as j_build
from repro_torch import checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.core import profile
from repro_torch.models import build_model

torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "granite-3-2b"
SEQ = 256
METHODS = ("share", "dense", "vertical_slash", "flex")
T = lambda a: torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = j_smoke(ARCH), get_smoke_config(ARCH)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tp = checkpoint.params_from_numpy(_flatten(jp), tcfg, device="cpu")
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (1, SEQ)).astype(np.int32)
    return dict(jm=jm, jp=jp, jcfg=jcfg, tm=tm, tp=tp, cfg=tcfg, toks=toks)


def test_block_attention_maps_match_reference(pair):
    ref = jprof.capture_block_attention_maps(pair["jp"], pair["jcfg"],
                                             jnp.asarray(pair["toks"]))
    got = profile.capture_block_attention_maps(pair["tp"], pair["cfg"],
                                               T(pair["toks"]).long())
    cfg = pair["cfg"]
    assert got.shape == (cfg.num_layers, cfg.num_heads, SEQ // 64, SEQ // 64)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    assert (np.triu(got, 1) == 0).all()


def _with_gamma(sp, gamma):
    return dataclasses.replace(sp, cfg=dataclasses.replace(sp.cfg,
                                                           gamma=gamma))


@pytest.mark.parametrize("gamma", [0.9, 0.3])
@pytest.mark.parametrize("method", METHODS)
def test_traced_prefill_matches_reference(pair, method, gamma):
    kw = dict(method=method, want_full_logits=True, want_masks=True,
              want_qkv=True)
    ref = jprof.run_prefill_traced(
        pair["jp"], pair["jcfg"], jnp.asarray(pair["toks"]),
        _with_gamma(pair["jm"].default_share_prefill(), gamma), **kw)
    got = profile.run_prefill_traced(
        pair["tp"], pair["cfg"], T(pair["toks"]).long(),
        _with_gamma(pair["tm"].default_share_prefill(), gamma), **kw)
    assert len(got.masks) == len(got.per_layer) == pair["cfg"].num_layers
    for a, r in zip(got.masks, ref.masks):
        assert a.dtype == bool
        np.testing.assert_array_equal(a, np.asarray(r))
    for a, r in zip(got.per_layer, ref.per_layer):
        assert a.keys() == r.keys()
        for key in a:
            np.testing.assert_allclose(a[key], r[key], atol=1e-6,
                                       err_msg=key)
    np.testing.assert_allclose(got.last_logits, ref.last_logits, atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got.full_logits, ref.full_logits, atol=1e-4,
                               rtol=0)
    for a, r in zip(got.qkv, ref.qkv):
        for x, y in zip(a, r):
            np.testing.assert_allclose(x, np.asarray(y), atol=1e-4, rtol=0)
    if method != "share":
        assert all(r["num_vs"] == pair["cfg"].num_heads
                   for r in got.per_layer)
    if method == "flex" and gamma < 0.9:
        assert max(r["block_density"] for r in got.per_layer) < 1.0


def test_share_trace_matches_model_prefill(pair):
    """The share trace's last logits equal the port's own one-shot prefill
    (the same masks and dictionary, dense-under-masks attention against
    the block-sparse kernel's plain version)."""
    sp = pair["tm"].default_share_prefill()
    trace = profile.run_prefill_traced(pair["tp"], pair["cfg"],
                                       T(pair["toks"]).long(), sp)
    res = pair["tm"].prefill(pair["tp"], T(pair["toks"]).long(), sp,
                             method="share", attn_impl="sparse")
    np.testing.assert_allclose(trace.last_logits, res.last_logits.numpy(),
                               atol=1e-4, rtol=0)
    assert trace.full_logits is None and trace.masks == [] \
        and trace.qkv == []
    stats = res.stats
    np.testing.assert_allclose(
        np.mean([r["block_density"] for r in trace.per_layer]),
        float(stats.block_density), atol=1e-6)


@pytest.mark.parametrize("what", ["moe", "prefix", "batch", "method",
                                  "hybrid", "encdec"])
def test_unported_inputs_raise(pair, what):
    cfg, toks = pair["cfg"], T(pair["toks"]).long()
    sp = pair["tm"].default_share_prefill()
    moe = dataclasses.replace(cfg.moe, num_experts=4, top_k=2)
    mla = dataclasses.replace(cfg.mla, kv_lora_rank=16)
    if what == "moe":               # served since the Mixtral slice
        cfg = dataclasses.replace(cfg, family="moe", moe=moe)
        params = checkpoint.init_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
        trace = profile.run_prefill_traced(params, cfg, toks, sp)
        assert np.isfinite(trace.last_logits).all()
        assert len(trace.per_layer) == cfg.num_layers
        cfg = dataclasses.replace(cfg, mla=mla)      # MLA alone: refused
    elif what == "prefix":          # DeepSeek-V2's dense first layer
        cfg = dataclasses.replace(cfg, moe=moe, mla=mla)
    if what in ("moe", "prefix"):
        for fn in (lambda: profile.capture_block_attention_maps(
                       pair["tp"], cfg, toks),
                   lambda: profile.run_prefill_traced(pair["tp"], cfg, toks,
                                                      sp)):
            with pytest.raises(NotImplementedError, match="not captured"):
                fn()
    elif what in ("hybrid", "encdec"):  # no stack of GQA layers: refused
        arch = {"hybrid": "recurrentgemma-9b", "encdec": "whisper-base"}
        other = get_smoke_config(arch[what])
        params = checkpoint.init_params(
            other, torch.Generator().manual_seed(0), device="cpu")
        for fn in (lambda: profile.capture_block_attention_maps(
                       params, other, toks),
                   lambda: profile.run_prefill_traced(params, other, toks,
                                                      sp)):
            with pytest.raises(NotImplementedError,
                               match=r"params\['stack'\]\[l\]\['attn'\]"):
                fn()
    elif what == "batch":
        with pytest.raises(ValueError, match="single sample"):
            profile.run_prefill_traced(pair["tp"], cfg, toks.repeat(2, 1),
                                       sp)
    else:
        with pytest.raises(ValueError, match="unknown prefill method"):
            profile.run_prefill_traced(pair["tp"], cfg, toks, sp,
                                       method="minference")

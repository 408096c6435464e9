"""The port's dense decoder and decode plan against the JAX package's.

The test model is llama3-8b-262k's smoke config with 8 query heads and 2
kv heads (G = 4), seq 512, block 64.  Parameters come from the JAX init and
cross through ``params_from_numpy``.  Float32, no TF32.  Tolerances:
logits 1e-4 and K/V 1e-4 + 1e-4·|x| (two layers of float32 products summed
in another order), decode logits 1e-4; masks, dictionary validity and DecodePlan
tables exactly, dictionary representatives 1e-6.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten, save
from repro.configs import get_smoke_config as j_smoke
from repro.core.pattern_dict import PivotalState as JState
from repro.models import common as jcommon
from repro.models.api import build_model as j_build
from repro.serving import decode_plan as jdplan
from repro.serving.sparse_decode import decode_keep_blocks as j_keep
from repro_torch import checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.core.pattern_dict import PivotalState
from repro_torch.models import build_model, common
from repro_torch.serving import decode_plan as dplan
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.sparse_decode import decode_keep_blocks

torch.backends.cuda.matmul.allow_tf32 = False

T = lambda a: torch.from_numpy(np.array(a))
S = 512
PLENS = np.array([512, 450], np.int32)


def _cfgs():
    kw = dict(num_heads=8, num_kv_heads=2)
    return (dataclasses.replace(j_smoke("llama3-8b-262k"), **kw),
            dataclasses.replace(get_smoke_config("llama3-8b-262k"), **kw))


@pytest.fixture(scope="module")
def pair():
    """Both models, the shared parameters and one ragged prefill each."""
    jcfg, tcfg = _cfgs()
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tp = checkpoint.params_from_numpy(_flatten(jp), tcfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, S))
    jsp, tsp = jm.default_share_prefill(), tm.default_share_prefill()
    jr = jm.prefill(jp, jnp.asarray(toks, jnp.int32), jsp, method="share",
                    attn_impl="sparse", prompt_lens=jnp.asarray(PLENS))
    tr = tm.prefill(tp, T(toks), tsp, method="share",
                    prompt_lens=T(PLENS).long())
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, toks=toks, jsp=jsp, tsp=tsp,
                jr=jr, tr=tr)


def test_prefill_logits_and_cache(pair):
    jr, tr = pair["jr"], pair["tr"]
    np.testing.assert_allclose(tr.last_logits.numpy(),
                               np.asarray(jr.last_logits), atol=1e-4, rtol=0)
    for i in range(2):
        np.testing.assert_allclose(tr.cache[i].numpy(),
                                   np.asarray(jr.cache["stack"][i]),
                                   atol=1e-4, rtol=1e-4)


def test_prefill_final_share_state(pair):
    jst, tst = pair["jr"].sp_state, pair["tr"].sp_state
    np.testing.assert_array_equal(tst.masks.numpy(), np.asarray(jst.masks))
    np.testing.assert_array_equal(tst.valid.numpy(), np.asarray(jst.valid))
    np.testing.assert_allclose(tst.reps.numpy(), np.asarray(jst.reps),
                               atol=1e-6)
    for a, b in zip(pair["tr"].stats, pair["jr"].stats):
        np.testing.assert_allclose(float(a), float(b), atol=1e-6)
    assert 0.0 < float(pair["tr"].stats.block_density) < 1.0


@pytest.mark.parametrize("seq", [512, 500])
def test_dense_prefill_matches(pair, seq):
    """``method="dense"``, and a length that sharing does not apply to
    (not a block multiple), attend densely on both sides."""
    toks = pair["toks"][:, :seq]
    method = "dense" if seq == 512 else "share"
    jr = pair["jm"].prefill(pair["jp"], jnp.asarray(toks, jnp.int32),
                            pair["jsp"], method=method, attn_impl="sparse")
    tr = pair["tm"].prefill(pair["tp"], T(toks), pair["tsp"], method=method)
    np.testing.assert_allclose(tr.last_logits.numpy(),
                               np.asarray(jr.last_logits), atol=1e-4, rtol=0)
    assert float(tr.stats.block_density) == 1.0


def test_decode_plan_tables_exact(pair):
    """The same post-prefill dictionary (the reference's, through numpy)
    gives the same tables, with and without a width cap."""
    jst = pair["jr"].sp_state
    tst = PivotalState(T(jst.masks), T(jst.reps), T(jst.valid))
    jcfg, tcfg = _cfgs()
    np.testing.assert_array_equal(
        decode_keep_blocks(pair["tsp"], tst, tcfg.num_layers,
                           tcfg.num_heads).numpy(),
        np.asarray(j_keep(pair["jsp"], jst, jcfg.num_layers,
                          jcfg.num_heads)))
    for width in (None, 3):
        jplan = jdplan.build_decode_plan(pair["jsp"], jst, jcfg,
                                         prefill_len=S, cache_len=S + 128,
                                         width=width)
        tplan = dplan.build_decode_plan(pair["tsp"], tst, tcfg,
                                        prefill_len=S, cache_len=S + 128,
                                        width=width)
        for f in ("indices", "counts", "keep_heads"):
            np.testing.assert_array_equal(getattr(tplan, f).numpy(),
                                          np.asarray(getattr(jplan, f)), f)
        assert dplan.plan_traffic_fraction(tplan) == pytest.approx(
            jdplan.plan_traffic_fraction(jplan))
        assert dplan.plan_block_counts(tplan) == tuple(
            int(x) for x in jdplan.plan_block_counts(jplan))
    with pytest.raises(ValueError, match="multiples"):
        dplan.build_decode_plan(pair["tsp"], tst, tcfg, prefill_len=S,
                                cache_len=S + 1)


@pytest.mark.parametrize("sparse", [False, True])
def test_decode_steps_match(pair, sparse):
    """Three decode steps on the grown cache, right-pad slots masked; with
    the plan on both sides (the JAX kernel in interpret mode)."""
    jm, tm = pair["jm"], pair["tm"]
    extra = 128
    jcache = {"prefix": [], "stack": tuple(
        jnp.pad(c, ((0, 0),) * 3 + ((0, extra), (0, 0)))
        for c in pair["jr"].cache["stack"])}
    tcache = ServingEngine.grow_cache(
        tuple(c.clone() for c in pair["tr"].cache), S, extra)
    jplan = tplan = None
    if sparse:
        jcfg, tcfg = _cfgs()
        jst = pair["jr"].sp_state
        jplan = jdplan.build_decode_plan(pair["jsp"], jst, jcfg,
                                         prefill_len=S, cache_len=S + extra)
        tplan = dplan.build_decode_plan(
            pair["tsp"], PivotalState(T(jst.masks), T(jst.reps),
                                      T(jst.valid)), tcfg,
            prefill_len=S, cache_len=S + extra)
    tok = np.asarray(pair["jr"].last_logits).argmax(-1)[:, None]
    for t in range(3):
        jl, jcache = jm.decode(pair["jp"], jnp.asarray(tok, jnp.int32),
                               jcache, jnp.int32(S + t), plan=jplan,
                               prompt_lens=jnp.asarray(PLENS),
                               prefill_len=S, decode_impl="kernel")
        tl, tcache = tm.decode(pair["tp"], T(tok).long(), tcache, S + t,
                               plan=tplan, prompt_lens=T(PLENS).long(),
                               prefill_len=S)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        tok = np.asarray(jl).argmax(-1)[:, None]
    np.testing.assert_allclose(tcache[0].numpy(),
                               np.asarray(jcache["stack"][0]), atol=1e-4,
                               rtol=1e-4)


def test_decode_valid_mask_hides_right_pad():
    from repro_torch.models.transformer import decode_valid_mask
    v = decode_valid_mask(8, 6, torch.tensor([5, 3]), 5)
    assert v.tolist() == [[True] * 5 + [True, True, False],
                          [True] * 3 + [False, False, True, True, False]]


# ------------------------------------------------------------ building blocks

def test_rope_float32_at_long_context_theta():
    """rope_theta 2.8e8 at positions near 8k: angles in float32, half-split."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 2, 4, 128)).astype(np.float32)
    pos = np.array([[0, 1, 4097, 8191]])[:, None, :]
    ref = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 283461213.0)
    got = common.apply_rope(T(x), T(pos), 283461213.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    bf = common.apply_rope(T(x).bfloat16(), T(pos), 283461213.0)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(bf.float().numpy(), np.asarray(ref),
                               atol=5e-2)


def test_rmsnorm_mlp_and_projections(pair):
    rng = np.random.default_rng(2)
    layer_j = jax.tree.map(lambda a: a[0], pair["jp"]["stack"])
    layer_t = pair["tp"]["layers"][0]
    x = rng.standard_normal((2, 5, 256)).astype(np.float32)
    np.testing.assert_allclose(
        common.rmsnorm(layer_t["ln1"], T(x)).numpy(),
        np.asarray(jcommon.rmsnorm(layer_j["ln1"], jnp.asarray(x))),
        atol=1e-5)
    np.testing.assert_allclose(
        common.mlp(layer_t["ffn"], T(x)).numpy(),
        np.asarray(jcommon.mlp(layer_j["ffn"], jnp.asarray(x))), atol=1e-5)
    for a, b in zip(common.gqa_qkv(layer_t["attn"], T(x)),
                    jcommon.gqa_qkv(layer_j["attn"], jnp.asarray(x))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


# ----------------------------------------------------------------- weights

def test_load_npz_reads_reference_checkpoint(pair, tmp_path):
    path = save(os.path.join(tmp_path, "params.npz"), pair["jp"])
    flat = checkpoint.load_npz(path)
    assert set(flat) == set(_flatten(pair["jp"]))
    _, tcfg = _cfgs()
    params = checkpoint.params_from_numpy(flat, tcfg, device="cpu")
    assert torch.equal(params["layers"][1]["attn"]["wk"],
                       pair["tp"]["layers"][1]["attn"]["wk"])
    assert checkpoint.num_params(params) == sum(
        a.size for a in _flatten(pair["jp"]).values())


def test_params_from_numpy_checks_shapes(pair):
    flat = dict(_flatten(pair["jp"]))
    flat["stack::attn::wq"] = flat["stack::attn::wq"][:, :, :4]
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="stack::attn::wq"):
        checkpoint.params_from_numpy(flat, tcfg, device="cpu")


def test_init_params_distributions():
    _, tcfg = _cfgs()
    p = checkpoint.init_params(tcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    q = checkpoint.init_params(tcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    wq = p["layers"][0]["attn"]["wq"]
    assert wq.shape == (256, 8, 64) and torch.equal(wq, q["layers"][0]
                                                    ["attn"]["wq"])
    bound = 2.0 / 256 ** 0.5                     # truncation at ±2σ
    assert wq.abs().max() <= bound + 1e-6
    assert abs(float(wq.std()) * 16.0 - 0.88) < 0.05   # trunc-normal σ≈0.88
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    assert torch.equal(p["layers"][1]["ln2"]["scale"], torch.ones(256))
    assert p["lm_head"].shape == (256, tcfg.vocab_size)


def test_init_cache_and_dtype():
    _, tcfg = _cfgs()
    m = build_model(tcfg, dtype=torch.bfloat16, device="cpu")
    k, v = m.init_cache(2, 128)
    assert k.shape == (2, 2, 2, 128, 64) and k.dtype == torch.bfloat16
    assert not k.any() and not v.any()

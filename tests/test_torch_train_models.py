"""The port's train paths (``Model.train_logits`` and each family's
``forward_train``) against the JAX package's, on the CPU.

Both packages run each config's smoke size at sequence 64, batch 2, from
the same parameters: the reference's init, carried across as the
reference's tree of stacked leaves (the training state's layout).
Float32, no TF32.

What is held, and how tightly:
  * ``train_logits``' logits within ``LOGIT_ATOL`` and its aux losses
    within ``AUX_ATOL`` of the reference's, for all twelve configs;
  * every gradient leaf of ``total_loss``, keyed by the reference's ``::``
    names, within ``GRAD_RTOL`` of that leaf's max |g| plus ``GRAD_ATOL``
    (float32 sums of many terms: the floor holds a leaf whose gradient is
    itself small, as Mamba-2's ``a_log``, ≈ 2.5e-4) against
    ``jax.value_and_grad``, and the loss within ``AUX_ATOL``, for each
    family: dense, vlm (3-D positions), moe (Mixtral with its window cut
    to 32 < 64, so it bites), MLA (DeepSeek-V2, with its dense prefix
    layer), ssm, hybrid (a local window of 32 < 64) and encdec (zero
    encoder frames); no gradient is NaN;
  * the MoE routing inside the training forward **exactly**, wherever the
    k-th and (k+1)-th router probabilities are more than ``TIE`` apart;
  * ``maybe_remat``'s ``full`` and ``dots`` against ``none``: equal loss,
    and gradients within 1e-6 of the leaf's max;
  * no NaN from a fully masked query row in the chunked attention's
    backward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten
from repro.configs import REGISTRY as J_REGISTRY
from repro.configs import get_smoke_config as j_smoke
from repro.models import attention as jattn
from repro.models import build_model as j_build
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.training import losses as jlosses
from repro_torch import checkpoint
from repro_torch import tree as tu
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.chunked import chunked_attention
from repro_torch.launch.train import extra_kwargs_fn
from repro_torch.models import attention, build_model, common, moe
from repro_torch.training import losses

from torch_serving_helpers import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False

SEQ, BATCH = 64, 2
LOGIT_ATOL = 1e-4
AUX_ATOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-7
TIE = 1e-5
WINDOW = 32             # < SEQ: the sliding / local window bites


def _cut_window(arch):
    if arch == "mixtral-8x22b":
        return lambda c: dataclasses.replace(c, sliding_window=WINDOW)
    if arch == "recurrentgemma-9b":
        return lambda c: dataclasses.replace(c, rglru=dataclasses.replace(
            c.rglru, local_attn_window=WINDOW))
    return lambda c: c


# one config per family, the windows cut to bite
GRAD_ARCHS = {"dense": "granite-3-2b", "vlm": "qwen2-vl-72b",
              "moe": "mixtral-8x22b", "mla": "deepseek-v2-236b",
              "ssm": "mamba2-370m", "hybrid": "recurrentgemma-9b",
              "encdec": "whisper-base"}
_CASES = {}


def _case(arch, grads: bool):
    """Both packages' model, the reference's tree in both, a batch and its
    extra inputs, and the reference's loss, logits, aux (and gradients;
    always for a family's config whose window is not cut, so that one
    reference run serves both tests)."""
    grads = grads or (arch in GRAD_ARCHS.values()
                      and arch not in ("mixtral-8x22b", "recurrentgemma-9b"))
    key = (arch, grads)
    if key in _CASES:
        return _CASES[key]
    cut = _cut_window(arch) if grads else (lambda c: c)
    jcfg, cfg = cut(j_smoke(arch)), cut(get_smoke_config(arch))
    jm, tm = j_build(jcfg), build_model(cfg, device="cpu")
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tree = tu.unflatten({k: torch.from_numpy(np.array(v))
                         for k, v in _flatten(jp).items()})
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    extra = extra_kwargs_fn(cfg)
    kw = extra(batch) if extra else {}
    jkw = {k: jnp.asarray(v.numpy()) for k, v in kw.items()}

    def jloss(p):
        logits, aux = jm.train_logits(p, jnp.asarray(toks[:, :-1]), **jkw)
        loss, _ = jlosses.total_loss(logits, jnp.asarray(toks[:, 1:]), aux)
        return loss, (logits, aux)
    if grads:
        (loss, (logits, aux)), g = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(jp)
        g = {k: np.asarray(v) for k, v in _flatten(g).items()}
    else:
        loss, (logits, aux), g = *jax.jit(jloss)(jp), None
    _CASES[key] = dict(cfg=cfg, jcfg=jcfg, jp=jp, tm=tm, tree=tree,
                       batch=batch, kw=kw, loss=float(loss),
                       logits=np.asarray(logits),
                       aux={k: float(v) for k, v in aux.items()}, grads=g)
    return _CASES[key]


def _port_loss(c, tree, remat=None):
    tm = c["tm"]
    if remat is not None:
        tm = build_model(dataclasses.replace(c["cfg"], remat_policy=remat),
                         device="cpu")
    logits, aux = tm.train_logits(tree, c["batch"]["tokens"], **c["kw"])
    loss, _ = losses.total_loss(logits, c["batch"]["labels"], aux)
    return loss, logits, aux


def _grads(c, remat=None):
    work = tu.tree_map(lambda p: p.clone().requires_grad_(), c["tree"])
    loss, _, _ = _port_loss(c, work, remat)
    loss.backward()
    return float(loss), {k: w.grad for k, w in tu.flatten_with_path(work)}


@pytest.mark.parametrize("arch", sorted(J_REGISTRY))
def test_train_logits_match_reference(arch):
    c = _case(arch, grads=False)
    with torch.no_grad():
        loss, logits, aux = _port_loss(c, c["tree"])
    assert logits.shape == (BATCH, SEQ, c["cfg"].vocab_size)
    np.testing.assert_allclose(logits.numpy(), c["logits"], atol=LOGIT_ATOL,
                               rtol=0)
    assert aux.keys() == c["aux"].keys()
    for k, v in c["aux"].items():
        assert float(aux[k]) == pytest.approx(v, abs=AUX_ATOL)
    assert float(loss) == pytest.approx(c["loss"], abs=AUX_ATOL)
    if c["cfg"].moe.enabled:
        assert c["aux"]["load_balance_loss"] > 0


@pytest.mark.parametrize("family", sorted(GRAD_ARCHS))
def test_gradients_match_reference(family):
    c = _case(GRAD_ARCHS[family], grads=True)
    loss, got = _grads(c)
    assert loss == pytest.approx(c["loss"], abs=AUX_ATOL)
    assert list(got) == list(c["grads"])            # the reference's keys
    for k, ref in c["grads"].items():
        g = got[k].numpy()
        assert np.isfinite(g).all(), k
        scale = float(np.abs(ref).max())
        err = float(np.abs(g - ref).max())
        assert err <= GRAD_RTOL * scale + GRAD_ATOL, \
            f"{k}: {err:.3e} at max |g| {scale:.3e}"


def test_moe_routing_in_training_is_exact():
    c = _case("mixtral-8x22b", grads=True)
    jcfg, cfg = c["jcfg"], c["cfg"]
    toks = c["batch"]["tokens"]
    pos = np.broadcast_to(np.arange(SEQ)[None], (BATCH, SEQ))
    jl = jax.tree.map(lambda a: a[0], c["jp"]["stack"])
    x = jtransformer.embed_tokens(c["jp"], jcfg, jnp.asarray(toks.numpy()))
    x = x + jattn.attention_train(
        jl["attn"], jcommon.rmsnorm(jl["ln1"], x, jcfg.rms_norm_eps), jcfg,
        jnp.asarray(pos))
    jh = jcommon.rmsnorm(jl["ln2"], x, jcfg.rms_norm_eps)
    tl = checkpoint.params_from_tree(c["tree"], cfg)["layers"][0]
    with torch.no_grad():
        y = c["tree"]["embed"][toks]
        y = y + attention.attention_train(
            tl["attn"], common.rmsnorm(tl["ln1"], y, cfg.rms_norm_eps), cfg,
            torch.from_numpy(pos.copy()))
        th = common.rmsnorm(tl["ln2"], y, cfg.rms_norm_eps)
    g = moe._group_size(SEQ)
    assert g == jmoe._group_size(SEQ)
    xg = jh.reshape(-1, g, jcfg.d_model)
    probs = np.asarray(jax.nn.softmax(xg @ jl["ffn"]["router"], -1))
    jidx = np.asarray(jax.lax.top_k(jnp.asarray(probs), jcfg.moe.top_k)[1])
    tidx = moe.route(tl["ffn"], th.reshape(-1, g, cfg.d_model), cfg)[3]
    k = jcfg.moe.top_k
    srt = np.sort(probs, -1)[..., ::-1]
    clear = srt[..., k - 1] - srt[..., k] > TIE
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(tidx.numpy()[clear], jidx[clear])


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "mixtral-8x22b"])
def test_remat_policies_give_the_same_values_and_gradients(arch, policy):
    c = _case(arch, grads=arch == "mixtral-8x22b")
    loss, ref = _grads(c, remat="none")
    got_loss, got = _grads(c, remat=policy)
    assert got_loss == loss
    for k, g in ref.items():
        scale = max(float(g.abs().max()), 1e-30)
        assert float((got[k] - g).abs().max()) <= 1e-6 * scale, k


def test_chunked_attention_backward_has_no_nan_on_a_masked_row():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 64, 16)).astype(
        np.float32)).requires_grad_() for _ in range(3))
    mask = torch.ones((1, 2, 4, 4), dtype=torch.bool)
    mask[0, 1, 2] = False                   # every key of a query block
    out = chunked_attention(q, k, v, block_size=16, causal=True,
                            block_mask=mask)
    out.sum().backward()
    assert torch.isfinite(out).all()
    assert (out[0, 1, 32:48] == 0).all()
    for t in (q, k, v):
        assert torch.isfinite(t.grad).all()
    assert (q.grad[0, 1, 32:48] == 0).all()
    # a window shorter than the sequence: every row keeps its diagonal
    out = chunked_attention(q, k, v, block_size=16, causal=True, window=5)
    torch.autograd.grad(out.sum(), (q, k, v))

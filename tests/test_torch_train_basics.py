"""The port's training pieces that hold no model (``repro_torch.data``,
``optim``, ``training.losses``, the checkpointer's write side and the
parameter bridges) against the JAX package's, on the CPU.

What is held, and how tightly:
  * the data pipeline **exactly**: every task's ``sample``, ``batches``
    (host-sharded, from a start index) and ``eval_batches``, under the
    suite's pinned ``PYTHONHASHSEED`` (the task enters the seed through
    Python's string hash in both packages);
  * the schedules at steps 0…300 within 1e-6 (float32 both);
  * ``cross_entropy`` and ``total_loss`` with and without a mask within
    1e-6 (1e-6 relative for the perplexity); ``global_norm``, clipping on and off, and one ``adamw_update``
    on the same gradients (float32 and bf16 parameters) within 1e-6 (bf16
    parameters: bitwise or one bf16 ulp); AdamW's ``step`` and the state
    dtypes exactly (int32; bf16 moments before the first step, float32
    after);
  * the checkpoint keys of ``(params, opt_state)`` **exactly**, for every
    family; a checkpoint written by either package restored by the other
    with equal keys and values; ``params_from_numpy(params_to_numpy(p))``
    bitwise for every family.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import optim as joptim
from repro.checkpoint.checkpointer import _flatten
from repro.configs import get_smoke_config as j_smoke
from repro.data import pipeline as jdata
from repro.models import build_model as j_build
from repro.training import losses as jlosses
from repro_torch import checkpoint, optim
from repro_torch import tree as tu
from repro_torch.configs import get_smoke_config
from repro_torch.data import pipeline as data
from repro_torch.training import losses

from torch_serving_helpers import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False

TOL = 1e-6
# one config per family (and MLA, and a tied head): every tree layout
FAMILY_ARCHS = ["granite-3-2b", "qwen2-vl-72b", "mixtral-8x22b",
                "deepseek-v2-236b", "mamba2-370m", "recurrentgemma-9b",
                "whisper-base"]
T = lambda a: torch.from_numpy(np.array(a))


def _close(got, ref, atol=TOL):
    """Within ``atol``, or 1e-6 relative (a perplexity of ~1e3)."""
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=1e-6)


def _tree(jtree):
    """A reference pytree as the port's tree of tensors (same containers:
    nested dicts, and AdamWState as the port's)."""
    if isinstance(jtree, joptim.AdamWState):
        return optim.AdamWState(*(_tree(x) for x in jtree))
    if isinstance(jtree, dict):
        return {k: _tree(v) for k, v in jtree.items()}
    if isinstance(jtree, (tuple, list)):
        return type(jtree)(_tree(v) for v in jtree)
    return T(jtree)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("task", data.TASKS)
def test_samples_equal_reference(task):
    assert data.TASKS == jdata.TASKS
    for kw in ({}, {"needle_len": 4, "span_len": 16, "turn_len": 8,
                    "zipf_a": 1.5, "seed": 3}):
        cfg = data.DataConfig(vocab_size=97, seq_len=128, global_batch=2,
                              task=task, **kw)
        jcfg = jdata.DataConfig(**dataclasses.asdict(cfg))
        for i in (0, 1, 7, 10**6):
            got, ref = data.sample(cfg, i), jdata.sample(jcfg, i)
            assert got.keys() == ref.keys()
            for k in ref:
                assert got[k].dtype == ref[k].dtype
                np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("task", data.TASKS)
@pytest.mark.parametrize("hosts", [(1, 0), (2, 1), (4, 2)])
def test_batches_and_eval_batches_equal_reference(task, hosts):
    num_hosts, host_id = hosts
    cfg = data.DataConfig(vocab_size=211, seq_len=64, global_batch=4,
                          task=task)
    jcfg = jdata.DataConfig(**dataclasses.asdict(cfg))
    it = data.batches(cfg, start_index=5, num_hosts=num_hosts,
                      host_id=host_id)
    jit = jdata.batches(jcfg, start_index=5, num_hosts=num_hosts,
                        host_id=host_id)
    pairs = [(next(it), next(jit)) for _ in range(3)]
    assert pairs[0][0]["tokens"].shape == (4 // num_hosts, 64)
    pairs += list(zip(data.eval_batches(cfg, 2), jdata.eval_batches(jcfg, 2)))
    for got, ref in pairs:
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], ref[k])


# --------------------------------------------------------------------------
# schedules, losses, AdamW
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("linear_warmup_cosine", {"warmup_steps": 20, "total_steps": 300}),
    ("linear_warmup_cosine", {"warmup_steps": 0, "total_steps": 100,
                              "min_ratio": 0.0}),
    ("constant", {"value": 0.5}),
    ("inverse_sqrt", {"warmup_steps": 10}),
])
def test_schedules_match_reference(name, kw):
    steps = np.arange(301, dtype=np.int32)
    got = getattr(optim, name)(torch.from_numpy(steps), **kw)
    ref = getattr(joptim, name)(jnp.asarray(steps), **kw)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref)
    # a 0-d int32 step, as the optimizer's
    one = getattr(optim, name)(torch.tensor(7, dtype=torch.int32), **kw)
    _close(one.numpy(), getattr(joptim, name)(jnp.int32(7), **kw))


def _logits(seed=0, b=2, s=16, v=37):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, v)).astype(np.float32) * 3,
            rng.integers(0, v, (b, s)).astype(np.int32),
            (rng.random((b, s)) < 0.7).astype(np.float32))


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    logits, labels, mask = _logits()
    m = mask if masked else None
    loss, metrics = losses.cross_entropy(T(logits), T(labels),
                                         None if m is None else T(m))
    jloss, jmetrics = jlosses.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if m is None else jnp.asarray(m))
    assert metrics.keys() == jmetrics.keys()
    _close(loss.numpy(), jloss)
    for k in jmetrics:
        _close(metrics[k].numpy(), jmetrics[k])
    # perplexity is clipped at exp(20)
    huge, hm = losses.cross_entropy(T(logits * 1e4), T(labels))
    assert float(huge) > 20
    assert float(hm["perplexity"]) == pytest.approx(np.exp(20.0), rel=1e-6)


@pytest.mark.parametrize("aux", [{}, {"load_balance_loss": 1.7,
                                      "router_z_loss": 23.5}])
@pytest.mark.parametrize("masked", [False, True])
def test_total_loss_matches_reference(aux, masked):
    logits, labels, mask = _logits(1)
    m = mask if masked else None
    loss, metrics = losses.total_loss(
        T(logits), T(labels), {k: torch.tensor(v) for k, v in aux.items()},
        mask=None if m is None else T(m))
    jloss, jmetrics = jlosses.total_loss(
        jnp.asarray(logits), jnp.asarray(labels),
        {k: jnp.float32(v) for k, v in aux.items()},
        mask=None if m is None else jnp.asarray(m))
    assert metrics.keys() == jmetrics.keys()
    _close(loss.numpy(), jloss)
    for k in jmetrics:
        _close(metrics[k].numpy(), jmetrics[k])


def _param_tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    leaf = lambda *s: rng.normal(size=s).astype(dtype)
    return {"embed": leaf(11, 8), "stack": {"w": leaf(3, 8, 5),
                                            "ln": {"scale": leaf(3, 8)}},
            "lm_head": leaf(8, 11)}


@pytest.mark.parametrize("clip", [1.0, 0.0, 1e3])
def test_global_norm_and_clipping_match_reference(clip):
    g = _param_tree(0)
    norm = optim.global_norm(_tree(g))
    _close(norm.numpy(), joptim.global_norm(g))
    if clip:
        got, n = optim.clip_by_global_norm(_tree(g), clip)
        ref, jn = joptim.clip_by_global_norm(g, clip)
        _close(n.numpy(), jn)
        for (k, a), (_, b) in zip(tu.flatten_with_path(got),
                                  sorted(_flatten(ref).items())):
            _close(a.numpy(), b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_matches_reference(dtype, clip):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    cfg = dict(learning_rate=1e-2, grad_clip_norm=clip)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), _param_tree(0))
    tp = tu.tree_map(lambda t: t.to(tdt),
                     _tree(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                        jp)))
    jstate, tstate = joptim.init_adamw(jp), optim.init_adamw(tp)
    assert tstate.step.dtype == torch.int32
    assert all(x.dtype == tdt for x in tu.leaves((tstate.mu, tstate.nu)))
    for i in range(3):
        g = _param_tree(10 + i)
        jp, jstate, jn = joptim.adamw_update(joptim.AdamWConfig(**cfg), jp,
                                             g, jstate, jnp.float32(0.7))
        tp, tstate, tn = optim.adamw_update(
            optim.AdamWConfig(**cfg), tp, _tree(g), tstate,
            torch.tensor(0.7))
        _close(tn.numpy(), jn)
        assert int(tstate.step) == int(jstate.step) == i + 1
        assert tstate.step.dtype == torch.int32
        assert all(x.dtype == torch.float32
                   for x in tu.leaves((tstate.mu, tstate.nu)))
        assert all(x.dtype == tdt for x in tu.leaves(tp))
        ref = _flatten((jp, jstate.mu, jstate.nu))
        for k, a in tu.flatten_with_path((tp, tstate.mu, tstate.nu)):
            r = np.asarray(ref[k], np.float32)
            if dtype == "bfloat16" and k.startswith("0"):
                # bf16 parameters: equal, or one bf16 ulp apart
                ulp = 2.0 ** (np.floor(np.log2(np.abs(r) + 1e-30)) - 7)
                assert (np.abs(a.float().numpy() - r) <= ulp).all(), k
            else:
                _close(a.float().numpy(), r, atol=1e-6)


def test_adamw_donation_matches_the_functional_update():
    tp = _tree(_param_tree(0))
    g = _tree(_param_tree(1))
    state = optim.init_adamw(tp)
    cfg = optim.AdamWConfig(learning_rate=1e-2)
    new, nstate, norm = optim.adamw_update(cfg, tp, g, state)
    keep = tu.tree_map(lambda t: t.clone(), tp)
    given = tu.tree_map(lambda t: t, tp)            # containers to donate
    dstate = optim.AdamWState(state.step, tu.tree_map(lambda t: t, state.mu),
                              tu.tree_map(lambda t: t, state.nu))
    dp, dst, dnorm = optim.adamw_update(cfg, given, g, dstate, donate=True)
    assert dp is given and dst.mu is dstate.mu     # updated in place
    assert torch.equal(norm, dnorm) and torch.equal(nstate.step, dst.step)
    for a, b in zip(tu.leaves((new, nstate)), tu.leaves((dp, dst))):
        assert torch.equal(a, b)
    # the functional update left its arguments alone
    for a, b in zip(tu.leaves(tp), tu.leaves(keep)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# checkpoints and the parameter bridges
# --------------------------------------------------------------------------

_PAIRS = {}


def _pair(arch):
    """The reference's smoke parameters, and the same as the port's tree
    and the port's layered parameters (built once per arch)."""
    if arch not in _PAIRS:
        jcfg = j_smoke(arch)
        jp = jax.jit(j_build(jcfg).init)(jax.random.PRNGKey(0))
        cfg = get_smoke_config(arch)
        flat = {k: np.asarray(v) for k, v in _flatten(jp).items()}
        _PAIRS[arch] = dict(jp=jp, flat=flat, cfg=cfg, tree=_tree(jp),
                            tp=checkpoint.params_from_numpy(flat, cfg,
                                                            device="cpu"))
    return _PAIRS[arch]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_checkpoint_keys_match_reference(arch):
    p = _pair(arch)
    jkeys = list(_flatten((p["jp"], joptim.init_adamw(p["jp"]))))
    tree = checkpoint.params_to_tree(p["tp"], p["cfg"])
    keys = [k for k, _ in tu.flatten_with_path(
        (tree, optim.init_adamw(tree)))]
    assert keys == jkeys                    # letter for letter, in order
    assert "0::embed" in keys and "1::.step" in keys
    assert any(k.startswith("1::.mu::") for k in keys)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_params_numpy_round_trip_is_bitwise(arch):
    p = _pair(arch)
    back = checkpoint.params_to_numpy(p["tp"], p["cfg"])
    assert back.keys() == p["flat"].keys()
    for k, v in p["flat"].items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
    again = checkpoint.params_from_numpy(back, p["cfg"], device="cpu")
    for a, b in zip(tu.leaves(again), tu.leaves(p["tp"])):
        assert torch.equal(a, b)
    # the tree bridge: views of the stacked leaves, the same values
    viewed = checkpoint.params_from_tree(p["tree"], p["cfg"])
    for a, b in zip(tu.leaves(viewed), tu.leaves(p["tp"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["granite-3-2b", "recurrentgemma-9b"])
def test_checkpoints_cross_between_packages(arch, tmp_path):
    p = _pair(arch)
    jp = p["jp"]
    g = jax.tree.map(lambda a: jnp.full_like(a, 0.01), jp)
    jp1, jstate = jax.jit(lambda p_, g_: joptim.adamw_update(
        joptim.AdamWConfig(), p_, g_, joptim.init_adamw(p_))[:2])(jp, g)
    jtree = (jp1, jstate)
    ttree = _tree(jtree)
    # the port writes, the reference reads
    checkpoint.save_step(str(tmp_path / "port"), 3, ttree,
                         extra_meta={"loss": 1.5})
    assert checkpoint.latest_step(str(tmp_path / "port")) == 3
    assert jckpt.latest_step(str(tmp_path / "port")) == 3
    back = jckpt.restore_step(str(tmp_path / "port"), 3, jtree)
    for k, v in _flatten(jtree).items():
        np.testing.assert_array_equal(np.asarray(_flatten(back)[k]),
                                      np.asarray(v))
    meta = json.loads((tmp_path / "port" / "step_00000003.meta.json")
                      .read_text())
    assert meta["step"] == 3 and meta["loss"] == 1.5
    assert meta["keys"] == sorted(_flatten(jtree))
    # the reference writes, the port reads
    jckpt.save_step(str(tmp_path / "ref"), 4, jtree)
    got = checkpoint.restore_step(str(tmp_path / "ref"), 4, ttree)
    assert isinstance(got[1], optim.AdamWState)
    assert got[1].step.dtype == torch.int32
    assert [k for k, _ in tu.flatten_with_path(got)] == list(_flatten(jtree))
    for (k, a), (_, b) in zip(tu.flatten_with_path(got),
                              tu.flatten_with_path(ttree)):
        assert torch.equal(a, b), k
    # bf16 leaves go through float32 and come back exactly
    bf = tu.tree_map(lambda t: t.to(torch.bfloat16) if t.is_floating_point()
                     else t, ttree)
    checkpoint.save(str(tmp_path / "bf.npz"), bf)
    for a, b in zip(tu.leaves(checkpoint.restore_like(
            str(tmp_path / "bf.npz"), bf)), tu.leaves(bf)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore_like(str(tmp_path / "bf.npz"), tu.tree_map(
            lambda t: t[..., :1] if t.dim() else t, bf))

"""The port's train step, train loop and launcher
(``repro_torch.training.train_loop``, ``repro_torch.launch.train``)
against the JAX package's, on the CPU.

Both packages start from the reference's smoke parameters (carried across
as the reference's tree) and take the same numpy batches.  Float32, no
TF32.

What is held, and how tightly:
  * one ``make_train_step`` step at 1 and 2 microbatches (the dense family,
    and Mixtral's MoE, whose aux losses enter the loss): every metric
    within ``METRIC_RTOL`` (relative), AdamW's moments within
    ``MOMENT_RTOL`` of each leaf's max, ``step`` exactly, and every
    updated parameter within ``PARAM_ATOL``, except where AdamW's first
    step divides a gradient near zero by itself (``g / (|g| + eps)``):
    elements whose first moment is below ``SMALL`` of the leaf's max may
    move up to one full step apart;
  * three steps of ``train`` with ``log_every=2`` and ``ckpt_every=2``:
    the history's keys and steps, its numbers within ``METRIC_RTOL``, the
    checkpoints' file names and keys equal to the reference's, the port's
    files read by the reference's ``restore_like``, and the final
    parameters within ``PARAM_ATOL_STEPS`` (near-zero elements within one
    step per step);
  * the launcher's ``main`` on smoke configs with ``--device cpu`` (dense,
    vlm with 3-D positions, encdec with zero frames), and its refusal to
    run without a GPU unless asked; ``train`` without parameters draws
    them from its seed.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import training as jtraining
from repro.checkpoint.checkpointer import _flatten
from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_adamw as j_init_adamw
from repro_torch import tree as tu
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, batches
from repro_torch.launch import train as launcher
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, init_adamw
from repro_torch.training import TrainConfig, make_train_step, train

from torch_serving_helpers import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False

SEQ, BATCH = 64, 2
LR = 1e-3
METRIC_RTOL = 1e-5
MOMENT_RTOL = 1e-4
PARAM_ATOL = 1e-5
# after several steps: an element that a near-zero gradient moved apart in
# one step moves the next steps' gradients by O(lr) (1e-3 here)
PARAM_ATOL_STEPS = 1e-4
SMALL = 1e-4


def _setup(arch):
    jcfg, cfg = j_smoke(arch), get_smoke_config(arch)
    jm, tm = j_build(jcfg), build_model(cfg, device="cpu")
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tree = tu.unflatten({k: torch.from_numpy(np.array(v))
                         for k, v in _flatten(jp).items()})
    dcfg = DataConfig(cfg.vocab_size, SEQ, BATCH, task="lm", seed=5)
    return jm, jp, tm, tree, dcfg


def _tcfg(cls, opt, **kw):
    return cls(num_steps=10, warmup_steps=2, optimizer=opt(learning_rate=LR),
               **kw)


def _assert_params(got, ref_flat, mu_flat, steps: int):
    """Parameters within ``PARAM_ATOL`` (``PARAM_ATOL_STEPS`` after more
    than one step); where the first moment is near zero, within one full
    AdamW step per step taken."""
    atol = PARAM_ATOL if steps == 1 else PARAM_ATOL_STEPS
    for k, p in tu.flatten_with_path(got):
        ref, mu = ref_flat[k], np.abs(mu_flat[k])
        diff = np.abs(p.numpy() - ref)
        small = mu < SMALL * max(float(mu.max()), 1e-30)
        assert (diff[~small] <= atol).all(), \
            f"{k}: {float(diff[~small].max()):.3e}"
        assert (diff[small] <= 2 * LR * steps * 1.01).all(), k


@pytest.mark.parametrize("arch,mb", [("granite-3-2b", 1),
                                     ("granite-3-2b", 2),
                                     ("mixtral-8x22b", 2)])
def test_train_step_matches_reference(arch, mb):
    jm, jp, tm, tree, dcfg = _setup(arch)
    batch = next(batches(dcfg))
    jstep = jax.jit(jtraining.make_train_step(
        jm, _tcfg(jtraining.TrainConfig, JAdamWConfig, microbatches=mb)))
    jp1, jstate, jmet = jstep(jp, j_init_adamw(jp),
                              {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_train_step(tm, _tcfg(TrainConfig, AdamWConfig,
                                     microbatches=mb))
    p1, state, met = step(tree, init_adamw(tree),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    assert met.keys() == jmet.keys()
    for k, v in jmet.items():
        assert float(met[k]) == pytest.approx(float(v), rel=METRIC_RTOL,
                                              abs=1e-7), k
    assert state.step.dtype == torch.int32 and int(state.step) == 1
    mu = {k: np.asarray(v) for k, v in _flatten(jstate.mu).items()}
    for name, tree_, ref in (("mu", state.mu, jstate.mu),
                             ("nu", state.nu, jstate.nu)):
        ref = _flatten(ref)
        for k, t in tu.flatten_with_path(tree_):
            r = np.asarray(ref[k])
            assert np.abs(t.numpy() - r).max() <= MOMENT_RTOL * max(
                float(np.abs(r).max()), 1e-30), f"{name} {k}"
    _assert_params(p1, {k: np.asarray(v) for k, v in _flatten(jp1).items()},
                   mu, 1)
    # the caller's tree is untouched by the functional step
    for k, t in tu.flatten_with_path(tree):
        np.testing.assert_array_equal(t.numpy(), np.asarray(_flatten(jp)[k]))


def test_train_three_steps_matches_reference(tmp_path):
    jm, jp, tm, tree, dcfg = _setup("granite-3-2b")
    kw = dict(num_steps=3, warmup_steps=1, log_every=2, ckpt_every=2)
    jp3, jstate, jhist = jtraining.train(
        jm, jtraining.TrainConfig(optimizer=JAdamWConfig(learning_rate=LR),
                                  **kw),
        batches(dcfg), params=jp, ckpt_dir=str(tmp_path / "ref"))
    logged = []
    p3, state, hist = train(
        tm, TrainConfig(optimizer=AdamWConfig(learning_rate=LR), **kw),
        batches(dcfg), params=tree, ckpt_dir=str(tmp_path / "port"),
        log_fn=lambda step, m: logged.append(step))
    assert logged == [0, 2]
    assert hist.keys() == jhist.keys()
    for k, v in jhist.items():
        assert len(hist[k]) == len(v) == 2
        if k != "wall_s":
            np.testing.assert_allclose(hist[k], v, rtol=METRIC_RTOL,
                                       atol=1e-7, err_msg=k)
    assert int(state.step) == int(jstate.step) == 3
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "ref")) == [
        "step_00000002.meta.json", "step_00000002.npz",
        "step_00000003.meta.json", "step_00000003.npz"]
    for name in ("step_00000002.npz", "step_00000003.npz"):
        with np.load(tmp_path / "port" / name) as a, \
                np.load(tmp_path / "ref" / name) as b:
            assert sorted(a.files) == sorted(b.files)
    back = jckpt.restore_step(str(tmp_path / "port"), 3, jp)
    for k, v in _flatten(back).items():
        np.testing.assert_array_equal(np.asarray(v),
                                      dict(tu.flatten_with_path(p3))[k])
    mu = {k: np.asarray(v) for k, v in _flatten(jstate.mu).items()}
    _assert_params(p3, {k: np.asarray(v) for k, v in _flatten(jp3).items()},
                   mu, 3)
    # the caller's parameters are read, never written
    for k, t in tu.flatten_with_path(tree):
        np.testing.assert_array_equal(t.numpy(), np.asarray(_flatten(jp)[k]))


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen2-vl-72b",
                                  "whisper-base"])
def test_launcher_trains_a_smoke_config_on_the_cpu(arch, tmp_path):
    out = tmp_path / "metrics.json"
    hist = launcher.main(["--arch", arch, "--smoke", "--steps", "3",
                          "--batch", "2", "--seq", "64", "--microbatches",
                          "2", "--device", "cpu", "--ckpt-dir",
                          str(tmp_path / "ckpt"), "--metrics-out", str(out)])
    assert json.loads(out.read_text()) == hist
    assert len(hist["total_loss"]) == 2                 # steps 0 and 2
    assert all(np.isfinite(hist["total_loss"]))
    assert os.path.exists(tmp_path / "ckpt" / "step_00000003.npz")


def test_launcher_and_train_run_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--arch", "granite-3-2b", "--smoke", "--steps", "1"])


def test_train_draws_parameters_from_its_seed():
    tm = build_model(get_smoke_config("granite-3-2b"), device="cpu")
    dcfg = DataConfig(tm.cfg.vocab_size, SEQ, BATCH)
    tcfg = TrainConfig(num_steps=2, warmup_steps=1, log_every=1)
    runs = [train(tm, tcfg, batches(dcfg), seed=s)[2]["total_loss"]
            for s in (3, 3, 4)]
    assert runs[0] == runs[1] != runs[2]

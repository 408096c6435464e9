"""Training loop (port of ``repro/training/train_loop.py``): the train step
with microbatching, and a host loop with checkpoints and metrics.

The training state is the reference's tree (nested dicts of stacked
leaves, :func:`repro_torch.checkpoint.params_to_tree`): parameters,
gradients and AdamW's moments share its flat keys, and
``Model.train_logits`` makes the per-layer views inside each forward.
Activation checkpointing is the model's (``ModelConfig.remat_policy``,
:func:`repro_torch.models.common.maybe_remat`), as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch import checkpoint
from repro_torch import tree as tu
from repro_torch.models.api import Model
from repro_torch.optim import AdamWConfig, AdamWState, adamw_update, init_adamw
from repro_torch.optim.schedule import linear_warmup_cosine
from repro_torch.training.losses import total_loss


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_steps: int = 200
    microbatches: int = 1           # grad-accumulation steps per train step
    warmup_steps: int = 20
    remat: bool = True              # unused, as in the reference: see above
    log_every: int = 10
    ckpt_every: int = 0             # 0 = only final
    optimizer: AdamWConfig = AdamWConfig()


def make_loss_fn(model: Model, extra_kwargs_fn: Optional[Callable] = None):
    """``loss_fn(params, batch) -> (loss, metrics)``."""
    def loss_fn(params, batch):
        kwargs = extra_kwargs_fn(batch) if extra_kwargs_fn else {}
        logits, aux = model.train_logits(params, batch["tokens"], **kwargs)
        return total_loss(logits, batch["labels"], aux)
    return loss_fn


def make_train_step(model: Model, tcfg: TrainConfig,
                    extra_kwargs_fn: Optional[Callable] = None, *,
                    donate: bool = False):
    """Build ``(params, opt_state, batch) -> (params, opt_state, metrics)``.

    The batch is split into ``microbatches`` equal parts along its rows;
    each part's gradients accumulate into the same buffers (the first
    part's gradient, then each next one added, then divided by the count:
    the reference's sum in its order) and the metrics are the parts'
    means.  The learning-rate scale is taken at the step before it is
    incremented.  Metrics are 0-d tensors on the device, with
    ``grad_norm`` (before clipping) and ``lr_scale`` added.  ``donate``
    hands ``params`` and ``opt_state`` to the update to overwrite
    (:func:`repro_torch.optim.adamw_update`)."""
    loss_fn = make_loss_fn(model, extra_kwargs_fn)

    def train_step(params, opt_state: AdamWState, batch):
        mb = tcfg.microbatches
        work = tu.tree_map(lambda p: p.detach().requires_grad_(), params)
        parts = ([batch] if mb == 1 else
                 [{k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])[i]
                   for k, v in batch.items()} for i in range(mb)])
        msum = None
        for part in parts:
            loss, metrics = loss_fn(work, part)
            loss.backward()
            metrics = {k: v.detach() for k, v in metrics.items()}
            msum = metrics if msum is None else {
                k: msum[k] + metrics[k] for k in msum}
            del loss
        grads = tu.tree_map(lambda w: torch.zeros_like(w) if w.grad is None
                            else w.grad, work)
        del work
        if mb > 1:
            tu.tree_map(lambda g: g.div_(mb), grads)
            msum = {k: v / mb for k, v in msum.items()}
        lr_scale = linear_warmup_cosine(
            opt_state.step, warmup_steps=tcfg.warmup_steps,
            total_steps=tcfg.num_steps)
        params, opt_state, gnorm = adamw_update(
            tcfg.optimizer, params, grads, opt_state, lr_scale,
            donate=donate)
        msum["grad_norm"] = gnorm
        msum["lr_scale"] = lr_scale
        return params, opt_state, msum

    return train_step


def train(model: Model, tcfg: TrainConfig,
          data_iter: Iterator[Dict[str, Any]], *,
          seed: int = 0,
          params=None,
          ckpt_dir: Optional[str] = None,
          extra_kwargs_fn: Optional[Callable] = None,
          log_fn: Callable[[int, Dict], None] = None
          ) -> Tuple[Any, AdamWState, Dict[str, list]]:
    """Host-side loop on the model's device.  ``params`` is the reference's
    tree (the caller's tensors are read, never written); without it the
    model's initialiser draws them from a ``torch.Generator`` seeded with
    ``seed`` on the model's device (the reference's distributions, not its
    numbers).  History holds every ``log_every``-th step and the last,
    with ``wall_s``; checkpoints go to ``ckpt_dir`` every ``ckpt_every``
    steps (not at step 0) and always at ``num_steps``."""
    dev = model.device
    if params is None:
        params = checkpoint.params_to_tree(
            model.init(torch.Generator(device=dev).manual_seed(seed)),
            model.cfg)
    else:
        params = tu.tree_map(lambda p: p, params)   # our own containers
    opt_state = init_adamw(params)
    step_fn = make_train_step(model, tcfg, extra_kwargs_fn, donate=True)

    history: Dict[str, list] = {}
    t0 = time.time()
    for step in range(tcfg.num_steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in next(data_iter).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % tcfg.log_every == 0 or step == tcfg.num_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["wall_s"] = time.time() - t0
            for k, v in m.items():
                history.setdefault(k, []).append(v)
            if log_fn:
                log_fn(step, m)
        if (ckpt_dir and tcfg.ckpt_every
                and step and step % tcfg.ckpt_every == 0):
            checkpoint.save_step(ckpt_dir, step, params)
    if ckpt_dir:
        checkpoint.save_step(ckpt_dir, tcfg.num_steps, params)
    return params, opt_state, history

"""AdamW with decoupled weight decay and global-norm gradient clipping
(port of ``repro/optim/adamw.py``).

The state mirrors the parameters' tree (:mod:`repro_torch.tree`), so its
flat keys are the parameters' (``.mu::stack::attn::wq`` …).  As in the
reference, :func:`init_adamw` makes ``mu``/``nu`` in each parameter's
dtype and the update computes and keeps them in float32 (with bf16
parameters the state is bf16 before the first step and float32 after);
``step`` is int32.

The update is functional: it returns new tensors and changes none of its
arguments, unless ``donate=True``, which stands for the reference's
buffer donation under ``jit``: each new parameter and moment then
replaces the old one in the given containers as soon as it is computed,
so at most one leaf is held twice (a full-width step on one card needs
it: parameters, gradients and both moments already fill half of it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import tree as tu


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0


def init_adamw(params: Any) -> AdamWState:
    first = tu.leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=tu.tree_map(torch.zeros_like, params),
        nu=tu.tree_map(torch.zeros_like, params))


def global_norm(tree: Any) -> torch.Tensor:
    """√(Σ over leaves of Σ x²), in float32, leaves in the reference's
    order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tu.leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tu.tree_map(lambda g: g.float() * scale, grads), norm


def adamw_update(cfg: AdamWConfig, params: Any, grads: Any,
                 state: AdamWState, lr_scale=1.0, *, donate: bool = False
                 ) -> Tuple[Any, AdamWState, torch.Tensor]:
    """Returns (new_params, new_state, pre-clip grad norm).  The clip's
    scale is applied to each leaf inside the update (the reference scales
    the whole tree first: the same products, without a second copy of
    the gradients)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, cfg.grad_clip_norm) if cfg.grad_clip_norm > 0 \
        else None
    step = state.step + 1
    t = step.to(torch.float32)
    lr = cfg.learning_rate * lr_scale
    c1, c2 = 1 - cfg.b1 ** t, 1 - cfg.b2 ** t

    def upd(p, g, m, n):
        g = g.float() if scale is None else g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        n = cfg.b2 * n + (1 - cfg.b2) * g * g
        p32 = p.float()
        delta = (m / c1) / (torch.sqrt(n / c2) + cfg.eps) \
            + cfg.weight_decay * p32
        return (p32 - lr * delta).to(p.dtype), m, n

    if donate:
        _update_in_place(upd, params, grads, state.mu, state.nu)
        return params, AdamWState(step, state.mu, state.nu), norm
    out = tu.tree_map(upd, params, grads, state.mu, state.nu)
    new_p, new_m, new_n = (tu.tree_map(lambda _, o: o[j], params, out)
                           for j in range(3))
    return new_p, AdamWState(step, new_m, new_n), norm


def _update_in_place(upd, p, g, m, n) -> None:
    """``donate``: each leaf of ``p``, ``m`` and ``n`` (dicts and lists)
    replaced by its update as soon as it is computed."""
    for k in (sorted(p) if isinstance(p, dict) else range(len(p))):
        if isinstance(p[k], (dict, list)):
            _update_in_place(upd, p[k], g[k], m[k], n[k])
        else:
            p[k], m[k], n[k] = upd(p[k], g[k], m[k], n[k])

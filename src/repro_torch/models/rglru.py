"""RG-LRU recurrent block (port of ``repro/models/rglru.py``; RecurrentGemma
/ Griffin, arXiv:2402.19427).

Real-Gated Linear Recurrent Unit::

    r_t = σ(W_a x_t + b_a)          recurrence gate
    i_t = σ(W_x x_t + b_x)          input gate
    a_t = a^(c·r_t),  a = σ(Λ)      per-channel learned decay, c = 8
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

The gates, the decay and the state are float32 whatever the parameters'
dtype (the reference promotes ``x`` to float32 before ``x @ w_a``).  The
reference evaluates the full sequence with ``jax.lax.associative_scan``;
here it is a Hillis–Steele doubling scan over the sequence axis,
⌈log₂ S⌉ passes of the reference's ``combine`` over ``(B, S, W)`` (no
closed form through ``cumsum(log a)``: dividing by its exponential
overflows at thousands of tokens).  Not a Pallas kernel in the reference:
plain torch here.  Decode is the O(1) step.  The block wraps the RG-LRU in
the Griffin recurrent-block topology: linear → causal conv → RG-LRU, gated
by a parallel GeLU branch (tanh approximation, ``jax.nn.gelu``'s default).

One layer's parameters (:func:`rglru_leaf_shapes`): ``w_x`` and ``w_gate``
``(d, W)``, the depthwise ``conv_w`` ``(conv_width, W)`` and ``conv_b``,
``w_a``/``w_i`` ``(W, W)`` and ``b_a``/``b_i``, ``lam`` ``(W,)`` and
``w_out`` ``(W, d)``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard
from repro_torch.models import common

_C = 8.0


def rglru_leaf_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """One recurrent layer's leaves and their shapes."""
    d, w = cfg.d_model, cfg.rglru.lru_width
    return {"w_x": (d, w), "w_gate": (d, w),
            "conv_w": (cfg.rglru.conv_width, w), "conv_b": (w,),
            "w_a": (w, w), "b_a": (w,), "w_i": (w, w), "b_i": (w,),
            "lam": (w,), "w_out": (w, d)}


def init_rglru_layer(cfg: ModelConfig, generator: torch.Generator, *,
                     device, dtype=torch.float32, out=None
                     ) -> Dict[str, torch.Tensor]:
    """One layer's leaves from the reference's distributions, into
    ``out``'s tensors when given: the projections fan-in truncated normal,
    ``conv_w`` normal × 0.1, zero biases, and Λ from u uniform in
    [0.9², 0.999²] so that a = σ(Λ) = √u lies in [0.9, 0.999].  The
    reference draws ``w_out`` from ``w_x``'s key (equal leaves where
    ``d_model == lru_width``); here every leaf is drawn on its own.  Same
    distributions, not the same numbers."""
    if out is None:
        out = {name: torch.empty(shape, dtype=dtype, device=device)
               for name, shape in rglru_leaf_shapes(cfg).items()}
    for name in ("w_x", "w_gate", "w_a", "w_i", "w_out"):
        common.dense_init_(out[name], generator)
    dev = out["conv_w"].device
    out["conv_w"].copy_(torch.randn(out["conv_w"].shape, generator=generator,
                                    device=dev) * 0.1)
    for name in ("conv_b", "b_a", "b_i"):
        out[name].zero_()
    u = torch.rand(out["lam"].shape, generator=generator, device=dev)
    u = 0.9 ** 2 + u * (0.999 ** 2 - 0.9 ** 2)
    out["lam"].copy_(torch.log(u.sqrt() / (1 - u.sqrt())))
    return out


def _causal_conv(params, u: torch.Tensor, conv_state=None):
    """u: (B, S, W).  Depthwise causal conv of width ``conv_width``, no
    activation.  Returns (out, new_conv_state (B, width − 1, W))."""
    w = params["conv_w"]
    width = w.shape[0]
    if conv_state is None:
        pad = u.new_zeros((u.shape[0], width - 1, u.shape[-1]))
    else:
        pad = conv_state
    up = torch.cat([pad, u], dim=1)
    out = sum(up[:, i: i + u.shape[1], :] * w[i] for i in range(width))
    return out + params["conv_b"], up[:, -(width - 1):, :]


def _gates(params, x32: torch.Tensor, lam: torch.Tensor):
    """float32 (log a, gated input) of inputs ``x32`` (…, W) float32."""
    r = torch.sigmoid(x32 @ params["w_a"].float() + params["b_a"].float())
    i = torch.sigmoid(x32 @ params["w_i"].float() + params["b_i"].float())
    log_sig_lam = -F.softplus(-lam.float())                  # log σ(Λ)
    return _C * r * log_sig_lam, i * x32


def _input_scale(log_a: torch.Tensor) -> torch.Tensor:
    """√(1 − a²), floored as the reference floors it."""
    return torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t · h_{t−1} + b_t along axis 1 from h_{−1} = 0, by doubling:
    pass d combines each position with the one ``d`` before it, ``(a1, b1)
    ∘ (a2, b2) = (a1·a2, b1·a2 + b2)`` (the reference's ``combine``, the
    earlier pair on the left), for d = 1, 2, 4, … < S."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], b[:, :-d],
                                               a[:, d:])], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def rglru_apply(params, x: torch.Tensor, lam: torch.Tensor,
                h0: torch.Tensor | None):
    """RG-LRU recurrence.  x: (B, S, W); lam: (W,); h0: (B, W) float32 or
    None.  Returns (h (B, S, W) float32, h_last (B, W))."""
    x32 = x.float()
    log_a, gated = _gates(params, x32, lam)
    a = torch.exp(log_a)
    b = _input_scale(log_a) * gated
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    return h, h[:, -1, :]


def recurrent_block_forward(params, x: torch.Tensor, cfg: ModelConfig,
                            conv_state=None, h0=None):
    """Griffin recurrent block over the full sequence: (y (B, S, d),
    (conv_state (B, width − 1, W), h_last (B, W) float32))."""
    gate = F.gelu(x @ params["w_gate"], approximate="tanh")
    u = shard(x @ params["w_x"], "batch", None, "ssm_inner")
    u, new_conv = _causal_conv(params, u, conv_state)
    h, h_last = rglru_apply(params, u, params["lam"], h0)
    y = h.to(x.dtype) * gate
    return y @ params["w_out"], (new_conv, h_last)


def recurrent_block_decode(params, x: torch.Tensor, cfg: ModelConfig,
                           conv_state: torch.Tensor, h: torch.Tensor):
    """One step.  x: (B, 1, d); h: (B, W) float32."""
    gate = F.gelu(x @ params["w_gate"], approximate="tanh")
    u = x @ params["w_x"]
    u, new_conv = _causal_conv(params, u, conv_state)
    log_a, gated = _gates(params, u[:, 0].float(), params["lam"])
    h = torch.exp(log_a) * h + _input_scale(log_a) * gated
    y = h[:, None, :].to(x.dtype) * gate
    return y @ params["w_out"], (new_conv, h)

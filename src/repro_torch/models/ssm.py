"""Mamba-2 SSD block (port of ``repro/models/ssm.py``; state-space duality,
arXiv:2405.21060).

The chunked SSD scan: an intra-chunk quadratic term like masked attention
and an inter-chunk linear recurrence over chunk states, the reference's
``lax.scan`` a loop over chunks here.  Decode is the single-step recurrence
h ← a·h + dt·B·x.  Attention-free: SharePrefill does not apply, and no
kernel of the port is launched; every contraction is ``einsum`` or
``matmul``, as the reference leaves them to XLA.  ``dt``, the decay, the
SSD inputs and the state are float32 whatever the parameters' dtype; the
output is cast back before ``w_out``.

One layer's parameters (flat ``::`` keys of :func:`ssm_leaf_shapes`, nested
in the model's dict): ``w_in`` ``(d, 2·d_inner + 2·N + nh)`` projecting to
``[z, x, B, C, dt]``, the depthwise ``conv_w`` ``(W, conv_dim)`` and
``conv_b`` over ``[x, B, C]``, ``a_log``, ``dt_bias``, ``d_skip`` ``(nh,)``,
``out_norm`` and ``w_out`` ``(d_inner, d)``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard
from repro_torch.models import common


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    return d_inner, nheads, s.head_dim, s.state_dim


def ssm_leaf_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """One SSM layer's leaves and their shapes."""
    d = cfg.d_model
    d_inner, nh, _, n = _dims(cfg)
    conv_dim = d_inner + 2 * n              # conv over [x, B, C]
    return {"w_in": (d, 2 * d_inner + 2 * n + nh),
            "conv_w": (cfg.ssm.conv_width, conv_dim),
            "conv_b": (conv_dim,), "a_log": (nh,), "dt_bias": (nh,),
            "d_skip": (nh,), "out_norm::scale": (d_inner,),
            "w_out": (d_inner, d)}


def init_ssm_layer(cfg: ModelConfig, generator: torch.Generator, *,
                   device, dtype=torch.float32, out=None
                   ) -> Dict[str, torch.Tensor]:
    """One layer's leaves (flat keys of :func:`ssm_leaf_shapes`) from the
    reference's distributions, into ``out``'s tensors when given: the
    projections fan-in truncated normal, ``conv_w`` normal × 0.1,
    ``a_log = log(1 … nh)``, zero ``conv_b`` and ``dt_bias``, ones for
    ``d_skip`` and the norm.  Same distributions, not the same numbers."""
    if out is None:
        out = {name: torch.empty(shape, dtype=dtype, device=device)
               for name, shape in ssm_leaf_shapes(cfg).items()}
    nh = out["a_log"].shape[0]
    for name in ("w_in", "w_out"):
        common.dense_init_(out[name], generator)
    out["conv_w"].copy_(torch.randn(out["conv_w"].shape, generator=generator,
                                    device=out["conv_w"].device) * 0.1)
    out["conv_b"].zero_()
    out["dt_bias"].zero_()
    out["a_log"].copy_(torch.log(torch.linspace(1.0, float(nh), nh)))
    out["d_skip"].fill_(1.0)
    out["out_norm::scale"].fill_(1.0)
    return out


def _split_in(params, x: torch.Tensor, cfg: ModelConfig):
    d_inner, nh, p, n = _dims(cfg)
    zxbcdt = x @ params["w_in"]
    z = zxbcdt[..., :d_inner]
    xs = zxbcdt[..., d_inner: 2 * d_inner]
    bb = zxbcdt[..., 2 * d_inner: 2 * d_inner + n]
    cc = zxbcdt[..., 2 * d_inner + n: 2 * d_inner + 2 * n]
    dt = zxbcdt[..., 2 * d_inner + 2 * n:]
    return z, xs, bb, cc, dt


def _split_conv(conv_out: torch.Tensor, cfg: ModelConfig):
    d_inner, _, _, n = _dims(cfg)
    return (conv_out[..., :d_inner], conv_out[..., d_inner: d_inner + n],
            conv_out[..., d_inner + n:])


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` as the reference's ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(params, u: torch.Tensor, conv_state=None):
    """u: (B, S, C).  Depthwise causal conv of width W.

    Returns (out, new_conv_state (B, W-1, C))."""
    w = params["conv_w"]                # (W, C)
    width = w.shape[0]
    if conv_state is None:
        pad = u.new_zeros((u.shape[0], width - 1, u.shape[-1]))
    else:
        pad = conv_state
    up = torch.cat([pad, u], dim=1)
    out = sum(up[:, i: i + u.shape[1], :] * w[i] for i in range(width))
    out = F.silu(out + params["conv_b"])
    return out, up[:, -(width - 1):, :]


def _ssd_chunked(xh, bb, cc, dt, a, chunk: int) -> torch.Tensor:
    """SSD scan. xh: (B,S,nh,P); bb/cc: (B,S,N); dt: (B,S,nh); a: (nh,)<0.

    Returns y (B,S,nh,P)."""
    b, s, nh, p = xh.shape
    n = bb.shape[-1]
    nc = s // chunk
    r = lambda t: t.reshape(b, nc, chunk, *t.shape[2:])
    xh, bb, cc, dt = r(xh), r(bb), r(cc), r(dt)

    da = dt * a                                    # (B,NC,L,nh) log-decay
    cum = torch.cumsum(da, dim=2)
    # intra-chunk: L_ij = exp(cum_i - cum_j) for i ≥ j; the mask comes
    # before exp, so i < j never overflows
    li = cum[:, :, :, None, :]                     # i
    lj = cum[:, :, None, :, :]                     # j
    seg = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=xh.device).tril()[None, None, :, :, None]
    decay = torch.exp(torch.where(seg, li - lj, float("-inf")))
    cb = torch.einsum("bzin,bzjn->bzij", cc, bb)   # (B,NC,L,L)
    att = cb[..., None] * decay                    # (B,NC,L,L,nh)
    y_intra = torch.einsum("bzijh,bzjhp->bzihp", att, xh * dt[..., None])

    # chunk state: S_z = Σ_j exp(cum_last - cum_j) dt_j B_j ⊗ x_j
    last = cum[:, :, -1:, :]
    w_state = torch.exp(last - cum) * dt           # (B,NC,L,nh)
    states = torch.einsum("bzjn,bzjhp->bzhnp", bb, xh * w_state[..., None])
    chunk_decay = torch.exp(last[:, :, 0, :])      # (B,NC,nh)

    h = xh.new_zeros((b, nh, n, p))
    h_prev = []                                    # the state BEFORE chunk z
    for z in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, z, :, None, None] + states[:, z]
    h_prev = torch.stack(h_prev, dim=1)            # (B,NC,nh,N,P)

    # inter-chunk: y_i += C_i · exp(cum_i) h_prev
    y_inter = (torch.einsum("bzin,bzhnp->bzihp", cc, h_prev)
               * torch.exp(cum)[..., None])
    return (y_intra + y_inter).reshape(b, s, nh, p)


def ssm_forward(params, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence forward (prefill).

    Returns (y (B,S,D), (conv_state, ssd_state)) for decode continuation.
    A sequence that is not a multiple of the chunk runs as one chunk of
    length S, as in the reference: its intra-chunk term is ``(B, 1, S, S,
    nh)`` float32, so serve full-width buckets that are multiples of the
    chunk."""
    d_inner, nh, p, n = _dims(cfg)
    b, s, _ = x.shape
    z, xs, bb, cc, dt = _split_in(params, x, cfg)
    conv_out, conv_state = _causal_conv(params,
                                        torch.cat([xs, bb, cc], dim=-1))
    xs, bb, cc = _split_conv(conv_out, cfg)

    dt = _softplus(dt.float() + params["dt_bias"])
    a = -torch.exp(params["a_log"].float())
    xh = shard(xs.reshape(b, s, nh, p), "batch", None, "ssm_inner")

    chunk = min(cfg.ssm.chunk_size, s)
    if s % chunk:
        chunk = s                                   # degenerate small case
    y = _ssd_chunked(xh.float(), bb.float(), cc.float(), dt, a, chunk)
    y = y + xh * params["d_skip"][None, None, :, None]

    # the decode state: the recurrence's end over the whole sequence, one
    # cumsum (not the chunk scan's last state), as the reference
    cum = torch.cumsum(dt * a, dim=1)
    wall = torch.exp(cum[:, -1:, :] - cum) * dt
    ssd_state = torch.einsum("bjn,bjhp->bhnp", bb.float(),
                             xh.float() * wall[..., None])

    y = y.reshape(b, s, d_inner)
    y = common.rmsnorm(params["out_norm"], y * F.silu(z), cfg.rms_norm_eps)
    out = y.to(x.dtype) @ params["w_out"]
    return out, (conv_state, ssd_state)


def ssm_decode(params, x: torch.Tensor, cfg: ModelConfig,
               conv_state: torch.Tensor, ssd_state: torch.Tensor):
    """Single-token step. x: (B, 1, D)."""
    d_inner, nh, p, n = _dims(cfg)
    b = x.shape[0]
    z, xs, bb, cc, dt = _split_in(params, x, cfg)
    conv_out, conv_state = _causal_conv(
        params, torch.cat([xs, bb, cc], dim=-1), conv_state)
    xs, bb, cc = _split_conv(conv_out, cfg)

    dt = _softplus(dt[:, 0].float() + params["dt_bias"])     # (B,nh)
    a = -torch.exp(params["a_log"].float())
    decay = torch.exp(dt * a)                                # (B,nh)
    xh = xs[:, 0].reshape(b, nh, p).float()
    upd = torch.einsum("bn,bhp->bhnp", bb[:, 0].float(), dt[..., None] * xh)
    ssd_state = ssd_state * decay[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", cc[:, 0].float(), ssd_state)
    y = y + xh * params["d_skip"][None, :, None]
    y = y.reshape(b, 1, d_inner)
    y = common.rmsnorm(params["out_norm"], y * F.silu(z), cfg.rms_norm_eps)
    out = y.to(x.dtype) @ params["w_out"]
    return out, (conv_state, ssd_state)

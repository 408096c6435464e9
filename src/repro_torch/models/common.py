"""Shared building blocks of the decoder (port of
``repro/models/common.py``): the reference's fan-in initialiser, RMSNorm
and RoPE in float32, SwiGLU, and the GQA projections with the reference's
``(d, H, hd)`` / ``(H, hd, d)`` weight layouts.  Plain
``torch.matmul``/``einsum`` products, as the reference leaves these to XLA
outside any Pallas kernel.  :func:`apply_mrope` is Qwen2-VL's multimodal
RoPE, :func:`sinusoidal_positions` Whisper's fixed position embeddings,
:func:`maybe_remat` the train paths' activation checkpointing.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import shard


def dense_init_(out: torch.Tensor, generator: torch.Generator
                ) -> torch.Tensor:
    """Fill ``out`` as the reference's ``dense_init``: truncated normal in
    [−2, 2] scaled by 1/√fan_in (fan_in = the leading axis), drawn in
    float32 on ``out``'s device (``generator`` must live there).  Same
    distribution, not the same numbers."""
    t = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    t.mul_(1.0 / out.shape[0] ** 0.5)
    return out.copy_(t)


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(dtype)


def rope_frequencies(dim: int, theta: float, *, device=None) -> torch.Tensor:
    """(dim/2,) float32 inverse frequencies."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate ``(…, S, D)`` by per-token positions ``(…, S)`` — half-split
    (not interleaved), with the angles in float32 (a bf16 RoPE loses the
    angle at rope_theta ~ 2.8e8)."""
    if theta <= 0:
        return x
    d = x.shape[-1]
    inv = rope_frequencies(d, theta, device=x.device)
    ang = positions[..., None].to(torch.float32) * inv       # (…, S, D/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: rotate ``(…, S, D)`` by 3-D positions
    ``(3, …, S)`` (temporal, height, width ids); frequency slot ``i`` of
    the D/2 takes its angle from stream 0 for the first ``sections[0]``
    slots, stream 1 for the next ``sections[1]`` and stream 2 for the
    last ``sections[2]`` (Σ sections = D/2).  Equal streams give
    :func:`apply_rope`."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"D/2 = {d // 2}")
    inv = rope_frequencies(d, theta, device=x.device)           # (D/2,)
    sec = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(list(sections), device=x.device))          # (D/2,)
    pos = positions.movedim(0, -1).to(torch.float32)            # (…, S, 3)
    ang = pos[..., sec] * inv                                   # (…, S, D/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(num: int, dim: int, *, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings ``(num, dim)`` float32:
    sin then cos of ``pos · 10000^(−i / (dim/2 − 1))``."""
    pos = torch.arange(num, dtype=torch.float32, device=device)[:, None]
    inv = torch.exp(-math.log(10000.0) * torch.arange(
        dim // 2, dtype=torch.float32, device=device) / (dim // 2 - 1))
    ang = pos * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU."""
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    h = shard(h, "batch", None, "mlp")
    return h @ params["w_down"]


def gqa_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) @ w (d, H, hd) → (B, H, S, hd), contiguous."""
    d, h, hd = w.shape
    # the product's columns unsharded before they split into heads (a
    # DTensor cannot split a columns axis sharded finer than the heads);
    # gqa_qkv's sites place the heads
    y = shard(x @ w.reshape(d, h * hd), "batch")           # (B, S, H·hd)
    return y.reshape(*x.shape[:-1], h, hd).transpose(1, 2).contiguous()


def gqa_qkv(params, x: torch.Tensor):
    """x (B, S, d) → q (B, H, S, hd), k/v (B, Hkv, S, hd), contiguous."""
    q, k, v = (gqa_proj(x, params[n]) for n in ("wq", "wk", "wv"))
    return (shard(q, "batch", "heads"), shard(k, "batch", "kv_heads"),
            shard(v, "batch", "kv_heads"))


def gqa_out(params, attn: torch.Tensor) -> torch.Tensor:
    """attn (B, H, S, hd) → (B, S, d)."""
    b, h, s, hd = attn.shape
    flat = attn.transpose(1, 2).reshape(b, s, h * hd)
    return flat @ params["wo"].reshape(h * hd, -1)


def _save_matmuls(ctx, op, *args, **kwargs):
    """The ``dots`` policy: keep the products for the backward."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    return (CheckpointPolicy.MUST_SAVE
            if op in (aten.mm.default, aten.bmm.default, aten.addmm.default)
            else CheckpointPolicy.PREFER_RECOMPUTE)


def maybe_remat(fn, policy: str):
    """Wrap a layer body in activation checkpointing per the config's
    ``remat_policy`` (the reference's ``jax.checkpoint`` policies):
    ``full`` saves nothing inside the body and recomputes it in the
    backward (``nothing_saveable``); ``dots`` saves
    the matmul outputs (``mm``, ``bmm``, ``addmm``) and recomputes the
    rest (the reference's ``dots_with_no_batch_dims_saveable`` keeps the
    weight products; here every 2-D and batched product); any other
    policy (``none``) returns ``fn``.  All give the same values and
    gradients."""
    if policy not in ("full", "dots"):
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    extra = ({} if policy == "full" else {"context_fn": lambda:
              create_selective_checkpoint_contexts(_save_matmuls)})

    def wrapped(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False, **extra, **kwargs)
    return wrapped

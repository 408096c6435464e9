"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434; port of
``repro/models/mla.py``).

K/V are compressed into a latent ``c_kv`` of ``kv_lora_rank`` channels plus
one rotary key stream ``k_rope`` shared by every head; per-head keys and
values are up-projections of the latent.  The cache holds only ``(c_kv,
k_rope)``.  Prefill decompresses, so SharePrefill's pattern logic sees
ordinary per-head blocks: Q and K of width ``qk_nope + qk_rope`` and V of
width ``v_head_dim`` go through the strip (B.1) and the block-sparse
kernels (B.2, or B.6 per sample) at Dqk ≠ Dv.  Decode is the **absorbed**
form: ``q_nope`` is pushed through ``W_uk`` and scored against the latent
cache directly, attention runs in latent space and ``W_uv`` is applied
after it.  Projections and the absorbed decode are plain torch products, as
the reference computes them with ``jnp.einsum`` outside any Pallas kernel.

Leaves of one layer's ``attn`` (``::`` keys of :func:`mla_leaf_shapes`)::

    w_kv_down (d, R + r)    kv_norm::scale (R,)
    w_uk (R, H, nope)       w_uv (R, H, dv)       wo (H, dv, d)
    w_q (d, H, nope + r)                            when q_lora_rank == 0
    w_q_down (d, Rq)  q_norm::scale (Rq,)  w_q_up (Rq, H, nope + r)
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import share_attention as sa
from repro_torch.core.api import SharePrefill
from repro_torch.distributed.sharding import shard
from repro_torch.kernels.chunked import chunked_attention
from repro_torch.models import common
from repro_torch.models.attention import (PREFILL_METHODS, AttnStats,
                                          prefill_block_size,
                                          resolve_attention_fn)


def mla_leaf_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """One layer's attention leaves (flat ``::`` keys) and their shapes,
    with the reference's Q variant: ``w_q``, or the low-rank ``w_q_down``,
    ``q_norm`` and ``w_q_up`` when ``q_lora_rank > 0``."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    shapes = {"w_kv_down": (d, m.kv_lora_rank + m.qk_rope_head_dim),
              "kv_norm::scale": (m.kv_lora_rank,),
              "w_uk": (m.kv_lora_rank, h, m.qk_nope_head_dim),
              "w_uv": (m.kv_lora_rank, h, m.v_head_dim),
              "wo": (h, m.v_head_dim, d)}
    if m.q_lora_rank:
        shapes.update({"w_q_down": (d, m.q_lora_rank),
                       "q_norm::scale": (m.q_lora_rank,),
                       "w_q_up": (m.q_lora_rank, h, qk)})
    else:
        shapes["w_q"] = (d, h, qk)
    return shapes


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsr,rhk->bhsk")`` as one matmul: x (B, S, R), w (R, H, K)
    → (B, H, S, K), contiguous."""
    r, h, k = w.shape
    y = x @ w.reshape(r, h * k)
    return y.reshape(*x.shape[:-1], h, k).transpose(1, 2).contiguous()


def _project_q(params, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, d) → q_nope (B, H, S, nope), q_rope (B, H, S, r)."""
    m = cfg.mla
    if m.q_lora_rank:
        cq = common.rmsnorm(params["q_norm"], x @ params["w_q_down"],
                            cfg.rms_norm_eps)
        q = _heads(cq, params["w_q_up"])
    else:
        q = _heads(x, params["w_q"])
    return (shard(q[..., :m.qk_nope_head_dim], "batch", "heads"),
            shard(q[..., m.qk_nope_head_dim:], "batch", "heads"))


def _project_kv_latent(params, x: torch.Tensor, cfg: ModelConfig,
                       positions: torch.Tensor):
    """x (B, S, d) → c_kv (B, S, R) and k_rope (B, 1, S, r), rotated at
    ``positions (B, S)``."""
    m = cfg.mla
    down = x @ params["w_kv_down"]
    c_kv = common.rmsnorm(params["kv_norm"], down[..., :m.kv_lora_rank],
                          cfg.rms_norm_eps)
    k_rope = down[..., m.kv_lora_rank:][:, None]
    return c_kv, common.apply_rope(k_rope, positions[:, None, :],
                                   cfg.rope_theta)


def _decompress(params, c_kv: torch.Tensor):
    """c_kv (B, S, R) → k_nope (B, H, S, nope), v (B, H, S, dv)."""
    return (shard(_heads(c_kv, params["w_uk"]), "batch", "heads"),
            shard(_heads(c_kv, params["w_uv"]), "batch", "heads"))


def mla_qkv(params, x: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor):
    """Prefill's decompressed attention inputs: q and k ``(B, H, S, nope +
    r)`` (k's rope part the shared stream, broadcast over heads), v ``(B,
    H, S, dv)``, and the latent cache entries ``c_kv (B, S, R)``, ``k_rope
    (B, S, r)``."""
    q_nope, q_rope = _project_q(params, x, cfg)
    q_rope = common.apply_rope(q_rope, positions[:, None, :], cfg.rope_theta)
    c_kv, k_rope = _project_kv_latent(params, x, cfg, positions)
    k_nope, v = _decompress(params, c_kv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:-1],
                                         k_rope.shape[-1])], dim=-1)
    return q, k, v, c_kv, k_rope[:, 0]


def mla_train(params, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, block_size: int = 128
              ) -> torch.Tensor:
    """The training attention of one MLA layer: x (B, S, d) → (B, S, d),
    causal chunked attention over the decompressed q/k (``Dqk = nope +
    rope``) and v (``Dv``), as the reference's."""
    q, k, v, _, _ = mla_qkv(params, x, cfg, positions)
    out = chunked_attention(q, k, v, block_size=min(block_size, x.shape[1]),
                            causal=True)
    out = shard(out, "batch", "heads")
    return common.gqa_out(params, out)


def mla_prefill(params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, *, method: str, sp: SharePrefill,
                sp_state, cluster_ids: Optional[torch.Tensor],
                attn_impl: str = "auto", attn_width: Optional[int] = None):
    """One MLA layer of prefill: ``(y (B, S, d), (c_kv, k_rope), new
    sp_state, stats)``.  ``share`` at a length pattern sharing applies to
    runs SharePrefill through ``attn_impl``'s attention function (the
    batched kernels, or per sample); every other method, and ``share`` at
    other lengths, attends densely (plain chunked attention), leaving
    ``sp_state`` as it is, as the reference does."""
    if method not in PREFILL_METHODS:
        raise ValueError(f"unknown prefill method {method!r}; expected one "
                         f"of {PREFILL_METHODS}")
    s = x.shape[1]
    q, k, v, c_kv, k_rope = mla_qkv(params, x, cfg, positions)
    if method == "share" and sp.applicable(s):
        attention_fn = resolve_attention_fn(
            attn_impl, prefill_block_size(sp, s), width=attn_width)
        out, sp_state, ls = sa.batched_share_prefill_attention_layer(
            q, k, v, sp_state, cluster_ids, sp.cfg, attention_fn)
        stats = AttnStats(ls.num_shared, ls.num_dense, ls.num_vs,
                          ls.block_density, ls.max_row_pop)
    else:
        out = chunked_attention(q, k, v, block_size=min(128, s), causal=True)
        stats = AttnStats.zero(x.device)
    out = shard(out, "batch", "heads")
    return common.gqa_out(params, out), (c_kv, k_rope), sp_state, stats


def mla_decode(params, x: torch.Tensor, cfg: ModelConfig,
               cache_ckv: torch.Tensor, cache_krope: torch.Tensor, pos: int,
               positions: torch.Tensor) -> torch.Tensor:
    """Absorbed decode of one token a row: x (B, 1, d) at the lockstep
    cache slot ``pos`` and rope positions ``(B, 1)``; the latent cache
    ``(B, S, R)`` / ``(B, S, r)`` is written in place at ``pos``.  Scores
    ``(q_nope · W_uk) · c_kv + q_rope · k_rope`` over ``1/√(nope + r)``
    against every slot ``≤ pos`` (pads included, as in the reference), the
    softmax in float32, attention in latent space, then ``W_uv`` and
    ``wo``.  Returns ``(B, 1, d)``."""
    m = cfg.mla
    q_nope, q_rope = _project_q(params, x, cfg)            # (B, H, 1, ·)
    q_rope = common.apply_rope(q_rope, positions[:, None, :], cfg.rope_theta)
    c_new, k_rope_new = _project_kv_latent(params, x, cfg, positions)
    cache_ckv[:, pos] = c_new[:, 0]
    cache_krope[:, pos] = k_rope_new[:, 0, 0]
    cache_ckv = shard(cache_ckv, "batch", "seq")
    q_lat = torch.einsum("bhqk,rhk->bhqr", q_nope, params["w_uk"])
    scale = 1.0 / ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** 0.5)
    logits = (torch.einsum("bhqr,bsr->bhqs", q_lat, cache_ckv)
              + torch.einsum("bhqk,bsk->bhqs", q_rope, cache_krope)) * scale
    s = cache_ckv.shape[1]
    live = torch.arange(s, device=x.device) <= pos
    p = torch.softmax(logits.float().masked_fill(~live, float("-inf")),
                      dim=-1)
    lat = torch.einsum("bhqs,bsr->bhqr", p, cache_ckv.float())
    out = torch.einsum("bhqr,rhk->bhqk", lat, params["w_uv"].float())
    return common.gqa_out(params, out.to(x.dtype))

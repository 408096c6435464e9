"""Decoder-only transformer for the ``dense`` and ``moe`` families (port of
``repro/models/transformer.py``).

Parameters are a plain dict (see :mod:`repro_torch.checkpoint`): ``embed``,
``final_norm``, ``lm_head`` and ``layers``, a list of per-layer dicts
``{attn: {wq, wk, wv, wo}, ffn: {w_gate, w_up, w_down}, ln1, ln2}``; a MoE
layer's ``ffn`` holds the router and the expert stacks
(:mod:`repro_torch.models.moe`).  The reference's ``lax.scan`` over stacked
layers is a Python loop here; the SharePrefill dictionary state is carried
from layer to layer.  The KV cache is a pair of stacked tensors ``(L, B,
Hkv, S, hd)``.  A config's ``sliding_window`` (Mixtral) bands the decode's
validity mask; prefill applies it in :mod:`repro_torch.models.attention`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import SharePrefill
from repro_torch.kernels.decode_attn import DecodePlan
from repro_torch.models import attention as attn
from repro_torch.models import common, moe

Cache = Tuple[torch.Tensor, torch.Tensor]


class PrefillResult(NamedTuple):
    last_logits: torch.Tensor       # (B, V)
    cache: Cache
    stats: attn.AttnStats
    sp_state: object


def logits_from_hidden(params, cfg: ModelConfig,
                       x: torch.Tensor) -> torch.Tensor:
    x = common.rmsnorm(params["final_norm"], x, cfg.rms_norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def num_prefix_layers(cfg: ModelConfig) -> int:
    """Layers outside the uniform stack (DeepSeek-V2's dense-FFN first
    layer in the reference); 0 for every family the port serves."""
    return 1 if (cfg.moe.enabled and cfg.mla.enabled) else 0


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    return params["embed"][tokens]


def _uses_moe(cfg: ModelConfig) -> bool:
    return cfg.moe.enabled


def _ffn_apply(layer, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One layer's FFN on its ln2-normed input: the MoE FFN for the
    ``moe`` family (its aux losses are for training and dropped here),
    else the SwiGLU MLP."""
    if _uses_moe(cfg):
        return moe.moe_apply(layer["ffn"], h, cfg)[0]
    return common.mlp(layer["ffn"], h)


def _ffn_block(layer, x, cfg: ModelConfig) -> torch.Tensor:
    h = common.rmsnorm(layer["ln2"], x, cfg.rms_norm_eps)
    return x + _ffn_apply(layer, h, cfg)


def layer_prefill(layer, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, sp: SharePrefill, sp_state,
                  cluster_ids: Optional[torch.Tensor], *, method: str,
                  attn_impl: str, attn_width: Optional[int] = None):
    """One layer of prefill: ``(x, (k, v), sp_state, stats)``."""
    h = common.rmsnorm(layer["ln1"], x, cfg.rms_norm_eps)
    a, cache, sp_state, stats = attn.attention_prefill(
        layer["attn"], h, cfg, positions, method=method, sp=sp,
        sp_state=sp_state, cluster_ids=cluster_ids, attn_impl=attn_impl,
        attn_width=attn_width)
    return _ffn_block(layer, x + a, cfg), cache, sp_state, stats


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            sp: SharePrefill, *, method: str = "share",
            attn_impl: str = "auto", attn_width: Optional[int] = None,
            prompt_lens: Optional[torch.Tensor] = None) -> PrefillResult:
    """Prefill the padded batch ``tokens (B, S)``.  ``prompt_lens`` gathers
    each row's last logits at its real last token (``prompt_len − 1``)
    instead of the padded final position.  Chunked prefill
    (:mod:`repro_torch.models.chunked_prefill`) runs the same pieces in
    quanta."""
    b, s = tokens.shape
    device = tokens.device
    positions = torch.arange(s, device=device)[None].expand(b, s)
    x = embed_tokens(params, cfg, tokens)

    sharing = sp.cfg.enabled and sp.applicable(s)
    sp_state = sp.init_state(b, s, device=device) if sharing else None
    cluster_arr = sp.layer_cluster_ids(device=device) if sharing else None

    hd = cfg.resolved_head_dim
    shape = (cfg.num_layers, b, cfg.num_kv_heads, s, hd)
    cache_k = torch.empty(shape, dtype=x.dtype, device=device)
    cache_v = torch.empty(shape, dtype=x.dtype, device=device)
    stats = []
    for li, layer in enumerate(params["layers"]):
        ids = cluster_arr[li] if cluster_arr is not None else None
        x, (k, v), sp_state, st = layer_prefill(
            layer, x, cfg, positions, sp, sp_state, ids, method=method,
            attn_impl=attn_impl, attn_width=attn_width)
        cache_k[li], cache_v[li] = k, v
        stats.append(st)

    if prompt_lens is None:
        last = x[:, -1, :]
    else:
        rows = torch.clamp(prompt_lens.long(), 1, s) - 1
        last = x[torch.arange(b, device=device), rows, :]
    return PrefillResult(logits_from_hidden(params, cfg, last),
                         (cache_k, cache_v),
                         attn.AttnStats.reduce_layers(stats), sp_state)


def decode_valid_mask(cache_len: int, pos, prompt_lens: torch.Tensor,
                      prefill_len) -> torch.Tensor:
    """(B, S) slot validity: written (≤ pos) and not right-pad of a shorter
    prompt (pad slots are ``[prompt_len, prefill_len)``).  ``pos`` and
    ``prefill_len`` are ints (lockstep) or per-row (B,) tensors (the slot
    scheduler, where buckets and positions differ per slot)."""
    b, dev = prompt_lens.shape[0], prompt_lens.device
    slots = torch.arange(cache_len, device=dev)[None, :]
    return ((slots <= attn.row_positions(pos, b, dev))
            & ((slots < prompt_lens[:, None])
               | (slots >= attn.row_positions(prefill_len, b, dev))))


def window_valid_mask(valid: Optional[torch.Tensor], cache_len: int, pos,
                      window: int, b: int, device) -> torch.Tensor:
    """``valid`` (or, without it, every slot ≤ pos) ANDed with the sliding
    window's band ``(pos − window, pos]``, per row: the reference's
    token-level window term of the decode mask (no sink)."""
    slots = torch.arange(cache_len, device=device)[None, :]
    pcol = attn.row_positions(pos, b, device)
    band = (slots > pcol - window) & (slots <= pcol)
    return band if valid is None else valid & band


def decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                cache: Cache, pos, *,
                plan: Optional[DecodePlan] = None,     # (L, B, …) leaves
                prompt_lens: Optional[torch.Tensor] = None,   # (B,)
                prefill_len=0,
                decode_impl: str = "auto",
                page_table: Optional[torch.Tensor] = None,    # (B, NB)
                collect_queries: bool = False,
                window: int = 0,
                ):
    """One decode step: token (B, 1) → logits (B, V), and the cache.

    ``pos`` is the lockstep write index (an int) or a ``(B,)`` tensor of
    per-slot positions, which then also give each row its rope position;
    ``prefill_len`` is an int or a ``(B,)`` tensor of per-slot prefill
    lengths (slots of different buckets under paging).  ``page_table``
    switches the cache to the block-paged pools ``(L, P, Hkv, ps, hd)``,
    read and appended through the table; the logical cache length is then
    ``page_table.shape[1] · ps``.  The cache is updated in place and
    returned.

    ``collect_queries`` also returns every layer's post-rope query
    ``(L, B, H, hd)`` as a third output (refresh's window capture); it
    needs a plan, as in the reference.  The logits are those of the step
    without it.

    ``window`` (default: the config's ``sliding_window``) keeps only the
    last ``window`` positions of each row visible, at token granularity;
    a plan's blocks are not narrowed by it, so a kept block the band hides
    wholly streams and weighs nothing."""
    if collect_queries and plan is None:
        raise ValueError("collect_queries requires a DecodePlan (the "
                         "refresh path is sparse paged decode)")
    b = token.shape[0]
    cache_k, cache_v = cache
    if page_table is not None and not (isinstance(pos, torch.Tensor)
                                       and pos.dim()):
        raise ValueError("paged decode requires per-slot (vector) pos")
    positions = attn.row_positions(pos, b, token.device)
    x = embed_tokens(params, cfg, token)
    window = window or cfg.sliding_window
    s = (page_table.shape[1] * cache_k.shape[3] if page_table is not None
         else cache_k.shape[3])
    valid = None
    if prompt_lens is not None:
        valid = decode_valid_mask(s, pos, prompt_lens, prefill_len)
    if window > 0:
        valid = window_valid_mask(valid, s, pos, window, b, token.device)
    qs = []
    for li, layer in enumerate(params["layers"]):
        h = common.rmsnorm(layer["ln1"], x, cfg.rms_norm_eps)
        a = attn.attention_decode(
            layer["attn"], h, cfg, cache_k[li], cache_v[li], pos, positions,
            valid_mask=valid, plan=None if plan is None else plan.layer(li),
            decode_impl=decode_impl, page_table=page_table,
            return_q=collect_queries)
        if collect_queries:
            a, q = a
            qs.append(q)
        x = _ffn_block(layer, x + a, cfg)
    logits = logits_from_hidden(params, cfg, x[:, -1, :])
    if collect_queries:
        return logits, cache, torch.stack(qs)
    return logits, cache


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               dtype=torch.float32, device=None) -> Cache:
    """Empty KV cache ``((L, B, Hkv, S, hd), (L, B, Hkv, S, hd))``."""
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, cache_len,
             cfg.resolved_head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))

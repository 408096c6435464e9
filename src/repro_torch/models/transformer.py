"""Decoder-only transformer for the ``dense``, ``vlm`` and ``moe`` families
(port of ``repro/models/transformer.py``).

Parameters are a plain dict (see :mod:`repro_torch.checkpoint`): ``embed``,
``final_norm``, ``lm_head`` and ``layers``, a list of per-layer dicts
``{attn: {wq, wk, wv, wo}, ffn: {w_gate, w_up, w_down}, ln1, ln2}``; a MoE
layer's ``ffn`` holds the router and the expert stacks
(:mod:`repro_torch.models.moe`), an MLA layer's ``attn`` the latent
projections (:mod:`repro_torch.models.mla`).  DeepSeek-V2 (MoE with MLA)
has :func:`num_prefix_layers` dense-FFN layers ahead of the stack: they are
the first entries of ``layers``.  The reference's ``lax.scan`` over stacked
layers is a Python loop here; the SharePrefill dictionary state is carried
from layer to layer.  The KV cache is a pair of stacked tensors ``(L, B,
Hkv, S, hd)``; MLA's latent cache is ``{"prefix": [(c_kv (B, S, R), k_rope
(B, S, r))], "stack": (c_kv (L', B, S, R), k_rope (L', B, S, r))}`` over
the prefix layers and the ``L'`` stacked ones, as in the reference.  A
config's ``sliding_window`` (Mixtral) bands the decode's validity mask;
prefill applies it in :mod:`repro_torch.models.attention`.  A VLM takes
``embeds`` (pre-projected patch embeddings in place of the token
embedding) and 3-D M-RoPE ``positions``; without them it is the dense
path under plain RoPE.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import SharePrefill
from repro_torch.distributed.sharding import empty_stack, shard
from repro_torch.kernels.decode_attn import DecodePlan
from repro_torch.models import attention as attn
from repro_torch.models import common, mla, moe

Cache = Tuple[torch.Tensor, torch.Tensor]


class PrefillResult(NamedTuple):
    last_logits: torch.Tensor       # (B, V)
    cache: object                   # Cache, or MLA's latent dict
    stats: attn.AttnStats
    sp_state: object


def logits_from_hidden(params, cfg: ModelConfig,
                       x: torch.Tensor) -> torch.Tensor:
    with tracing.span("model.head"):
        x = common.rmsnorm(params["final_norm"], x, cfg.rms_norm_eps)
        # the product's operands placed first, the hidden over the batch
        # and the table over the vocabulary: a DTensor product of a
        # model-partial hidden and an FSDP-split table gathers both (every
        # rank held the training step's global (B, S, V) logits)
        x = shard(x, "batch")
        w = (shard(params["embed"], "vocab").T if cfg.tie_embeddings
             else shard(params["lm_head"], None, "vocab"))
        return shard(x @ w, "batch", None, "vocab")


def num_prefix_layers(cfg: ModelConfig) -> int:
    """Layers outside the uniform stack: DeepSeek-V2's dense-FFN first
    layer (MoE with MLA)."""
    return 1 if (cfg.moe.enabled and cfg.mla.enabled) else 0


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    # the table over the vocabulary alone before the lookup (an FSDP-split
    # table's lookup gathered the batch's whole (B, S, d) on every rank)
    return shard(shard(params["embed"], "vocab")[tokens], "batch")


def _ffn_apply(layer, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One layer's FFN on its ln2-normed input: the MoE FFN where the layer
    holds a router (every layer of a ``moe`` config but its prefix layers;
    its aux losses are for training, :func:`_ffn_train`), else the SwiGLU
    MLP."""
    if "router" in layer["ffn"]:
        return moe.moe_apply(layer["ffn"], h, cfg)[0]
    return common.mlp(layer["ffn"], h)


def _ffn_train(layer, h: torch.Tensor, cfg: ModelConfig):
    """:func:`_ffn_apply` with the MoE FFN's aux losses ``(load balance,
    router z)``, zeros for the SwiGLU MLP."""
    if "router" in layer["ffn"]:
        y, aux = moe.moe_apply(layer["ffn"], h, cfg)
        return y, (aux.load_balance_loss, aux.router_z_loss)
    zero = torch.zeros((), device=h.device)
    return common.mlp(layer["ffn"], h), (zero, zero)


def _ffn_block(layer, x, cfg: ModelConfig) -> torch.Tensor:
    with tracing.span("ffn"):
        h = common.rmsnorm(layer["ln2"], x, cfg.rms_norm_eps)
        return x + _ffn_apply(layer, h, cfg)


def zero_aux(device) -> dict:
    """The aux losses of a stack without a MoE FFN: zeros."""
    z = torch.zeros((), device=device)
    return {"load_balance_loss": z, "router_z_loss": z}


def layer_train(layer, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor):
    """One layer of the training forward: ``(x, (load balance, router z))``
    with the attention over the whole sequence
    (:func:`~repro_torch.models.attention.attention_train`, or
    :func:`~repro_torch.models.mla.mla_train`)."""
    h = common.rmsnorm(layer["ln1"], x, cfg.rms_norm_eps)
    attn_fn = mla.mla_train if cfg.mla.enabled else attn.attention_train
    x = x + attn_fn(layer["attn"], h, cfg, positions)
    h = common.rmsnorm(layer["ln2"], x, cfg.rms_norm_eps)
    f, aux = _ffn_train(layer, h, cfg)
    return x + f, aux


def forward_train(params, cfg: ModelConfig, tokens: Optional[torch.Tensor],
                  positions: Optional[torch.Tensor] = None,
                  embeds: Optional[torch.Tensor] = None):
    """tokens (B, S) → (logits (B, S, V), aux losses); a VLM passes
    ``embeds`` and 3-D positions.  The stack's layers (not the prefix
    layers) run under the config's ``remat_policy``, and the aux losses
    are their means over the stack, as the reference's scan gives them."""
    x = embeds if embeds is not None else embed_tokens(params, cfg, tokens)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    n_prefix = num_prefix_layers(cfg)
    body = common.maybe_remat(layer_train, cfg.remat_policy)
    lb = zl = torch.zeros((), device=x.device)
    for li, layer in enumerate(params["layers"]):
        if li < n_prefix:
            x, _ = layer_train(layer, x, cfg, positions)
            continue
        x, (l1, l2) = body(layer, x, cfg, positions)
        lb, zl = lb + l1, zl + l2
    n_stack = max(cfg.num_layers - n_prefix, 1)
    return logits_from_hidden(params, cfg, x), {
        "load_balance_loss": lb / n_stack, "router_z_loss": zl / n_stack}


def layer_prefill(layer, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, sp: SharePrefill, sp_state,
                  cluster_ids: Optional[torch.Tensor], *, method: str,
                  attn_impl: str, attn_width: Optional[int] = None):
    """One layer of prefill: ``(x, cache entry, sp_state, stats)``; the
    entry is ``(k, v)``, or MLA's ``(c_kv, k_rope)``."""
    with tracing.span("attn.qkv"):
        h = common.rmsnorm(layer["ln1"], x, cfg.rms_norm_eps)
    layer_fn = mla.mla_prefill if cfg.mla.enabled else attn.attention_prefill
    a, cache, sp_state, stats = layer_fn(
        layer["attn"], h, cfg, positions, method=method, sp=sp,
        sp_state=sp_state, cluster_ids=cluster_ids, attn_impl=attn_impl,
        attn_width=attn_width)
    return _ffn_block(layer, x + a, cfg), cache, sp_state, stats


def prefill(params, cfg: ModelConfig, tokens: Optional[torch.Tensor],
            sp: SharePrefill, *, method: str = "share",
            attn_impl: str = "auto", attn_width: Optional[int] = None,
            prompt_lens: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None) -> PrefillResult:
    """Prefill the padded batch ``tokens (B, S)``, or ``embeds (B, S, d)``
    in place of their embedding.  ``positions`` are the rope positions
    ``(B, S)`` (default ``arange``) or a VLM's M-RoPE ``(3, B, S)``.
    ``prompt_lens`` gathers each row's last logits at its real last token
    (``prompt_len − 1``) instead of the padded final position.  Chunked
    prefill (:mod:`repro_torch.models.chunked_prefill`) runs the same
    pieces in quanta."""
    x = embeds if embeds is not None else embed_tokens(params, cfg, tokens)
    b, s = x.shape[:2]
    device = x.device
    if positions is None:
        positions = torch.arange(s, device=device)[None].expand(b, s)

    sharing = sp.cfg.enabled and sp.applicable(s)
    sp_state = sp.init_state(b, s, device=device) if sharing else None
    cluster_arr = sp.layer_cluster_ids(device=device) if sharing else None

    # prefix layers' entries as they are; the stack's copied into (L', …)
    # tensors allocated at the first one, so each layer's own can go (on
    # DTensors, each rank's shard of the stack alone: empty_stack)
    n_prefix = num_prefix_layers(cfg)
    prefix, stack, stats = [], None, []
    for li, layer in enumerate(params["layers"]):
        ids = cluster_arr[li] if cluster_arr is not None else None
        x, entry, sp_state, st = layer_prefill(
            layer, x, cfg, positions, sp, sp_state, ids, method=method,
            attn_impl=attn_impl, attn_width=attn_width)
        if li < n_prefix:           # the reference reduces the stack's stats
            prefix.append(entry)
            continue
        if stack is None:
            stack = tuple(empty_stack(t, cfg.num_layers - n_prefix)
                          for t in entry)
        for dst, t in zip(stack, entry):
            dst[li - n_prefix] = t
        stats.append(st)

    if prompt_lens is None:
        last = x[:, -1, :]
    else:
        rows = torch.clamp(prompt_lens.long(), 1, s) - 1
        last = x[torch.arange(b, device=device), rows, :]
    cache = {"prefix": prefix, "stack": stack} if cfg.mla.enabled else stack
    return PrefillResult(logits_from_hidden(params, cfg, last), cache,
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


def decode_step(params, cfg: ModelConfig, token: Optional[torch.Tensor],
                cache, pos, *,
                positions: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None,
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
    per-slot positions, which then also give each row its rope position
    unless ``positions`` gives them (``(B, 1)``, or a VLM's M-RoPE ``(3,
    B, 1)``); ``embeds (B, 1, d)`` replaces the token's embedding.
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
    wholly streams and weighs nothing.

    MLA's latent cache takes the lockstep scalar ``pos`` only, and no page
    table; its absorbed decode attends every slot ≤ ``pos`` (``prompt_lens``
    and ``plan`` are not read), as the reference's does."""
    if collect_queries and plan is None:
        raise ValueError("collect_queries requires a DecodePlan (the "
                         "refresh path is sparse paged decode)")
    x = embeds if embeds is not None else embed_tokens(params, cfg, token)
    b, dev = x.shape[0], x.device
    vector_pos = isinstance(pos, torch.Tensor) and pos.dim() > 0
    if cfg.mla.enabled and (vector_pos or page_table is not None):
        raise ValueError(
            "per-slot decode positions and page tables require the GQA "
            "cache layout; MLA latent caches keep the lockstep scalar pos "
            "(serve them through the batch path)")
    if page_table is not None and not vector_pos:
        raise ValueError("paged decode requires per-slot (vector) pos")
    if positions is None:
        positions = attn.row_positions(pos, b, dev)
    if cfg.mla.enabled:
        if collect_queries:
            raise ValueError("collect_queries is a GQA decode contract; "
                             "MLA layers never carry a DecodePlan")
        return _decode_step_mla(params, cfg, x, cache, int(pos), positions)
    cache_k, cache_v = cache
    window = window or cfg.sliding_window
    s = (page_table.shape[1] * cache_k.shape[3] if page_table is not None
         else cache_k.shape[3])
    valid = None
    if prompt_lens is not None:
        valid = decode_valid_mask(s, pos, prompt_lens, prefill_len)
    if window > 0:
        valid = window_valid_mask(valid, s, pos, window, b, dev)
    qs = []
    for li, layer in enumerate(params["layers"]):
        with tracing.span("attn.qkv"):
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


def _decode_step_mla(params, cfg: ModelConfig, x: torch.Tensor, cache,
                     pos: int, positions: torch.Tensor):
    """:func:`decode_step` over MLA's latent cache (absorbed decode)."""
    n_prefix = num_prefix_layers(cfg)
    ckv, krope = cache["stack"]
    for li, layer in enumerate(params["layers"]):
        c = (cache["prefix"][li] if li < n_prefix
             else (ckv[li - n_prefix], krope[li - n_prefix]))
        h = common.rmsnorm(layer["ln1"], x, cfg.rms_norm_eps)
        a = mla.mla_decode(layer["attn"], h, cfg, c[0], c[1], pos, positions)
        x = _ffn_block(layer, x + a, cfg)
    return logits_from_hidden(params, cfg, x[:, -1, :]), cache


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               dtype=torch.float32, device=None):
    """Empty KV cache ``((L, B, Hkv, S, hd), (L, B, Hkv, S, hd))``, or MLA's
    latent dict (module docstring)."""
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    if cfg.mla.enabled:
        n_prefix = num_prefix_layers(cfg)
        r, rr = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
        n = cfg.num_layers - n_prefix
        return {"prefix": [(zeros(batch, cache_len, r),
                            zeros(batch, cache_len, rr))
                           for _ in range(n_prefix)],
                "stack": (zeros(n, batch, cache_len, r),
                          zeros(n, batch, cache_len, rr))}
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, cache_len,
             cfg.resolved_head_dim)
    return zeros(*shape), zeros(*shape)

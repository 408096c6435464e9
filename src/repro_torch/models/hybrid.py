"""RecurrentGemma hybrid stack (port of ``repro/models/hybrid.py``):
(recurrent, recurrent, local-attention) × ``n_super`` super-blocks, then
the trailing recurrent layers (38 layers at full size: 12 super-blocks and
2 trailing, a 1:2 ratio).

Local-attention layers keep a ring-buffer KV cache of ``local_attn_window``
slots (slot = position mod W), so decode memory is O(window).  They prefill
through :func:`repro_torch.models.attention.attention_prefill` with the
config's ``sliding_window`` set to the window, so SharePrefill runs under
window ∧ sparse masks (B.1 and B.2, or B.6 per sample), and decode densely
over the ring, with no plan.  One cluster-id row goes to each super-block's
attention layer: rows ``[:n_super]`` of the SharePrefill's table.

Parameters (:mod:`repro_torch.checkpoint`): ``embed``, ``final_norm``,
``lm_head``, ``stack`` (a list of ``n_super`` dicts ``{rec1, rec2, attn}``)
and ``trail_0``, ``trail_1``, …; each sublayer is ``{mixer, mlp, ln1,
ln2}``, the mixer an RG-LRU block (:mod:`repro_torch.models.rglru`) or the
GQA projections.  The cache is ``{"stack": ((conv, h), (conv, h), (k, v)),
"prefix": [(conv, h), …]}``: conv ``(n_super, B, conv_width − 1, W)``, h
``(n_super, B, W)`` float32 and the rings ``(n_super, B, Hkv, window,
hd)``; the trailing layers' states unstacked.  Decode updates it in place.
Prefill pads every ring to ``local_attn_window`` slots while
:func:`init_cache` makes ``min(window, cache_len)``, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import SharePrefill
from repro_torch.models import attention as attn_mod
from repro_torch.models import common
from repro_torch.models.attention import AttnStats
from repro_torch.models.rglru import (recurrent_block_decode,
                                      recurrent_block_forward)
from repro_torch.models.transformer import (PrefillResult, embed_tokens,
                                            logits_from_hidden, zero_aux)

SUPER = 3       # layers per super-block: rec, rec, attn


def _attn_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg,
                               sliding_window=cfg.rglru.local_attn_window)


def _counts(cfg: ModelConfig) -> Tuple[int, int]:
    n_super = cfg.num_layers // SUPER
    n_trail = cfg.num_layers - n_super * SUPER       # trailing recurrents
    return n_super, n_trail


def _mlp_block(layer, x, cfg: ModelConfig) -> torch.Tensor:
    h = common.rmsnorm(layer["ln2"], x, cfg.rms_norm_eps)
    return x + common.mlp(layer["mlp"], h)


def _sub_forward(layer, x, cfg: ModelConfig):
    """A full-sequence recurrent sublayer: (x, (conv_state, h_last))."""
    h = common.rmsnorm(layer["ln1"], x, cfg.rms_norm_eps)
    y, state = recurrent_block_forward(layer["mixer"], h, cfg)
    return _mlp_block(layer, x + y, cfg), state


def _attn_train_sub(layer, x, cfg: ModelConfig, positions):
    """A local-attention sublayer over the whole sequence (training)."""
    h = common.rmsnorm(layer["ln1"], x, cfg.rms_norm_eps)
    y = attn_mod.attention_train(layer["mixer"], h, _attn_cfg(cfg), positions)
    return _mlp_block(layer, x + y, cfg)


def forward_train(params, cfg: ModelConfig, tokens, positions=None,
                  embeds=None):
    """tokens (B, S) → (logits (B, S, V), zero aux losses): each
    super-block's rec, rec and local-attention sublayers under the
    config's ``remat_policy``, then the trailing recurrent layers."""
    x = embeds if embeds is not None else embed_tokens(params, cfg, tokens)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)

    def body(block, x):
        x, _ = _sub_forward(block["rec1"], x, cfg)
        x, _ = _sub_forward(block["rec2"], x, cfg)
        return _attn_train_sub(block["attn"], x, cfg, positions)

    body = common.maybe_remat(body, cfg.remat_policy)
    for block in params["stack"]:
        x = body(block, x)
    for i in range(_counts(cfg)[1]):
        x, _ = _sub_forward(params[f"trail_{i}"], x, cfg)
    return logits_from_hidden(params, cfg, x), zero_aux(x.device)


def _ring(k: torch.Tensor, wcap: int) -> torch.Tensor:
    """The last ``wcap`` positions of ``k (B, Hkv, S, hd)`` at slot
    position mod ``wcap``; zero-padded on the right when S < wcap."""
    s = k.shape[2]
    if s < wcap:
        return torch.cat([k, k.new_zeros(
            k.shape[:2] + (wcap - s,) + k.shape[3:])], dim=2)
    slots = (torch.arange(wcap, device=k.device) + s - wcap) % wcap
    ring = k.new_zeros(k.shape[:2] + (wcap,) + k.shape[3:])
    ring[:, :, slots] = k[:, :, -wcap:]
    return ring


def _attn_prefill_sub(layer, x, cfg: ModelConfig, positions, sp, sp_state,
                      ids, method: str, attn_impl: str):
    h = common.rmsnorm(layer["ln1"], x, cfg.rms_norm_eps)
    y, (k, v), sp_state, stats = attn_mod.attention_prefill(
        layer["mixer"], h, _attn_cfg(cfg), positions, method=method, sp=sp,
        sp_state=sp_state, cluster_ids=ids, attn_impl=attn_impl)
    x = _mlp_block(layer, x + y, cfg)
    wcap = cfg.rglru.local_attn_window
    return x, (_ring(k, wcap), _ring(v, wcap)), sp_state, stats


def _stack(states) -> tuple:
    """Per-layer tuples of tensors → one tuple of (L, …) tensors."""
    return tuple(torch.stack(list(col)) for col in zip(*states))


def prefill(params, cfg: ModelConfig, tokens, sp: SharePrefill, *,
            method: str = "share", attn_impl: str = "auto", positions=None,
            embeds=None) -> PrefillResult:
    """Prefill the padded batch ``tokens (B, S)`` (or ``embeds (B, S, d)``);
    each row's last logits are at the padded final position (the family
    takes no ``prompt_lens``), as in the reference."""
    x = embeds if embeds is not None else embed_tokens(params, cfg, tokens)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    n_super, _ = _counts(cfg)

    use_sp = sp.cfg.enabled and sp.applicable(s)
    sp_state = sp.init_state(b, s, device=x.device) if use_sp else None
    ids = (sp.layer_cluster_ids(device=x.device)[:n_super] if use_sp
           else None)

    rec1, rec2, rings, stats = [], [], [], []
    for i, block in enumerate(params["stack"]):
        x, st1 = _sub_forward(block["rec1"], x, cfg)
        x, st2 = _sub_forward(block["rec2"], x, cfg)
        x, kv, sp_state, st = _attn_prefill_sub(
            block["attn"], x, cfg, positions, sp, sp_state,
            None if ids is None else ids[i], method, attn_impl)
        rec1.append(st1)
        rec2.append(st2)
        rings.append(kv)
        stats.append(st)

    trail = []
    for i in range(cfg.num_layers - n_super * SUPER):
        x, st = _sub_forward(params[f"trail_{i}"], x, cfg)
        trail.append(st)

    logits = logits_from_hidden(params, cfg, x[:, -1, :])
    stats = (AttnStats.reduce_layers(stats) if n_super
             else AttnStats.zero(device=x.device))
    cache = {"stack": (_stack(rec1), _stack(rec2), _stack(rings)),
             "prefix": trail}
    return PrefillResult(logits, cache, stats, sp_state)


def _rec_decode(layer, x, cfg: ModelConfig, conv, h):
    hn = common.rmsnorm(layer["ln1"], x, cfg.rms_norm_eps)
    y, state = recurrent_block_decode(layer["mixer"], hn, cfg, conv, h)
    return _mlp_block(layer, x + y, cfg), state


def _attn_decode(layer, x, cfg: ModelConfig, ck, cv, pos: int, positions):
    """Dense decode over the ring, written in place at slot ``pos mod
    w``: once ``pos ≥ w`` every slot holds a live (windowed) entry."""
    h = common.rmsnorm(layer["ln1"], x, cfg.rms_norm_eps)
    w = ck.shape[2]
    slots = torch.arange(w, device=x.device)
    valid = (slots <= pos) | (pos >= w)
    y = attn_mod.attention_decode(
        layer["mixer"], h, _attn_cfg(cfg), ck, cv, pos % w, positions,
        valid_mask=valid[None].expand(x.shape[0], w))
    return _mlp_block(layer, x + y, cfg)


def decode_step(params, cfg: ModelConfig, token, cache, pos, positions=None,
                *, window: int = 0, embeds=None):
    """One token through every sublayer at the lockstep position ``pos`` (an
    int or a 0-d tensor); ``cache``'s states and rings are updated in place
    and returned.  ``window`` is unused: the rings carry the window."""
    x = embeds if embeds is not None else embed_tokens(params, cfg, token)
    b = x.shape[0]
    if isinstance(pos, torch.Tensor) and pos.dim():
        raise ValueError("the hybrid family decodes at one lockstep pos")
    pos = int(pos)
    if positions is None:
        positions = attn_mod.row_positions(pos, b, x.device)
    if params["stack"]:
        (c1, h1), (c2, h2), (ck, cv) = cache["stack"]
    for i, block in enumerate(params["stack"]):
        x, (c1[i], h1[i]) = _rec_decode(block["rec1"], x, cfg, c1[i], h1[i])
        x, (c2[i], h2[i]) = _rec_decode(block["rec2"], x, cfg, c2[i], h2[i])
        x = _attn_decode(block["attn"], x, cfg, ck[i], cv[i], pos, positions)
    trail = cache["prefix"]
    for i, (conv, h) in enumerate(trail):
        x, trail[i] = _rec_decode(params[f"trail_{i}"], x, cfg, conv, h)
    return logits_from_hidden(params, cfg, x[:, -1, :]), cache


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               dtype=torch.float32, device=None):
    """Zeroed states (O(1) in length) and rings of ``min(window,
    cache_len)`` slots."""
    n_super, n_trail = _counts(cfg)
    w, cw = cfg.rglru.lru_width, cfg.rglru.conv_width
    wloc = min(cfg.rglru.local_attn_window, cache_len)
    hd = cfg.resolved_head_dim
    zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt,
                                                 device=device)
    rec = lambda *lead: (zeros(*lead, batch, cw - 1, w),
                         zeros(*lead, batch, w, dt=torch.float32))
    kv = (zeros(n_super, batch, cfg.num_kv_heads, wloc, hd),
          zeros(n_super, batch, cfg.num_kv_heads, wloc, hd))
    return {"stack": (rec(n_super), rec(n_super), kv),
            "prefix": [rec() for _ in range(n_trail)]}

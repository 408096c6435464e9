"""Mamba-2 decoder stack, attention-free (port of
``repro/models/ssm_stack.py``).

Parameters (:mod:`repro_torch.checkpoint`: ``init_params`` draws them,
``params_from_numpy`` carries the reference's across) are ``embed``,
``final_norm``, ``lm_head`` and ``layers``, a list of ``{ssm: …, ln:
{scale}}`` (:mod:`repro_torch.models.ssm`).  The cache is ``{"stack":
(conv (L, B, W-1, conv_dim), ssd (L, B, nh, N, P) float32), "prefix":
[]}``: O(1) in sequence length, so ``cache_len`` is ignored.  Prefill
returns zero attention stats and no SharePrefill state; each row's last
logits are at the padded final position (the family takes no
``prompt_lens``), as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import SharePrefill
from repro_torch.models import common
from repro_torch.models.attention import AttnStats
from repro_torch.models.ssm import _dims, ssm_decode, ssm_forward
from repro_torch.models.transformer import (PrefillResult, embed_tokens,
                                            logits_from_hidden, zero_aux)


def forward_train(params, cfg: ModelConfig, tokens, positions=None,
                  embeds=None):
    """tokens (B, S) → (logits (B, S, V), zero aux losses): each layer's
    ``ssm_forward`` on its normed input, under the config's
    ``remat_policy``."""
    x = embeds if embeds is not None else embed_tokens(params, cfg, tokens)

    def body(layer, x):
        h = common.rmsnorm(layer["ln"], x, cfg.rms_norm_eps)
        return x + ssm_forward(layer["ssm"], h, cfg)[0]

    body = common.maybe_remat(body, cfg.remat_policy)
    for layer in params["layers"]:
        x = body(layer, x)
    return logits_from_hidden(params, cfg, x), zero_aux(x.device)


def prefill(params, cfg: ModelConfig, tokens, sp: SharePrefill, *,
            method: str = "share", attn_impl: str = "auto", positions=None,
            embeds=None) -> PrefillResult:
    """``sp``, ``method``, ``attn_impl`` and ``positions`` are accepted for
    the common signature and unused: the family has no attention."""
    x = embeds if embeds is not None else embed_tokens(params, cfg, tokens)
    conv, ssd = [], []
    for layer in params["layers"]:
        h = common.rmsnorm(layer["ln"], x, cfg.rms_norm_eps)
        y, (c, s) = ssm_forward(layer["ssm"], h, cfg)
        x = x + y
        conv.append(c)
        ssd.append(s)
    logits = logits_from_hidden(params, cfg, x[:, -1, :])
    cache = {"stack": (torch.stack(conv), torch.stack(ssd)), "prefix": []}
    return PrefillResult(logits, cache, AttnStats.zero(device=x.device),
                         None)


def decode_step(params, cfg: ModelConfig, token, cache, pos, positions=None,
                *, window: int = 0, embeds=None):
    """One token through every layer's recurrence; ``cache``'s states are
    updated in place and returned.  ``pos``, ``positions`` and ``window``
    are unused (the state carries the position)."""
    x = embeds if embeds is not None else embed_tokens(params, cfg, token)
    conv, ssd = cache["stack"]
    for li, layer in enumerate(params["layers"]):
        h = common.rmsnorm(layer["ln"], x, cfg.rms_norm_eps)
        y, (c, s) = ssm_decode(layer["ssm"], h, cfg, conv[li], ssd[li])
        x = x + y
        conv[li] = c
        ssd[li] = s
    return logits_from_hidden(params, cfg, x[:, -1, :]), cache


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               dtype=torch.float32, device=None):
    """Zeroed states; the SSM state is O(1) in sequence length, so
    ``cache_len`` is ignored."""
    s = cfg.ssm
    d_inner, nh, _, _ = _dims(cfg)
    conv = torch.zeros((cfg.num_layers, batch, s.conv_width - 1,
                        d_inner + 2 * s.state_dim), dtype=dtype,
                       device=device)
    ssd = torch.zeros((cfg.num_layers, batch, nh, s.state_dim, s.head_dim),
                      dtype=torch.float32, device=device)
    return {"stack": (conv, ssd), "prefix": []}

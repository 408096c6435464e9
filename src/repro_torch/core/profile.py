"""Profiling for the offline phase and the paper's analyses (port of
``repro/core/profile.py``).

:func:`capture_block_attention_maps` runs a dense prefill and records the
block-averaged attention map of every (layer, head): the input to offline
clustering (paper §5.2, clustering on the attention maps of one sample).

:func:`run_prefill_traced` runs prefill layer by layer under any of the
four prefill methods and records per-layer pattern statistics, and
optionally the masks and q/k/v: the data behind the paper's observations
(Figure 2) and pattern distribution (Figure 6).  Its attention is the
plain dense-under-masks function (:func:`~repro_torch.kernels.chunked.
chunked_attention_fn`), as in the reference; the masks come from the same
builders as the model's (the strip kernel for CUDA tensors).

Both take the port's params (``params["layers"][i]``) and one sample,
as the reference does, and run on the device of the tokens; a MoE config
runs its MoE FFN after each layer's attention, and a VLM is traced on
tokens under plain RoPE.  MLA layers are refused: the reference's trace
cannot capture them either.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import share_attention as sa
from repro_torch.core.api import SharePrefill
from repro_torch.core.baselines import baseline_block_masks
from repro_torch.core.construct import block_softmax
from repro_torch.core.patterns import causal_block_mask
from repro_torch.kernels.chunked import chunked_attention, chunked_attention_fn
from repro_torch.kernels.ops import expand_kv
from repro_torch.models import common
from repro_torch.models.attention import (PREFILL_METHODS, baseline_stats,
                                          rope_qk)
from repro_torch.models.transformer import (_ffn_block, embed_tokens,
                                            logits_from_hidden,
                                            num_prefix_layers)


# the per-layer statistics of a trace (fields of LayerStats and AttnStats)
_STATS = ("num_shared", "num_dense", "num_vs", "block_density",
          "max_row_pop")


def _check_model(cfg: ModelConfig, tokens: torch.Tensor) -> None:
    if tokens.shape[0] != 1:
        raise ValueError("profiling uses a single sample (paper §5.2); got "
                         f"a batch of {tokens.shape[0]}")
    if cfg.family not in ("dense", "vlm", "moe"):
        raise NotImplementedError(
            f"profiling {cfg.name!r}: the trace reads every layer's "
            "params['stack'][l]['attn'] through gqa_qkv, which the "
            f"{cfg.family!r} family's tree does not have, as in the "
            "reference")
    if cfg.mla.enabled or num_prefix_layers(cfg):
        raise NotImplementedError(
            f"profiling {cfg.name!r}: the trace captures GQA layers only; "
            "MLA and prefix layers are not captured, as in the reference "
            "(its trace projects every layer through gqa_qkv)")


def _layer_qkv(layer, x, cfg: ModelConfig, positions):
    h = common.rmsnorm(layer["ln1"], x, cfg.rms_norm_eps)
    q, k, v = common.gqa_qkv(layer["attn"], h)
    return (*rope_qk(q, k, positions, cfg), v)


def _layer_finish(layer, x, attn_out, cfg: ModelConfig):
    return _ffn_block(layer, x + common.gqa_out(layer["attn"], attn_out), cfg)


def _numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach()
    return (x if x.dtype == torch.bool else x.float()).cpu().numpy()


def capture_block_attention_maps(params, cfg: ModelConfig,
                                 tokens: torch.Tensor, *,
                                 block_size: int = 64) -> np.ndarray:
    """Dense prefill of ``tokens (1, S)`` capturing every layer's block
    attention maps: ``(L, H, NB, NB)`` float32, each row the softmax of the
    block's mean scaled logits over the causal kv blocks."""
    _check_model(cfg, tokens)
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None]
    x = embed_tokens(params, cfg, tokens)
    maps: List[np.ndarray] = []
    for layer in params["layers"]:
        q, k, v = _layer_qkv(layer, x, cfg, positions)
        kx, vx = expand_kv(k, v, q.shape[1])
        out, a_tilde = chunked_attention(q, kx, vx, block_size=block_size,
                                         causal=True, collect_stats=True)
        maps.append(_numpy(block_softmax(a_tilde[0])))
        x = _layer_finish(layer, x, out, cfg)
    return np.stack(maps)


@dataclasses.dataclass
class PrefillTrace:
    last_logits: np.ndarray
    full_logits: Optional[np.ndarray]
    per_layer: List[Dict[str, float]]       # shared/dense/vs/density per layer
    masks: List[np.ndarray]                 # (H, NB, NB) per layer
    qkv: List[Tuple[np.ndarray, np.ndarray, np.ndarray]]  # per layer, opt.


def run_prefill_traced(params, cfg: ModelConfig, tokens: torch.Tensor,
                       sp: SharePrefill, *, method: str = "share",
                       want_full_logits: bool = False,
                       want_masks: bool = False,
                       want_qkv: bool = False) -> PrefillTrace:
    """Prefill of ``tokens (1, S)`` layer by layer under ``method`` (one of
    :data:`~repro_torch.models.attention.PREFILL_METHODS`) with each
    layer's statistics.  ``want_masks`` records each layer's selected
    ``(H, NB, NB)`` masks, ``want_qkv`` each layer's post-rope q and
    un-expanded k/v (float32 numpy); ``want_full_logits`` the logits of
    every position.  Masks and the dictionary run at the sample's full
    length; K/V stay un-expanded until the dense-under-masks attention."""
    if method not in PREFILL_METHODS:
        raise ValueError(f"unknown prefill method {method!r}; expected one "
                         f"of {PREFILL_METHODS}")
    _check_model(cfg, tokens)
    s = tokens.shape[1]
    dev = tokens.device
    positions = torch.arange(s, device=dev)[None]
    x = embed_tokens(params, cfg, tokens)
    bs = sp.cfg.block_size
    nb = s // bs
    causal = causal_block_mask(nb, device=dev)
    state = sa.init_batched_state(1, max(sp.num_clusters, 1), nb, device=dev)
    attention_fn = chunked_attention_fn(block_size=bs)

    per_layer, masks_out, qkv_out = [], [], []
    for li, layer in enumerate(params["layers"]):
        q, k, v = _layer_qkv(layer, x, cfg, positions)
        h = q.shape[1]
        if method == "share":
            ids = (sp.layer_cluster_ids(device=dev)[li] if sp.cfg.enabled
                   else torch.arange(h, dtype=torch.int32, device=dev))
            masks, decision = sa.build_share_masks(q, k, state, ids, sp.cfg)
            mask = masks[0]
            out, a_tilde = attention_fn(q[0], k[0], v[0], mask)
            state = sa.update_share_state(a_tilde[None], state, ids,
                                          decision, sp.cfg)
            st = sa.layer_pattern_stats(masks, decision)
        else:
            if method == "dense":
                mask = causal[None].expand(h, nb, nb)
            else:
                mask = baseline_block_masks(method, q, k, gamma=sp.cfg.gamma,
                                            block_size=bs)[0]
            mask = mask & causal
            out, _ = attention_fn(q[0], k[0], v[0], mask)
            st = baseline_stats(mask[None])
        per_layer.append({name: float(getattr(st, name))
                          for name in _STATS})
        if want_masks:
            masks_out.append(_numpy(mask))
        if want_qkv:
            qkv_out.append((_numpy(q[0]), _numpy(k[0]), _numpy(v[0])))
        x = _layer_finish(layer, x, out[None], cfg)

    full = logits_from_hidden(params, cfg, x) if want_full_logits else None
    last = logits_from_hidden(params, cfg, x[:, -1, :])
    return PrefillTrace(_numpy(last), None if full is None else _numpy(full),
                        per_layer, masks_out, qkv_out)

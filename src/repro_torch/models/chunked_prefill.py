"""One-shot prefill cut into step-cadence quanta: chunked admission (port
of ``repro/models/chunked_prefill.py``).

The serving scheduler cannot let one long prompt's prefill stall every
decoding slot for the whole admission.  This module runs the SAME
computation as ``transformer.prefill`` as a sequence of small quanta the
scheduler interleaves with decode steps::

    begin                                   (embed)
    for each layer l:
        layer_begin(l)                      (ln1 + qkv + rope + masks)
        attn(l, chunk_0) … attn(l, chunk_C) (Q chunk × full K/V)
        layer_end(l)                        (o-proj + residual + ln2 + FFN,
                                             dictionary update, stats)
    finish                                  (last-token gather + lm head)

The order is layer-major: SharePrefill's masks at every layer depend on the
full-sequence strip of the last query block (Algorithm 3), so estimation,
the decision and the dictionary update run at full length in
``layer_begin``/``layer_end``, exactly the ops of the one-shot path, and
only the attention's output rows are split over chunks.  Each chunk
launches the batched block-sparse kernel at ``q_block_offset`` (a
rectangular ``NBq × NBkv`` launch) on the chunk's rows of the same
head-permuted q, masks and gate; the kernel's per-row arithmetic depends on
the row's tables alone, so the assembled outputs and Ã are bitwise the
one-shot launch's, and every projection and FFN runs at the one-shot
shapes.  The pieces are the one-shot path's own
(:func:`~repro_torch.models.attention.attention_prefill_begin`,
``attention_prefill_rows``, ``attention_prefill_end``): one-shot prefill is
the same three with one chunk of every query block.

The reference slices its stacked params with a traced layer index so that
one jitted program serves every layer, and caches those programs; here the
layer index is a plain Python int into ``params["layers"]``, and the
serving run calls these functions directly (nothing is compiled).

Packing: ``seg_blocks`` isolates the concatenated prompts of a packed
launch by ANDing a block-diagonal segment mask into the masks (positions
restart per segment on the caller's side).  The pattern dictionary and the
strip still see the packed row as one, which is why packing is opt-in.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import SharePrefill
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models.transformer import (_ffn_block, embed_tokens,
                                            logits_from_hidden,
                                            num_prefix_layers)

# a chunk quantum is the attention over a run of query rows
chunk_prefill_attn = attn.attention_prefill_rows


def chunk_prefill_supported(cfg: ModelConfig) -> bool:
    """Whether chunked admission can serve ``cfg`` (``Model.prefill_chunk``):
    not for MLA latent caches or prefix layers outside the stack."""
    return not (cfg.mla.enabled or num_prefix_layers(cfg) > 0)


def chunk_prefill_begin(params, cfg: ModelConfig,
                        tokens: torch.Tensor) -> torch.Tensor:
    """Quantum 0: token embedding of the full (packed) row."""
    return embed_tokens(params, cfg, tokens)


def chunk_prefill_layer_begin(
    params, cfg: ModelConfig, layer_idx: int, x: torch.Tensor,
    positions: torch.Tensor, sp: SharePrefill, sp_state,
    cluster_arr: Optional[torch.Tensor], *, method: str, attn_impl: str,
    seg_blocks: Optional[int] = None,
) -> attn.LayerStage:
    """ln1 and :func:`~repro_torch.models.attention.attention_prefill_begin`
    at full length: QKV, rope and the mask staging."""
    layer = params["layers"][layer_idx]
    with tracing.span("attn.qkv"):
        h = common.rmsnorm(layer["ln1"], x, cfg.rms_norm_eps)
    return attn.attention_prefill_begin(
        layer["attn"], h, cfg, positions, method=method, sp=sp,
        sp_state=sp_state,
        cluster_ids=None if cluster_arr is None else cluster_arr[layer_idx],
        attn_impl=attn_impl, seg_blocks=seg_blocks)


def chunk_prefill_layer_end(
    params, cfg: ModelConfig, layer_idx: int, x: torch.Tensor,
    stage: attn.LayerStage,
    out: torch.Tensor,                  # (B, H, S, Dv) assembled rows
    a_tilde: Optional[torch.Tensor],    # (B, H, NB, NB) assembled Ã
    sp: SharePrefill, sp_state, cluster_arr,
):
    """The output projection, residual and FFN at full length, then
    :func:`~repro_torch.models.attention.attention_prefill_end` (the gemms
    go first: the quantum ends in a device sync, and the device runs them
    while the host issues the dictionary update's small ops).  Returns
    ``(x, (k, v), sp_state, AttnStats)``, the ``layer_prefill`` contract."""
    layer = params["layers"][layer_idx]
    x = _ffn_block(layer, x + attn.prefill_out_proj(layer["attn"], out), cfg)
    sp_state, stats = attn.attention_prefill_end(
        stage, a_tilde, sp=sp, sp_state=sp_state,
        cluster_ids=None if cluster_arr is None else cluster_arr[layer_idx])
    return x, (stage.k, stage.v), sp_state, stats


def chunk_prefill_finish(params, cfg: ModelConfig, x: torch.Tensor,
                         batch_idx: torch.Tensor,
                         rows: torch.Tensor) -> torch.Tensor:
    """Final quantum: each segment's last-token gather and the LM head →
    ``(P, V)``.  ``rows`` are positions in the packed row: segment j's
    real last token ``j · seg + clip(plen, 1, seg) − 1``."""
    return logits_from_hidden(params, cfg, x[batch_idx, rows])

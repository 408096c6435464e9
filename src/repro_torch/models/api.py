"""Model API of the port (``repro/models/api.py``'s counterpart) for every
family: ``dense``, ``vlm`` and ``moe`` (the transformer, with the MoE FFN
and sliding-window attention for Mixtral, M-RoPE for Qwen2-VL, and latent
attention with a dense prefix layer for DeepSeek-V2), the attention-free
``ssm`` family (Mamba-2, :mod:`repro_torch.models.ssm_stack`), the RG-LRU
``hybrid`` (RecurrentGemma, :mod:`repro_torch.models.hybrid`) and the
``encdec`` family (Whisper, :mod:`repro_torch.models.whisper`)::

    model = build_model(cfg, dtype=torch.bfloat16)        # on cuda
    params = model.init(torch.Generator("cuda").manual_seed(0))
    logits, aux = model.train_logits(tree, tokens)        # training
    result = model.prefill(params, tokens, sp, method="share")
    logits, cache = model.decode(params, token, cache, pos, plan=plan)
    # a VLM: prefill(params, None, sp, positions=(3, B, S), embeds=...)
    # collect_queries=True also returns each layer's query (L, B, H, hd)
    # the slot scheduler: per-slot pos (B,), and page_table= for the pool
    # chunked admission runs repro_torch.models.chunked_prefill's quanta
    # where model.prefill_chunk is True
    # the ssm, hybrid and encdec families take the plain signatures only:
    # no attn_width, prompt_lens, plan, page table or query collection (as
    # the reference); whisper's prefill takes the encoder frames as embeds

``build_model`` runs on CUDA unless the caller passes ``device="cpu"``; with
no device and no GPU it raises rather than run quietly on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import checkpoint, tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import SharePrefill
from repro_torch.models import hybrid, ssm_stack, transformer, whisper
from repro_torch.models.chunked_prefill import chunk_prefill_supported


def resolve_device(device=None) -> torch.device:
    """``device`` as given, or CUDA; raises when neither is available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU; pass "
                           "device='cpu' to run on the CPU")
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    dtype: torch.dtype
    # whether chunked admission (models/chunked_prefill.py) can serve it
    prefill_chunk: bool = False

    def init(self, generator: torch.Generator):
        return checkpoint.init_params(self.cfg, generator,
                                      device=self.device, dtype=self.dtype)

    @property
    def transformer_family(self) -> bool:
        """Whether prefill and decode take the transformer's arguments
        (width caps, prompt lengths, plans, page tables)."""
        return self.cfg.family in TRANSFORMER_FAMILIES

    def _plain_only(self, **given) -> None:
        bad = sorted(k for k, v in given.items() if v)
        if bad and not self.transformer_family:
            raise TypeError(f"family {self.cfg.family!r} takes no {bad}")

    def train_logits(self, tree, tokens, positions=None, embeds=None):
        """The training forward: ``(logits (B, S, V), aux losses)`` from the
        reference's parameter tree (nested dicts of stacked leaves, as
        training keeps them), whose per-layer views are made inside the
        differentiable forward on every call.  A VLM takes ``embeds`` and
        3-D ``positions``; Whisper its frames as ``embeds``."""
        params = checkpoint.params_from_tree(tree, self.cfg)
        family = (transformer if self.transformer_family
                  else PLAIN_FAMILIES[self.cfg.family])
        return family.forward_train(params, self.cfg, tokens, positions,
                                    embeds)

    def prefill(self, params, tokens, sp: SharePrefill, *,
                method: str = "share", attn_impl: str = "auto",
                attn_width: Optional[int] = None, prompt_lens=None,
                positions=None, embeds=None):
        with tracing.span("model.prefill"):
            if not self.transformer_family:
                self._plain_only(attn_width=attn_width,
                                 prompt_lens=prompt_lens is not None)
                return PLAIN_FAMILIES[self.cfg.family].prefill(
                    params, self.cfg, tokens, sp, method=method,
                    attn_impl=attn_impl, positions=positions, embeds=embeds)
            return transformer.prefill(params, self.cfg, tokens, sp,
                                       method=method, attn_impl=attn_impl,
                                       attn_width=attn_width,
                                       prompt_lens=prompt_lens,
                                       positions=positions, embeds=embeds)

    def decode(self, params, token, cache, pos, *, positions=None,
               embeds=None, plan=None, prompt_lens=None, prefill_len=0,
               decode_impl: str = "auto", page_table=None,
               collect_queries: bool = False, window: int = 0):
        with tracing.span("model.decode"):
            if not self.transformer_family:
                self._plain_only(plan=plan is not None,
                                 prompt_lens=prompt_lens is not None,
                                 prefill_len=prefill_len,
                                 decode_impl=decode_impl != "auto",
                                 page_table=page_table is not None,
                                 collect_queries=collect_queries)
                return PLAIN_FAMILIES[self.cfg.family].decode_step(
                    params, self.cfg, token, cache, pos, positions,
                    window=window, embeds=embeds)
            return transformer.decode_step(params, self.cfg, token, cache, pos,
                                           positions=positions, embeds=embeds,
                                           plan=plan, prompt_lens=prompt_lens,
                                           prefill_len=prefill_len,
                                           decode_impl=decode_impl,
                                           page_table=page_table,
                                           collect_queries=collect_queries,
                                           window=window)

    def init_cache(self, batch: int, cache_len: int, *, dtype=None):
        """Zeroed contiguous cache in ``dtype`` (default: the model's); the
        slot scheduler passes its prefill cache's dtype."""
        if not self.transformer_family:
            return PLAIN_FAMILIES[self.cfg.family].init_cache(
                self.cfg, batch, cache_len, dtype=dtype or self.dtype,
                device=self.device)
        return transformer.init_cache(self.cfg, batch, cache_len,
                                      dtype=dtype or self.dtype,
                                      device=self.device)

    def default_share_prefill(self) -> SharePrefill:
        """Trivial clustering (per-head clusters) until an offline artifact
        exists (:mod:`repro_torch.core.clustering`); disabled for a config
        without attention."""
        if not self.cfg.share_prefill.enabled or not self.cfg.has_attention:
            return SharePrefill.disabled()
        return SharePrefill.trivial(self.cfg.share_prefill,
                                    self.cfg.num_layers,
                                    max(self.cfg.num_heads, 1))


TRANSFORMER_FAMILIES = ("dense", "vlm", "moe")
# the families with the plain prefill/decode signatures, and their modules
PLAIN_FAMILIES = {"ssm": ssm_stack, "hybrid": hybrid, "encdec": whisper}
FAMILIES = TRANSFORMER_FAMILIES + tuple(PLAIN_FAMILIES)


def build_model(cfg: ModelConfig, dtype=torch.float32,
                device=None) -> Model:
    """The transformer of a ``dense``, ``vlm`` or ``moe`` config (MLA and
    prefix layers included), the SSM stack of an ``ssm`` config, the
    RG-LRU hybrid of a ``hybrid`` one or the encoder-decoder of an
    ``encdec`` one.  MLA and the plain families take no chunked admission
    (``prefill_chunk`` False); MLA, the hybrid and Whisper take a scalar
    decode ``pos`` only."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return Model(cfg, resolve_device(device), dtype,
                 prefill_chunk=(cfg.family in TRANSFORMER_FAMILIES
                                and chunk_prefill_supported(cfg)))

"""Model API of the port (``repro/models/api.py``'s counterpart) for the
``dense``, ``vlm`` and ``moe`` families (the transformer, with the MoE FFN
and sliding-window attention for Mixtral, M-RoPE for Qwen2-VL, and latent
attention with a dense prefix layer for DeepSeek-V2)::

    model = build_model(cfg, dtype=torch.bfloat16)        # on cuda
    params = model.init(torch.Generator("cuda").manual_seed(0))
    result = model.prefill(params, tokens, sp, method="share")
    logits, cache = model.decode(params, token, cache, pos, plan=plan)
    # a VLM: prefill(params, None, sp, positions=(3, B, S), embeds=...)
    # collect_queries=True also returns each layer's query (L, B, H, hd)
    # the slot scheduler: per-slot pos (B,), and page_table= for the pool
    # chunked admission runs repro_torch.models.chunked_prefill's quanta
    # where model.prefill_chunk is True

``build_model`` runs on CUDA unless the caller passes ``device="cpu"``; with
no device and no GPU it raises rather than run quietly on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import checkpoint
from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import SharePrefill
from repro_torch.models import transformer
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

    def prefill(self, params, tokens, sp: SharePrefill, *,
                method: str = "share", attn_impl: str = "auto",
                attn_width: Optional[int] = None, prompt_lens=None,
                positions=None, embeds=None):
        return transformer.prefill(params, self.cfg, tokens, sp,
                                   method=method, attn_impl=attn_impl,
                                   attn_width=attn_width,
                                   prompt_lens=prompt_lens,
                                   positions=positions, embeds=embeds)

    def decode(self, params, token, cache, pos, *, positions=None,
               embeds=None, plan=None, prompt_lens=None, prefill_len=0,
               decode_impl: str = "auto", page_table=None,
               collect_queries: bool = False, window: int = 0):
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
        return transformer.init_cache(self.cfg, batch, cache_len,
                                      dtype=dtype or self.dtype,
                                      device=self.device)

    def default_share_prefill(self) -> SharePrefill:
        """Trivial clustering (per-head clusters) until an offline artifact
        exists."""
        if not self.cfg.share_prefill.enabled:
            return SharePrefill.disabled()
        return SharePrefill.trivial(self.cfg.share_prefill,
                                    self.cfg.num_layers,
                                    max(self.cfg.num_heads, 1))


def build_model(cfg: ModelConfig, dtype=torch.float32,
                device=None) -> Model:
    """The transformer of a ``dense``, ``vlm`` or ``moe`` config (MLA and
    prefix layers included); the other families raise, naming ROADMAP.md
    A.10.  MLA takes no chunked admission (``prefill_chunk`` False) and a
    scalar decode ``pos`` only."""
    if cfg.family not in ("dense", "vlm", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r}: the port serves the dense, vlm and moe "
            "families so far (ROADMAP.md queue A.10)")
    return Model(cfg, resolve_device(device), dtype,
                 prefill_chunk=chunk_prefill_supported(cfg))

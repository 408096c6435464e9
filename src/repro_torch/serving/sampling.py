"""Token sampling for the serving engine (port of
``repro/serving/sampling.py``).

Greedy decoding is ``argmax`` (first maximum, as in the reference).
Temperature / top-k / top-p draws come from a ``torch.Generator``: the
reference's JAX key chains cannot be reproduced, so sampled streams are not
held against it.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0        # 0 → greedy
    top_k: int = 0                  # 0 → full distribution
    top_p: float = 1.0
    # sampling one of these ends the request: the stop token is kept as the
    # final output token and the row stops decoding
    stop_tokens: Tuple[int, ...] = ()

    def is_stop(self, token: int) -> bool:
        return token in self.stop_tokens


def sample_token(logits: torch.Tensor, cfg: SamplingConfig,
                 generator: torch.Generator) -> torch.Tensor:
    """logits (B, V) → tokens (B,) int64."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -cfg.top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if cfg.top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        csum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
        cutoff_idx = (csum < cfg.top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_l, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]

"""SharePrefill core, ported to PyTorch.

  patterns         block-sparse pattern algebra (masks, cumulative-γ top-k)
  jsd              Jensen-Shannon distance (d_sparse / d_sim)
  vertical_slash   Algorithm 5 — cumulative-threshold vertical-slash search
  determine        Algorithm 3 — per-head pattern decision
  construct        Algorithm 2 — pivotal pattern construction
  pattern_dict     the per-sample pivotal-pattern dictionary
  share_attention  Algorithm 1 — per-layer orchestration, batched
  api              SharePrefill — the module models consume
"""
from repro_torch.core.api import SharePrefill
from repro_torch.core.pattern_dict import PivotalState
from repro_torch.core.share_attention import (
    LayerStats,
    batched_share_prefill_attention_layer,
    init_batched_state,
)

__all__ = [
    "SharePrefill", "PivotalState", "LayerStats",
    "batched_share_prefill_attention_layer", "init_batched_state",
]

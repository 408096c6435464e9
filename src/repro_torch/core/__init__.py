"""SharePrefill core, ported to PyTorch.

  patterns         block-sparse pattern algebra (masks, cumulative-γ top-k)
  jsd              Jensen-Shannon distance (d_sparse / d_sim)
  vertical_slash   Algorithm 5 — cumulative-threshold vertical-slash search
  determine        Algorithm 3 — per-head pattern decision
  construct        Algorithm 2 — pivotal pattern construction
  pattern_dict     the per-sample pivotal-pattern dictionary
  share_attention  Algorithm 1 — per-layer orchestration, batched
  baselines        the paper's baselines (MInference, FlexPrefill, dense)
  profile          block attention maps and the layer-by-layer traced
                   prefill behind the paper's analyses
  clustering       offline head clustering (autoencoder + agglomerative)
  api              SharePrefill — the module models consume
"""
from repro_torch.core.api import SharePrefill
from repro_torch.core.pattern_dict import PivotalState, init_pivotal_state
from repro_torch.core.share_attention import (
    LayerStats,
    batched_share_prefill_attention_layer,
    gqa_head_vmap,
    init_batched_state,
    share_prefill_attention_layer,
)

__all__ = [
    "SharePrefill", "PivotalState", "init_pivotal_state", "LayerStats",
    "share_prefill_attention_layer", "batched_share_prefill_attention_layer",
    "gqa_head_vmap", "init_batched_state",
]

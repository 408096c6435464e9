"""Public API of the SharePrefill core (port of ``repro/core/api.py``)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import SharePrefillConfig
from repro_torch.core import share_attention as sa
from repro_torch.core.pattern_dict import PivotalState
from repro_torch.core.patterns import num_blocks


@dataclasses.dataclass(frozen=True)
class SharePrefill:
    """The paper's technique as a module models consume.

    Attributes:
      cfg: thresholds (γ, τ, δ) and block size.
      cluster_ids: (L, H) int32 head clusters from offline clustering
        (−1 noise).
      num_clusters: number of non-noise clusters.
    """

    cfg: SharePrefillConfig
    cluster_ids: np.ndarray
    num_clusters: int

    @staticmethod
    def disabled() -> "SharePrefill":
        return SharePrefill(SharePrefillConfig(enabled=False),
                            np.zeros((0, 0), np.int32), 1)

    @staticmethod
    def from_clustering(cfg: SharePrefillConfig, cluster_ids: np.ndarray,
                        num_clusters: int) -> "SharePrefill":
        return SharePrefill(cfg, np.asarray(cluster_ids, np.int32),
                            max(int(num_clusters), 1))

    @staticmethod
    def trivial(cfg: SharePrefillConfig, num_layers: int,
                num_heads: int) -> "SharePrefill":
        """Head-index-tied clusters (head h of every layer shares cluster
        h), used before an offline clustering artifact exists."""
        ids = np.tile(np.arange(num_heads, dtype=np.int32), (num_layers, 1))
        return SharePrefill(cfg, ids, num_heads)

    def applicable(self, seq_len: int) -> bool:
        if not self.cfg.enabled:
            return False
        nb = seq_len // self.cfg.block_size
        return (seq_len % self.cfg.block_size == 0
                and nb >= self.cfg.min_seq_blocks)

    def init_state(self, batch: int, seq_len: int, *,
                   device=None) -> PivotalState:
        nb = num_blocks(seq_len, self.cfg.block_size)
        return sa.init_batched_state(batch, self.num_clusters, nb,
                                     device=device)

    def layer_cluster_ids(self, *, device=None) -> torch.Tensor:
        """(L, H) int32 cluster ids."""
        return torch.as_tensor(self.cluster_ids, dtype=torch.int32,
                               device=device)

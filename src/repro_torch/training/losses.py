"""Training losses (port of ``repro/training/losses.py``)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed.sharding import shard


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-level CE in float32. logits (B, S, V), labels (B, S); ``mask``
    (B, S) weights the tokens (default all ones)."""
    # the vocabulary gathered before the gold logit's gather (a DTensor's
    # gather over a vocab-sharded axis does not propagate)
    logits = shard(logits.float(), "batch")
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    mask = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
    total = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / total
    acc = ((logits.argmax(-1) == labels) * mask).sum() / total
    return loss, {"ce_loss": loss, "accuracy": acc,
                  "perplexity": torch.exp(torch.clamp(loss, max=20.0))}


def total_loss(logits, labels, aux, *, lb_weight: float = 0.01,
               z_weight: float = 1e-3, mask=None):
    ce, metrics = cross_entropy(logits, labels, mask)
    loss = (ce + lb_weight * aux.get("load_balance_loss", 0.0)
            + z_weight * aux.get("router_z_loss", 0.0))
    metrics["total_loss"] = loss
    metrics["load_balance_loss"] = aux.get(
        "load_balance_loss", torch.zeros((), device=ce.device))
    return loss, metrics

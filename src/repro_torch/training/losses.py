"""Training losses (port of ``repro/training/losses.py``)."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed.sharding import shard


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp(x, -1)`` in aten's own steps (the row's max, inf
    maxima taken as 0, the shifted exp-sum, its log plus the max) and with
    aten's backward, ``g · exp(x − lse)``: bitwise aten's on plain tensors.
    On a ``DTensor`` sharded over the last axis each step is a reduction
    ``DTensor`` keeps sharded, where aten's own op gathers the axis."""

    @staticmethod
    def forward(ctx, x):
        m = x.amax(-1, keepdim=True)
        m = m.masked_fill(m.abs() == math.inf, 0.0)
        out = (x - m).exp().sum(-1).log() + m[..., 0]
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g[..., None] * (x - out[..., None]).exp()


def _vocab_ids(logits: torch.Tensor) -> torch.Tensor:
    """``arange(V)`` as int32 ``(1, 1, V)``; on a ``DTensor`` split as
    ``logits``' vocab axis is, so each rank holds its shard's ids."""
    v = logits.shape[-1]
    ids = torch.arange(v, dtype=torch.int32, device=logits.device)[None, None]
    if type(logits) is torch.Tensor:
        return ids
    from torch.distributed.tensor import (
        DTensor,
        Replicate,
        Shard,
        distribute_tensor,
    )
    if not isinstance(logits, DTensor):
        return ids
    return distribute_tensor(
        ids, logits.device_mesh,
        [p if p == Shard(2) else Replicate() for p in logits.placements],
        src_data_rank=None)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-level CE in float32. logits (B, S, V), labels (B, S); ``mask``
    (B, S) weights the tokens (default all ones).

    The vocabulary stays sharded through the loss and its backward (the
    step bundles' logits are vocab-sharded ``DTensor``s): the gold logit is
    the row's one matching term summed (a gather's backward would allocate
    zeros of the global shape), the log-sum-exp a max then a sum, and the
    prediction argmax's first index among the row's maxima, each a
    reduction over the vocab shards; the per-token terms are placed over
    the batch alone.  On plain tensors the loss and its gradient are
    bitwise ``logsumexp − gather``'s."""
    logits = shard(logits.float(), "batch", None, "vocab")
    ids = _vocab_ids(logits)
    logz = shard(_LogSumExp.apply(logits), "batch")
    hit = ids == labels[..., None]
    gold = shard(torch.where(hit, logits, 0.0).sum(-1), "batch")
    nll = logz - gold
    mask = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
    total = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / total
    top = logits.detach().amax(-1, keepdim=True)
    pred = shard(torch.where(logits.detach() == top, ids, logits.shape[-1])
                 .amin(-1), "batch")
    acc = ((pred == labels) * mask).sum() / total
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

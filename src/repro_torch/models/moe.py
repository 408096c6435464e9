"""Mixture-of-experts FFN with capacity-bucketed one-hot dispatch (port of
``repro/models/moe.py``).

Tokens are routed to ``top_k`` of ``num_experts`` experts within fixed-size
routing groups (Mesh-TF style); each expert takes at most ``capacity``
tokens a group, in token order, and the rest of its tokens are dropped
(they get no output from that expert).  Dispatch and combine are products
with one-hot tensors ``(groups, g, E, C)`` in the activation dtype, as in
the reference: the dispatch product picks each expert slot's token exactly,
and the combine product sums each token's gated expert outputs.  Shared
experts (``num_shared_experts``, DeepSeek-V2 style) add an always-on
SwiGLU.  Covers Mixtral (8 experts, top 2).

These are plain ``torch.matmul`` products: the reference computes them
with ``jnp.einsum`` outside any Pallas kernel.

Capacity is per routing group and groups are cut from the tokens one call
sees (``_group_size``): a chunked prefill routes other groups than the
one-shot prefill, and a padded batch row's pad tokens are routed and use
capacity too, in the reference as here.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard
from repro_torch.models import common


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor
    router_z_loss: torch.Tensor
    expert_load: torch.Tensor       # (E,) mean routed fraction per expert

    @staticmethod
    def zero(num_experts: int = 1, device=None) -> "MoEAux":
        z = torch.zeros((), device=device)
        return MoEAux(z, z, torch.zeros((num_experts,), device=device))


# the MoE FFN leaves whose leading axis is the expert axis (each expert's
# matrix is drawn on its own, as the reference's stack_init does)
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def moe_leaf_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """One layer's MoE FFN leaves (``shared::`` for the shared experts) and
    their shapes: router ``(d, E)``, w_gate / w_up ``(E, d, F)``, w_down
    ``(E, F, d)``; the shared SwiGLU is ``F · num_shared_experts`` wide."""
    mo = cfg.moe
    d, e = cfg.d_model, mo.num_experts
    f = mo.expert_d_ff or cfg.d_ff
    shapes = {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
              "w_down": (e, f, d)}
    if mo.num_shared_experts:
        fs = f * mo.num_shared_experts
        shapes.update({"shared::w_gate": (d, fs), "shared::w_up": (d, fs),
                       "shared::w_down": (fs, d)})
    return shapes


def init_moe_layer(cfg: ModelConfig, generator: torch.Generator, *,
                   device, dtype=torch.float32, out=None
                   ) -> Dict[str, torch.Tensor]:
    """One layer's MoE FFN leaves (flat keys of :func:`moe_leaf_shapes`)
    drawn from the reference's distributions, one expert matrix at a time
    (its float32 scratch is one matrix), into ``out``'s tensors when
    given."""
    if out is None:
        out = {name: torch.empty(shape, dtype=dtype, device=device)
               for name, shape in moe_leaf_shapes(cfg).items()}
    for name, t in out.items():
        for m in (t if name in EXPERT_LEAVES else (t,)):
            common.dense_init_(m, generator)
    return out


GROUP_TOKENS = 2048     # routing-group size: dispatch memory O(S·g·k·cf)


def _group_size(s: int) -> int:
    g = min(GROUP_TOKENS, s)
    while s % g:
        g -= 1
    return g


def _capacity(group: int, cfg: ModelConfig) -> int:
    mo = cfg.moe
    c = int(group * mo.top_k * mo.capacity_factor / mo.num_experts)
    return max(c, mo.top_k)


def route(params, xg: torch.Tensor, cfg: ModelConfig):
    """Router logits ``(NG, g, E)`` in the activation dtype, float32
    probabilities, and the top-k gates (renormalised) and expert ids
    ``(NG, g, K)``, best first."""
    logits = xg @ params["router"]
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gate_vals, gate_idx


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, MoEAux]:
    """x ``(B, S, d)`` → ``(B, S, d)`` and the aux losses."""
    mo = cfg.moe
    b, s, d = x.shape
    e, k = mo.num_experts, mo.top_k
    g = _group_size(s)
    ng = (b * s) // g
    cap = _capacity(g, cfg)
    xg = x.reshape(ng, g, d)
    with tracing.span("moe.route"):
        logits, probs, gate_vals, gate_idx = route(params, xg, cfg)

    with tracing.span("moe.dispatch"):
        # each (token, choice) slot's position in its expert's queue, in
        # token order and best choice first; past the capacity it is dropped
        onehot = F.one_hot(gate_idx, e).float()              # (NG, g, K, E)
        flat = onehot.reshape(ng, g * k, e)
        pos = ((torch.cumsum(flat, 1) - flat) * flat).sum(-1)  # (NG, g·K)
        keep = pos < cap
        slot_gate = gate_vals.reshape(ng, g * k) * keep

        # dispatch / combine (NG, g, E·C): a token's k slots lie in distinct
        # experts' columns, so each entry is one slot's keep bit / gate
        adt = x.dtype
        col = (gate_idx.reshape(ng, g * k) * cap
               + pos.long().clamp(max=cap - 1)).reshape(ng, g, k)
        dispatch = torch.zeros((ng, g, e * cap), dtype=adt, device=x.device)
        combine = torch.zeros_like(dispatch)
        dispatch.scatter_(2, col, keep.reshape(ng, g, k).to(adt))
        combine.scatter_(2, col, slot_gate.reshape(ng, g, k).to(adt))

        # expert inputs (E, NG·C, d): the dispatch product picks each
        # slot's token
        expert_in = (dispatch.transpose(1, 2) @ xg).reshape(ng, e, cap, d)
        expert_in = expert_in.transpose(0, 1).reshape(e, ng * cap, d)
        expert_in = shard(expert_in, "experts", "batch")

    with tracing.span("moe.experts"):
        # each expert's SwiGLU in float32 between its two products
        expert_out = torch.empty_like(expert_in)
        for i in range(e):
            xi = expert_in[i]
            h = (F.silu((xi @ params["w_gate"][i]).float())
                 * (xi @ params["w_up"][i]).float()).to(adt)
            # the hidden on the FFN dim (the reference's (E, …) site:
            # sharded on the experts where they divide, else here)
            h = shard(h, "batch", "mlp")
            expert_out[i] = h @ params["w_down"][i]

    with tracing.span("moe.combine"):
        expert_out = expert_out.reshape(e, ng, cap, d).transpose(0, 1)
        y = (combine @ expert_out.reshape(ng, e * cap, d)).reshape(b, s, d)

    if "shared" in params:
        y = y + common.mlp(params["shared"], x)

    # aux losses (Switch-style load balance, router z-loss)
    me = onehot.sum(2).clamp(0, 1).mean((0, 1))
    ce = probs.mean((0, 1))
    lb = e * (me * ce).sum()
    z = (torch.logsumexp(logits.float(), -1) ** 2).mean()
    return y.to(x.dtype), MoEAux(lb, z, me)

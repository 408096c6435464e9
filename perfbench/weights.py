"""The model's weights, made by the benchmark from the seed and handed to
both the port and the plain reference.

One flat dict of ``::`` keys (the layout of the port's checkpoints, which
the reference reads too), every leaf stacked over the layers and drawn in
one call on the device, in the type it is served in::

    embed                      (V, d)       normal x 0.02
    lm_head                    (d, V)       normal / sqrt(d)
    final_norm::scale          (d,)         ones
    stack::ln1::scale          (L, d)       ones (and ln2)
    stack::attn::wq            (L, d, H, hd)     — wk, wv (L, d, Hkv, hd)
    stack::attn::wo            (L, H, hd, d)
    stack::ffn::w_gate         (L, d, F)    — w_up; w_down (L, F, d)

and for a mixture of experts ``stack::ffn::router (L, d, E)`` and the
expert stacks ``w_gate``/``w_up`` ``(L, E, d, F)``, ``w_down (L, E, F,
d)``.  Matrices are normal, scaled by 1/sqrt(fan_in) (the second-to-last
input axis of the product).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def shapes(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """Every leaf's shape and fan-in (0: a norm scale, 1 for ones) from a
    configuration file's published keys."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // h
    f, v = cfg["intermediate_size"], cfg["vocab_size"]
    out = {"embed": ((v, d), -1), "final_norm::scale": ((d,), 0),
           "stack::ln1::scale": ((L, d), 0), "stack::ln2::scale": ((L, d), 0),
           "stack::attn::wq": ((L, d, h, hd), d),
           "stack::attn::wk": ((L, d, hkv, hd), d),
           "stack::attn::wv": ((L, d, hkv, hd), d),
           "stack::attn::wo": ((L, h, hd, d), h * hd)}
    if not cfg.get("tie_word_embeddings", False):
        out["lm_head"] = ((d, v), d)
    e = cfg.get("num_local_experts", 0)
    if e:
        out.update({"stack::ffn::router": ((L, d, e), d),
                    "stack::ffn::w_gate": ((L, e, d, f), d),
                    "stack::ffn::w_up": ((L, e, d, f), d),
                    "stack::ffn::w_down": ((L, e, f, d), f)})
    else:
        out.update({"stack::ffn::w_gate": ((L, d, f), d),
                    "stack::ffn::w_up": ((L, d, f), d),
                    "stack::ffn::w_down": ((L, f, d), f)})
    return out


def make(cfg: dict, seed: int, *, device, dtype=torch.bfloat16
         ) -> Dict[str, torch.Tensor]:
    """The flat weights of ``cfg`` from ``seed``: one generator on
    ``device``, one draw a leaf, in key order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    for name, (shape, fan_in) in sorted(shapes(cfg).items()):
        if fan_in == 0:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        t.mul_(0.02 if fan_in < 0 else 1.0 / math.sqrt(fan_in))
        out[name] = t
    return out


def nbytes(flat: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in flat.values())

"""Weights for the port: the bridge from the reference's parameters, and a
seeded initialiser.

The reference's parameter tree for the dense decoder, flattened with ``::``
(its checkpoint key format), is::

    embed                      (V, d)
    final_norm::scale          (d,)
    lm_head                    (d, V)          (absent when tied)
    stack::attn::wq            (L, d, H, hd)   — and wk, wv (L, d, Hkv, hd)
    stack::attn::wo            (L, H, hd, d)
    stack::ffn::w_gate         (L, d, F)       — and w_up; w_down (L, F, d)
    stack::ln1::scale          (L, d)          — and ln2

The port's parameters are a plain dict with the same leaves and layouts,
except that the leading layer axis becomes a list ``layers`` of per-layer
dicts (views into one stacked tensor per leaf).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

SEP = "::"
_LAYER_LEAVES = {
    "attn": ("wq", "wk", "wv", "wo"),
    "ffn": ("w_gate", "w_up", "w_down"),
    "ln1": ("scale",),
    "ln2": ("scale",),
}


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Read a flat-key ``::`` npz file into a dict of arrays."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as f:
        return {k: f[k] for k in f.files}


def _layer_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d, f = cfg.d_model, cfg.d_ff
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "attn::wq": (d, h, hd), "attn::wk": (d, hkv, hd),
        "attn::wv": (d, hkv, hd), "attn::wo": (h, hd, d),
        "ffn::w_gate": (d, f), "ffn::w_up": (d, f), "ffn::w_down": (f, d),
        "ln1::scale": (d,), "ln2::scale": (d,),
    }


def _assemble(stacked: Dict[str, torch.Tensor], top: Dict[str, torch.Tensor],
              cfg: ModelConfig) -> Dict:
    layers = []
    for i in range(cfg.num_layers):
        layer = {}
        for group, leaves in _LAYER_LEAVES.items():
            layer[group] = {n: stacked[f"{group}{SEP}{n}"][i] for n in leaves}
        layers.append(layer)
    params = {"embed": top["embed"],
              "final_norm": {"scale": top["final_norm::scale"]},
              "layers": layers}
    if not cfg.tie_embeddings:
        params["lm_head"] = top["lm_head"]
    return params


def params_from_numpy(flat: Dict[str, np.ndarray], cfg: ModelConfig, *,
                      device, dtype=torch.float32) -> Dict:
    """The reference's flat parameter dict → the port's parameters."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: the port serves the dense family so far "
            "(ROADMAP.md queue A.10)")
    conv = lambda a: torch.tensor(np.asarray(a)).to(device=device,
                                                    dtype=dtype)
    stacked = {}
    for name, shape in _layer_shapes(cfg).items():
        arr = flat[f"stack{SEP}{name}"]
        if arr.shape != (cfg.num_layers,) + shape:
            raise ValueError(f"stack::{name}: shape {arr.shape}, expected "
                             f"{(cfg.num_layers,) + shape}")
        stacked[name] = conv(arr)
    top = {"embed": conv(flat["embed"]),
           "final_norm::scale": conv(flat[f"final_norm{SEP}scale"])}
    if not cfg.tie_embeddings:
        top["lm_head"] = conv(flat["lm_head"])
    return _assemble(stacked, top, cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device, dtype=torch.float32) -> Dict:
    """Random parameters drawn from the reference's distributions
    (``repro/models/common.py``): matrices truncated-normal in [−2, 2]
    scaled by 1/√fan_in (fan_in = the leading axis), the embedding
    normal × 0.02, norm scales ones.  Same distributions, not the same
    numbers.  Each layer is drawn in float32 on ``device`` (``generator``
    must live there) and stored in ``dtype``."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: the port serves the dense family so far "
            "(ROADMAP.md queue A.10)")

    def dense(shape, out=None):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        t.mul_(1.0 / shape[0] ** 0.5)
        if out is None:
            return t.to(dtype)
        out.copy_(t)
        return out

    stacked = {}
    for name, shape in _layer_shapes(cfg).items():
        full = torch.empty((cfg.num_layers,) + shape, dtype=dtype,
                           device=device)
        for i in range(cfg.num_layers):
            if name.endswith("scale"):
                full[i].fill_(1.0)
            else:
                dense(shape, out=full[i])
        stacked[name] = full
    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=generator,
                        dtype=torch.float32, device=device).mul_(0.02)
    top = {"embed": embed.to(dtype),
           "final_norm::scale": torch.ones(cfg.d_model, dtype=dtype,
                                           device=device)}
    if not cfg.tie_embeddings:
        top["lm_head"] = dense((cfg.d_model, cfg.vocab_size))
    return _assemble(stacked, top, cfg)


def num_params(params: Dict) -> int:
    """Parameter count of a port parameter dict."""
    n = params["embed"].numel() + params["final_norm"]["scale"].numel()
    if "lm_head" in params:
        n += params["lm_head"].numel()
    for layer in params["layers"]:
        n += sum(t.numel() for g in layer.values() for t in g.values())
    return n

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

and for the ``moe`` family the FFN leaves are the experts' instead::

    stack::ffn::router         (L, d, E)
    stack::ffn::w_gate         (L, E, d, F)    — and w_up; w_down (L, E, F, d)
    stack::ffn::shared::w_gate (L, d, F·S)     — and w_up, w_down (shared
                                                 experts, when S > 0)

The port's parameters are a plain dict with the same leaves and layouts,
except that the leading layer axis becomes a list ``layers`` of per-layer
dicts (views into one stacked tensor per leaf).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, moe

SEP = "::"


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Read a flat-key ``::`` npz file into a dict of arrays."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as f:
        return {k: f[k] for k in f.files}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe") or cfg.mla.enabled:
        raise NotImplementedError(
            f"family {cfg.family!r}{' with MLA' if cfg.mla.enabled else ''}:"
            " the port serves the dense and moe families so far (ROADMAP.md "
            "queue A.10)")


def _layer_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Every per-layer leaf (``::`` keys under ``stack``) and its shape."""
    d, f = cfg.d_model, cfg.d_ff
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    shapes = {
        "attn::wq": (d, h, hd), "attn::wk": (d, hkv, hd),
        "attn::wv": (d, hkv, hd), "attn::wo": (h, hd, d),
        "ln1::scale": (d,), "ln2::scale": (d,),
    }
    if cfg.moe.enabled:
        shapes.update({f"ffn{SEP}{k}": v
                       for k, v in moe.moe_leaf_shapes(cfg).items()})
    else:
        shapes.update({"ffn::w_gate": (d, f), "ffn::w_up": (d, f),
                       "ffn::w_down": (f, d)})
    return shapes


def _assemble(stacked: Dict[str, torch.Tensor], top: Dict[str, torch.Tensor],
              cfg: ModelConfig) -> Dict:
    layers = []
    for i in range(cfg.num_layers):
        layer: Dict = {}
        for name, full in stacked.items():
            *path, leaf = name.split(SEP)
            node = layer
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = full[i]
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
    _check_family(cfg)
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
    scaled by 1/√fan_in (:func:`~repro_torch.models.common.dense_init_`;
    an expert stack one expert at a time, as the reference's
    ``stack_init``), the embedding normal × 0.02, norm scales ones.  Same
    distributions, not the same numbers.  Each matrix is drawn in float32
    on ``device`` (``generator`` must live there) and stored in
    ``dtype``."""
    _check_family(cfg)
    shapes = _layer_shapes(cfg)
    stacked = {name: torch.empty((cfg.num_layers,) + shape, dtype=dtype,
                                 device=device)
               for name, shape in shapes.items()}
    ffn = f"ffn{SEP}"
    experts = {name[len(ffn):]: full for name, full in stacked.items()
               if cfg.moe.enabled and name.startswith(ffn)}
    for name, full in stacked.items():
        if cfg.moe.enabled and name.startswith(ffn):
            continue                    # drawn per expert below
        for i in range(cfg.num_layers):
            if name.endswith("scale"):
                full[i].fill_(1.0)
            else:
                common.dense_init_(full[i], generator)
    for i in range(cfg.num_layers if experts else 0):
        moe.init_moe_layer(cfg, generator, device=device,
                           out={n: full[i] for n, full in experts.items()})
    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=generator,
                        dtype=torch.float32, device=device).mul_(0.02)
    top = {"embed": embed.to(dtype),
           "final_norm::scale": torch.ones(cfg.d_model, dtype=dtype,
                                           device=device)}
    if not cfg.tie_embeddings:
        top["lm_head"] = common.dense_init_(
            torch.empty((cfg.d_model, cfg.vocab_size), dtype=dtype,
                        device=device), generator)
    return _assemble(stacked, top, cfg)


def num_params(params) -> int:
    """Parameter count of a port parameter dict (any nesting)."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    vals = params.values() if isinstance(params, dict) else params
    return sum(num_params(v) for v in vals)

"""Weights for the port: the bridge from the reference's parameters and
back, a seeded initialiser, and the checkpointer's write side.

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

the ``ssm`` family (Mamba-2) has one SSM block and one norm a layer
(:func:`repro_torch.models.ssm.ssm_leaf_shapes`)::

    stack::ssm::w_in           (L, d, 2·d_inner + 2·N + nh)
    stack::ssm::conv_w         (L, W, conv_dim)  — and conv_b (L, conv_dim)
    stack::ssm::a_log          (L, nh)           — and dt_bias, d_skip
    stack::ssm::out_norm::scale (L, d_inner)
    stack::ssm::w_out          (L, d_inner, d)
    stack::ln::scale           (L, d)

the ``hybrid`` family (RecurrentGemma) stacks its ``n_super`` super-blocks
and keeps its trailing recurrent layers apart, each sublayer a mixer, an
MLP and two norms (:func:`repro_torch.models.rglru.rglru_leaf_shapes`)::

    stack::rec1::mixer::w_x    (n_super, d, W)   — and w_gate; w_a, w_i
                                                   (W, W); w_out (W, d);
                                                   conv_w (conv_width, W);
                                                   conv_b, b_a, b_i, lam (W,)
    stack::rec1::mlp::w_gate   (n_super, d, F)   — and w_up; w_down (F, d)
    stack::rec1::ln1::scale    (n_super, d)      — and ln2; rec2 the same
    stack::attn::mixer::wq     (n_super, d, H, hd) — and wk, wv, wo; mlp,
                                                   ln1, ln2 as rec1's
    trail_0::mixer::w_x        (d, W)            — trail_i as rec1, unstacked

and the ``encdec`` family (Whisper) an encoder and a decoder stack::

    enc_stack::attn::wq        (L_enc, d, H, hd) — and wk, wv, wo
    enc_stack::mlp::w_gate     (L_enc, d, F)     — and w_up, w_down; ln1, ln2
    enc_norm::scale            (d,)
    dec_stack::self_attn::wq   (L, d, H, hd)     — and wk, wv, wo; cross_attn
                                                   the same
    dec_stack::mlp::w_gate     (L, d, F)         — and w_up, w_down; ln1,
                                                   ln_x, ln2

A ``vlm`` config (Qwen2-VL's backbone) has the dense family's leaves.  With
MLA the attention leaves are the latent projections of
:func:`repro_torch.models.mla.mla_leaf_shapes` (``stack::attn::w_kv_down``
…), and DeepSeek-V2 (MoE with MLA) has its dense-FFN prefix layer apart
from the stack, unstacked, as ``prefix_0::attn::…``, ``prefix_0::ffn::
w_gate`` (d, F) …, ``prefix_0::ln1::scale``; the stack then holds
``L − 1`` layers.

The port's parameters are a plain dict with the same leaves and layouts,
except that the layers become one list ``layers`` of per-layer dicts, the
prefix layers first (stack layers are views into one stacked tensor per
leaf); the hybrid and encdec families keep the reference's groups, each
stack a list of per-layer (per-super-block) dicts.  Training keeps its
state (parameters, gradients, AdamW's moments) in the reference's tree
instead (:func:`params_to_tree`; :func:`params_from_tree` makes the
layers' views again), so its flat keys are the reference's as they are.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import unstack
from repro_torch.models import common, mla, moe, rglru, ssm
from repro_torch.models.hybrid import _counts as hybrid_counts
from repro_torch.models.transformer import num_prefix_layers

SEP = tu.SEP


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Read a flat-key ``::`` npz file into a dict of arrays."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as f:
        return {k: f[k] for k in f.files}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid", "encdec"):
        raise ValueError(f"unknown family {cfg.family!r}")


# the families whose tree is the reference's groups (``_groups``) rather
# than one stack of uniform layers
GROUPED_FAMILIES = ("hybrid", "encdec")


def _sublayer(cfg: ModelConfig, mixers: Dict[str, Dict[str, tuple]],
              norms=("ln1", "ln2")) -> Dict[str, tuple]:
    """One hybrid or Whisper sublayer's leaves: each mixer's, the SwiGLU
    MLP's and the norms'."""
    d, f = cfg.d_model, cfg.d_ff
    shapes = {f"{m}{SEP}{k}": v for m, leaves in mixers.items()
              for k, v in leaves.items()}
    shapes.update({"mlp::w_gate": (d, f), "mlp::w_up": (d, f),
                   "mlp::w_down": (f, d)})
    shapes.update({f"{n}::scale": (d,) for n in norms})
    return shapes


def _groups(cfg: ModelConfig) -> Dict[str, Tuple[Optional[int],
                                                 Dict[str, tuple]]]:
    """The hybrid and encdec trees: each group's layer count (None:
    unstacked) and one layer's leaves."""
    d, h, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    gqa = lambda: {"wq": (d, h, hd), "wk": (d, hkv, hd),
                   "wv": (d, hkv, hd), "wo": (h, hd, d)}
    if cfg.family == "hybrid":
        n_super, n_trail = hybrid_counts(cfg)
        rec = _sublayer(cfg, {"mixer": rglru.rglru_leaf_shapes(cfg)})
        block = {f"{sub}{SEP}{k}": v for sub in ("rec1", "rec2")
                 for k, v in rec.items()}
        block.update({f"attn{SEP}{k}": v for k, v in
                      _sublayer(cfg, {"mixer": gqa()}).items()})
        groups = {"stack": (n_super, block)}
        groups.update({f"trail_{i}": (None, rec) for i in range(n_trail)})
        return groups
    return {"enc_stack": (cfg.encdec.num_encoder_layers,
                          _sublayer(cfg, {"attn": gqa()})),
            "enc_norm": (None, {"scale": (d,)}),
            "dec_stack": (cfg.num_layers, _sublayer(
                cfg, {"self_attn": gqa(), "cross_attn": gqa()},
                norms=("ln1", "ln_x", "ln2")))}


def _grouped(make, cfg: ModelConfig, top: Dict[str, torch.Tensor]) -> Dict:
    """The hybrid or encdec parameters: ``make(key, shape)`` gives each
    group's leaf (with the layer axis first for a stack), split into one
    dict per layer."""
    params = {"embed": top["embed"],
              "final_norm": {"scale": top["final_norm::scale"]}}
    if not cfg.tie_embeddings:
        params["lm_head"] = top["lm_head"]
    for group, (n, shapes) in _groups(cfg).items():
        lead = () if n is None else (n,)
        full = {name: make(f"{group}{SEP}{name}", lead + shape)
                for name, shape in shapes.items()}
        params[group] = (tu.unflatten(full) if n is None else
                         [tu.unflatten({k: t[i] for k, t in full.items()})
                          for i in range(n)])
    return params


def _fill_grouped(cfg: ModelConfig, params: Dict,
                  generator: torch.Generator, device) -> None:
    """Draw every leaf of a hybrid or encdec tree in place: each RG-LRU
    mixer (a dict holding ``lam``) by :func:`rglru.init_rglru_layer`, norm
    scales ones, matrices by ``dense_init_``."""
    def walk(node):
        if "lam" in node:
            rglru.init_rglru_layer(cfg, generator, device=device, out=node)
            return
        for v in node.values():
            if isinstance(v, dict):
                walk(v)
            elif isinstance(v, list):
                for layer in v:
                    walk(layer)
            elif v.dim() == 1:
                v.fill_(1.0)
            else:
                common.dense_init_(v, generator)
    walk({k: v for k, v in params.items()
          if k not in ("embed", "final_norm", "lm_head")})


def _layer_shapes(cfg: ModelConfig, *, moe_ffn: bool) -> Dict[str, tuple]:
    """Every leaf of one layer (``::`` keys under ``stack``, or a prefix
    layer's with ``moe_ffn=False``) and its shape."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.family == "ssm":
        shapes = {f"ssm{SEP}{k}": v
                  for k, v in ssm.ssm_leaf_shapes(cfg).items()}
        shapes["ln::scale"] = (d,)
        return shapes
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if cfg.mla.enabled:
        shapes = {f"attn{SEP}{k}": v
                  for k, v in mla.mla_leaf_shapes(cfg).items()}
    else:
        shapes = {"attn::wq": (d, h, hd), "attn::wk": (d, hkv, hd),
                  "attn::wv": (d, hkv, hd), "attn::wo": (h, hd, d)}
    shapes.update({"ln1::scale": (d,), "ln2::scale": (d,)})
    if moe_ffn:
        shapes.update({f"ffn{SEP}{k}": v
                       for k, v in moe.moe_leaf_shapes(cfg).items()})
    else:
        shapes.update({"ffn::w_gate": (d, f), "ffn::w_up": (d, f),
                       "ffn::w_down": (f, d)})
    return shapes


def _assemble(prefix, stacked: Dict[str, torch.Tensor],
              top: Dict[str, torch.Tensor], cfg: ModelConfig) -> Dict:
    """``prefix``: each prefix layer's flat leaves; ``stacked``: the stack's
    ``(L', …)`` leaves."""
    n_stack = cfg.num_layers - len(prefix)
    split = {name: unstack(full) for name, full in stacked.items()}
    layers = [tu.unflatten(p) for p in prefix] + [
        tu.unflatten({name: split[name][i] for name in stacked})
        for i in range(n_stack)]
    params = {"embed": top["embed"],
              "final_norm": {"scale": top["final_norm::scale"]},
              "layers": layers}
    if not cfg.tie_embeddings:
        params["lm_head"] = top["lm_head"]
    return params


def _from_flat(flat: Dict, cfg: ModelConfig, conv) -> Dict:
    """The reference's flat parameter keys → the port's parameters, each
    leaf through ``conv`` (its shape checked)."""
    _check_family(cfg)

    def take(key, shape):
        arr = flat[key]
        if tuple(arr.shape) != shape:
            raise ValueError(f"{key}: shape {tuple(arr.shape)}, expected "
                             f"{shape}")
        return conv(arr)

    top = {"embed": conv(flat["embed"]),
           "final_norm::scale": conv(flat[f"final_norm{SEP}scale"])}
    if not cfg.tie_embeddings:
        top["lm_head"] = conv(flat["lm_head"])
    if cfg.family in GROUPED_FAMILIES:
        return _grouped(take, cfg, top)
    n_prefix = num_prefix_layers(cfg)
    n_stack = cfg.num_layers - n_prefix
    stacked = {name: take(f"stack{SEP}{name}", (n_stack,) + shape)
               for name, shape in _layer_shapes(
                   cfg, moe_ffn=cfg.moe.enabled).items()}
    prefix = [{name: take(f"prefix_{i}{SEP}{name}", shape)
               for name, shape in _layer_shapes(cfg, moe_ffn=False).items()}
              for i in range(n_prefix)]
    return _assemble(prefix, stacked, top, cfg)


def params_from_numpy(flat: Dict[str, np.ndarray], cfg: ModelConfig, *,
                      device, dtype=torch.float32) -> Dict:
    """The reference's flat parameter dict → the port's parameters."""
    return _from_flat(flat, cfg, lambda a: torch.tensor(np.asarray(a)).to(
        device=device, dtype=dtype))


def params_from_tree(tree: Dict, cfg: ModelConfig) -> Dict:
    """The reference's parameter tree (nested dicts of stacked tensors, the
    training state's layout) → the port's parameters, with every layer's
    leaves views into the stacked tensors: differentiable, so the gradient
    of a stacked leaf gathers each layer's (``Model.train_logits`` builds
    them on every call)."""
    return _from_flat(dict(tu.flatten_with_path(tree)), cfg, lambda t: t)


def _leaf(node: Dict, name: str) -> torch.Tensor:
    for part in name.split(SEP):
        node = node[part]
    return node


def params_to_tree(params: Dict, cfg: ModelConfig) -> Dict:
    """The inverse of :func:`params_from_tree`: the port's parameters →
    the reference's tree, each stack's layers restacked into ``(L', …)``
    leaves (a copy), the prefix layers as ``prefix_i``, the hybrid's and
    Whisper's groups under the reference's keys."""
    _check_family(cfg)
    flat = {"embed": params["embed"],
            f"final_norm{SEP}scale": params["final_norm"]["scale"]}
    if not cfg.tie_embeddings:
        flat["lm_head"] = params["lm_head"]
    if cfg.family in GROUPED_FAMILIES:
        for group, (n, shapes) in _groups(cfg).items():
            for name in shapes:
                flat[f"{group}{SEP}{name}"] = (
                    _leaf(params[group], name) if n is None else torch.stack(
                        [_leaf(layer, name) for layer in params[group]]))
        return tu.unflatten(flat)
    n_prefix = num_prefix_layers(cfg)
    for i in range(n_prefix):
        for name in _layer_shapes(cfg, moe_ffn=False):
            flat[f"prefix_{i}{SEP}{name}"] = _leaf(params["layers"][i], name)
    for name in _layer_shapes(cfg, moe_ffn=cfg.moe.enabled):
        flat[f"stack{SEP}{name}"] = torch.stack(
            [_leaf(layer, name) for layer in params["layers"][n_prefix:]])
    return tu.unflatten(flat)


def params_to_numpy(params: Dict, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_numpy`: the port's parameters →
    the reference's flat ``::`` keys and arrays."""
    return {k: _numpy(v) for k, v in
            tu.flatten_with_path(params_to_tree(params, cfg))}


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device, dtype=torch.float32) -> Dict:
    """Random parameters drawn from the reference's distributions
    (``repro/models/common.py``): matrices truncated-normal in [−2, 2]
    scaled by 1/√fan_in (:func:`~repro_torch.models.common.dense_init_`;
    an expert stack one expert at a time, as the reference's
    ``stack_init``; an SSM block's leaves as
    :func:`~repro_torch.models.ssm.init_ssm_layer`, an RG-LRU block's as
    :func:`~repro_torch.models.rglru.init_rglru_layer`), the embedding normal ×
    0.02, norm scales ones.  Same
    distributions, not the same numbers.  Each matrix is drawn in float32
    on ``device`` (``generator`` must live there) and stored in
    ``dtype``."""
    _check_family(cfg)
    empty = lambda shape: torch.empty(shape, dtype=dtype, device=device)
    if cfg.family in GROUPED_FAMILIES:
        params = _grouped(lambda _, shape: empty(shape), cfg,
                          _draw_top(cfg, generator, device, dtype))
        _fill_grouped(cfg, params, generator, device)
        return params
    n_prefix = num_prefix_layers(cfg)
    n_stack = cfg.num_layers - n_prefix
    stacked = {name: empty((n_stack,) + shape)
               for name, shape in _layer_shapes(
                   cfg, moe_ffn=cfg.moe.enabled).items()}
    prefix = [{name: empty(shape) for name, shape in _layer_shapes(
        cfg, moe_ffn=False).items()} for _ in range(n_prefix)]
    # the leaves a family draws itself, layer by layer: the MoE FFN's
    # (expert by expert) and the SSM block's
    own, init_own = ((f"ffn{SEP}", moe.init_moe_layer) if cfg.moe.enabled
                     else (f"ssm{SEP}", ssm.init_ssm_layer))
    owned = {name[len(own):]: full for name, full in stacked.items()
             if name.startswith(own)}
    fill = lambda t: (t.fill_(1.0) if t.dim() == 1
                      else common.dense_init_(t, generator))
    for name, full in stacked.items():
        if name.startswith(own):
            continue                    # drawn by the family below
        for i in range(n_stack):
            fill(full[i])
    for i in range(n_stack if owned else 0):
        init_own(cfg, generator, device=device,
                 out={n: full[i] for n, full in owned.items()})
    for layer in prefix:
        for t in layer.values():
            fill(t)
    return _assemble(prefix, stacked,
                     _draw_top(cfg, generator, device, dtype), cfg)


def _draw_top(cfg: ModelConfig, generator: torch.Generator, device,
              dtype) -> Dict[str, torch.Tensor]:
    """The embedding (normal × 0.02), the final norm (ones) and the untied
    head (fan-in truncated normal)."""
    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=generator,
                        dtype=torch.float32, device=device).mul_(0.02)
    top = {"embed": embed.to(dtype),
           "final_norm::scale": torch.ones(cfg.d_model, dtype=dtype,
                                           device=device)}
    if not cfg.tie_embeddings:
        top["lm_head"] = common.dense_init_(
            torch.empty((cfg.d_model, cfg.vocab_size), dtype=dtype,
                        device=device), generator)
    return top


def num_params(params) -> int:
    """Parameter count of a port parameter dict (any nesting)."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    vals = params.values() if isinstance(params, dict) else params
    return sum(num_params(v) for v in vals)


# --------------------------------------------------------------------------
# The checkpointer (port of ``repro/checkpoint/checkpointer.py``): flat-key
# npz snapshots of any tree (parameters, optimizer state, or both)
# --------------------------------------------------------------------------

def _numpy(leaf) -> np.ndarray:
    """A leaf as a numpy array; bfloat16 (which numpy lacks) as float32,
    which :func:`restore_like` casts back exactly."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.numpy()
    return np.asarray(leaf)


def save(path: str, tree: Any, *, step: Optional[int] = None,
         extra_meta: Optional[Dict] = None) -> str:
    """Write ``tree``'s leaves to ``path`` (``.npz``) under the reference's
    flat keys (:mod:`repro_torch.tree`: ``0::embed``, ``1::.mu::…``), and
    a ``.meta.json`` beside it with the step, the sorted keys and under
    ``treedef`` the port's own description of the containers
    (:func:`repro_torch.tree.structure`; the reference writes JAX's
    treedef there).  Neither package's :func:`restore_like` reads
    ``treedef``: the template gives the structure."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _numpy(v) for k, v in tu.flatten_with_path(tree)}
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)
    meta = {"step": step, "keys": sorted(flat),
            "treedef": tu.structure(tree)}
    if extra_meta:
        meta.update(extra_meta)
    with open(re.sub(r"\.npz$", "", path) + ".meta.json", "w") as f:
        json.dump(meta, f, indent=1, default=str)
    return path


def restore_like(path: str, template: Any) -> Any:
    """Restore into the structure of ``template``: each leaf a tensor of
    the template leaf's dtype and device (shapes checked)."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as f:
        def one(key, leaf):
            arr = f[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs template {tuple(leaf.shape)}")
            return torch.as_tensor(arr).to(device=leaf.device,
                                           dtype=leaf.dtype)
        return tu.tree_map_with_path(one, template)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for m in
             (re.match(r"step_(\d+)\.npz$", n) for n in os.listdir(ckpt_dir))
             if m]
    return max(steps) if steps else None


def save_step(ckpt_dir: str, step: int, tree: Any, **kw) -> str:
    return save(os.path.join(ckpt_dir, f"step_{step:08d}.npz"), tree,
                step=step, **kw)


def restore_step(ckpt_dir: str, step: int, template: Any) -> Any:
    return restore_like(os.path.join(ckpt_dir, f"step_{step:08d}.npz"),
                        template)

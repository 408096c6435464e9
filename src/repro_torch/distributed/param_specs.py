"""Parameter and cache partition specs, FSDP over ``data`` and tensor
parallelism over ``model`` (port of ``repro/distributed/param_specs.py``).

A leaf is matched by the last key of its path in the reference's parameter
tree (:func:`repro_torch.checkpoint.params_to_tree`, walked by
:mod:`repro_torch.tree`); a dimension whose size its mesh axes do not
divide is replicated instead.  Rules count dimensions from the end, so one
rule covers a stacked ``(L, …)`` leaf and an unstacked one.  The default is
2-D: the tensor-parallel dimension (heads, FFN hidden, experts, vocab) over
``model`` and the other large one over ``data``; ``fsdp=False`` keeps the
second replicated.

The spec functions read only ``mesh.shape`` and ``mesh.axis_names`` and
return :class:`~repro_torch.distributed.sharding.PartitionSpec` tuples.
:func:`param_shardings` and :func:`cache_shardings` turn them into
``torch.distributed.tensor`` placements (``Shard(d)`` / ``Replicate()``,
one per mesh dimension) for a :class:`~repro_torch.distributed.sharding.
Mesh`.  The serve calls none of them: its tensors stay replicated.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

from repro_torch import tree as tu
from repro_torch.distributed.sharding import PartitionSpec as P

# (last key, per-dimension logical axes counted from the END)
_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    ("embed", ("vocab", "fsdp")),
    ("lm_head", ("fsdp", "vocab")),
    ("wq", ("fsdp", "tp", None)),
    ("w_q", ("fsdp", "tp", None)),
    ("wk", ("fsdp", "tp", None)),
    ("wv", ("fsdp", "tp", None)),
    ("wo", ("tp", None, "fsdp")),
    ("w_gate", ("fsdp", "tp")),         # dense MLP
    ("w_up", ("fsdp", "tp")),
    ("w_down", ("tp", "fsdp")),
    ("router", ("fsdp", None)),
    ("w_kv_down", ("fsdp", None)),
    ("w_q_down", ("fsdp", None)),
    ("w_q_up", (None, "tp", None)),
    ("w_uk", (None, "tp", None)),
    ("w_uv", (None, "tp", None)),
    ("w_in", ("fsdp", "tp")),
    ("w_x", ("fsdp", "tp")),
    ("w_a", ("tp", None)),
    ("w_i", ("tp", None)),
    ("w_out", ("tp", "fsdp")),
    ("conv_w", (None, "tp")),
)

# MoE expert stacks have a leading expert dimension.  Where the expert
# count does not divide the model axis, the FFN hidden dimension is
# sharded instead.
_MOE_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    ("w_gate", ("experts", "fsdp", None)),
    ("w_up", ("experts", "fsdp", None)),
    ("w_down", ("experts", None, "fsdp")),
)
_MOE_FALLBACK = {
    "w_gate": (None, "fsdp", "tp"),
    "w_up": (None, "fsdp", "tp"),
    "w_down": (None, "tp", "fsdp"),
}


def _axes_for(logical: Optional[str], *, fsdp: bool
              ) -> Optional[Tuple[str, ...]]:
    if logical in ("tp", "vocab", "experts"):
        return ("model",)
    if logical == "fsdp" and fsdp:
        return ("data",)
    return None


def _size(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def leaf_pspec(path_keys: Tuple[str, ...], shape: Tuple[int, ...], mesh, *,
               fsdp: bool = True) -> P:
    last = path_keys[-1]
    ndim = len(shape)
    is_moe_expert = (last in ("w_gate", "w_up", "w_down")
                     and "ffn" in path_keys and ndim >= 3
                     and "shared" not in path_keys)
    rules = _MOE_RULES if is_moe_expert else _RULES
    if is_moe_expert and shape[ndim - 3] % mesh.shape.get("model", 1):
        rules = ((last, _MOE_FALLBACK[last]),)
    for name, dims in rules:
        if last == name and ndim >= len(dims):
            parts: list = [None] * ndim
            for i, logical in enumerate(dims):
                dim = ndim - len(dims) + i
                axes = _axes_for(logical, fsdp=fsdp)
                if axes is not None and shape[dim] % _size(mesh, axes) == 0:
                    parts[dim] = axes[0] if len(axes) == 1 else axes
            return P(*parts)
    return P()          # replicated (norms, biases, small vectors)


def param_pspecs(params_tree: Any, mesh, *, fsdp: bool = True) -> Any:
    """The spec of every leaf of the reference-keyed parameter tree (leaves
    are tensors, meta tensors included), in a tree of the same
    structure."""
    return tu.tree_map_with_path(
        lambda key, x: leaf_pspec(tuple(key.split(tu.SEP)), tuple(x.shape),
                                  mesh, fsdp=fsdp), params_tree)


def placements(spec: P, mesh) -> tuple:
    """``torch.distributed.tensor`` placements of ``spec`` on ``mesh``: one
    per mesh axis, ``Shard(d)`` where the spec puts that axis on tensor
    dimension ``d``, else ``Replicate()`` (also on an axis of one rank,
    whose one shard is the whole tensor)."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for dim, part in enumerate(spec):
        for axis in (part,) if isinstance(part, str) else (part or ()):
            where[axis] = dim
    return tuple(Shard(where[a]) if a in where and mesh.shape[a] > 1
                 else Replicate() for a in mesh.axis_names)


def param_shardings(params_tree: Any, mesh, *, fsdp: bool = True) -> Any:
    """:func:`param_pspecs` as placements (:func:`placements`), for
    ``torch.distributed.tensor.distribute_tensor(leaf,
    mesh.device_mesh, placements)``."""
    return tu.tree_map_with_path(
        lambda key, x: placements(leaf_pspec(
            tuple(key.split(tu.SEP)), tuple(x.shape), mesh, fsdp=fsdp),
            mesh), params_tree)


# --------------------------------------------------------------------------
# Cache and batch specs
# --------------------------------------------------------------------------

def _data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_pspec(mesh, batch: int) -> P:
    axes = _data_axes(mesh)
    if axes and batch % _size(mesh, axes) == 0:
        return P(axes if len(axes) > 1 else axes[0])
    return P()


def cache_pspec(shape: Tuple[int, ...], mesh, *, batch: int,
                stacked: bool) -> P:
    """A KV-cache leaf's spec: batch over (pod, data); ONE of {kv heads,
    head dim, sequence} over model (in that order, where divisible); a
    batch-1 long-decode cache shards its sequence over (pod, data)
    instead."""
    dims = list(shape)
    parts: list = [None] * len(dims)
    i0 = 1 if stacked else 0
    data_axes = _data_axes(mesh)
    dsize = _size(mesh, data_axes) if data_axes else 1
    msize = mesh.shape.get("model", 1)
    data_part = data_axes if len(data_axes) > 1 else (
        data_axes[0] if data_axes else None)

    used_data = False
    if data_axes and dims[i0] % dsize == 0 and dims[i0] > 1:
        parts[i0] = data_part
        used_data = True

    # one dimension for the model axis: kv heads > head dim > sequence
    model_dim = None
    cands = {4: (i0 + 1, i0 + 3, i0 + 2),      # (B, Hkv, S, hd)
             3: (i0 + 1, i0 + 2)}              # (B, S, R) MLA latent
    for cand in cands.get(len(dims) - i0, ()):
        if dims[cand] % msize == 0 and dims[cand] >= msize:
            model_dim = cand
            break
    if model_dim is not None and "model" in mesh.axis_names:
        parts[model_dim] = "model"

    # batch 1, long decode: the sequence over (pod, data)
    if not used_data and data_axes and len(dims) - i0 >= 3:
        seq = i0 + 2 if len(dims) - i0 == 4 else i0 + 1
        if parts[seq] is None and dims[seq] % dsize == 0 \
                and dims[seq] >= dsize:
            parts[seq] = data_part
    return P(*parts)


def _stacked(shape, batch: int) -> bool:
    """The leaf's first dimension is the layer stack (batch at dim 1)."""
    return len(shape) >= 2 and shape[0] != batch and shape[1] == batch


def cache_shardings(cache: Any, mesh, *, batch: int) -> Any:
    """:func:`cache_pspec` of every leaf of a cache tree, as placements."""
    return tu.tree_map(
        lambda x: placements(cache_pspec(
            tuple(x.shape), mesh, batch=batch,
            stacked=_stacked(tuple(x.shape), batch)), mesh), cache)

"""Logical-axis sharding rules and the heads-sharded serve (port of
``repro/distributed/sharding.py``).

A :class:`ShardingRules` context maps logical axis names (``batch``,
``heads``, ``mlp`` …) to the axes of a :class:`Mesh` of ranks.  Outside a
context nothing is sharded.  Inside one whose ``"model"`` axis is larger
than 1, the serve's three hot kernels run per head shard (the
**mesh-active routing rule**, :func:`active_model_mesh`):

  * sparse prefill, B.2, through :func:`sharded_batched_block_sparse_attention`;
  * sparse decode, B.3, through :func:`sharded_flash_decode`;
  * paged sparse decode, B.4, through :func:`sharded_flash_decode_paged`.

Each keeps the reference's ``shard_map`` contract with ``out_specs =
P(None, axis)``: global tensors go in, held replicated by every rank; rank r
of n takes heads ``[r·H/n, (r+1)·H/n)`` with the kv heads of their GQA
groups, builds its tables from its own slice of the masks or the plan,
launches the kernel on its slice, and all-gathers the heads into the global
output, the same on every rank.  Head-parallel attention reduces nothing
across shards, and the decode split rule takes the model's kv-head count
(:func:`repro_torch.kernels.decode_attn.decode_splits`), so every output is
bitwise the single-device output.

Logical axes:
  batch        data parallelism over ("pod", "data")
  seq          context parallelism — the long-decode cache's sequence
  heads        tensor parallelism over "model" — attention heads
  kv_heads     over "model" (GQA: fewer than the axis → replicated)
  embed        the replicated feature dimension of activations
  mlp          over "model" — the FFN's hidden dimension
  experts      expert parallelism over "model"
  vocab        over "model" — embedding and logits
  ssm_inner    over "model" — the SSM / RG-LRU channel dimension
  stack        the layer-stack dimension (never sharded)
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

_state = threading.local()

DEFAULT_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "seq": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "embed": None,
    "mlp": ("model",),
    "experts": ("model",),
    "expert_cap": None,
    "vocab": ("model",),
    "ssm_inner": ("model",),
    "ssm_state": None,
    "stack": None,
    "blocks_q": None,
    "blocks_kv": None,
    "clusters": None,
}

# calls of the sharded functions by (function, local heads, heads): which
# head shard each launch ran (the counters the chip run reads)
SHARD_CALLS: collections.Counter = collections.Counter()


def reset_shard_calls() -> None:
    SHARD_CALLS.clear()


# the all-gathers of this process: calls, bytes received, host seconds
GATHER_STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}


def reset_gather_stats() -> None:
    GATHER_STATS.update(calls=0, bytes=0, seconds=0.0)


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec`` as a tuple: one entry per tensor dimension,
    each a mesh axis name, a tuple of names, or None (replicated); ``P()``
    replicates every dimension."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """A mesh of ranks: a thin class over torch's ``DeviceMesh`` read as
    JAX reads its mesh — ``axis_names`` in order, ``shape`` a name → size
    dict — with each axis's process group and this rank's index on it."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))

    def group(self, axis: str):
        """The process group of the ranks along ``axis`` through this
        rank."""
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's position along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


class ShardingRules:
    def __init__(self, mesh,
                 overrides: Optional[Dict[str, Optional[Tuple[str, ...]]]]
                 = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if overrides:
            self.rules.update(overrides)
        axes = set(mesh.axis_names)
        # drop mesh axes the current mesh does not have (e.g. "pod" on one
        # pod)
        for k, v in list(self.rules.items()):
            if v is None:
                continue
            kept = tuple(a for a in v if a in axes)
            self.rules[k] = kept if kept else None

    def spec(self, *logical: Optional[str]) -> PartitionSpec:
        parts = []
        for name in logical:
            axes = None if name is None else self.rules.get(name)
            if axes is None:
                parts.append(None)
            elif len(axes) == 1:
                parts.append(axes[0])
            else:
                parts.append(axes)
        return P(*parts)


def current_rules() -> Optional[ShardingRules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    """Make ``rules`` current in this thread for the ``with`` block."""
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def head_shard_count(mesh, axis: str, num_heads: int,
                     num_kv_heads: int) -> int:
    """Usable shard count of ``axis`` for head-parallel attention: the axis
    size when both head counts divide it (each shard holds whole GQA
    groups), else 1 (replicated)."""
    if axis not in mesh.axis_names:
        return 1
    n = mesh.shape[axis]
    if n <= 1 or num_heads % n or num_kv_heads % n:
        return 1
    return n


def active_model_mesh(axis: str = "model"):
    """The mesh-active routing rule of sparse prefill and sparse decode: the
    current rules context's mesh when its ``axis`` is larger than 1, else
    None.  :func:`repro_torch.models.attention.resolve_attention_fn` routes
    the prefill kernel by it, and the decode of a plan goes through
    :func:`shardable_model_mesh`, so a served model runs prefill and decode
    under one mesh with no per-call configuration."""
    rules = current_rules()
    if rules is None or axis not in rules.mesh.axis_names:
        return None
    return rules.mesh if rules.mesh.shape[axis] > 1 else None


def shardable_model_mesh(num_heads: int, num_kv_heads: int,
                         axis: str = "model"):
    """:func:`active_model_mesh` with head divisibility folded in: the mesh
    when both head counts shard over ``axis``, else None.  The attention's
    decode resolves through it (the plan itself is global on every rank:
    :mod:`repro_torch.serving.decode_plan`)."""
    mesh = active_model_mesh(axis)
    if mesh is None or head_shard_count(mesh, axis, num_heads,
                                        num_kv_heads) <= 1:
        return None
    return mesh


def shard_range(mesh, axis: str, num_heads: int, num_kv_heads: int
                ) -> Tuple[slice, slice]:
    """This rank's ``(heads, kv heads)`` slices on ``axis``; raises
    ``ValueError`` where the head counts do not shard over it."""
    n = head_shard_count(mesh, axis, num_heads, num_kv_heads)
    if n <= 1:
        raise ValueError(
            f"head counts {num_heads}/{num_kv_heads} do not shard over mesh "
            f"axis {axis!r} of {mesh.shape}")
    r = mesh.index(axis)
    h, hkv = num_heads // n, num_kv_heads // n
    return slice(r * h, (r + 1) * h), slice(r * hkv, (r + 1) * hkv)


def all_gather(tensor: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``tensor`` of ``group``, in the group's rank order.
    The bytes are gathered (a ``uint8`` view), so any dtype goes through
    any backend exactly.  Gloo takes CUDA tensors here (it stages them
    through host memory itself; torch 2.11 on the H100, phase 22).  Adds
    to :data:`GATHER_STATS`."""
    src = tensor.contiguous()
    raw = src.reshape(-1).view(torch.uint8)
    n = dist.get_world_size(group)
    t0 = time.perf_counter()
    parts = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(parts, raw, group=group)
    GATHER_STATS["calls"] += 1
    GATHER_STATS["bytes"] += n * raw.numel()
    GATHER_STATS["seconds"] += time.perf_counter() - t0
    return [p.view(src.dtype).reshape(src.shape) for p in parts]


def gather_cat(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated on ``dim`` in the
    axis's rank order (heads come back in order, not interleaved)."""
    return torch.cat(all_gather(x, mesh.group(axis)), dim=dim)


def sharded_batched_block_sparse_attention(
    q: torch.Tensor,               # (B, H, N, Dqk)
    k: torch.Tensor,               # (B, Hkv, N, Dqk)
    v: torch.Tensor,               # (B, Hkv, N, Dv)
    block_mask: torch.Tensor,      # (B, H, NBq, NBkv) bool
    *,
    mesh,
    axis: str = "model",
    block_size: int,
    causal: bool = True,
    width: Optional[int] = None,
    stats_gate: Optional[torch.Tensor] = None,     # (B, H)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Heads-sharded batched block-sparse prefill (B.2): this rank's head
    slice of every operand through
    :func:`repro_torch.kernels.ops.batched_block_sparse_attention`, whose
    ``(indices, counts)`` tables are built from the rank's own mask slice;
    the output ``(B, H, N, Dv)`` and Ã ``(B, H, NBq, NBkv)`` are gathered
    over the heads.  Raises ``ValueError`` where the head counts do not
    shard (callers such as :func:`repro_torch.kernels.
    batched_sparse_attention_fn` take the single-device path then)."""
    from repro_torch.kernels.ops import batched_block_sparse_attention

    hs, ks = shard_range(mesh, axis, q.shape[1], k.shape[1])
    gate = None if stats_gate is None else stats_gate[:, hs].contiguous()
    out, a_tilde = batched_block_sparse_attention(
        q[:, hs].contiguous(), k[:, ks].contiguous(), v[:, ks].contiguous(),
        block_mask[:, hs], block_size=block_size, causal=causal, width=width,
        stats_gate=gate)
    SHARD_CALLS["prefill", hs.stop - hs.start, q.shape[1]] += 1
    return (gather_cat(out, mesh, axis, 1),
            gather_cat(a_tilde, mesh, axis, 1))


def _plan_slice(plan, ks: slice):
    from repro_torch.kernels.decode_attn import DecodePlan
    return DecodePlan(*(x[:, ks].contiguous() for x in plan))


def sharded_flash_decode(
    q: torch.Tensor,               # (B, H, D) one token per sequence
    cache_k: torch.Tensor,         # (B, Hkv, S, D)
    cache_v: torch.Tensor,         # (B, Hkv, S, Dv)
    plan,                          # DecodePlan, one layer's (B, Hkv, …)
    valid: torch.Tensor,           # (B, S) bool slot validity
    *,
    mesh,
    axis: str = "model",
    impl: str = "auto",
) -> torch.Tensor:
    """Heads-sharded sparse decode over a DecodePlan (B.3): this rank's
    queries, kv heads of the cache and plan rows through
    :func:`repro_torch.kernels.decode_attn.flash_decode_plan`, split by the
    model's kv-head count; the kernel reads the rank's kv heads of the
    replicated cache in place (a head-slice view, no copy), and the
    validity is shared.  Returns ``(B, H, Dv)``
    gathered over the heads, bitwise the single-device decode.  MLA's
    latent cache and the hybrid's ring never reach it: they decode densely,
    with no plan."""
    from repro_torch.kernels.decode_attn import flash_decode_plan

    hs, ks = shard_range(mesh, axis, q.shape[1], cache_k.shape[1])
    out = flash_decode_plan(
        q[:, hs].contiguous(), cache_k[:, ks], cache_v[:, ks],
        _plan_slice(plan, ks), valid, impl=impl,
        num_kv_heads=cache_k.shape[1])
    SHARD_CALLS["decode", ks.stop - ks.start, cache_k.shape[1]] += 1
    return gather_cat(out, mesh, axis, 1)


def sharded_flash_decode_paged(
    q: torch.Tensor,               # (B, H, D) one token per slot
    pool_k: torch.Tensor,          # (P, Hkv, ps, D) shared page pool
    pool_v: torch.Tensor,          # (P, Hkv, ps, Dv)
    page_table: torch.Tensor,      # (B, NB) int32
    plan,                          # DecodePlan, one layer's (B, Hkv, …)
    valid: torch.Tensor,           # (B, NB·ps) bool
    *,
    mesh,
    axis: str = "model",
    impl: str = "auto",
) -> torch.Tensor:
    """:func:`sharded_flash_decode` over a block-paged pool (B.4): the
    pool's heads axis (axis 1) is sliced as the contiguous cache's, and
    read in place; the page table and validity are shared (residency is a slot's, not a head's).
    Returns ``(B, H, Dv)``, bitwise the single-device paged decode."""
    from repro_torch.kernels.decode_attn import flash_decode_plan_paged

    hs, ks = shard_range(mesh, axis, q.shape[1], pool_k.shape[1])
    out = flash_decode_plan_paged(
        q[:, hs].contiguous(), pool_k[:, ks], pool_v[:, ks], page_table,
        _plan_slice(plan, ks), valid, impl=impl,
        num_kv_heads=pool_k.shape[1])
    SHARD_CALLS["decode_paged", ks.stop - ks.start, pool_k.shape[1]] += 1
    return gather_cat(out, mesh, axis, 1)


def shard_spec(rules: ShardingRules, shape: Tuple[int, ...],
               logical: Tuple[Optional[str], ...]) -> PartitionSpec:
    """The reference's ``shard`` spec of a tensor of ``shape`` under
    ``rules``: ``logical`` may be shorter than the shape (missing trailing
    axes are replicated); a mesh axis appears at most once (the first
    dimension that asks for it wins); a dimension its axes do not divide is
    replicated (e.g. 8 kv heads on a 16-way model axis)."""
    logical = tuple(logical) + (None,) * (len(shape) - len(logical))
    parts = []
    used: set = set()
    for dim, name in zip(shape, logical):
        axes = None if name is None else rules.rules.get(name)
        if axes:
            axes = tuple(a for a in axes if a not in used)
        if not axes:
            parts.append(None)
            continue
        size = 1
        for a in axes:
            size *= rules.mesh.shape[a]
        if dim % size != 0:
            parts.append(None)
        else:
            used.update(axes)
            parts.append(axes[0] if len(axes) == 1 else axes)
    return P(*parts)


class _Constrain(torch.autograd.Function):
    """Redistribute to ``placements``, and the gradient to the same ones,
    as JAX transposes a sharding constraint into the same constraint on
    the cotangent (``DTensor.redistribute``'s own backward would return it
    to the input's placements)."""

    @staticmethod
    def forward(ctx, x, place):
        ctx.place = place
        return x.redistribute(x.device_mesh, place)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.place), None


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """The reference's activation constraint: inside a rules context, a
    ``DTensor`` is redistributed to the placements of :func:`shard_spec`
    (its gradient too); anything else (a plain tensor, or no context)
    comes back as the same object.  The port's serve keeps plain tensors,
    so only the step bundles (:mod:`repro_torch.launch.steps`) on
    ``DTensor`` arguments are placed by it."""
    rules = current_rules()
    if rules is None or type(x) is torch.Tensor:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.distributed.param_specs import placements
    want = placements(shard_spec(rules, tuple(x.shape), logical), rules.mesh)
    if tuple(x.placements) == want and not x.requires_grad:
        return x
    return _Constrain.apply(x, want)


def empty_stack(entry: torch.Tensor, n: int) -> torch.Tensor:
    """An uninitialised ``(n, *entry.shape)`` stack for ``n`` layers' cache
    entries like ``entry`` (batch first): ``entry.new_empty`` on a plain
    tensor, one allocation; on a ``DTensor`` inside a rules context, this
    rank's shard alone, placed by the reference's ``cache_pspec(...,
    stacked=True)`` (``new_empty`` on a ``DTensor`` replicates the whole
    stack on every rank)."""
    rules = current_rules()
    shape = (n, *entry.shape)
    if rules is None or type(entry) is torch.Tensor:
        return entry.new_empty(shape)
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(entry, DTensor):
        return entry.new_empty(shape)
    from repro_torch.distributed.param_specs import cache_pspec, placements
    place = placements(cache_pspec(shape, rules.mesh, batch=entry.shape[0],
                                   stacked=True), rules.mesh)
    mesh = entry.device_mesh
    local = list(shape)
    for axis, p in enumerate(place):
        if isinstance(p, Shard):        # cache_pspec splits evenly
            local[p.dim] //= mesh.size(axis)
    stride = [1] * len(shape)           # the global tensor's, contiguous
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(entry.to_local().new_empty(local), mesh,
                              place, run_check=False, shape=shape,
                              stride=tuple(stride))


def unstack(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``x.unbind(0)``: a stacked leaf's layers.  A ``DTensor`` sharded on
    its stack axis (the reference's specs shard a dense FFN's layer stack
    as an expert stack) is gathered on that axis first, once for all its
    layers, its other placements kept."""
    if type(x) is not torch.Tensor:
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if isinstance(x, DTensor) and Shard(0) in x.placements:
            x = x.redistribute(x.device_mesh, [
                Replicate() if p == Shard(0) else p for p in x.placements])
    return x.unbind(0)

"""What a step dispatches: collective bytes, FLOPs, bytes accessed and the
peak of its live memory, and the roofline terms they give (the counterpart
of ``repro/launch/hlo_analysis.py``).

The reference reads a compiled program: XLA's ``cost_analysis`` and the
optimized HLO text.  A torch step has no HLO, so :class:`StepCounter`, a
``TorchDispatchMode``, counts the aten ops the step dispatches while it
runs.  On ``DTensor`` arguments it steps aside (``NotImplemented``), so
``DTensor`` unwraps each op and the mode sees the **local** op of this rank,
and the collectives its redistributions issue: every count is **per
rank**, as the reference's ``cost_analysis`` is per partition.  Ops that
``DTensor``'s sharding propagation runs on fake tensors to learn output
shapes are not counted.

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode``'s formulas (its
    ``flop_registry``: matmuls, convolutions, attention) on each local op.
  * Bytes accessed: each op's input and output tensor bytes, views
    excluded (a view moves no data).
  * Collectives: calls and output bytes per category of the ``c10d`` and
    ``_c10d_functional`` ops, the reference's "op-output bytes" convention
    (an all-gather's output ≈ the bytes landing on each rank).
  * Memory: the peak of the live bytes of storages the step creates, less
    its outputs' (``temp``), so that argument + temp + output bytes are
    the step's peak (an upper bound: a dead storage is found within
    ``_SWEEP`` ops).

Counting runs on any tensors: meta tensors in the dry-run (no data, no
allocation), real ones on the card.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")

# c10d / _c10d_functional op names (without namespace and overload) → the
# reference's HLO categories
_CATEGORY = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "c10d")
# functional-collective bookkeeping ops: their output is their input's data
# (on meta shards a new storage object, which takes the input's place)
_ALIASES = ("_wrap_tensor_autograd", "wait_tensor")
# live storages: the newest are checked after every op, all of them every
# _SWEEP ops (a dead storage older than the newest _RECENT may count until
# the next sweep: the peak is an upper bound within that window)
_RECENT = 64
_SWEEP = 256


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s local shard, else ``t``."""
    return getattr(t, "_local_tensor", t)


def _storage_key(t: torch.Tensor):
    from torch.multiprocessing.reductions import StorageWeakRef
    return StorageWeakRef(t.untyped_storage())


def tree_bytes(tree) -> int:
    """Local bytes of every tensor of ``tree`` (a ``DTensor``'s shard on
    this rank), each storage once."""
    seen, total = set(), 0
    for t in _tensors(tree):
        t = _local(t)
        ref = _storage_key(t)
        if ref.cdata not in seen:
            seen.add(ref.cdata)
            total += t.untyped_storage().nbytes()
    return total


_PLAIN = (torch.Tensor, torch.nn.Parameter)


def _fake_mode_active() -> bool:
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


class StepCounter(TorchDispatchMode):
    """Counts what a step dispatches on this rank (module docstring)::

        with StepCounter(args) as c:
            out = fn(*args)
        c.flops, c.bytes_accessed, c.collectives, c.temp_bytes(out)

    ``args`` are the step's arguments: their storages are not the step's
    own (an in-place write into them allocates nothing), and their device
    is the step's: an op touching no tensor on it (``DTensor``'s own index
    arithmetic on the CPU) is not counted."""

    def __init__(self, args=()):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self.flop_registry = FlopCounterMode().flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.ops = 0
        self.collectives = {op: {"count": 0, "bytes": 0}
                            for op in COLLECTIVE_OPS}
        local = [_local(t) for t in _tensors(args)]
        self._known = {_storage_key(t).cdata for t in local}
        self._device = local[0].device.type if local else None
        self._live: Dict[int, tuple] = {}       # cdata → (weak ref, bytes)
        self._live_bytes = 0
        self.peak_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _fake_mode_active():
            return func(*args, **kwargs)    # DTensor's sharding propagation
        if any(t not in _PLAIN for t in types):
            return NotImplemented           # a DTensor: count its local ops
        out = func(*args, **kwargs)
        if self._device is None or any(
                t.device.type == self._device
                for t in _tensors((args, kwargs, out))):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        self.ops += 1
        packet = func._overloadpacket
        if packet in self.flop_registry:
            self.flops += int(self.flop_registry[packet](
                *args, **kwargs, out_val=out))
        ns = func.namespace
        if ns in _NAMESPACES:
            cat = _CATEGORY.get(packet.__name__)
            if cat is not None:
                self.collectives[cat]["count"] += 1
                self.collectives[cat]["bytes"] += sum(
                    nbytes(t) for t in _tensors(out))
        if ns in _NAMESPACES and packet.__name__ in _ALIASES:
            self._untrack(args)
            self._track(out)
            return
        if not func.is_view:
            self.bytes_accessed += sum(
                nbytes(t) for t in _tensors((args, kwargs, out)))
        self._track(out)

    def _untrack(self, tree) -> None:
        for t in _tensors(tree):
            entry = self._live.pop(_storage_key(t).cdata, None)
            if entry is not None:
                self._live_bytes -= entry[1]

    def _track(self, out) -> None:
        keys = (list(self._live) if self.ops % _SWEEP == 0
                else [c for c, _ in zip(reversed(self._live), range(_RECENT))])
        for cdata in keys:
            if self._live[cdata][0].expired():
                self._live_bytes -= self._live.pop(cdata)[1]
        for t in _tensors(out):
            ref = _storage_key(t)
            if ref.cdata in self._known or ref.cdata in self._live:
                continue
            size = t.untyped_storage().nbytes()
            self._live[ref.cdata] = (ref, size)
            self._live_bytes += size
        self.peak_bytes = max(self.peak_bytes, self._live_bytes)

    def output_bytes(self, out) -> int:
        """Local bytes of the step's outputs that are not its arguments
        (an output written in place into an argument is counted there)."""
        seen, total = set(self._known), 0
        for t in _tensors(out):
            t = _local(t)
            ref = _storage_key(t)
            if ref.cdata not in seen:
                seen.add(ref.cdata)
                total += t.untyped_storage().nbytes()
        return total

    def temp_bytes(self, out) -> int:
        """The peak of the step's live bytes less its outputs'."""
        return max(self.peak_bytes - self.output_bytes(out), 0)


def collective_bytes(counter: StepCounter) -> Dict[str, Dict[str, float]]:
    """Per-category ``{count, bytes}`` of the collectives a counted step
    issued on this rank."""
    return {op: dict(v) for op, v in counter.collectives.items()}


def roofline_terms(*, flops: float, bytes_accessed: float,
                   coll: Dict[str, Dict[str, float]], chips: int,
                   peak_flops: float, hbm_bw: float, link_bw: float
                   ) -> Dict[str, float]:
    """Three-term roofline (seconds).  The counts are per rank, so the terms
    divide by per-card rates only."""
    del chips
    total_coll = sum(v["bytes"] for v in coll.values())
    return {
        "compute_s": flops / peak_flops,
        "memory_s": bytes_accessed / hbm_bw,
        "collective_s": total_coll / link_bw,
        "collective_bytes": total_coll,
        "flops": flops,
        "bytes_accessed": bytes_accessed,
    }


def dominant_term(terms: Dict[str, float]) -> str:
    cand = {k: terms[k] for k in ("compute_s", "memory_s", "collective_s")}
    return max(cand, key=cand.get)

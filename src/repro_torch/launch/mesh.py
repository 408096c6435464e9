"""Process groups, meshes and ranks for the heads-sharded serve (port of
``repro/launch/mesh.py``).

The reference's mesh is one process over many devices; the port's is one
process per rank under ``torch.distributed``.  :func:`init_process_group`
picks the backend (:func:`rank_backend`): NCCL when every rank of a node
has a card of its own, gloo when ranks share a card or run on the CPU.
The mesh factories then lay the world's ranks out as a ``("data",
"model")`` (or ``("pod", "data", "model")``) :class:`~repro_torch.
distributed.sharding.Mesh`, and
:func:`run_ranks` starts a world of ranks in fresh processes (``spawn``:
CUDA cannot be initialised again in a forked child).

:func:`fake_world` starts a world of ``"fake"`` ranks in this one process
(no collective moves data), on which the dry-run lays out the production
meshes.  The hardware constants below are the card's, for the roofline.

Importing this module touches no device and starts no process.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import multiprocessing
import os
import sys
import time
from typing import Callable, Mapping, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import Mesh

# NVIDIA H100 SXM5 80GB hardware constants for the roofline model (per card;
# data-sheet peaks at the 700 W power limit).
PEAK_FLOPS_BF16 = 989e12        # dense bf16 on the tensor cores, FLOP/s
HBM_BW = 3.35e12                # HBM3, bytes/s
LINK_BW = 450e9                 # NVLink 4, one direction, bytes/s


def rank_backend(rank: int, world_size: int, device: str, cards: int,
                 env: Mapping[str, str] = os.environ
                 ) -> Tuple[str, torch.device]:
    """The backend and device of ``rank`` of ``world_size`` with ``cards``
    visible on its node.  The node's share of the world is ``LOCAL_RANK``
    of ``LOCAL_WORLD_SIZE`` (``torchrun`` sets both; without them the
    whole world is one node, as :func:`run_ranks` starts it).
    ``device="cuda"`` takes card ``LOCAL_RANK % cards``: NCCL when the
    node's ranks each have their own card, gloo when they share one (NCCL
    refuses two ranks on one device); it raises where there is no card.
    ``device="cpu"`` takes gloo on the CPU."""
    if device == "cpu":
        return "gloo", torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if cards < 1:
        raise RuntimeError("no CUDA device: pass device='cpu' (the "
                           "launcher's --device cpu) to run on the CPU")
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_size = int(env.get("LOCAL_WORLD_SIZE", world_size))
    return ("nccl" if cards >= local_size else "gloo",
            torch.device("cuda", local_rank % cards))


def init_process_group(rank: int, world_size: int, *, init_method: str,
                       device: str = "cuda",
                       timeout_s: float = 600.0) -> torch.device:
    """Join the default process group as ``rank`` of ``world_size`` and
    return this rank's device, both as :func:`rank_backend` picks them.
    Collectives give up after ``timeout_s``.  Prints the backend and the
    device."""
    cards = torch.cuda.device_count() if device == "cuda" \
        and torch.cuda.is_available() else 0
    backend, dev = rank_backend(rank, world_size, device, cards)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.init()               # the mesh reads the device type
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    # one write, so that the ranks' lines do not interleave
    sys.stdout.write(f"rank {rank}/{world_size}: backend {backend}, device "
                     f"{dev}\n")
    sys.stdout.flush()
    return dev


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of ``world_size`` ``"fake"`` ranks over a
    ``FakeStore``, this process being rank 0: meshes lay out over it and
    collectives return at once, moving no data.  Raises if a default group
    exists; destroys the group on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _device_type() -> str:
    """The meshes' device type: the card's where CUDA is in use, the CPU's
    on a fake world (its ranks hold no data)."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        return "cpu"
    return "cuda" if torch.cuda.is_available() and \
        torch.cuda.is_initialized() else "cpu"


def _mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    return Mesh(DeviceMesh(_device_type(),
                           torch.arange(n).reshape(tuple(shape)),
                           mesh_dim_names=tuple(axes)))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """``(data 16, model 16)`` over 256 ranks, or ``(pod 2, data 16, model
    16)`` over 512 with ``multi_pod``; raises on any other world size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks, have "
                         f"{dist.get_world_size()}")
    return _mesh(shape, axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
    """A small mesh for tests over the first ``prod(shape)`` ranks."""
    return _mesh(shape, axes)


def make_serving_mesh(model_parallel: int = 0,
                      data_parallel: int = 1) -> Mesh:
    """The serving launcher's ``(data, model)`` mesh over the world's ranks.
    ``model_parallel=0`` puts every rank left after ``data_parallel`` on
    the model axis.  A rules context on a mesh whose model axis is larger
    than 1 runs sparse prefill and sparse decode per head shard (the
    mesh-active routing rule, :func:`repro_torch.distributed.sharding.
    active_model_mesh`)."""
    n = dist.get_world_size()
    dp = max(data_parallel, 1)
    mp = model_parallel or max(n // dp, 1)
    if dp * mp > n:
        raise ValueError(f"mesh (data={dp}, model={mp}) needs {dp * mp} "
                         f"devices, have {n}")
    return _mesh((dp, mp), ("data", "model"))


def _rank_main(rank: int, world_size: int, init_method: str, device: str,
               timeout_s: float, fn: Callable, args: tuple) -> None:
    dev = init_process_group(rank, world_size, init_method=init_method,
                             device=device, timeout_s=timeout_s)
    try:
        fn(rank, dev, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, args: tuple = (), *,
              init_file: str, device: str = "cuda",
              timeout_s: float = 600.0) -> None:
    """Run ``fn(rank, device, *args)`` in ``world_size`` fresh processes
    (the ``spawn`` start method), each first joining the process group
    through the file store ``init_file`` (which must not exist yet) with
    :func:`init_process_group`, whose device it passes on.  ``fn`` must
    be importable by name.  Waits for every rank; raises if one exits with
    an error (its traceback is on its stderr) or outlives ``timeout_s``,
    which also bounds each collective.  Leaves no process running."""
    if os.path.exists(init_file):
        raise ValueError(f"{init_file} exists: a file store starts empty")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        r, world_size, f"file://{init_file}", device, timeout_s, fn, args))
        for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        # a failed rank ends the world at once: the others would wait on
        # their next collective until its timeout
        while any(p.is_alive() for p in procs) \
                and time.monotonic() < deadline \
                and not any(p.exitcode for p in procs):
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    bad = {r: c for r, c in enumerate(codes) if c != 0}
    if bad:
        raise RuntimeError(f"ranks failed (rank: exit code; negative: killed "
                           f"by that signal): {bad}")

"""The ranks' side of ``test_torch_dtensor_costs.py``: the three repaired
``DTensor`` sites run with values by four gloo ranks on the CPU under a
``(data 2, model 2)`` mesh.  The ranks import the port only (no JAX): the
test process writes the inputs, starts the ranks with
:func:`repro_torch.launch.mesh.run_ranks` and holds rank 0's results
against the plain functions.

Each rank places the inputs from its own full copy (``src_data_rank=None``:
a local slice, no scatter) and runs, inside a rules context:
  * ``cross_entropy`` on logits split batch over data and vocab over model,
    and its gradient;
  * ``chunked_attention`` on q split (batch, heads) and K/V split over the
    batch alone (GQA-expanded kv heads), with and without a block mask and
    stats;
  * ``empty_stack`` filled with batch-split cache entries, layer by layer.
Rank 0 writes each result gathered whole, with its placements.
"""
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.distributed.sharding import (
    ShardingRules,
    empty_stack,
    use_rules,
)
from repro_torch.kernels.chunked import chunked_attention
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.training.losses import cross_entropy

BLOCK = 16


def costs_rank(rank: int, device, inputs: str, out: str) -> None:
    torch.set_num_threads(1)
    x = torch.load(inputs)
    mesh = make_test_mesh((2, 2))

    def put(t, *place):
        return distribute_tensor(t, mesh.device_mesh, list(place),
                                 src_data_rank=None)

    res = {}
    with use_rules(ShardingRules(mesh)), implicit_replication():
        logits = put(x["logits"], Shard(0), Shard(2)).requires_grad_()
        loss, metrics = cross_entropy(
            logits, put(x["labels"], Shard(0), Replicate()),
            put(x["mask"], Shard(0), Replicate()))
        grad, = torch.autograd.grad(loss, logits)
        res["loss"] = loss.full_tensor()
        res["accuracy"] = metrics["accuracy"].full_tensor()
        res["grad"] = grad.full_tensor()
        res["grad_placements"] = tuple(grad.placements)

        q = put(x["q"], Shard(0), Shard(1))
        k, v = (put(x[n], Shard(0), Replicate()) for n in ("k", "v"))
        plain = chunked_attention(q, k, v, block_size=BLOCK)
        out_m, stats = chunked_attention(
            q, k, v, block_size=BLOCK, collect_stats=True,
            block_mask=put(x["block_mask"], Shard(0), Replicate()))
        res["out"] = plain.full_tensor()
        res["out_masked"] = out_m.full_tensor()
        res["stats"] = stats.full_tensor()
        res["out_placements"] = tuple(plain.placements)

        entries = [put(e, Shard(0), Replicate()) for e in x["entries"]]
        stack = empty_stack(entries[0], len(entries))
        for i, e in enumerate(entries):
            stack[i] = e
        res["stack"] = stack.full_tensor()
        res["stack_placements"] = tuple(stack.placements)
        res["stack_local_shape"] = tuple(stack.to_local().shape)
    if rank == 0:
        torch.save(res, out)

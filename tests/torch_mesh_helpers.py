"""The ranks' side of ``test_torch_mesh_serve.py``: what each of two gloo
ranks on the CPU runs under a ``(data 1, model 2)`` mesh.  The ranks
import the port only (no JAX): the test process prepares the inputs,
holds the ranks' results against the reference, and starts the ranks with
:func:`repro_torch.launch.mesh.run_ranks`.

Inputs (``torch.save``d by the test): the serve's parameters and prompts,
the plan config's random dictionary, the kernels' operands.  Each rank
writes ``rank{r}.pt``: the plan and the kv-head range of it that the
rank's decode reads, the sharded kernels' outputs, the serves' tokens and
every logit row they produced, unsharded and sharded, and the shard call
counters.
"""
import dataclasses

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.pattern_dict import PivotalState
from repro_torch.distributed import sharding as dsh
from repro_torch.kernels.decode_attn import DecodePlan
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import build_model
from repro_torch.serving import EngineConfig, Request, ServingEngine
from repro_torch.serving import decode_plan as dplan

ARCH = "llama3-8b-262k"
PLAN_HEADS = dict(num_heads=8, num_kv_heads=4)   # G = 2, 2 kv heads a rank


class Probe:
    """The model as the engine calls it, keeping every logit row."""

    def __init__(self, model):
        self.model, self.cfg, self.device = model, model.cfg, model.device
        self.logits = []

    def prefill(self, *args, **kwargs):
        result = self.model.prefill(*args, **kwargs)
        self.logits.append(result.last_logits.float().clone())
        return result

    def decode(self, *args, **kwargs):
        out = self.model.decode(*args, **kwargs)
        self.logits.append(out[0].float().clone())
        return out

    def __getattr__(self, name):
        return getattr(self.model, name)


def plan_config():
    return dataclasses.replace(get_smoke_config(ARCH), **PLAN_HEADS)


def _plans(inp, mesh):
    """The plan a sharded serve builds (the global one, under the rules
    context as the engine builds it) and, per layer, the kv-head range that
    this rank's sharded decode slices out of it, at full width and
    capped."""
    cfg = plan_config()
    sp = build_model(cfg, device="cpu").default_share_prefill()
    st = PivotalState(*inp["state"])
    kw = dict(prefill_len=inp["prefill_len"], cache_len=inp["cache_len"])
    _, ks = dsh.shard_range(mesh, "model", cfg.num_heads, cfg.num_kv_heads)
    out = {}
    with dsh.use_rules(dsh.ShardingRules(mesh)):
        for key, width in (("", None), ("_w", inp["width"])):
            plan = dplan.build_decode_plan(sp, st, cfg, width=width, **kw)
            rows = [dsh._plan_slice(plan.layer(i), ks)
                    for i in range(cfg.num_layers)]
            out["global" + key] = tuple(plan)
            out["slice" + key] = tuple(torch.stack(x) for x in zip(*rows))
    return out


def _kernels(inp, mesh):
    k = inp["kernels"]
    out, a_tilde = dsh.sharded_batched_block_sparse_attention(
        k["q"], k["k"], k["v"], k["masks"], mesh=mesh,
        block_size=k["block_size"], stats_gate=k["gate"])
    plan = DecodePlan(*k["plan"])
    dec = dsh.sharded_flash_decode(k["dq"], k["ck"], k["cv"], plan,
                                   k["valid"], mesh=mesh, impl="kernel")
    paged = dsh.sharded_flash_decode_paged(
        k["dq"], k["pool_k"], k["pool_v"], k["page_table"], plan,
        k["valid"], mesh=mesh, impl="kernel")
    return {"b2": (out, a_tilde), "b3": dec, "b4": paged}


def _serve(model, params, inp, news, mesh, **ecfg):
    probe = Probe(model)
    eng = ServingEngine(probe, params, model.default_share_prefill(),
                        EngineConfig(method="share", decode_sparse=True,
                                     seq_buckets=(inp["seq"],), **ecfg))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(inp["prompts"], news))]
    dsh.reset_shard_calls()
    with dsh.use_rules(None if mesh is None else dsh.ShardingRules(mesh)):
        eng.serve(reqs)
    return {"tokens": [r.output_tokens.tolist() for r in reqs],
            "reasons": [r.finish_reason for r in reqs],
            "logits": probe.logits, "calls": dict(dsh.SHARD_CALLS),
            "pool": dict(eng.page_pool_stats)}


def _serves(inp, mesh):
    model = build_model(get_smoke_config(ARCH), device="cpu")
    params = inp["params"]
    out = {}
    for name, news, ecfg in (
            ("batch", inp["news"], dict(max_batch=2)),
            ("paged", inp["paged_news"], dict(max_batch=2, paged=True))):
        for m in (None, mesh):
            key = name if m is None else name + "_mesh"
            out[key] = _serve(model, params, inp, news, m, **ecfg)
    eng = ServingEngine(model, params, model.default_share_prefill(),
                        EngineConfig(scheduler=True, prefill_chunk=64,
                                     seq_buckets=(inp["seq"],)))
    with dsh.use_rules(dsh.ShardingRules(mesh)):
        under = eng._chunk_tokens(inp["seq"])
    out["chunk_tokens"] = (eng._chunk_tokens(inp["seq"]), under)
    return out


def rank_job(rank: int, device, in_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    inp = torch.load(in_path, weights_only=False)
    mesh = make_serving_mesh(2)
    result = {"mesh": (dict(mesh.shape), mesh.index("model")),
              "plans": _plans(inp, mesh),
              "kernels": _kernels(inp, mesh),
              "serves": _serves(inp, mesh)}
    torch.save(result, f"{out_dir}/rank{rank}.pt")

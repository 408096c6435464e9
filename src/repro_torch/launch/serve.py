"""Serving launcher: long-context requests through the engine (the port of
``repro/launch/serve.py``, with its flags and printed lines).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --smoke --num-requests 4 --prompt-len 512 --method share --device cpu

It runs on CUDA unless ``--device cpu`` is given (without a GPU and without
it, it raises).  Weights are random, drawn from seed 0.  ``--scheduler``
serves through the slot-based continuous-batching scheduler instead of
batch-at-a-time; ``--arrival-rate R`` spaces arrivals 1/R seconds apart;
``--max-new`` takes a comma-separated list cycled over the requests;
``--paged`` serves from the block-paged KV cache (``--num-pages`` caps the
pool, 0 sizes it); ``--prefix-sharing`` (paged) serves duplicate prompts
from one prefill, and ``--repeat-prompt N`` gives the first N requests
request 0's prompt.  ``--refresh-every N`` (paged, ``--decode-sparse``)
re-estimates a slot's decode plan every N tokens.

``--model-parallel N`` (N > 1) serves heads-sharded over a ``(data,
model)`` mesh of N ranks: sparse prefill and sparse decode run per head
shard (the mesh-active routing rule, :func:`repro_torch.distributed.
sharding.active_model_mesh`), bitwise the unsharded serve.  The launcher
starts the N ranks itself (the ``spawn`` start method) and rank 0 prints;
under ``torchrun`` (``RANK``/``WORLD_SIZE`` set) each process is one rank.
On one card the ranks share it over gloo; with ``--device cpu`` they run on
the CPU.  Prompts come from the data pipeline, whose retrieval task hashes
its name: rank 0's prompts are broadcast to every rank, and two launcher
runs serve the same prompts under one ``PYTHONHASHSEED``.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, sample
from repro_torch.distributed.sharding import ShardingRules, use_rules
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import build_model
from repro_torch.serving import EngineConfig, Request, ServingEngine


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--num-requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--max-new", default="8",
                    help="tokens to generate; a comma-separated list is "
                    "cycled over requests (mixed-length workload)")
    ap.add_argument("--scheduler", action="store_true",
                    help="slot-based continuous batching (per-slot decode "
                    "positions, EOS early exit, in-flight slot refill) "
                    "instead of batch-at-a-time")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="step-cadence chunked admission: tokens per "
                    "prefill quantum interleaved with decode steps (0 = "
                    "whole-sequence one-shot admission); scheduler only")
    ap.add_argument("--prefill-pack", type=int, default=1,
                    help="pack up to N same-bucket queued prompts into one "
                    "chunked prefill run (block-diagonal isolation mask, "
                    "one slot per segment); needs --prefill-chunk")
    ap.add_argument("--paged", action="store_true",
                    help="block-paged KV cache: decode state in a shared "
                    "page pool with per-slot page tables (page_size == "
                    "pattern block size); ONE cross-bucket scheduler, "
                    "admission gated on pool headroom")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="page-pool capacity incl. the reserved null page "
                    "(0 = auto-size so max-batch slots can never starve); "
                    "undersized pools keep requests WAITING, never crash")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="prefill-once prompt sharing over the paged pool: "
                    "duplicate (clipped) prompts map the donor's KV pages "
                    "read-only and skip their prefill launch; bitwise-"
                    "invisible (COW at the decode boundary); needs --paged")
    ap.add_argument("--repeat-prompt", type=int, default=0,
                    help="first N requests reuse request 0's prompt (a "
                    "shared-prefix workload for --prefix-sharing)")
    ap.add_argument("--preempt-after", type=int, default=0,
                    help="preempt the lowest-priority decoding victim once "
                    "admission has been pool-starved for this many "
                    "consecutive steps (paged only; 0 = never preempt — "
                    "starved requests wait indefinitely)")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request wall budget from arrival; exceeded "
                    "requests finish with reason 'timeout' (0 = none; "
                    "scheduler only)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="simulated request arrivals per second (0 = all "
                    "requests arrive at once); the scheduler honours "
                    "arrival times for admission")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="decode slots (scheduler) / batch size (legacy)")
    ap.add_argument("--method", default="share",
                    choices=["share", "dense", "vertical_slash", "flex"])
    ap.add_argument("--attn-impl", default="auto",
                    choices=["auto", "sparse", "chunked"],
                    help="prefill attention backend (auto and sparse = the "
                    "batched block-sparse kernel; its plain version on the "
                    "CPU)")
    ap.add_argument("--decode-sparse", action="store_true",
                    help="decode-phase pattern sharing via the build-once "
                    "DecodePlan (needs --method share)")
    ap.add_argument("--refresh-every", type=int, default=0,
                    help="adaptive pattern refresh: re-estimate a slot's "
                    "decode plan from the strip scores of its recent-query "
                    "window every N decode steps (paged + --decode-sparse "
                    "only; 0 = frozen plans, the bitwise default)")
    ap.add_argument("--refresh-mass", type=float, default=0.95,
                    help="per-head cumulative score-mass budget a refreshed "
                    "row must cover (higher = wider keep-sets)")
    ap.add_argument("--refresh-tail-threshold", type=float, default=0.0,
                    help="also refresh early when a slot's dense-tail "
                    "fraction crosses this value (0 = cadence only)")
    ap.add_argument("--model-parallel", type=int, default=0,
                    help="model-axis size of the serving mesh; > 1 runs "
                    "prefill and decode heads-sharded over that many ranks")
    ap.add_argument("--task", default="retrieval")
    ap.add_argument("--device", default=None,
                    help="cpu to serve on the CPU (default: cuda)")
    return ap.parse_args(argv)


def make_requests(args, vocab_size: int):
    dcfg = DataConfig(vocab_size=vocab_size, seq_len=args.prompt_len,
                      global_batch=1, task=args.task)
    max_new = [int(m) for m in str(args.max_new).split(",")]
    gap = 1.0 / args.arrival_rate if args.arrival_rate > 0 else 0.0
    return [
        Request(uid=i,
                prompt=sample(dcfg, 0 if i < args.repeat_prompt
                              else i)["tokens"],
                max_new_tokens=max_new[i % len(max_new)],
                arrival_s=i * gap, deadline_s=args.deadline_s)
        for i in range(args.num_requests)
    ]


def serve(args, device, mesh=None, show: bool = True):
    """Build the model and requests, serve them (under ``mesh``'s rules
    when given) and, with ``show``, print the reference's report.  Returns
    the requests."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    sp = model.default_share_prefill()
    requests = make_requests(args, cfg.vocab_size)
    if mesh is not None:
        # every rank serves rank 0's prompts (see the module docstring)
        prompts = [r.prompt for r in requests]
        dist.broadcast_object_list(prompts, src=0)
        for r, p in zip(requests, prompts):
            r.prompt = p

    engine = ServingEngine(
        model, params, sp,
        EngineConfig(method=args.method,
                     attn_impl=args.attn_impl,
                     decode_sparse=args.decode_sparse,
                     max_batch=args.max_batch,
                     scheduler=args.scheduler,
                     prefill_chunk=args.prefill_chunk,
                     prefill_pack=args.prefill_pack,
                     paged=args.paged,
                     num_pages=args.num_pages,
                     preempt_after_steps=args.preempt_after,
                     prefix_sharing=args.prefix_sharing,
                     refresh_every=args.refresh_every,
                     refresh_mass=args.refresh_mass,
                     refresh_tail_threshold=args.refresh_tail_threshold,
                     seq_buckets=(args.prompt_len,)))

    # one mesh for the whole serve: prefill and decode run under the same
    # rules context, so both hot paths resolve their sharded twin
    ctx = contextlib.ExitStack()
    if mesh is not None:
        ctx.enter_context(use_rules(ShardingRules(mesh)))
        if show:
            print(f"serving under mesh {dict(mesh.shape)}")

    with ctx:
        t0 = time.time()
        engine.serve(requests)
        wall = time.time() - t0
        if show:
            report(args, engine, requests, wall)
    return requests


def report(args, engine, requests, wall: float) -> None:
    for r in requests:
        m = r.metrics()
        lifecycle = (f" deferred={m['waiting_deferred_steps']}"
                     f" preempts={m['preempted_count']}"
                     if (m["waiting_deferred_steps"]
                         or m["preempted_count"]) else "")
        if r.prefix_hit:
            lifecycle += " prefix-hit"
        if r.refreshes:
            lifecycle += f" refreshes={r.refreshes}"
        err = f" error={r.error}" if r.error is not None else ""
        # plan-shape telemetry: the slot's dense-tail share and the share
        # of its allocated KV its plan row streams
        plan_shape = (f" tail={r.tail_fraction:.3f}"
                      f" traffic={r.plan_traffic_fraction:.3f}"
                      if r.plan_traffic_fraction > 0 else "")
        print(f"req {r.uid}: queue={r.queue_s:.3f}s ttft={r.ttft_s:.3f}s "
              f"prefill={r.prefill_s:.3f}s decode={r.decode_s:.3f}s "
              f"({r.decode_tokens_per_s:.1f} tok/s, "
              f"{r.finish_reason}/{r.state}){lifecycle}{plan_shape}{err} "
              f"out={r.output_tokens[:8].tolist()} "
              f"stats={r.pattern_stats}")
    # the engine serves batch-at-a-time the families with no per-slot
    # cache layout: label the mode by what ran
    sched_req = args.scheduler or args.paged
    mode = ("scheduler" if sched_req and engine._supports_scheduler()
            else "batch")
    if sched_req and mode == "batch":
        print("note: --scheduler/--paged requested but this family has no "
              "per-slot cache layout; served batch-at-a-time (dense "
              "carve-out)")
    if mode == "scheduler" and engine._chunk_tokens(args.prompt_len):
        mode = "scheduler-chunked"
    if mode != "batch" and args.paged:
        mode += "-paged"
        pool = {k: round(v, 3) if isinstance(v, float) else v
                for k, v in engine.page_pool_stats.items()}
        print(f"page pool: {pool} admissions deferred on headroom: "
              f"{engine.pages_exhausted_steps}, preemptions: "
              f"{engine.preemptions}")
        if args.prefix_sharing and engine.prefix_stats:
            pfx = {k: round(v, 3) for k, v in engine.prefix_stats.items()}
            print(f"prefix sharing: {pfx}")
        if args.refresh_every > 0:
            print(f"pattern refresh: "
                  f"{ {k: int(v) for k, v in engine.refresh_stats.items()} }")
    elif args.prefill_chunk > 0 and args.scheduler:
        print("note: --prefill-chunk requested but this config cannot be "
              "chunk-admitted (see ServingEngine._chunk_tokens); served "
              "with one-shot admission")
    print(f"total wall {wall:.2f}s, method={args.method}, mode={mode}, "
          f"slot occupancy {engine.slot_occupancy():.3f}, "
          f"phase_s={ {k: round(v, 3) for k, v in engine.phase_s.items()} }")


def serve_rank(rank: int, device, args) -> None:
    """One rank of a ``--model-parallel`` serve (inside its process
    group); rank 0 prints."""
    mesh = mesh_lib.make_serving_mesh(args.model_parallel)
    serve(args, device, mesh=mesh, show=rank == 0)


def main(argv=None):
    args = parse_args(argv)
    device = args.device or "cuda"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # torchrun
        rank = int(os.environ["RANK"])
        dev = mesh_lib.init_process_group(
            rank, int(os.environ["WORLD_SIZE"]), init_method="env://",
            device=device)
        try:
            serve_rank(rank, dev, args)
        finally:
            dist.destroy_process_group()
    elif args.model_parallel > 1:
        with tempfile.TemporaryDirectory() as tmp:
            mesh_lib.run_ranks(serve_rank, args.model_parallel, (args,),
                               init_file=os.path.join(tmp, "store"),
                               device=device)
    else:
        serve(args, args.device)


if __name__ == "__main__":
    main()

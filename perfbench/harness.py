"""One run of one cell: set-up, the measured window, the metrics, the
check, the result line.  ``run.py`` is the command line around
:func:`main`."""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import Dict, List

import numpy as np

from perfbench import files
from perfbench.traffic.generator import validate

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """Modules of the JAX package or JAX loaded in this process, compared
    by whole top-level name (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Failure(Exception):
    """A run that must print no result."""


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _records(specs, reqs, rec, buckets, due) -> List[dict]:
    """One dict a request.  ``due`` holds each request's due time on the
    host clock; its first token came ``Request.ttft_s`` (the port's span)
    after it."""
    out = []
    for spec, r, t_due in zip(specs, reqs, due):
        first = rec.first.get(spec.uid)
        toks = (np.asarray(r.output_tokens) if r.output_tokens is not None
                else np.zeros(0, np.int32))
        ok = (r.finish_reason in ("stop", "length") and r.error is None
              and len(toks) == spec.max_new_tokens)
        plen = len(spec.prompt)
        out.append({
            "uid": spec.uid, "prompt": spec.prompt, "prompt_len": plen,
            "bucket": next((b for b in buckets if plen <= b), buckets[-1]),
            "max_new": spec.max_new_tokens, "tokens": toks,
            "finish": r.finish_reason, "ok": ok, "due": t_due,
            "ttft_s": r.ttft_s if ok else None,
            "t_first": t_due + r.ttft_s if ok else None,
            "first_logits": None if first is None else first.float().cpu(),
            "queue_s": r.queue_s, "prefill_s": r.prefill_s,
            "decode_s": r.decode_s,
            "density": (r.pattern_stats or {}).get("block_density"),
            "dense_heads": (r.pattern_stats or {}).get("num_dense", 0.0)})
    return out


def warm_specs(traffic: dict, buckets, seed: int, vocab: int):
    """One request a bucket the traffic reaches, at the bucket's length."""
    from perfbench.traffic.generator import Spec, rng
    if traffic["loop"] == "closed":
        lo, hi = min(b[0] for b in traffic["bands"]), \
            max(b[1] for b in traffic["bands"])
        new = traffic["output_tokens"]
    else:
        lo, hi = traffic["prompt_tokens"]["lo"], traffic["prompt_tokens"]["hi"]
        new = 2
    used = [b for i, b in enumerate(buckets)
            if b >= lo and (i == 0 or buckets[i - 1] < hi)]
    g = rng(seed, 6)
    return [Spec(10 ** 9 + i, g.integers(0, vocab, b, dtype=np.int32), new)
            for i, b in enumerate(used)]


def closed_window(eng, tracer, traffic, args, vocab):
    """The closed loop: one client, whole cycles until ``seconds`` have
    passed; the traced run profiles the first cycle that starts after half
    the window (or one more cycle after it)."""
    from perfbench import system
    from perfbench.traffic.generator import closed_cycles
    cycles = closed_cycles(traffic, args.seed, vocab)
    specs, reqs, due = [], [], []
    t_open = time.perf_counter()
    while True:
        cycle = next(cycles)
        late = time.perf_counter() - t_open >= args.seconds / 2
        if tracer is not None and not tracer.done and late:
            tracer.start()
        for spec in cycle:
            r = system.request(spec)
            due.append(time.perf_counter())
            eng.serve([r])
            specs.append(spec)
            reqs.append(r)
        if tracer is not None and tracer.running:
            tracer.stop()
        if time.perf_counter() - t_open >= args.seconds:
            break
    t_close = time.perf_counter()
    extra = []
    if tracer is not None and not tracer.done:
        tracer.start()
        for spec in next(cycles):
            r = system.request(spec)
            extra.append((spec, r, time.perf_counter()))
            eng.serve([r])
        tracer.stop()
    return specs, reqs, due, t_open, t_close, extra


def open_window(eng, rec, tracer, traffic, args, vocab, trace_s: float):
    """The open loop: every request due in ``[0, seconds)`` handed to one
    ``serve``, which admits each at its due time and drains the rest; the
    traced run profiles from ``trace_s`` before the last due time to the
    end."""
    from perfbench import system
    from perfbench.traffic.generator import open_schedule
    specs = open_schedule(traffic, args.seed, args.seconds, vocab)
    reqs = [system.request(s) for s in specs]
    t_open = time.perf_counter()
    if tracer is not None:
        rec.trace_from = t_open + max(args.seconds - trace_s, 0.0)
    eng.serve(reqs)
    if tracer is not None and tracer.running:
        tracer.stop()
    due = [t_open + s.arrival_s for s in specs]
    return specs, reqs, due, t_open, time.perf_counter(), []


def setup(cfg, wl, traffic, seed, dev, tracer=None):
    """Weights from the seed, the port's model on them, its clusters, the
    instrumented engine, and one request of each bucket the traffic uses
    served to warm every shape up."""
    import types
    import torch
    from perfbench import system, weights
    from perfbench.traffic.generator import profile_prompt
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)      # the context, before its counters
        torch.cuda.reset_peak_memory_stats(dev)
    vocab = cfg["vocab_size"]
    flat = weights.make(cfg, seed, device=dev)
    model, params = system.build(cfg, flat, dev)
    sp, clusters, n_clusters, cluster_s = system.clusters(
        model, params, cfg,
        profile_prompt(seed, cfg["port"]["cluster_profile_tokens"], vocab),
        seed)
    rec = system.Recorder(tracer)
    undo = system.instrument(rec)
    eng = system.make_engine(model, params, sp, wl["engine"], rec)
    buckets = sorted(wl["engine"]["seq_buckets"])
    warm = warm_specs(traffic, buckets, seed, vocab)
    if traffic["loop"] == "closed":
        for w in warm:
            eng.serve([system.request(w)])
    else:
        eng.serve([system.request(w) for w in warm])
    return types.SimpleNamespace(
        flat=flat, model=model, params=params, sp=sp, clusters=clusters,
        n_clusters=n_clusters, cluster_s=cluster_s, rec=rec, undo=undo,
        eng=eng, buckets=buckets)


def run(argv, t_start: float) -> Dict:
    args = parse(argv)
    bench = files.benchmark()
    entry = files.cell_entry(bench, args.workload)
    wl = files.workload(args.workload)
    if (wl["config"], wl["traffic"]) != (entry["config"], entry["traffic"]):
        raise Failure(f"workloads/{args.workload}.json names "
                      f"{wl['config']}/{wl['traffic']}, BENCHMARK.json "
                      f"{entry['config']}/{entry['traffic']}")
    cfg = files.config(wl["config"])
    traffic = files.traffic(wl["traffic"])
    try:
        validate(traffic)
    except ValueError as e:
        raise Failure(f"traffic/{wl['traffic']}.json: {e}")
    e2e = files.metrics_for(bench, args.workload, "end_to_end")
    layer = files.metrics_for(bench, args.workload, "per_layer")
    readers = {m["name"]: files.reader(
        "end_to_end" if args.trace == 0 else "metrics", m["name"])
        for m in (e2e if args.trace == 0 else layer)}

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        raise Failure(f"{args.workload} needs {entry['chips']} CUDA "
                      f"device(s); found "
                      f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    return run_cell(args, t_start, entry, wl, cfg, traffic, e2e, layer,
                    readers, torch.device("cuda:0"))


def run_cell(args, t_start, entry, wl, cfg, traffic, e2e, layer, readers,
             dev, detail=None) -> Dict:
    """The run after the look for the card: on ``dev`` (the tests drive it
    on the CPU at a small size).  A ``detail`` dict (``calibrate.py``)
    receives the check's readings position by position, its timings, and
    with ``detail["control"]`` set the control's readings too."""
    import torch
    from perfbench import check
    from perfbench.trace import Tracer

    cuda = dev.type == "cuda"
    tracer = Tracer() if args.trace else None
    s = setup(cfg, wl, traffic, args.seed, dev, tracer)
    flat, clusters, n_clusters = s.flat, s.clusters, s.n_clusters
    eng, rec, undo, buckets = s.eng, s.rec, s.undo, s.buckets
    cluster_s = s.cluster_s
    model, params, sp = s.model, s.params, s.sp
    del s
    vocab = cfg["vocab_size"]
    if tracer is not None:
        tracer.warm()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.time() - t_start

    if traffic["loop"] == "closed":
        specs, reqs, due, t_open, t_close, extra = closed_window(
            eng, tracer, traffic, args, vocab)
    else:
        specs, reqs, due, t_open, t_close, extra = open_window(
            eng, rec, tracer, traffic, args, vocab,
            wl.get("trace_seconds", 6.0))
    bad = forbidden_modules()
    if bad:
        raise Failure(f"modules of JAX or the JAX package loaded: {bad}")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    records = _records(specs, reqs, rec, buckets, due)
    # a cycle traced after a short window: for the per-layer metrics only
    after = _records([e[0] for e in extra], [e[1] for e in extra], rec,
                     buckets, [e[2] for e in extra])
    summary = tracer.summary() if tracer is not None else None
    ctx = _Ctx(cfg=cfg, workload=wl, records=records, after=after,
               setup_s=setup_s,
               t_open=t_open, t_close=t_close, trace=summary,
               cluster_s=cluster_s)
    metrics = {}
    for m in (e2e if args.trace == 0 else layer):
        v = readers[m["name"]](ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the program's state goes before the reference runs
    undo()
    del eng, model, params, sp, rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = wl["check"]["limits"]
    faults = check.hard_faults(records)
    chosen = check.sample(records, wl["check"]["sample"], args.seed)
    got = {}
    t_ref = time.perf_counter()
    if chosen:
        rep = check.replay(cfg, flat, chosen, clusters, n_clusters)
        readings = check.system_rows(rep, chosen)
        got = check.numbers(readings)
        if detail is not None:
            detail["system"] = readings
            if detail.get("control"):
                low = check.replay(cfg, flat, chosen, clusters,
                                   n_clusters, precision="fp8")
                detail["control"] = check.control_rows(rep, low)
    ref_s = time.perf_counter() - t_ref
    print(f"timing: setup {setup_s:.2f} s (clustering {cluster_s:.2f}), "
          f"window {t_close - t_open:.2f} s, reference {ref_s:.2f} s, "
          f"requests {len(records)}, checked {len(chosen)}", file=sys.stderr)
    if detail is not None:
        detail.update(setup_s=setup_s, cluster_s=cluster_s,
                      window_s=t_close - t_open, reference_s=ref_s,
                      checked=[r["uid"] for r in chosen],
                      prompt_lens=[r["prompt_len"] for r in chosen])
    correct = (not faults and bool(chosen)
               and all(got.get(k) is not None and got[k] <= limits[k]
                       for k in limits))
    bad = forbidden_modules()
    if bad:
        raise Failure(f"modules of JAX or the JAX package loaded: {bad}")
    compared = {k: {"value": got.get(k), "limit": limits[k]}
                for k in limits}
    compared["requests_faulted"] = {"value": len(faults), "limit": 0}
    result = {
        "correct": correct, "attempted": len(records),
        "failed": sum(not r["ok"] for r in records), "metrics": metrics,
        "device": {"platform": "gpu", "kind": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
                   "count": entry["chips"], "memory_peak_bytes": int(peak)}}
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s,
                                window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checked"] = compared
    for f in faults[:20]:
        print(f"fault: {f}", file=sys.stderr)
    for k, v in compared.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    return result


class _Ctx:
    """What a metric reader reads: ``cfg`` (the configuration file),
    ``workload``, ``records`` (one dict a request of the window),
    ``after`` (requests traced after the window, if any),
    ``setup_s``, ``t_open``/``t_close`` (host clock), ``trace`` (a
    :class:`perfbench.trace.Summary` or None) and ``cluster_s``."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def main(argv, t_start: float) -> int:
    try:
        result = run(argv, t_start)
    except Failure as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    return 0

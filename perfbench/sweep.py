"""The served cell's rate sweep (once, on the card; not part of a
benchmark run): one set-up, then the open loop at each rate for
``--seconds``, with TTFT's median and 90th percentile, the time the serve
ran past the last due time, and the mean TTFT of the window's last third
over its first third (a backlog that grows through the window reads well
above 1):

    python3 perfbench/sweep.py --workload <cell> --seed <n> \
        --seconds <s> --rates 1.5,2,2.5
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from perfbench import run as entry  # noqa: E402


def main() -> int:
    entry.prepare()
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    a = p.parse_args()
    import numpy as np
    import torch
    from perfbench import files, harness
    wl = files.workload(a.workload)
    cfg, traffic = files.config(wl["config"]), files.traffic(wl["traffic"])
    s = harness.setup(cfg, wl, traffic, a.seed, torch.device("cuda:0"))
    for rate in (float(r) for r in a.rates.split(",")):
        tr = dict(traffic, rate_per_s=rate)
        s.rec.first.clear()             # uids repeat from rate to rate
        args = argparse.Namespace(seed=a.seed, seconds=a.seconds)
        specs, reqs, due, t0, t1, _ = harness.open_window(
            s.eng, s.rec, None, tr, args, cfg["vocab_size"], 0.0)
        recs = harness._records(specs, reqs, s.rec, s.buckets, due)
        ttft = np.array([r["ttft_s"] if r["ok"] else np.inf for r in recs])
        third = max(len(ttft) // 3, 1)
        print(json.dumps({
            "rate": rate, "requests": len(recs),
            "failed": sum(not r["ok"] for r in recs),
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p90_s": float(np.percentile(ttft, 90)),
            "past_last_due_s": t1 - t0 - max(sp.arrival_s for sp in specs),
            "last_over_first_third": float(ttft[-third:].mean()
                                           / ttft[:third].mean()),
            "queue_p50_s": float(np.median([r["queue_s"] for r in recs]))}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

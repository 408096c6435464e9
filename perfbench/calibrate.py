"""Readings that the check's limits are set from, on the card at a cell's
own size and load (not part of a benchmark run):

    python3 perfbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds 1,2,3,... --control-seeds 1,2,3 --out <file.jsonl>

For each seed, one whole run of the cell (set-up from the seed, a window
of ``--seconds``, the check), its numbers and its readings position by
position; for the control seeds also the control's (the reference in
float8, ``check.py``).  One JSON line a seed, appended to ``--out``.
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
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", required=True)
    a = p.parse_args()
    import torch
    from perfbench import check, files, harness
    bench = files.benchmark()
    cell = files.cell_entry(bench, a.workload)
    wl = files.workload(a.workload)
    cfg, traffic = files.config(wl["config"]), files.traffic(wl["traffic"])
    ctrl = {int(s) for s in a.control_seeds.split(",") if s}
    for seed in (int(s) for s in a.seeds.split(",")):
        args = argparse.Namespace(workload=a.workload, seed=seed,
                                  seconds=a.seconds, trace=0)
        detail = {"control": seed in ctrl}
        t = time.time()
        res = harness.run_cell(args, t, cell, wl, cfg, traffic, [], [], {},
                               torch.device("cuda:0"), detail=detail)
        line = {"seed": seed, "correct": res["correct"],
                "system": check.numbers(detail["system"]),
                "detail": detail}
        if seed in ctrl:
            line["control"] = check.numbers(detail["control"])
        with open(a.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps({k: v for k, v in line.items() if k != "detail"}),
              f"{time.time() - t:.1f} s", flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
